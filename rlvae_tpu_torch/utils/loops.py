"""A loop over steps that an exported program holds once.

:func:`loop_steps` runs a step function over the leading axis of some
tensors: a Python loop eagerly, and one ``while_loop`` op while a program
is exported (``torch.export``), so the program holds the step's body once
however many steps it runs.  The HMC chains (``samplers/hmc.py``) and the
energy path's Adam steps (``geometry/geodesics.py``) loop through it.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

__all__ = ["loop_steps"]


def loop_steps(step: Callable, carry, xs: Tuple[torch.Tensor, ...]):
    """``step(carry, x) -> (carry, y)`` over the leading axis of the tensors
    of ``xs`` (at least one step); returns the last carry and the ys
    stacked.  Eagerly a Python loop.  While a program is exported
    (``torch.compiler.is_exporting()``), one ``while_loop`` op over the
    steps, the counterpart of JAX's ``lax.scan``: the program holds
    ``step``'s body once (an HMC chain's 16 B4 calls, not 1601) and runs the
    same body the eager loop runs, as many times.

    The exported loop keeps only its carry (ys is None; the programs read
    the last carry).  ``scan``, which keeps ys, runs its body once more
    than it has steps in torch before 2.13 (to size its outputs): 16 B4
    launches more a chain.  The loop's counter is a CPU tensor, so its
    test reads nothing from the card, and each step takes row 0 of the
    draws, which the body then rolls by one (a saved program holds no
    int counter, and an index tensor on the CPU would be copied to the
    card, synchronizing, every step)."""
    if torch.compiler.is_exporting():
        from torch._higher_order_ops.while_loop import while_loop

        leaves, spec = tree_flatten(carry)
        n, k = xs[0].shape[0], len(xs)

        def body(i, *state):
            now, leaves = state[:k], state[k:]
            carry, _ = step(tree_unflatten(list(leaves), spec), tuple(x[0] for x in now))
            return (i + 1, *(torch.roll(x, -1, 0) for x in now), *tree_flatten(carry)[0])

        counter = torch.zeros((), dtype=torch.int64)
        out = while_loop(lambda i, *state: i < n, body, (counter, *xs, *leaves))
        return tree_unflatten(list(out[1 + k:]), spec), None
    ys = []
    for i in range(xs[0].shape[0]):
        carry, y = step(carry, tuple(x[i] for x in xs))
        ys.append(y)
    return carry, tree_map(lambda *t: torch.stack(t), ys[0], *ys[1:])
