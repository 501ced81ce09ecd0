"""Debug-mode NaN/Inf guards: the counterpart of ``rlvae_tpu/utils/debug.py``.

JAX instruments its jitted step with ``checkify`` float checks.  Here the
checks run on the host after each call: :func:`add_nan_checks` wraps a
train step and raises ``FloatingPointError`` naming the first non-finite
loss term it returned, then the first non-finite gradient, then the first
non-finite parameter of the module it updated.  The trainer turns it on
with ``training.debug_nan_checks: true``; every check reads the card, so
each step waits for it.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch


def _leaves(tree, path: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs; a path is written as ``jax.tree_util.keystr``
    writes it (``['a'][0]``)."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _leaves(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, v in enumerate(tree) for leaf in _leaves(v, f"{path}[{i}]")]
    return [(path, tree)]


def _finite(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return bool(torch.isfinite(leaf).all())
    return bool(np.isfinite(np.asarray(leaf)).all())


def assert_finite_tree(tree, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` listing (up to 5) paths of ``tree`` that
    hold a NaN or Inf.  Leaves are tensors, arrays or numbers in nested
    dicts, lists and tuples."""
    bad = [path for path, leaf in _leaves(tree) if leaf is not None and not _finite(leaf)]
    if bad:
        raise FloatingPointError(f"Non-finite values in {name}: {bad[:5]}")


def add_nan_checks(fn: Callable, module: Optional[torch.nn.Module] = None) -> Callable:
    """``fn`` followed by finiteness checks of what it returned (the loss
    terms, in their order) and, with ``module``, of its parameters'
    gradients and of the parameters themselves."""

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        assert_finite_tree(out, "loss terms")
        if module is not None:
            named = list(module.named_parameters())
            assert_finite_tree({k: p.grad for k, p in named}, "gradients")
            assert_finite_tree({k: p.detach() for k, p in named}, "parameters")
        return out

    return wrapper
