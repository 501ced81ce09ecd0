"""Communication audit of the data-parallel and DP x TP train steps.

Port of ``rlvae_tpu/parallel/comm_audit.py`` and ``scripts/comm_audit.py``.
JAX parses the optimized HLO of a compiled step; the port's collectives are
calls of its counted wrappers (:mod:`.collectives`), so :func:`audit` runs
one call of a function and returns the same ``{op: {count, bytes}}`` shape
with the totals.  :func:`step_plan` is what one data-parallel step must
send: one flat all-reduce of every local gradient, the loss terms and the
BatchNorm running statistics over the data group (under DP x TP also the
sharded gradients' squared norm over the model group; the layers' activation
collectives come on top).  ``tests/test_torch_comm_audit.py`` pins JAX's
invariants (DP: all-reduce bytes within [1.0, 1.25] x the parameter bytes,
no all-gather; DP x TP: fewer bytes in all than the parameters, all-gathers
below half of them).

    python -m rlvae_tpu_torch.parallel.comm_audit --world 4 --model-parallel 2 \\
        --device cpu --out /tmp/audit

runs one step of the DP layout (world x 1) and of the DP x TP layout through
:mod:`.dp_verify` on JAX's audit model (3x8x8 frames, latent 16, two flows
of width 32, batch 16) and writes ``OUT/comm_audit.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch

from rlvae_tpu_torch.parallel.collectives import KINDS, TALLY, CommTally
from rlvae_tpu_torch.parallel.mesh import Mesh

N_LOSS_TERMS = 5  # loss, recon_loss, kld_loss, flow_loss, loop_penalty


def audit(fn: Callable, *args, tally: CommTally = TALLY, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once and return its collectives (every
    rank of the world must call it together)."""
    tally.reset()
    fn(*args, **kwargs)
    summary = tally.snapshot()
    return {"collectives": summary,
            "total_count": sum(v["count"] for v in summary.values()),
            "total_bytes": sum(v["bytes"] for v in summary.values())}


def param_bytes(model: torch.nn.Module) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def step_plan(model: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer],
              mesh: Optional[Mesh]) -> Dict[str, Dict[str, int]]:
    """The collectives one data-parallel train step makes over ``mesh``
    (its activation collectives under DP x TP aside)."""
    from rlvae_tpu_torch.train.trainer import batchnorm_stats

    plan = {k: {"count": 0, "bytes": 0} for k in KINDS}
    if mesh is None:
        return plan
    params = [p for p in model.parameters() if p.requires_grad]
    n = sum(p.numel() for p in params) + N_LOSS_TERMS + sum(
        b.numel() for b in batchnorm_stats(model))
    plan["all-reduce"] = {"count": 1, "bytes": 4 * n}
    if any("parametrizations." in k for k, _ in model.named_parameters()) or any(
            hasattr(m, "sharded_dense") for m in model.modules()):
        plan["all-reduce"]["count"] += 1  # the sharded gradients' squared norm
        plan["all-reduce"]["bytes"] += 4
    return plan


def main(argv=None) -> int:
    from rlvae_tpu_torch.parallel import dp_verify

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--world", type=int, default=2)
    parser.add_argument("--model-parallel", type=int, default=2)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--backend", choices=("gloo", "nccl"), default=None)
    parser.add_argument("--out", required=True)
    parser.add_argument("--timeout", type=float, default=300.0)
    args = parser.parse_args(argv)
    out = Path(args.out).resolve()
    cmd = ["--world", str(args.world), "--model-parallel", f"1,{args.model_parallel}",
           "--device", args.device, "--out", str(out), "--steps", "1", "--epochs", "0",
           "--timeout", str(args.timeout)]
    if args.backend:
        cmd += ["--backend", args.backend]
    if dp_verify.main(cmd) != 0:
        return 1
    layouts = json.loads((out / "summary.json").read_text())["layouts"]
    report: Dict[str, Any] = {
        name: {k: layouts[str(mp)][k] for k in ("mesh", "collectives", "plan", "param_bytes",
                                                "total_bytes")}
        for name, mp in (("dp", 1), ("dp_tp", args.model_parallel))}
    (out / "comm_audit.json").write_text(json.dumps(report, indent=2))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
