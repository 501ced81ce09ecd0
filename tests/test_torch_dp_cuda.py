"""Data parallelism on the card (marker ``cuda``; each test skips with a
reason without one).  Run on a machine with a card, without JAX:

    python -m pytest tests/test_torch_dp_cuda.py -q --noconftest

- A gloo world of two ranks sharing ``cuda:0`` (NCCL refuses two ranks on
  one device) through ``python -m rlvae_tpu_torch.parallel.dp_verify``: the
  2 x 1 and 1 x 2 layouts of JAX's DP x TP parity model, every step against
  the plain step on the whole batch replayed on the card, the epoch rows
  against ``host_epoch_perm``, the chunked epoch against the resident one,
  the collectives against the plan; each rank's step launches the IAF-chain
  forward and backward once (the model's Gaussian posterior without a
  metric launches no chol-bundle).  In the same world the fast preset
  (3x8x8, two flows of width 32, the K=50 metric) on 1 x 2: its decoder's
  output layer gathered for the fused kernel, each rank's step launching
  the chol-bundle twice and each decode+MSE kernel (forward, dh, dW) once,
  and no IAF chain.
- An NCCL world of one rank: its steps equal the plain trainer's bits.
- NCCL with more ranks than cards raises and names ``--backend gloo``.
"""

import json
from pathlib import Path

import pytest
import torch

from rlvae_tpu_torch.models import PRESETS
from rlvae_tpu_torch.parallel import dp_verify

pytestmark = pytest.mark.cuda
DATA = Path(__file__).resolve().parents[1] / "data" / "pretrained"
FAST = {**PRESETS["riemannian_flow_vae_fast"], "input_dim": [3, 8, 8], "n_flows": 2,
        "flow_hidden_size": 32,
        "pretrained": {"metric_path": str(DATA / "metric_T0.7_scaled.npz")}}
NONE = dict.fromkeys(("chol_bundle", "iaf_chain_fwd", "iaf_chain_bwd", "hmc_terms",
                      "metric_bundle", "g_inv", "decode_mse_fwd", "decode_mse_bwd_dh",
                      "decode_mse_bwd_dw", "hmc_partials"), 0)
PER_STEP = {"small": {**NONE, "iaf_chain_fwd": 1, "iaf_chain_bwd": 1},
            "fast": {**NONE, "chol_bundle": 2, "decode_mse_fwd": 1, "decode_mse_bwd_dh": 1,
                     "decode_mse_bwd_dw": 1}}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _run(out, *argv):
    rc = dp_verify.main([*argv, "--device", "cuda", "--out", str(out), "--timeout", "300"])
    summary = json.loads((out / "summary.json").read_text())
    assert rc == 0 and summary["ok"], summary
    return summary


def _launched_per_step(layout, per_step):
    """Every rank's every step launched ``per_step``."""
    assert layout["launches"] and all(layout["launches"])
    for steps in layout["launches"]:
        for counts in steps:
            assert counts == per_step, counts


def test_two_rank_gloo_world_on_one_card(card, tmp_path):
    (tmp_path / "fast.json").write_text(json.dumps(FAST))
    summary = _run(tmp_path, "--world", "2", "--backend", "gloo", "--model-parallel", "1,2",
                   "--epochs", "1", "--extra", "fast@2")
    for name, layout in summary["layouts"].items():
        _launched_per_step(layout, PER_STEP["fast" if name == "fast" else "small"])
    dp = summary["layouts"]["1"]
    assert dp["rows_equal_host_epoch_perm"] and dp["chunked_equals_resident"]
    assert dp["collectives"]["all-reduce"] == dp["plan"]["all-reduce"]
    assert summary["layouts"]["fast"]["tp_layout"]["decoder.out.weight"] == [1, "gather"]


def test_one_rank_nccl_world_is_the_plain_trainer(card, tmp_path):
    summary = _run(tmp_path, "--world", "1", "--backend", "nccl", "--epochs", "1")
    layout = summary["layouts"]["1"]
    _launched_per_step(layout, PER_STEP["small"])
    assert layout["steps_vs_plain"]["bitwise"] and layout["epochs"]["vs_replay"]["bitwise"]


def test_nccl_refuses_more_ranks_than_cards(card, tmp_path):
    with pytest.raises(ValueError, match="--backend gloo"):
        dp_verify.main(["--world", str(torch.cuda.device_count() + 1), "--device", "cuda",
                        "--backend", "nccl", "--out", str(tmp_path)])
