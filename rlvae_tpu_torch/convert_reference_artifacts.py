"""One-shot migration of the reference's ``.pt`` artifacts to ``.npz``.

Port of ``scripts/convert_reference_artifacts.py``, on the port's
converters (:mod:`rlvae_tpu_torch.data.convert`,
:mod:`rlvae_tpu_torch.geometry.loader`): a ``.pt`` [N, T, C, H, W]
sequence dataset, a pythae MLP encoder's and decoder's state dicts, and a
metric (any key aliases) each become the ``.npz`` both packages read.  Each
output is checked after it is written (the dataset's shape, the component's
parameter count read back, the metric's validation report) and the summary
is printed as JSON.

Run: ``python -m rlvae_tpu_torch.convert_reference_artifacts --dataset
D.pt --encoder E.pt --decoder DEC.pt --metric M.pt --out-dir converted/``
(at least one input).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from rlvae_tpu_torch.data import convert as cv
from rlvae_tpu_torch.geometry.loader import load_metric, save_metric, validate_metric_file


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node


def convert(out: Path, dataset=None, encoder=None, decoder=None, metric=None) -> dict:
    """Convert the given artifacts into ``out``; returns the report."""
    out.mkdir(parents=True, exist_ok=True)
    report = {}
    if dataset:
        dst = out / (Path(dataset).stem + ".npz")
        report["dataset"] = {"out": str(dst), "shape": list(cv.convert_dataset(dataset, dst))}
    for kind, src in (("encoder", encoder), ("decoder", decoder)):
        if src:
            dst = out / (Path(src).stem + ".npz")
            cv.convert_component(src, dst, kind)
            params = cv.load_component_npz(dst)["params"]  # read back
            n = sum(v.size for v in _leaves(params))
            report[kind] = {"out": str(dst), "param_count": int(n)}
    if metric:
        m = load_metric(metric)  # alias-tolerant, validates
        dst = out / (Path(metric).stem + ".npz")
        save_metric(m, dst)
        report["metric"] = {"out": str(dst), "n_centroids": int(m.n_centroids),
                            "latent_dim": int(m.latent_dim),
                            "validation": validate_metric_file(dst)}
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Convert the reference's .pt artifacts to .npz.")
    ap.add_argument("--dataset", type=Path, help=".pt [N,T,C,H,W] sequences")
    ap.add_argument("--encoder", type=Path, help="encoder .pt state dict")
    ap.add_argument("--decoder", type=Path, help="decoder .pt state dict")
    ap.add_argument("--metric", type=Path, help="metric .pt (any alias scheme)")
    ap.add_argument("--out-dir", type=Path, default=Path("converted"))
    args = ap.parse_args(argv)
    if not any((args.dataset, args.encoder, args.decoder, args.metric)):
        ap.error("nothing to convert: pass at least one of --dataset/--encoder/--decoder/--metric")
    report = convert(args.out_dir, args.dataset, args.encoder, args.decoder, args.metric)
    print(json.dumps(report, indent=2, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
