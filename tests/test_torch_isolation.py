"""The port stands alone: no JAX, orbax, optax and nothing of rlvae_tpu is
imported by rlvae_tpu_torch or chip_smoke.py; the entry points do not fall
back to the CPU; the kernel build targets sm_90a from csrc/ into an ignored
directory and raises without nvcc."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import rlvae_tpu_torch
from rlvae_tpu_torch import ModelManager, PRESETS, components, experiment, resolve_device
from rlvae_tpu_torch.ops import build
from rlvae_tpu_torch.ops.iaf_kernels import iaf_chain_fwd
from rlvae_tpu_torch.ops.metric_kernels import chol_bundle, g_inv, hmc_terms, metric_bundle
from rlvae_tpu_torch.ops.recon_kernels import decode_mse, decode_mse_bwd_dh, decode_mse_bwd_dw

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "rlvae_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = re.compile(r"^\s*(from|import)\s+(jax|flax|orbax|optax|rlvae_tpu)(\.|\s|$)", re.M)

_PROBE = """
import importlib, pkgutil, sys
before = set(sys.modules)
import rlvae_tpu_torch, chip_smoke
for info in pkgutil.walk_packages(rlvae_tpu_torch.__path__, "rlvae_tpu_torch."):
    importlib.import_module(info.name)
new = set(sys.modules) - before
bad = sorted(m for m in new if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "optax",
                                                  "rlvae_tpu"))
print(len(new), bad)
sys.exit(1 if bad else 0)
"""


def test_import_pulls_in_no_jax_and_no_rlvae_tpu():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_CONFIG_PROBE = """
import sys
before = set(sys.modules)
import rlvae_tpu_torch.config, rlvae_tpu_torch.experiment
bad = sorted(m for m in set(sys.modules) - before
             if m.split(".")[0] in ("yaml", "rlvae_tpu", "jax"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_config_imports_no_yaml_and_no_rlvae_tpu():
    """PyYAML loads lazily, where a file is read or written."""
    proc = subprocess.run([sys.executable, "-c", _CONFIG_PROBE], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_scan_covers_the_net_families():
    """``PORT_FILES`` globs the package, so the scan below reads every module,
    the CNN and ResNet nets and their layers included."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for mod in ("layers", "cnn", "resnet", "mlp", "registry"):
        assert f"rlvae_tpu_torch/nets/{mod}.py" in names


def test_the_scan_covers_the_geometry_stack():
    """The geodesics, curvature, metric pre-training and the components
    entry point are read by the scan below and imported by the probe above."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for mod in ("geometry/geodesics", "geometry/curvature", "geometry/pretrain",
                "geometry/loader", "geometry/metric", "components"):
        assert f"rlvae_tpu_torch/{mod}.py" in names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_statement_of_jax_or_rlvae_tpu(path):
    assert not FORBIDDEN.search(path.read_text()), path


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelManager.from_config(PRESETS["riemannian_flow_vae"])
    with pytest.raises(RuntimeError, match="CUDA"):  # before the run directory is written
        experiment.main([f"run.dir={tmp_path / 'run'}"])
    assert not (tmp_path / "run").exists()
    with pytest.raises(RuntimeError, match="CUDA"):  # before the run directory is read
        ModelManager.from_checkpoint("no-such-run", PRESETS["riemannian_flow_vae"])
    with pytest.raises(RuntimeError, match="CUDA"):  # before anything is trained or written
        components.main(["--out-dir", str(tmp_path / "components")])
    assert not (tmp_path / "components").exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_wrappers_take_the_plain_version_only_for_cpu_tensors():
    z = torch.empty((4, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        chol_bundle(z, z, torch.empty((4, 16, 16), device="meta"), 1.0, 0.01)
    with pytest.raises(ValueError, match="unsupported device"):
        hmc_terms(z, z, torch.empty((4, 16, 16), device="meta"), 1.0, 0.01, -23.0)
    for wrapper in (metric_bundle, g_inv):
        with pytest.raises(ValueError, match="unsupported device"):
            wrapper(z, z, torch.empty((4, 16, 16), device="meta"), 1.0, 0.01)
    w = torch.empty((1, 1, 16, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        iaf_chain_fwd(z, w, w, w, w, w, w)
    h, x, g = torch.empty((4, 32), device="meta"), torch.empty((4, 8), device="meta"), z[0, 0]
    for wrapper, args in ((decode_mse, ()), (decode_mse_bwd_dh, (g,)), (decode_mse_bwd_dw, (g,))):
        with pytest.raises(ValueError, match="unsupported device"):
            wrapper(h, torch.empty((8, 32), device="meta"), x[0], x, h[:, 0], *args)


def _ignored(path: Path) -> bool:
    inside_git = subprocess.run(["git", "rev-parse", "--is-inside-work-tree"], cwd=REPO,
                                capture_output=True, text=True).returncode == 0
    if inside_git:
        return subprocess.run(["git", "check-ignore", "-q", str(path)], cwd=REPO).returncode == 0
    return "build/" in (REPO / ".gitignore").read_text().split()


def test_build_command():
    out = build.library_path()
    srcs = build.sources()
    objs = [out.with_name(f"{p.stem}.o") for p in srcs]
    for src, obj in zip(srcs, objs):
        argv = build.compile_argv("nvcc", src, obj)
        assert "arch=compute_90a,code=sm_90a" in argv
        assert {"-c", "-O3", "-std=c++17"} <= set(argv)
        assert [a for a in argv if a.endswith(".cu")] == [str(src)]
    link = build.link_argv("nvcc", objs, out)
    assert "arch=compute_90a,code=sm_90a" in link and "-shared" in link
    assert link[-len(objs):] == [str(o) for o in objs]
    assert sorted(p.name for p in srcs) == ["chol_bundle.cu", "decode_mse.cu",
                                            "decode_mse_wide.cu", "hmc_partials.cu",
                                            "hmc_terms.cu", "iaf_chain.cu", "iaf_chain_bwd.cu",
                                            "metric_bundle.cu"]
    assert [p.name for p in build.headers()] == ["hmc_bank.cuh", "iaf_cluster.cuh", "sm90.cuh"]
    assert all(p.parent == REPO / "rlvae_tpu_torch" / "csrc" for p in srcs)
    assert out.parent == REPO / "build" / "rlvae_tpu_torch"
    assert re.fullmatch(r"librlvae_kernels_[0-9a-f]{16}\.so", out.name)
    assert _ignored(out)
    for src in srcs:
        text = src.read_text()
        assert "torch/extension.h" not in text and 'extern "C"' in text


def test_signatures_match_the_sources():
    """Every extern "C" function of csrc/*.cu has a ctypes signature with one
    argtype per parameter (nothing compiles here, so this is the check that
    a pointer is not passed as a 32-bit int).  The profile build's entries
    are compiled only under its define."""
    found, profiled = {}, set()
    for src in build.sources():
        text = src.read_text()
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            found[name] = len(params.split(","))
        for define in build.PROFILES:
            for block in re.findall(rf"#ifdef {define}\n(.*?)#endif", text, re.S):
                profiled |= set(re.findall(r'extern "C" int (\w+)\(', block))
    signatures = {**build.SIGNATURES, **build.PROFILE_SIGNATURES}
    assert {k: len(v) for k, v in signatures.items()} == found
    assert profiled == set(build.PROFILE_SIGNATURES)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "NVCC_FALLBACKS", ())
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "b")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not (tmp_path / "b").exists()
