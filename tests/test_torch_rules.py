"""Rules of the port: it stands alone from the JAX package, it runs on the
card unless the caller asks for the CPU, and its kernels never fall back."""

import ast
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

from eccoxide_tpu_torch.ops import build, group
from eccoxide_tpu_torch.protocol import ed25519 as tpe
from eccoxide_tpu_torch.protocol import ed25519_batch as tpb

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "eccoxide_tpu_torch"
SOURCES = sorted(p for ext in ("*.py", "*.cu", "*.cuh") for p in PKG.rglob(ext))


def test_no_file_of_the_port_names_jax_or_the_jax_package():
    assert len(SOURCES) > 15
    bad = re.compile(r"\bjax\b|eccoxide_tpu(?!_torch)")
    hits = [f"{p.relative_to(ROOT)}:{i}" for p in SOURCES
            for i, line in enumerate(p.read_text().splitlines(), 1) if bad.search(line)]
    assert hits == []


def test_chip_smoke_imports_nothing_of_the_jax_package():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names if m.split(".")[0] in ("jax", "eccoxide_tpu")]


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import eccoxide_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'eccoxide_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) > 15, mods\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'eccoxide_tpu' or m.startswith('eccoxide_tpu.')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    pk, sig = bytes(32), bytes(64)
    with pytest.raises(RuntimeError):
        tpe.verify_host([pk], [b""], [sig])
    with pytest.raises(RuntimeError):
        tpb.verify_batch_host([pk], [b""], [sig])
    with pytest.raises(RuntimeError):
        tpe.VerifyTables()


def test_cpu_tensors_never_launch():
    group.reset_launches()
    p = tpe.ED.identity((3,), "cpu").xyzt
    group.ed_add(p, p)
    group.ed_double(p)
    group.pow_const_kernel(p[1], 2**255 - 21)
    tpe.verify_host([bytes(32)], [b""], [bytes(64)], device="cpu")
    assert group.launches() == {"pow_const_kernel": 0, "ed_add": 0, "ed_double": 0}


def test_no_kernel_for_other_devices_and_no_build_without_nvcc():
    p = torch.zeros((4, 10, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        group.ed_add(p, p)
    with pytest.raises(ValueError):
        group.ed_add(p.to(torch.int64), p.to(torch.int64))
    if shutil.which("nvcc") or torch.cuda.is_available():
        pytest.skip("nvcc is present: the build can run here")
    with pytest.raises(build.BuildError):
        build.kernels()
