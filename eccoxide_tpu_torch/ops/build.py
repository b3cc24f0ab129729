"""Builds the port's native code on first use and loads it with ctypes.

- The CUDA kernels (``csrc/group.cu``) are compiled by ``nvcc`` for
  ``sm_90a`` into a shared library with a plain C interface.
- The host batch SHA-512 (``native/sha512.cpp`` at the repository root) is
  compiled by ``g++``.

Outputs go to ``eccoxide_tpu_torch/_build/`` (listed in ``.gitignore``),
named by a hash of the sources and flags, so an edited source is rebuilt
and a stale library is never loaded. A missing compiler or a failed build
raises ``BuildError``; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PKG_DIR / "_build"
CSRC = Path(__file__).resolve().parent / "csrc"
KERNEL_SOURCES = [CSRC / "group.cu"]
KERNEL_DEPS = [CSRC / "fe25519.cuh"]
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
SHA512_SOURCE = PKG_DIR.parent / "native" / "sha512.cpp"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]
GXX_LIBS = ["-lpthread", "-ldl"]


class BuildError(RuntimeError):
    pass


@dataclass
class Built:
    path: Path
    log: str          # compiler output (nvcc: the -Xptxas -v report), kept
                      # beside the library, so a reused build has it too
    seconds: float    # 0.0 when an earlier build was reused


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise BuildError("nvcc not found: the CUDA kernels cannot be built")


def _gxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise BuildError("g++ not found: the SHA-512 library cannot be built")
    return found


class _Job:
    """One compiler run into a content-addressed output."""

    def __init__(self, name: str, cmd_fn, files, flags, libs=()):
        h = hashlib.sha256()
        for f in files:
            h.update(Path(f).read_bytes())
        h.update(" ".join(list(flags) + list(libs)).encode())
        self.out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
        self.name = name
        self.cmd_fn = cmd_fn
        self.proc = None
        self.t0 = 0.0

    def start(self):
        if self.out.exists():
            return self
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self.tmp = self.out.with_name(f"{self.out.name}.{os.getpid()}.tmp")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            self.cmd_fn(str(self.tmp)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        return self

    def finish(self) -> Built:
        log_path = self.out.with_suffix(".log")
        if self.proc is None:
            return Built(self.out, log_path.read_text() if log_path.exists() else "", 0.0)
        log, _ = self.proc.communicate()
        secs = time.perf_counter() - self.t0
        if self.proc.returncode != 0:
            raise BuildError(f"building {self.name} failed:\n{log}")
        log_path.write_text(log)
        os.replace(self.tmp, self.out)
        return Built(self.out, log, secs)


def _kernel_job() -> _Job:
    nvcc = _nvcc()
    return _Job(
        "eccoxide_kernels",
        lambda out: [nvcc, *NVCC_FLAGS, "-o", out,
                     *map(str, KERNEL_SOURCES)],
        KERNEL_SOURCES + KERNEL_DEPS, NVCC_FLAGS)


def _sha512_job() -> _Job:
    gxx = _gxx()
    return _Job(
        "sha512",
        lambda out: [gxx, *GXX_FLAGS, "-o", out, str(SHA512_SOURCE),
                     *GXX_LIBS],
        [SHA512_SOURCE], GXX_FLAGS, GXX_LIBS)


_libs: dict = {}


def _bind_kernels(lib):
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.ed_add_launch.argtypes = [vp, vp, vp, i32, i32, i64, vp]
    lib.ed_double_launch.argtypes = [vp, vp, i32, i32, i64, vp]
    lib.pow_launch.argtypes = [vp, vp, vp, i32, i64, vp]
    for fn in (lib.ed_add_launch, lib.ed_double_launch, lib.pow_launch):
        fn.restype = ctypes.c_int


def _bind_sha512(lib):
    lib.sha512_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int,
    ]
    lib.sha512_batch.restype = None


def _load(name: str, built: Built, bind):
    lib = ctypes.CDLL(str(built.path))
    bind(lib)
    _libs[name] = lib
    return lib


def build_all() -> dict:
    """Build the kernels and the SHA-512 library, both compilers running at
    once; load both. Returns {name: Built}."""
    jobs = {"kernels": _kernel_job().start(), "sha512": _sha512_job().start()}
    out = {}
    for name, job in jobs.items():
        built = job.finish()
        _load(name, built, _bind_kernels if name == "kernels" else _bind_sha512)
        out[name] = built
    return out


def kernels():
    """The loaded kernel library (built on first use)."""
    if "kernels" not in _libs:
        _load("kernels", _kernel_job().start().finish(), _bind_kernels)
    return _libs["kernels"]


def sha512_lib():
    """The loaded SHA-512 library (built on first use)."""
    if "sha512" not in _libs:
        _load("sha512", _sha512_job().start().finish(), _bind_sha512)
    return _libs["sha512"]
