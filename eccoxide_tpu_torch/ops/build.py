"""Builds the port's native code on first use and loads it with ctypes.

- The CUDA kernels are compiled by ``nvcc`` for ``sm_90a``, one shared
  library with a plain C interface per source (``csrc/group.cu``: the
  edwards25519 add, double and pow kernels; ``csrc/pow448.cu``: the pow
  kernel over FQ448; ``csrc/pow_sec2.cu``: the pow kernel over the SEC2
  primes, one instance per limb count of ``POW_SEC2_LIMBS``), every
  compiler started at once.
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
KERNEL_SOURCES = {"group": CSRC / "group.cu", "pow448": CSRC / "pow448.cu",
                  "pow_sec2": CSRC / "pow_sec2.cu"}
KERNEL_DEPS = {"group": [CSRC / "fe25519.cuh"], "pow448": [CSRC / "fe448.cuh"],
               "pow_sec2": [CSRC / "fe_sec2.cuh"]}
# the limb counts of the 15 SEC2 coordinate fields (field_sec2.limb_count),
# one entry point pow_sec2_launch_<n> each in csrc/pow_sec2.cu
POW_SEC2_LIMBS = (6, 7, 9, 10, 11, 15, 20)
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


def _kernel_job(name: str) -> _Job:
    nvcc = _nvcc()
    src = KERNEL_SOURCES[name]
    return _Job(
        f"eccoxide_{name}",
        lambda out: [nvcc, *NVCC_FLAGS, "-o", out, str(src)],
        [src, *KERNEL_DEPS[name]], NVCC_FLAGS)


def _sha512_job() -> _Job:
    gxx = _gxx()
    return _Job(
        "sha512",
        lambda out: [gxx, *GXX_FLAGS, "-o", out, str(SHA512_SOURCE),
                     *GXX_LIBS],
        [SHA512_SOURCE], GXX_FLAGS, GXX_LIBS)


_libs: dict = {}


_vp, _i64, _i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# the C entry points of each kernel library and their argument types
_ENTRY_POINTS = {
    "group": {"ed_add_launch": [_vp, _vp, _vp, _i32, _i32, _i64, _vp],
              "ed_double_launch": [_vp, _vp, _i32, _i32, _i64, _vp],
              "pow_launch": [_vp, _vp, _vp, _i32, _i64, _vp]},
    "pow448": {"pow448_launch": [_vp, _vp, _vp, _i32, _i64, _vp]},
    "pow_sec2": {f"pow_sec2_launch_{n}": [_vp, _vp, _vp, _i32, _vp, _i64, _vp]
                 for n in POW_SEC2_LIMBS},
}


def _binder(name: str):
    def bind(lib):
        for fn_name, argtypes in _ENTRY_POINTS[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return bind


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
    """Build every kernel library and the SHA-512 library, all compilers
    running at once; load them. Returns {name: Built}, keyed by the names
    of ``KERNEL_SOURCES`` and "sha512"."""
    jobs = {name: _kernel_job(name).start() for name in KERNEL_SOURCES}
    jobs["sha512"] = _sha512_job().start()
    out = {}
    for name, job in jobs.items():
        built = job.finish()
        _load(name, built, _bind_sha512 if name == "sha512" else _binder(name))
        out[name] = built
    return out


def kernels(name: str):
    """The loaded kernel library ``name`` of ``KERNEL_SOURCES`` (built on
    first use)."""
    if name not in _libs:
        _load(name, _kernel_job(name).start().finish(), _binder(name))
    return _libs[name]


def sha512_lib():
    """The loaded SHA-512 library (built on first use)."""
    if "sha512" not in _libs:
        _load("sha512", _sha512_job().start().finish(), _bind_sha512)
    return _libs["sha512"]
