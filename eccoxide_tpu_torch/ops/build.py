"""Builds the port's native code on first use and loads it with ctypes.

- The CUDA kernels are compiled by ``nvcc`` for ``sm_90a``, one shared
  library with a plain C interface per source, every compiler started at
  once: ``csrc/group.cu`` (the edwards25519 add, double and pow kernels),
  ``csrc/pow448.cu`` (the pow kernel over FQ448), ``csrc/imad_probe.cu``
  (the multiply-add rate probe) and, for each limb count of
  ``POW_SEC2_LIMBS``, a source generated here (``pow_sec2_source``) with
  one instance of ``csrc/pow_sec2.cuh`` per prime of that count in
  ``POW_SEC2_INSTANCES`` (the SEC2 coordinate primes, the SEC2 group
  orders and l), its fold matrix as constants.
- The host batch SHA-512 (``native/sha512.cpp`` at the repository root) and
  the verifiers' host columns (``csrc/ed25519_inputs.cpp``, which includes
  it and the interpreter's ``Python.h``) are compiled by ``g++``.

Outputs (and the generated sources, under ``gen/``) go to
``eccoxide_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash
of the sources and flags, so an edited source is rebuilt and a stale
library is never loaded. A missing compiler or a failed build raises
``BuildError``; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sysconfig
import time
from dataclasses import dataclass
from pathlib import Path

from ..field import L
from ..field_sec2 import limb_count
from ..params.sec2_params import CURVES

PKG_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PKG_DIR / "_build"
GEN_DIR = BUILD_DIR / "gen"
CSRC = Path(__file__).resolve().parent / "csrc"
KERNEL_SOURCES = {"group": CSRC / "group.cu", "pow448": CSRC / "pow448.cu",
                  "imad_probe": CSRC / "imad_probe.cu"}
KERNEL_DEPS = {"group": [CSRC / "fe25519.cuh"],
               "pow448": [CSRC / "fe448.cuh", CSRC / "madw.cuh"],
               "imad_probe": [CSRC / "madw.cuh"]}
# The SEC2 pow kernel: one instance per prime, one library per limb count,
# its source generated into GEN_DIR. A coordinate prime (p112r2, p128r2 and
# p160r2 share the prime of p112r1, p128r1 and p160k1) is named after the
# first curve of params/sec2_params.py with it, a group order after its
# curve with the suffix _n (the curves' scalar fields), and l, the order of
# edwards25519 (FL's pow), l25519: no name stands for two primes.
_COORDINATE_PRIMES = {c["p"]: name for name, c in reversed(CURVES.items())}
_ORDERS = {c["order"]: f"{name}_n" for name, c in CURVES.items()}
POW_SEC2_INSTANCES = {**_COORDINATE_PRIMES, **_ORDERS, L: "l25519"}   # p -> name
assert len(POW_SEC2_INSTANCES) == len(_COORDINATE_PRIMES) + len(_ORDERS) + 1
assert len(set(POW_SEC2_INSTANCES.values())) == len(POW_SEC2_INSTANCES)
POW_SEC2_LIMBS = tuple(sorted({limb_count(p.bit_length()) for p in POW_SEC2_INSTANCES}))
KERNEL_SOURCES.update({f"pow_sec2_{n}": GEN_DIR / f"pow_sec2_{n}.cu" for n in POW_SEC2_LIMBS})
KERNEL_DEPS.update({f"pow_sec2_{n}": [CSRC / "pow_sec2.cuh", CSRC / "fe_sec2.cuh",
                                      CSRC / "madw.cuh"] for n in POW_SEC2_LIMBS})
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
SHA512_SOURCE = PKG_DIR.parent / "native" / "sha512.cpp"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]
GXX_LIBS = ["-lpthread", "-ldl"]
INPUTS_SOURCE = CSRC / "ed25519_inputs.cpp"
INPUTS_INCLUDES = ["-I", sysconfig.get_paths()["include"], "-I", str(SHA512_SOURCE.parent)]


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
        raise BuildError("g++ not found: the host libraries cannot be built")
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


def pow_sec2_primes(n: int) -> list:
    """[(instance name, p)] of the SEC2 pow kernel's instances of n limbs."""
    return [(name, p) for p, name in POW_SEC2_INSTANCES.items()
            if limb_count(p.bit_length()) == n]


def pow_sec2_source(n: int) -> str:
    """The generated source of library ``pow_sec2_<n>``: per prime of n
    limbs, a struct with the limb count and the fold matrix
    (``field_sec2._Format.FOLD``) as constants, and its entry point
    ``pow_sec2_launch_<instance name>``."""
    from ..field_sec2 import _Format

    out = ["// Generated by eccoxide_tpu_torch/ops/build.py (pow_sec2_source) from",
           "// field_sec2._Format.FOLD: the pow_sec2 kernel (csrc/pow_sec2.cuh) for",
           f"// the primes of {n} limbs.",
           '#include "pow_sec2.cuh"', ""]
    for name, p in pow_sec2_primes(n):
        fold = _Format(p).FOLD
        rows = ",\n".join("      {" + ", ".join(f"{v:#x}u" for v in row) + "}" for row in fold)
        out += [f"// p = {p:#x}",
                f"struct {name} {{",
                f"  static constexpr int N = {n};",
                "  static constexpr uint32_t kFold[N][N] = {",
                rows + "};",
                "};",
                f"POW_SEC2_ENTRY({name})", ""]
    return "\n".join(out)


def _kernel_job(name: str) -> _Job:
    nvcc = _nvcc()
    src = KERNEL_SOURCES[name]
    if src.parent == GEN_DIR:
        text = pow_sec2_source(int(name.rsplit("_", 1)[1]))
        if not src.exists() or src.read_text() != text:
            GEN_DIR.mkdir(parents=True, exist_ok=True)
            tmp = src.with_name(f"{src.name}.{os.getpid()}.tmp")
            tmp.write_text(text)
            os.replace(tmp, src)
    return _Job(
        f"eccoxide_{name}",
        lambda out: [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", out, str(src)],
        [src, *KERNEL_DEPS[name]], NVCC_FLAGS)


def _sha512_job() -> _Job:
    gxx = _gxx()
    return _Job(
        "sha512",
        lambda out: [gxx, *GXX_FLAGS, "-o", out, str(SHA512_SOURCE),
                     *GXX_LIBS],
        [SHA512_SOURCE], GXX_FLAGS, GXX_LIBS)


def _inputs_job() -> _Job:
    gxx = _gxx()
    flags = GXX_FLAGS + INPUTS_INCLUDES
    return _Job(
        "ed25519_inputs",
        lambda out: [gxx, *flags, "-o", out, str(INPUTS_SOURCE), *GXX_LIBS],
        [INPUTS_SOURCE, SHA512_SOURCE], flags, GXX_LIBS)


_libs: dict = {}


_vp, _i64, _i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# the C entry points of each kernel library and their argument types
_ENTRY_POINTS = {
    "group": {"ed_add_launch": [_vp, _vp, _vp, _i32, _i32, _i64, _vp],
              "ed_double_launch": [_vp, _vp, _i32, _i32, _i64, _vp],
              "pow_launch": [_vp, _vp, _vp, _i32, _i64, _vp]},
    "pow448": {"pow448_launch": [_vp, _vp, _vp, _i32, _i64, _vp]},
    "imad_probe": {"imad_probe_launch": [_vp, ctypes.c_uint32, _i32, _i32, _vp]},
    **{f"pow_sec2_{n}": {f"pow_sec2_launch_{name}": [_vp, _vp, _vp, _i32, _i64, _vp]
                         for name, _ in pow_sec2_primes(n)}
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


def _bind_inputs(lib):
    lib.ed25519_inputs_walk.argtypes = [ctypes.py_object] * 3
    lib.ed25519_inputs_walk.restype = ctypes.c_void_p
    lib.ed25519_inputs_hash.argtypes = [ctypes.c_void_p] * 6
    lib.ed25519_inputs_hash.restype = ctypes.c_int
    lib.ed25519_inputs_free.argtypes = [ctypes.c_void_p]
    lib.ed25519_inputs_free.restype = None


def _load(name: str, built: Built, bind, dll=ctypes.CDLL):
    lib = dll(str(built.path))
    bind(lib)
    _libs[name] = lib
    return lib


def build_all() -> dict:
    """Build every kernel library, the SHA-512 library and the host columns'
    library, all compilers running at once; load them. Returns {name:
    Built}, keyed by the names of ``KERNEL_SOURCES``, "sha512" and
    "ed25519_inputs"."""
    jobs = {name: _kernel_job(name).start() for name in KERNEL_SOURCES}
    jobs["sha512"] = _sha512_job().start()
    jobs["ed25519_inputs"] = _inputs_job().start()
    host = {"sha512": (_bind_sha512, ctypes.CDLL),
            "ed25519_inputs": (_bind_inputs, ctypes.PyDLL)}
    out = {}
    for name, job in jobs.items():
        built = job.finish()
        _load(name, built, *host.get(name, (_binder(name),)))
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


def inputs_lib():
    """The loaded host columns' library (built on first use), its calls
    holding the interpreter lock (``ctypes.PyDLL``)."""
    if "ed25519_inputs" not in _libs:
        _load("ed25519_inputs", _inputs_job().start().finish(), _bind_inputs, ctypes.PyDLL)
    return _libs["ed25519_inputs"]
