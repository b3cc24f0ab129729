"""Host batch SHA-512: B messages hashed across a thread pool by the native
library ``native/sha512.cpp`` (OpenSSL when the process can load it, else
its own portable code), built with g++ on first use by ``ops/build.py``;
and the Ed25519 verifiers' host columns, H(R || A || M) with pk, R and S,
in one native pass over the caller's byte strings by
``csrc/ed25519_inputs.cpp``, which hashes with the same code.

A failed build raises: this module never switches to another hasher, and
``hasher()`` names the code the libraries run, so a timed run can say which
one it timed.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..spans import span
from .build import inputs_lib, sha512_lib


def sha512_batch(msgs: list[bytes]) -> np.ndarray:
    """Hash B messages -> (64, B) int32 byte columns, on as many threads as
    the host has cores."""
    lib = sha512_lib()
    n = len(msgs)
    with span("sha512.join"):
        blob = b"".join(msgs)
        offsets = np.zeros(n + 1, dtype=np.uint64)
        np.cumsum([len(m) for m in msgs], out=offsets[1:])
        buf = np.frombuffer(blob, dtype=np.uint8) if blob else np.zeros(1, np.uint8)
    with span("sha512.hash"):
        out = np.empty((n, 64), dtype=np.uint8)
        lib.sha512_batch(
            buf.ctypes.data, offsets.ctypes.data, n, out.ctypes.data, 0
        )
    with span("sha512.columns"):
        return np.ascontiguousarray(out.T).astype(np.int32)


def verify_columns(pks, msgs, sigs) -> tuple:
    """The byte columns (pk, R, S, H(R || A || M)) of B signatures, int32
    (32, B), (32, B), (32, B) and (64, B) on the host, from sequences of
    bytes-like keys (32 B), messages and signatures (64 B, R || S): the
    native walk over the three sequences, then the threaded pass that
    hashes each lane and writes the columns. Raises ValueError for
    sequences of different lengths or a key or signature of another width,
    TypeError for an element that is not bytes-like."""
    lib = inputs_lib()
    n = len(pks)
    out = tuple(torch.empty((w, n), dtype=torch.int32) for w in (32, 32, 32, 64))
    with span("ed25519.concat"):
        walk = lib.ed25519_inputs_walk(pks, msgs, sigs)
    with span("sha512.hash") as s:
        hashed = ctypes.c_int64()
        try:
            threads = lib.ed25519_inputs_hash(
                walk, *(t.data_ptr() for t in out), ctypes.addressof(hashed))
        finally:
            lib.ed25519_inputs_free(walk)
        s.set(lanes=n, bytes=hashed.value, threads=threads)
    return out


def hasher() -> str:
    """The SHA-512 code ``sha512_batch`` and ``verify_columns`` run in this
    process. The libraries bind OpenSSL's EVP_sha512 and EVP_Digest from
    libcrypto.so.3, else from libcrypto.so.1.1, at their first call, and use
    their portable code when the first of those they can load lacks them or
    neither loads. This repeats that search in the same order."""
    for name in ("libcrypto.so.3", "libcrypto.so.1.1"):
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        if hasattr(lib, "EVP_sha512") and hasattr(lib, "EVP_Digest"):
            return f"openssl {name}"
        return "portable"
    return "portable"
