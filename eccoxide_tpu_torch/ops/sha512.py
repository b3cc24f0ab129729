"""Host batch SHA-512: B messages hashed across a thread pool by the native
library ``native/sha512.cpp`` (OpenSSL when the process can load it, else
its own portable code), built with g++ on first use by ``ops/build.py``.

A failed build raises: this module never switches to another hasher, and
``hasher()`` names the code the library runs, so a timed run can say which
one it timed.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .build import sha512_lib


def sha512_batch(msgs: list[bytes]) -> np.ndarray:
    """Hash B messages -> (64, B) int32 byte columns, on as many threads as
    the host has cores."""
    lib = sha512_lib()
    n = len(msgs)
    blob = b"".join(msgs)
    offsets = np.zeros(n + 1, dtype=np.uint64)
    np.cumsum([len(m) for m in msgs], out=offsets[1:])
    buf = np.frombuffer(blob, dtype=np.uint8) if blob else np.zeros(1, np.uint8)
    out = np.empty((n, 64), dtype=np.uint8)
    lib.sha512_batch(
        buf.ctypes.data, offsets.ctypes.data, n, out.ctypes.data, 0
    )
    return np.ascontiguousarray(out.T).astype(np.int32)


def hasher() -> str:
    """The SHA-512 code ``sha512_batch`` runs in this process. The library
    binds OpenSSL's EVP_sha512 and EVP_Digest from libcrypto.so.3, else from
    libcrypto.so.1.1, at its first call, and uses its portable code when the
    first of those it can load lacks them or neither loads. This repeats
    that search in the same order."""
    for name in ("libcrypto.so.3", "libcrypto.so.1.1"):
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        if hasattr(lib, "EVP_sha512") and hasattr(lib, "EVP_Digest"):
            return f"openssl {name}"
        return "portable"
    return "portable"
