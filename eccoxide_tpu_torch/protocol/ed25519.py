"""Ed25519 (RFC 8032 PureEdDSA), batched: key generation and signing on
the constant-time comb, and the per-signature Straus verifier.
Counterpart of the JAX package's ``protocol/ed25519.py``.

SHA-512 runs on the host (``ops/sha512.py``); the curve and scalar
arithmetic runs batched on the device the caller names. Device functions
take byte columns, int32 ``(32, B)`` and ``(64, B)``, the JAX package's
layout; host functions take Python bytes. Signing hashes in three passes,
as the JAX package does: the secret keys, then prefix || M (for r), then
R || A || M (for k).
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves.curve25519 import EDWARDS as ED
from ..curves.curve25519 import FL
from ..curves.edwards import ExtPoint
from ..device import resolve_device
from ..limbs import windows_from_bytes_le
from ..ops.sha512 import sha512_batch, verify_columns
from ..params.comb import comb_tables, edwards_byte_table, edwards_comb, mul_base
from ..spans import span


class VerifyTables:
    """The verifiers' precomputed tables, on one device:

    - ``byte``: [k]B for k < 256 as (3, 10, 256) int32 (x, y, t rows), the
      8-bit windows of the Straus chain;
    - ``comb``: [j 16^i]B as (3, 64, 16, 10) int32, the fixed-base gather
      of the batch verifier.
    """

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        byte = np.stack(edwards_byte_table()).transpose(0, 2, 1)
        self.byte = torch.from_numpy(np.ascontiguousarray(byte)).to(self.device)
        self.comb = torch.from_numpy(np.stack(comb_tables())).to(self.device)


class SignTables:
    """The signer's table on one device: ``comb``, [j 16^i]B as
    (64, 16, 3, 10) int32 (window, entry, x|y|t, limbs), the layout
    ``params.comb.mul_base`` selects from."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.comb = edwards_comb(self.device)


def clamp_scalar_bytes(h: np.ndarray) -> np.ndarray:
    """RFC 8032 secret-scalar clamp on (32, B) byte columns."""
    h = h.copy()
    h[0] &= 0xF8
    h[31] = (h[31] & 0x7F) | 0x40
    return h


def double_scalar_mul_base(s_bytes, Q: ExtPoint, k_bytes, tables: VerifyTables):
    """[s]B + [k]Q with one shared doubling chain (Straus): 32 steps of
    8 doublings, 2 additions of the 16-entry Q table and 1 mixed addition
    of the byte table [S_m]B.

    Every input is public (signature, key, digest), so lookups are gathers.
    Byte m of S enters at sub-step 63 - 2m, i.e. in the second half of step
    31 - m. Each run of four doublings is one launch, T computed only at
    its end, and the Q additions skip T: nothing consumes it before the
    next doubling."""
    B = s_bytes.shape[1]
    wq = windows_from_bytes_le(k_bytes, 64).long()        # (64, B) MSB first
    tab_q = ED.window_table(Q, 4)                          # (16, 4, 10, B)

    def gather_q(idx):
        return ExtPoint(tab_q.gather(0, idx.view(1, 1, 1, B).expand(1, 4, 10, B))[0])

    acc = ED.identity((B,), s_bytes.device)
    for i in range(32):
        acc = ED.double(acc, k=4)
        acc = ED.add(acc, gather_q(wq[2 * i]), need_t=False)
        acc = ED.double(acc, k=4)
        acc = ED.add_mixed(acc, tables.byte[:, :, s_bytes[31 - i].long()])
        acc = ED.add(acc, gather_q(wq[2 * i + 1]), need_t=False)
    return acc


def scalar_mul_base(scalar_bytes, tables: SignTables) -> ExtPoint:
    """[s]B for (32, B) LE scalar bytes (the constant-time comb)."""
    return mul_base(scalar_bytes, tables.comb)


def scalar_mul(point: ExtPoint, scalar_bytes) -> ExtPoint:
    """[s]P for (32, B) LE scalar bytes (constant-time windows)."""
    return ED.scalar_mul(point, windows_from_bytes_le(scalar_bytes, 64))


def sign_core(a_clamped_bytes, r_wide_bytes, k_wide_bytes):
    """S = r + k a mod l as (32, B) bytes, for the clamped secret scalar a
    (32, B), r_wide = H(prefix || M) and k_wide = H(R || A || M) (64, B).
    The clamped a can be >= l, so it is reduced as a wide value."""
    r = FL.from_wide_bytes_le(r_wide_bytes)
    k = FL.from_wide_bytes_le(k_wide_bytes)
    a = FL.from_wide_bytes_le(a_clamped_bytes)
    return FL.to_bytes_le(FL.add(r, FL.mul(k, a)))


def r_point_core(r_wide_bytes, tables: SignTables):
    """R = [r]B compressed (32, B), r = r_wide mod l."""
    r_bytes = FL.to_bytes_le(FL.from_wide_bytes_le(r_wide_bytes))
    return ED.compress(scalar_mul_base(r_bytes, tables))


def public_key_core(a_clamped_bytes, tables: SignTables):
    """A = [a]B compressed (32, B)."""
    a_bytes = FL.to_bytes_le(FL.from_wide_bytes_le(a_clamped_bytes))
    return ED.compress(scalar_mul_base(a_bytes, tables))


def verify_core(pk_bytes, r_bytes, s_bytes, k_wide_bytes, tables: VerifyTables):
    """(B,) bool: [S]B - [k]A == R, with A and R decodable and canonical and
    S < l. k_wide is H(R || A || M) as (64, B) bytes."""
    with span("ed25519.decode"):
        A, ok_a = ED.decompress(pk_bytes)
        R, ok_r = ED.decompress(r_bytes)
        _, ok_s = FL.from_bytes_le(s_bytes)        # canonical-S rejection only
        k_bytes = FL.reduce_wide_bytes_le(k_wide_bytes)
    lhs = double_scalar_mul_base(s_bytes, ED.neg(A), k_bytes, tables)
    return ok_a & ok_r & ok_s & ED.eq(lhs, R)


# ---------------------------------------------------------------------------
# host API
# ---------------------------------------------------------------------------


def cols(bs: list[bytes], width: int, device) -> torch.Tensor:
    """B byte strings of one width -> (width, B) int32 byte columns."""
    if any(len(b) != width for b in bs):
        raise ValueError(f"every input must be {width} bytes")
    a = np.frombuffer(b"".join(bs), np.uint8).reshape(len(bs), width)
    return torch.from_numpy(np.ascontiguousarray(a.T).astype(np.int32)).to(device)


def rows(by: torch.Tensor) -> list[bytes]:
    """(width, B) byte columns -> B byte strings."""
    a = by.cpu().numpy().astype(np.uint8).T
    return [r.tobytes() for r in a]


def host_inputs(pks, msgs, sigs, device):
    """Byte columns (pk, R, S, H(R || A || M)) on ``device``: the four built
    on the host in one native pass (``ops/sha512.py`` ``verify_columns``),
    then copied."""
    with span("ed25519.host_inputs"):
        return to_device(verify_columns(pks, msgs, sigs), device)


def to_device(host, device) -> tuple:
    """The host tensors ``host`` on ``device``, their bytes counted."""
    with span("ed25519.copy") as s:
        s.set(bytes=sum(t.nbytes for t in host))
        return tuple(t.to(device) for t in host)


def verify_host(pks: list[bytes], msgs: list[bytes], sigs: list[bytes],
                device="cuda", tables: VerifyTables | None = None) -> list[bool]:
    """Verify B signatures one by one (Straus) on ``device``."""
    with span("ed25519.verify_host"):
        dev = resolve_device(device)
        tables = tables if tables is not None else VerifyTables(dev)
        ok = verify_core(*host_inputs(pks, msgs, sigs, dev), tables)
        return ok.cpu().tolist()


def expand_secret_host(sks: list[bytes]):
    """B secret keys -> (clamped scalar columns (32, B) int32 numpy, the B
    32-byte prefixes)."""
    if any(len(sk) != 32 for sk in sks):
        raise ValueError("every secret key must be 32 bytes")
    h = sha512_batch(sks)                                   # (64, B) int32
    prefixes = [r.tobytes() for r in h[32:].astype(np.uint8).T]
    return clamp_scalar_bytes(h[:32]), prefixes


def public_keys_host(sks: list[bytes], device="cuda",
                     tables: SignTables | None = None) -> list[bytes]:
    """The B public keys of B secret keys, on ``device``."""
    dev = resolve_device(device)
    tables = tables if tables is not None else SignTables(dev)
    a, _ = expand_secret_host(sks)
    return rows(public_key_core(torch.from_numpy(a).to(dev), tables))


def sign_with_expanded_host(a, prefixes, pks, msgs, device="cuda",
                            tables: SignTables | None = None) -> list[bytes]:
    """Sign with expanded secrets (the cached keypair's path): a = clamped
    scalar columns (32, B), prefixes and public keys as byte lists."""
    if not len(prefixes) == len(pks) == len(msgs) == a.shape[1]:
        raise ValueError("a, prefixes, pks and msgs differ in length")
    dev = resolve_device(device)
    tables = tables if tables is not None else SignTables(dev)
    r_wide = torch.from_numpy(sha512_batch([p + m for p, m in zip(prefixes, msgs)])).to(dev)
    R = rows(r_point_core(r_wide, tables))
    k_wide = sha512_batch([r + pk + m for r, pk, m in zip(R, pks, msgs)])
    S = rows(sign_core(torch.from_numpy(a).to(dev), r_wide, torch.from_numpy(k_wide).to(dev)))
    return [r + s for r, s in zip(R, S)]


def sign_host(sks: list[bytes], msgs: list[bytes], device="cuda",
              tables: SignTables | None = None) -> list[bytes]:
    """B signatures of B messages under B secret keys, on ``device``. A is
    computed anew from each key, as the JAX package does."""
    if len(sks) != len(msgs):
        raise ValueError("sks and msgs differ in length")
    dev = resolve_device(device)
    tables = tables if tables is not None else SignTables(dev)
    a, prefixes = expand_secret_host(sks)
    pks = public_keys_host(sks, dev, tables)
    return sign_with_expanded_host(a, prefixes, pks, msgs, dev, tables)
