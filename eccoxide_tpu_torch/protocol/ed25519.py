"""Ed25519 verification (RFC 8032 PureEdDSA), batched: the per-signature
Straus verifier. Counterpart of the verify side of
the JAX package's ``protocol/ed25519.py``.

SHA-512 runs on the host (``ops/sha512.py``); the curve and scalar
arithmetic runs batched on the device the caller names. Device functions
take byte columns, int32 ``(32, B)`` and ``(64, B)``, the JAX package's
layout; host functions take Python bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves.curve25519 import EDWARDS as ED
from ..curves.curve25519 import FL
from ..curves.edwards import ExtPoint
from ..ops.sha512 import sha512_batch
from ..params.comb import comb_tables, edwards_byte_table


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. A CUDA device that is not there
    raises; nothing moves to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain versions on the CPU")
    return dev


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


def windows_from_bytes_le(by, n_windows: int):
    """(nbytes, B) LE bytes -> (n_windows, B) 4-bit digits, MSB first."""
    bits = 4 * (n_windows - 1 - np.arange(n_windows))
    q = torch.as_tensor(bits // 8, device=by.device)
    r = torch.as_tensor(bits % 8, device=by.device)
    return (by[q] >> r[:, None]) & 0xF


def double_scalar_mul_base(s_bytes, Q: ExtPoint, k_bytes, tables: VerifyTables):
    """[s]B + [k]Q with one shared doubling chain (Straus): 32 steps of
    8 doublings, 2 additions of the 16-entry Q table and 1 mixed addition
    of the byte table [S_m]B.

    Every input is public (signature, key, digest), so lookups are gathers.
    Byte m of S enters at sub-step 63 - 2m, i.e. in the second half of step
    31 - m. Doublings skip T except the last of each run of four, and the
    Q additions skip T: nothing consumes it before the next doubling."""
    B = s_bytes.shape[1]
    wq = windows_from_bytes_le(k_bytes, 64).long()        # (64, B) MSB first
    tab_q = ED.window_table(Q, 4)                          # (16, 4, 10, B)

    def gather_q(idx):
        return ExtPoint(tab_q.gather(0, idx.view(1, 1, 1, B).expand(1, 4, 10, B))[0])

    acc = ED.identity((B,), s_bytes.device)
    for i in range(32):
        for j in range(4):
            acc = ED.double(acc, need_t=(j == 3))
        acc = ED.add(acc, gather_q(wq[2 * i]), need_t=False)
        for j in range(4):
            acc = ED.double(acc, need_t=(j == 3))
        b = tables.byte[:, :, s_bytes[31 - i].long()]       # (3, 10, B)
        acc = ED.add_mixed(acc, b[0], b[1], b[2])
        acc = ED.add(acc, gather_q(wq[2 * i + 1]), need_t=False)
    return acc


def verify_core(pk_bytes, r_bytes, s_bytes, k_wide_bytes, tables: VerifyTables):
    """(B,) bool: [S]B - [k]A == R, with A and R decodable and canonical and
    S < l. k_wide is H(R || A || M) as (64, B) bytes."""
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


def host_inputs(pks, msgs, sigs, device):
    """Byte columns (pk, R, S, H(R || A || M)) on ``device``."""
    if not len(pks) == len(msgs) == len(sigs):
        raise ValueError("pks, msgs and sigs differ in length")
    rs = [s[:32] for s in sigs]
    ss = [s[32:] for s in sigs]
    k_wide = sha512_batch([r + pk + m for r, pk, m in zip(rs, pks, msgs)])
    return (cols(pks, 32, device), cols(rs, 32, device), cols(ss, 32, device),
            torch.from_numpy(k_wide).to(device))


def verify_host(pks: list[bytes], msgs: list[bytes], sigs: list[bytes],
                device="cuda", tables: VerifyTables | None = None) -> list[bool]:
    """Verify B signatures one by one (Straus) on ``device``."""
    dev = resolve_device(device)
    tables = tables if tables is not None else VerifyTables(dev)
    ok = verify_core(*host_inputs(pks, msgs, sigs, dev), tables)
    return ok.cpu().tolist()
