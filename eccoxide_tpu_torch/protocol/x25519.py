"""X25519 Diffie-Hellman (RFC 7748), batched. Counterpart of the JAX
package's ``protocol/x25519.py``: every device function takes (32, B)
int32 LE byte columns; the host functions take and return single values.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves import curve25519 as c255
from ..curves.montgomery import ladder
from .ed25519 import resolve_device


def clamp(scalar_bytes: torch.Tensor) -> torch.Tensor:
    """RFC 7748 clamping: clear the low 3 bits and the top bit, set bit 254."""
    s = scalar_bytes.clone()
    s[0] &= 0xF8
    s[31] = (s[31] & 0x7F) | 0x40
    return s


def _bits_from_bytes(by: torch.Tensor, n_bits: int) -> torch.Tensor:
    """(nbytes, *batch) -> (n_bits, *batch) 0/1, bit i the coefficient of
    2^i."""
    i = torch.arange(n_bits, device=by.device)
    shift = (i % 8).view((n_bits,) + (1,) * (by.dim() - 1))
    return (by[i // 8] >> shift) & 1


def x25519(scalar_bytes: torch.Tensor, u_bytes: torch.Tensor) -> torch.Tensor:
    """Shared-secret u (32, B) bytes for scalars and peer u's (32, B)."""
    k_bits = _bits_from_bytes(clamp(scalar_bytes), 255)
    out = ladder(c255.MONT, c255.decode_u(u_bytes), k_bits)
    return c255.FQ.to_bytes_le(out)


def x25519_base(scalar_bytes: torch.Tensor) -> torch.Tensor:
    """Public keys [k]9 (32, B) bytes for scalars (32, B)."""
    u9 = c255.FQ.const(9, scalar_bytes.shape[1:], scalar_bytes.device)
    k_bits = _bits_from_bytes(clamp(scalar_bytes), 255)
    return c255.FQ.to_bytes_le(ladder(c255.MONT, u9, k_bits))


def was_contributory(shared_bytes: torch.Tensor) -> torch.Tensor:
    """False where the shared secret is all zero (a low-order peer u)."""
    return (shared_bytes != 0).any(0)


def _col(b: bytes, n: int, device) -> torch.Tensor:
    if len(b) != n:
        raise ValueError(f"expected {n} bytes, got {len(b)}")
    return torch.from_numpy(np.frombuffer(b, np.uint8).astype(np.int32)[:, None]).to(device)


def x25519_host(scalar: bytes, u: bytes, device="cuda") -> bytes:
    dev = resolve_device(device)
    out = x25519(_col(scalar, 32, dev), _col(u, 32, dev))
    return bytes(out[:, 0].cpu().tolist())


def x25519_base_host(scalar: bytes, device="cuda") -> bytes:
    dev = resolve_device(device)
    return bytes(x25519_base(_col(scalar, 32, dev))[:, 0].cpu().tolist())
