"""X448 Diffie-Hellman (RFC 7748), batched. Counterpart of the JAX
package's ``protocol/x448.py``: every device function takes (56, B) int32
LE byte columns; the host functions take and return single values.
"""

from __future__ import annotations

import torch

from ..curves import curve448 as c448
from ..curves.montgomery import ladder
from .ed25519 import resolve_device
from .x25519 import _bits_from_bytes, _col, was_contributory

__all__ = ["clamp", "x448", "x448_base", "was_contributory", "x448_host",
           "x448_base_host"]


def clamp(scalar_bytes: torch.Tensor) -> torch.Tensor:
    """RFC 7748 X448 clamping: clear the low 2 bits, set bit 447."""
    s = scalar_bytes.clone()
    s[0] &= 0xFC
    s[55] |= 0x80
    return s


def x448(scalar_bytes: torch.Tensor, u_bytes: torch.Tensor) -> torch.Tensor:
    """Shared-secret u (56, B) bytes for scalars and peer u's (56, B)."""
    k_bits = _bits_from_bytes(clamp(scalar_bytes), 448)
    out = ladder(c448.MONT, c448.decode_u(u_bytes), k_bits)
    return c448.FQ.to_bytes_le(out)


def x448_base(scalar_bytes: torch.Tensor) -> torch.Tensor:
    """Public keys [k]5 (56, B) bytes for scalars (56, B)."""
    u5 = c448.FQ.const(5, scalar_bytes.shape[1:], scalar_bytes.device)
    k_bits = _bits_from_bytes(clamp(scalar_bytes), 448)
    return c448.FQ.to_bytes_le(ladder(c448.MONT, u5, k_bits))


def x448_host(scalar: bytes, u: bytes, device="cuda") -> bytes:
    dev = resolve_device(device)
    out = x448(_col(scalar, 56, dev), _col(u, 56, dev))
    return bytes(out[:, 0].cpu().tolist())


def x448_base_host(scalar: bytes, device="cuda") -> bytes:
    dev = resolve_device(device)
    return bytes(x448_base(_col(scalar, 56, dev))[:, 0].cpu().tolist())
