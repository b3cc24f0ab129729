"""X25519 Diffie-Hellman (RFC 7748), batched. Counterpart of the JAX
package's ``protocol/x25519.py``: every device function takes (32, B)
int32 LE byte columns; the host functions take and return single values,
but for ``exchange_host``, a server's batched key exchange, which takes and
returns lists.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves import curve25519 as c255
from ..curves.montgomery import ladder
from ..spans import span
from .ed25519 import cols, resolve_device


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


def exchange_core(scalar_cols: torch.Tensor, u_cols: torch.Tensor):
    """The server's side of B X25519 key exchanges from (32, B) scalar and
    peer-u byte columns: (shares, secrets, contributory), the key shares
    [k]9 and the shared secrets [k]u as (32, B) byte columns and the (B,)
    mask of secrets that are not all zero. One ladder call over 2B lanes,
    the B u's of 9 beside the B peer u's under the same clamped scalar
    bits: the ladder's launches do not grow with its width."""
    b = scalar_cols.shape[1]
    k_bits = _bits_from_bytes(clamp(scalar_cols), 255)
    u = torch.cat([c255.FQ.const(9, (b,), u_cols.device), c255.decode_u(u_cols)], 1)
    out = c255.FQ.to_bytes_le(ladder(c255.MONT, u, torch.cat([k_bits, k_bits], 1)))
    shares, secrets = out[:, :b], out[:, b:]
    return shares, secrets, was_contributory(secrets)


def exchange_host(scalars, peer_us, device="cuda"):
    """A TLS 1.3 server's X25519 key exchange (RFC 8446 4.2.8 and 7.4.2)
    for B handshakes: ``scalars`` the server's ephemeral secrets, ``peer_us``
    the clients' key shares, each a list of 32-byte values. Returns (shares,
    secrets): shares[i] = X25519(k_i, 9), the server's key share, and
    secrets[i] = X25519(k_i, u_i), or None where it is all zero (RFC 7748
    6.1), which refuses that handshake. Lists of unequal length and values
    that are not 32 bytes raise ValueError before any device work."""
    with span("x25519.exchange_host"):
        dev = resolve_device(device)
        with span("x25519.inputs") as s:
            if len(scalars) != len(peer_us):
                raise ValueError(f"{len(scalars)} scalars but {len(peer_us)} peer u's")
            host = torch.cat([cols(scalars, 32, "cpu"), cols(peer_us, 32, "cpu")])
            b = host.shape[1]
            if b == 0:
                return [], []
            s.set(lanes=b, bytes=host.nbytes)
            both = host.to(dev)
        shares, secrets, ok = exchange_core(both[:32], both[32:])
        with span("x25519.outputs") as s:
            out = torch.cat([shares, secrets, ok[None].to(shares.dtype)])
            out = out.to(torch.uint8).cpu().numpy()              # (65, B)
            blob, ok = np.ascontiguousarray(out[:64].T).tobytes(), out[64].tolist()
            s.set(refused=b - sum(ok))
            return ([blob[i:i + 32] for i in range(0, 64 * b, 64)],
                    [blob[i + 32:i + 64] if k else None for i, k in zip(range(0, 64 * b, 64), ok)])
