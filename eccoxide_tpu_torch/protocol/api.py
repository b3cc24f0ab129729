"""Single-key API over the batched engines: the X25519, X448 and Ed25519
key types. Counterpart of the JAX package's ``protocol/api.py``; a single
key is a batch of one. For throughput, use the batched functions.

Every type carries the device its operations run on, ``"cuda"`` unless
the caller names another; it is not part of a key's value (equality and
hashing compare the bytes only).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import ed25519 as _ed25519
from . import x448 as _x448
from . import x25519 as _x25519

# ---------------------------------------------------------------------------
# X25519
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class X25519SharedSecret:
    bytes: "bytes"

    def was_contributory(self) -> bool:
        """False when the peer's point was of low order."""
        return self.bytes != b"\x00" * 32


@dataclass(frozen=True)
class X25519PublicKey:
    bytes: "bytes"


@dataclass(frozen=True)
class X25519SecretKey:
    bytes: "bytes"
    device: str = field(default="cuda", compare=False)

    def public_key(self) -> X25519PublicKey:
        return X25519PublicKey(_x25519.x25519_base_host(self.bytes, self.device))

    def exchange(self, peer: X25519PublicKey) -> X25519SharedSecret:
        return X25519SharedSecret(_x25519.x25519_host(self.bytes, peer.bytes, self.device))


# ---------------------------------------------------------------------------
# X448
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class X448SharedSecret:
    bytes: "bytes"

    def was_contributory(self) -> bool:
        return self.bytes != b"\x00" * 56


@dataclass(frozen=True)
class X448PublicKey:
    bytes: "bytes"


@dataclass(frozen=True)
class X448SecretKey:
    bytes: "bytes"
    device: str = field(default="cuda", compare=False)

    def public_key(self) -> X448PublicKey:
        return X448PublicKey(_x448.x448_base_host(self.bytes, self.device))

    def exchange(self, peer: X448PublicKey) -> X448SharedSecret:
        return X448SharedSecret(_x448.x448_host(self.bytes, peer.bytes, self.device))


# ---------------------------------------------------------------------------
# Ed25519
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Ed25519PublicKey:
    bytes: "bytes"
    device: str = field(default="cuda", compare=False)

    def verify(self, message: bytes, signature: bytes) -> bool:
        return _ed25519.verify_host([self.bytes], [message], [signature], self.device)[0]


@dataclass(frozen=True)
class Ed25519SecretKey:
    bytes: "bytes"
    device: str = field(default="cuda", compare=False)

    def public_key(self) -> Ed25519PublicKey:
        return Ed25519PublicKey(_ed25519.public_keys_host([self.bytes], self.device)[0],
                                self.device)

    def sign(self, message: bytes) -> bytes:
        return _ed25519.sign_host([self.bytes], [message], self.device)[0]


class Ed25519Keypair:
    """Keeps the expanded scalar, the prefix and the public key, so that
    signing skips the secret's expansion and the public key's derivation."""

    def __init__(self, secret: bytes, device="cuda"):
        self.secret = secret
        self.device = device
        a, prefixes = _ed25519.expand_secret_host([secret])
        self._a = a
        self._prefix = prefixes[0]
        self.public = Ed25519PublicKey(
            _ed25519.public_keys_host([secret], device)[0], device)

    def sign(self, message: bytes) -> bytes:
        return _ed25519.sign_with_expanded_host(
            self._a, [self._prefix], [self.public.bytes], [message], self.device)[0]

    def verify(self, message: bytes, signature: bytes) -> bool:
        return self.public.verify(message, signature)
