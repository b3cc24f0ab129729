"""The x25519_ecdhe configuration's pool, reference answers and control.

A pool item is a pair (server scalar, client key share) made from the
seed, the key share a public key of a seeded client scalar by the plain
reference; some are planted, of the kinds the traffic names. A lane's
answer is 65 bytes: the key share [k]9, the shared secret [k]u (zeros
where it is refused) and the contributory flag (1, or 0 where refused).
The answer of an item is the plain reference's, never the label it was
planted with.
"""

from __future__ import annotations

import numpy as np

from ..reference import x25519 as ref

ZERO = bytes(32)
WIDTH = 65


def _plant(kind: str, scalar: bytes, u: bytes, low: int):
    """A pair of the planted ``kind`` made from a valid one; ``low`` picks
    the low-order u."""
    if kind == "low_order":                     # a point of order 1, 2, 4 or 8: refused
        return scalar, ref.LOW_ORDER_U[low % len(ref.LOW_ORDER_U)].to_bytes(32, "little")
    if kind == "top_bit_set":                   # bit 255 is masked
        return scalar, u[:31] + bytes([u[31] | 0x80])
    if kind == "noncanonical_u":                # u = p + 9 is u = 9
        return scalar, (ref.P + 9).to_bytes(32, "little")
    raise ValueError(f"unknown planted kind {kind!r}")


def make_pool(cfg: dict, traffic: dict, rng: np.random.Generator, forged: int) -> dict:
    """{"items": [(scalar, u)], "kinds": [label], "regular": n, "forged": []}:
    n = cfg["distinct_pairs"] distinct pairs, one in ``invalid_every``
    planted (kinds in turn, at seeded places; the low-order u's in turn
    from a seeded one). The traffic has no forged batches."""
    if forged:
        raise ValueError("x25519_ecdhe has no forged batches")
    n = cfg["distinct_pairs"]
    items = [(rng.bytes(32), ref.public_key(rng.bytes(32))) for _ in range(n)]
    kinds = ["valid"] * n
    every = traffic.get("invalid_every", 0)
    if every:
        names = traffic["invalid_kinds"]
        low = int(rng.integers(len(ref.LOW_ORDER_U)))
        for j, i in enumerate(sorted(rng.choice(n, n // every, replace=False))):
            kinds[i] = names[j % len(names)]
            items[i] = _plant(kinds[i], *items[i], low + j // len(names))
    return {"items": items, "kinds": kinds, "regular": n, "forged": []}


def _answer(share: bytes, secret: bytes) -> bytes:
    ok = secret != ZERO
    return share + (secret if ok else ZERO) + bytes([ok])


def reference(pool: dict, mask: bool = True) -> np.ndarray:
    """Each item's answer by the plain reference, (items, 65) uint8;
    ``mask=False`` keeps bit 255 of u (the control)."""
    rows = b"".join(_answer(ref.public_key(k), ref.x25519(k, u, mask)) for k, u in pool["items"])
    return np.frombuffer(rows, np.uint8).reshape(-1, WIDTH)


def control(name: str, pool: dict, slots: list) -> list:
    """Each slot's answers by the plain reference with one guarantee broken:

    - ``no_mask``: bit 255 of u kept, so a u with it set is read as a
      different value (RFC 7748 5 masks it)."""
    if name == "no_mask":
        rows = reference(pool, mask=False)
        return [rows[idx] for idx in slots]
    raise ValueError(f"unknown control {name!r}")


def as_array(answers) -> np.ndarray:
    """One batch's answers, (shares, secrets) as the entry returns them,
    as (lanes, 65) uint8 rows; a control's rows as they are. A value of
    another width gives rows of width 0, which the comparison counts
    wrong."""
    if isinstance(answers, np.ndarray):
        return answers
    shares, secrets = answers
    rows = [bytes(sh) + (ZERO + b"\0" if se is None else bytes(se) + b"\1")
            for sh, se in zip(shares, secrets)]
    if len(shares) != len(secrets) or any(len(r) != WIDTH for r in rows):
        return np.zeros((len(shares), 0), np.uint8)
    return np.frombuffer(b"".join(rows), np.uint8).reshape(-1, WIDTH)
