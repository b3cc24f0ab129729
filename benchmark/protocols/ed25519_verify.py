"""The ed25519_verify configuration's pool, reference verdicts and controls.

A pool item is a triple (public key, message, signature) made by the plain
signer from the seed; some are planted invalid, of the kinds the traffic
names. The verdict of an item is the plain verifier's (reference), never
the label it was planted with.
"""

from __future__ import annotations

import math

import numpy as np

from ..reference import ed25519 as ref

ANSWER = "bool"

_IDENTITY = (1).to_bytes(32, "little")
_NEG_ZERO = (1 | 1 << 255).to_bytes(32, "little")


def _flip_byte(b: bytes, i: int) -> bytes:
    return b[:i] + bytes([b[i] ^ 1]) + b[i + 1:]


def _plant(kind: str, pk: bytes, msg: bytes, sig: bytes):
    """A triple of the invalid ``kind`` made from a valid one."""
    if kind == "tampered_s":
        return pk, msg, _flip_byte(sig, 32)
    if kind == "tampered_msg":
        return pk, _flip_byte(msg, len(msg) // 2), sig
    if kind == "noncanonical_key":              # y = p + 1: the identity, not reduced
        return (ref.P + 1).to_bytes(32, "little"), msg, sig
    if kind == "s_plus_l":                      # the same S mod l, not canonical
        s = int.from_bytes(sig[32:], "little") + ref.L
        return pk, msg, sig[:32] + s.to_bytes(32, "little")
    if kind == "neg_zero_key":                  # A = -0, R = identity, S = 0
        return _NEG_ZERO, msg, _IDENTITY + bytes(32)
    if kind == "neg_zero_r":                    # A = identity, R = -0, S = 0
        return _IDENTITY, msg, _NEG_ZERO + bytes(32)
    raise ValueError(f"unknown invalid kind {kind!r}")


def message_lengths(cfg: dict, n: int) -> list[int]:
    """n lengths, the same set on every seed, so a seed changes the order of
    the hashing work and not its amount: ``fixed`` (every message
    ``bytes`` long) or ``log_uniform`` over [min, max], stratified."""
    spec = cfg["message_bytes"]
    if spec["distribution"] == "fixed":
        return [spec["bytes"]] * n
    if spec["distribution"] != "log_uniform":
        raise ValueError(f"unknown message length distribution {spec['distribution']!r}")
    lo, hi = math.log(spec["min"]), math.log(spec["max"])
    return [round(math.exp(lo + (i + 0.5) / n * (hi - lo))) for i in range(n)]


def make_pool(cfg: dict, traffic: dict, rng: np.random.Generator, forged: int) -> dict:
    """{"items": [(pk, msg, sig)], "kinds": [label], "regular": n, "forged":
    [indices]}: n = cfg["distinct_triples"] distinct keys and messages, one
    in ``invalid_every`` planted invalid (kinds in turn, at seeded places),
    then ``forged`` more items of ``forged_kind`` for the forged batches."""
    n = cfg["distinct_triples"]
    lengths = [message_lengths(cfg, n)[i] for i in rng.permutation(n)]
    items, kinds = [], []
    for length in lengths + [lengths[0]] * forged:
        sk, msg = rng.bytes(32), rng.bytes(length)
        pk = ref.public_key(sk)
        items.append((pk, msg, ref.sign(sk, msg, pk)))
        kinds.append("valid")
    every = traffic.get("invalid_every", 0)
    if every:
        names = traffic["invalid_kinds"]
        for j, i in enumerate(sorted(rng.choice(n, n // every, replace=False))):
            kinds[i] = names[j % len(names)]
            items[i] = _plant(kinds[i], *items[i])
    for i in range(n, n + forged):
        kinds[i] = traffic["forged_kind"]
        items[i] = _plant(kinds[i], *items[i])
    return {"items": items, "kinds": kinds, "regular": n, "forged": list(range(n, n + forged))}


def reference(pool: dict) -> np.ndarray:
    """Each item's verdict by the plain verifier."""
    return np.array([ref.verify(*it) for it in pool["items"]], dtype=bool)


def control(name: str, pool: dict, slots: list) -> list:
    """Each slot's verdicts by the plain verifier with one guarantee broken:

    - ``lax_s``: S >= l accepted (taken mod l), the canonical-S rule dropped;
    - ``no_isolation``: a batch with any invalid lane answered all False, as
      a batch check without the per-signature fallback would."""
    if name == "lax_s":
        lax = np.array([ref.verify(*it, check_s=False) for it in pool["items"]], dtype=bool)
        return [lax[idx] for idx in slots]
    if name == "no_isolation":
        ok = reference(pool)
        return [ok[idx] if ok[idx].all() else np.zeros(len(idx), bool) for idx in slots]
    raise ValueError(f"unknown control {name!r}")


def as_array(answers) -> np.ndarray:
    """One batch's answers (a list of bools) as a bool array."""
    return np.asarray(answers, dtype=bool)
