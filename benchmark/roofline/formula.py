"""The work an elliptic-curve kernel's operation needs, priced by the
operation and not by the program's limb format.

A field multiplication of a b-bit prime costs ceil(b/32)^2 32x32->64
multiply-adds (schoolbook on 32-bit words), a squaring k(k+1)/2 with
k = ceil(b/32) (each cross product once). Reductions, carries and
additions are not counted. A field element is read or written once, at
its canonical encoding size: ceil(b/8) bytes (32 B for 2^255-19)."""

from __future__ import annotations

import json
from pathlib import Path

PEAK = json.loads((Path(__file__).resolve().parent / "peak.json").read_text())


def words(bits: int) -> int:
    return -(-bits // 32)


def mul_madds(bits: int) -> int:
    return words(bits) ** 2


def sqr_madds(bits: int) -> int:
    k = words(bits)
    return k * (k + 1) // 2


def element_bytes(bits: int) -> int:
    return -(-bits // 8)


def madds(bits: int, muls: int, sqrs: int) -> int:
    return muls * mul_madds(bits) + sqrs * sqr_madds(bits)


def bound_s(madds_: float, bytes_: float) -> float:
    """The least time the card could take: the larger of the operations
    over the peak multiply-add rate and the bytes over the peak bandwidth."""
    return max(madds_ / PEAK["madds_per_s"], bytes_ / PEAK["bytes_per_s"])


def exp_digits(e: int) -> list[int]:
    """The 4-bit digits of e > 0, most significant first."""
    n = max(1, -(-e.bit_length() // 4))
    return [(e >> (4 * (n - 1 - i))) & 15 for i in range(n)]


def pow_counts(e: int) -> tuple[int, int]:
    """(multiplications, squarings) of x^e by the 4-bit fixed-window chain:
    a table x^2..x^15 (14 products), then per digit after the first 4
    squarings and, unless the digit is 0, one product."""
    d = exp_digits(e)
    return 14 + sum(1 for x in d[1:] if x), 4 * (len(d) - 1)
