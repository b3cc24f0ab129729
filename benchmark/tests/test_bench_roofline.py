"""The roofline's yardstick: the formula counts of each kernel family, the
peak constant against the port's probe, and no kernel of the port's
recorded table (PERF.md, "Table of every TPU kernel": device ms per launch
by CUDA graph replay on an H100 80GB HBM3 at 700 W) reading over 100% at
its recorded time. CPU only."""

import json
from pathlib import Path

import pytest

from benchmark.roofline import formula
from benchmark.roofline.kernels import (ed_add, ed_double, pow448_kernel, pow_kernel,
                                        pow_sec2_kernel)

P25519 = 2**255 - 19
P448 = 2**448 - 2**224 - 1
L25519 = 2**252 + 27742317777372353535851937790883648493
W = 32768


def test_formula_counts():
    assert formula.mul_madds(255) == 64 and formula.sqr_madds(255) == 36
    assert formula.element_bytes(255) == 32 and formula.element_bytes(448) == 56
    # the add: 9 products full, 8 without T3 or with Z2 = 1
    assert ed_add.work({"mode": "full", "w": 1}) == (9 * 64, 12 * 32)
    assert ed_add.work({"mode": "need_t=False", "w": 1}) == (8 * 64, 11 * 32)
    assert ed_add.work({"mode": "mixed", "w": 1}) == (8 * 64, 11 * 32)
    # k doublings: 4k squarings, 3k products, T3 once
    assert ed_double.work({"k": 4, "need_t": False, "w": 1}) == (12 * 64 + 16 * 36, 6 * 32)
    assert ed_double.work({"k": 4, "need_t": True, "w": 1}) == (13 * 64 + 16 * 36, 7 * 32)
    # (p-5)/8 = 2^252 - 3: 63 digits, none zero
    assert formula.pow_counts((P25519 - 5) // 8) == (14 + 62, 4 * 62)
    assert formula.pow_counts(0x10F) == (14 + 1, 8)                   # a zero digit takes no product


def test_peak_is_not_below_the_probe():
    peak = json.loads((Path(formula.__file__).parent / "peak.json").read_text())
    per_clock_per_sm = peak["madds_per_s"] / (132 * 1980e6)
    assert per_clock_per_sm >= 30.4                                    # the port's probe read 30.2-30.4
    assert peak["bytes_per_s"] == 3.35e12


def _sec2():
    from eccoxide_tpu_torch.params.sec2_params import CURVES

    return CURVES


def _rows():
    """(kernel family, launch record, recorded ms) of the table."""
    c = _sec2()
    rows = [(ed_add, {"mode": "full", "w": 786432}, 0.14171711921691896),
            (ed_add, {"mode": "full", "w": W}, 0.007684000134468079),
            (ed_add, {"mode": "need_t=False", "w": W}, 0.007281919717788696),
            (ed_add, {"mode": "mixed", "w": W}, 0.007248640060424805),
            (ed_double, {"k": 4, "need_t": True, "w": W}, 0.018454079627990724),
            (pow_kernel, {"bits": 255, "e": (P25519 - 5) // 8, "w": W}, 0.12695072174072267),
            (pow448_kernel, {"bits": 448, "e": P448 - 2, "w": W}, 0.6265484619140625),
            (pow_sec2_kernel, {"bits": 253, "e": L25519 - 2, "w": W}, 0.3648)]
    p = {name: c[name]["p"] for name in c}
    n = {name: c[name]["order"] for name in c}
    for name, ms in (("p256r1", (0.3458047866821289, 0.3464, 0.3122)),
                     ("p256k1", (0.3150, 0.3151, 0.3134)),
                     ("p521r1", (1.5972, 1.5756, 1.3153))):
        for e, t in zip((p[name] - 2, (p[name] - 1) // 2, (p[name] + 1) // 4), ms):
            rows.append((pow_sec2_kernel, {"bits": p[name].bit_length(), "e": e, "w": W}, t))
    for name, t in (("p384r1", 0.8322), ("p224r1", 0.2546), ("p224k1", 0.2258),
                    ("p192r1", 0.1805), ("p192k1", 0.1701), ("p160r1", 0.1091),
                    ("p160k1", 0.1008), ("p128r1", 0.0713), ("p112r1", 0.0528)):
        rows.append((pow_sec2_kernel, {"bits": p[name].bit_length(), "e": p[name] - 2, "w": W}, t))
    for name, t in (("p521r1", 2.7187), ("p384r1", 1.2271), ("p256r1", 0.4191),
                    ("p256k1", 0.4092), ("p224r1", 0.2897), ("p224k1", 0.2764),
                    ("p192r1", 0.2108), ("p192k1", 0.2097), ("p160r1", 0.1156),
                    ("p160k1", 0.1152), ("p160r2", 0.1146), ("p128r1", 0.0715),
                    ("p128r2", 0.0752), ("p112r1", 0.0646), ("p112r2", 0.0626)):
        rows.append((pow_sec2_kernel, {"bits": n[name].bit_length(), "e": n[name] - 2, "w": W}, t))
    return rows


def test_no_recorded_kernel_reads_over_100_percent():
    shares = []
    for fam, rec, ms in _rows():
        share = 100 * formula.bound_s(*fam.work(rec)) / (ms / 1e3)
        shares.append(share)
        assert 0 < share <= 100, (fam.__name__, rec, share)
    assert len(shares) == 41
    assert max(shares) == pytest.approx(63.5, abs=1)                  # ed_add at 786432 lanes
