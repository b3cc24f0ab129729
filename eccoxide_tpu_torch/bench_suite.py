"""The full benchmark matrix on one card, the counterpart of the JAX
package's ``bench_suite.py`` at the repository's root: the same metric
names row by row (field ops on six fields, SEC2 point ops, X25519,
edwards25519 ops, Ed25519 verify, X448, host SHA-512, square roots, the
p256k1 MSM), as batched throughput (ops/s at a batch size).

    python -m eccoxide_tpu_torch.bench_suite [batch] [--out SUITE.json]

Prints one JSON line per metric; with ``--out`` also writes
``{"meta": ..., "results": [...]}``. It runs on the card only (``suite``
takes ``device`` for the tests, which run it on the CPU's plain
versions). Each record carries the kernel launches of its row
(``launches``, ``launch_shapes``: ``ops.group.launch_report``, the counts
set to 0 when the row starts).
"""

from __future__ import annotations

import json
import platform
import sys
import time

import numpy as np
import torch

from .bench import _card, _fetch
from .device import resolve_device
from .ops import group


def _bench(fn, args, reps_short=3, reps_long=13):
    """Per-call time: queue N in-order calls, end with one real fetch, and
    difference two queue lengths so the issue of the first call and the
    single sync cancel (the card runs a stream's work in order)."""
    out = fn(*args)
    _fetch(out)
    totals = {}
    for reps in (reps_short, reps_long):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        _fetch(out)
        totals[reps] = time.perf_counter() - t0
    return max((totals[reps_long] - totals[reps_short]) / (reps_long - reps_short), 1e-9)


def _elements(f, B: int, rng, dev) -> torch.Tensor:
    """B random elements of field f (ints mod p from rng) as f's limbs."""
    nb = (f.p.bit_length() + 7) // 8 + 8
    return f.encode_ints([int.from_bytes(rng.bytes(nb), "little") % f.p for _ in range(B)], dev)


def _bytes(rng, rows: int, B: int, dev, high: int = 256) -> torch.Tensor:
    return torch.from_numpy(rng.integers(0, high, size=(rows, B), dtype=np.int32)).to(dev)


def suite(B: int = 8192, device="cuda", reps=(3, 13), msm_n=(1 << 14, 1 << 16),
          msm_reps=(2, 6)) -> list[dict]:
    """Every row of the matrix at batch B on device, in the JAX suite's
    order, each printed as it lands; returns the records. ``reps`` are the
    two queue lengths of ``_bench``; the MSM rows (named after 2^14 and
    2^16 points) take ``msm_n`` points and ``msm_reps``."""
    from . import oracle
    from .curves import curve25519 as c255
    from .curves import sec2
    from .entry import example_verify_batch
    from .field448 import FQ448
    from .ops.sha512 import sha512_batch
    from .parallel.msm import msm_local
    from .params.comb import get_weierstrass_comb
    from .protocol import ed25519 as ped
    from .protocol import x448 as px4
    from .protocol import x25519 as px

    dev = resolve_device(device)
    rng = np.random.default_rng(1)
    results = []

    def record(rec):
        rec = {**rec, **group.launch_report()}
        results.append(rec)
        print(json.dumps(rec), flush=True)

    def emit(metric, fn, args):
        group.reset_launches()
        secs = _bench(fn, args, *reps)
        record({"metric": metric, "value": round(B / secs, 1), "unit": "ops/s",
                "batch": B, "sec": round(secs, 5)})

    # ---- field matrix ----
    field_targets = {
        "p256r1": sec2.get_curve("p256r1").field,
        "p256k1": sec2.get_curve("p256k1").field,
        "p384r1": sec2.get_curve("p384r1").field,
        "p521r1": sec2.get_curve("p521r1").field,
        "curve25519": c255.FQ,
        "curve448": FQ448,
    }
    for name, f in field_targets.items():
        xs, ys = _elements(f, B, rng, dev), _elements(f, B, rng, dev)
        emit(f"field_mul_{name}", f.mul, (xs, ys))
        emit(f"field_add_{name}", f.add, (xs, ys))
        emit(f"field_inverse_{name}", f.inverse, (xs,))
        emit(f"field_square_{name}", f.square, (xs,))

    # ---- point ops ----
    for cname in ["p256r1", "p256k1"]:
        spec = sec2.get_curve(cname)
        G = spec.generator((B,), dev)
        emit(f"point_add_{cname}", lambda P, s=spec: s.add(P, P), (G,))
        emit(f"point_double_{cname}", spec.double, (G,))
        nw = -(-spec.scalar.bits // 4)
        w = _bytes(rng, nw, B, dev, high=16)
        emit(f"scalar_mul_{cname}",
             lambda w_, s=spec: s.scalar_mul(s.generator((B,), dev), w_), (w,))
        sb = _bytes(rng, spec.scalar.n_bytes, B, dev)
        wtabs = get_weierstrass_comb(spec).tables(dev)
        emit(f"mul_base_{cname}", spec.mul_base, (sb, wtabs))

    # ---- curve25519 / protocols ----
    sbytes, ubytes = _bytes(rng, 32, B, dev), _bytes(rng, 32, B, dev)
    emit("x25519", px.x25519, (sbytes, ubytes))
    ED = c255.EDWARDS
    G = ED.generator((B,), dev)
    emit("ed_point_add", lambda P: ED.add(P, P), (G,))
    emit("ed_point_double", ED.double, (G,))
    emit("ed_mul_base_comb", ped.scalar_mul_base, (sbytes, ped.SignTables(dev)))

    # the JAX entry's example batch, signed on dev (the oracle's bytes); the
    # row's launches count the signing
    nv = min(B, 4096)
    group.reset_launches()
    vargs = [torch.from_numpy(a).to(dev) for a in example_verify_batch(nv, dev)]
    vargs.append(ped.VerifyTables(dev))
    out = ped.verify_core(*vargs)
    if not bool(out.all()):
        raise RuntimeError("ed25519_verify rejected a valid signature")
    t0 = time.perf_counter()
    for _ in range(3):
        out = ped.verify_core(*vargs)
    _fetch(out)
    secs = (time.perf_counter() - t0) / 3
    record({"metric": "ed25519_verify", "value": round(nv / secs, 1), "unit": "ops/s",
            "batch": nv, "sec": round(secs, 5)})

    # ---- x448 ----
    s4, u4 = _bytes(rng, 56, B, dev), _bytes(rng, 56, B, dev)
    emit("x448", px4.x448, (s4, u4))

    # ---- host batched SHA-512 (msgs/s; the Ed25519 host half) ----
    hmsgs = [bytes([i & 0xFF]) * 96 for i in range(B)]
    group.reset_launches()
    t0 = time.perf_counter()
    for _ in range(3):
        sha512_batch(hmsgs)
    secs = (time.perf_counter() - t0) / 3
    record({"metric": "sha512_host", "value": round(B / secs, 1), "unit": "msgs/s",
            "batch": B, "sec": round(secs, 5)})

    # ---- sqrt: Tonelli-Shanks (p224r1) against the (p+1)/4 chain (p256r1) ----
    for cname in ["p256r1", "p224r1"]:
        f = sec2.get_curve(cname).field
        sq = f.square(_elements(f, B, rng, dev))
        emit(f"field_sqrt_{cname}", f.sqrt, (sq,))

    # ---- Pippenger MSM (p256k1): 1024 distinct points [i]G, tiled ----
    spec, o = sec2.get_curve("p256k1"), oracle.sec2_curve("p256k1")
    fld = spec.field
    for logn, N in zip((14, 16), msm_n):
        n_distinct = min(N, 1024)
        acc, apts = None, []
        for _ in range(n_distinct):
            acc = o.add(acc, (o.gx, o.gy))
            apts.append(acc)
        reps_tile = -(-N // n_distinct)
        X = fld.encode_ints([p_[0] for p_ in apts], dev).repeat(1, reps_tile)[:, :N]
        Y = fld.encode_ints([p_[1] for p_ in apts], dev).repeat(1, reps_tile)[:, :N]
        pts = spec.from_affine(X.contiguous(), Y.contiguous())
        sb = _bytes(rng, 32, N, dev)
        group.reset_launches()
        secs = _bench(lambda p, s: msm_local(spec, p, s), (pts, sb), *msm_reps)
        record({"metric": f"msm_p256k1_2e{logn}", "value": round(N / secs, 1),
                "unit": "pointmuls/s", "batch": N, "sec": round(secs, 5)})
    return results


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    B = int(argv[0]) if argv and not argv[0].startswith("--") else 8192
    results = suite(B)
    if "--out" in argv:
        out_path = argv[argv.index("--out") + 1]
        meta = {"suite": "eccoxide_tpu_torch bench_suite", "batch_default": B,
                "backend": "cuda", "device": _card(torch.device("cuda")),
                "host": platform.platform()}
        with open(out_path, "w") as fh:
            json.dump({"meta": meta, "results": results}, fh, indent=1)
        print(f"# wrote {out_path} ({len(results)} records)", file=sys.stderr)


if __name__ == "__main__":
    main()
