"""The port's measurement entry points (eccoxide_tpu_torch/bench.py and
bench_suite.py, the counterparts of the JAX bench.py and bench_suite.py at
the repository's root) on the CPU's plain versions: the verify rungs'
inputs against the JAX bench's, made with the JAX package's integer
oracle; each run_* and each suite row at B = 8 on short chains, with the
JAX records' names and keys and their correctness checks passing; the
ladder from the command line without a card. Times taken here say nothing
of cards. (Three tests: see test_torch_sign.py for why the port's files
stay small.)"""

import inspect
import json
import os
import pathlib
import random
import subprocess
import sys

import numpy as np
import torch

from chip_smoke import jax_suite_metrics
from eccoxide_tpu.oracle import ed25519 as jax_oracle
from eccoxide_tpu.protocol.ed25519 import sha512_batch_host
from eccoxide_tpu_torch import bench, bench_suite

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
# the keys each record adds to the JAX record's (vs_baseline left out)
PORT_KEYS = {"device", "launches", "launch_shapes"}


def test_verify_inputs_are_the_jax_benchs():
    """bench.py:75-103 (run_verify; run_rlc repeats it): 128 distinct
    triples from random.Random(1234) signed by the JAX package's oracle,
    kw by its sha512_batch_host, tiled to B."""
    rng = random.Random(1234)
    sks = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(128)]
    msgs = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(128)]
    pks = [jax_oracle.public_key(sk) for sk in sks]
    sigs = [jax_oracle.sign(sk, m) for sk, m in zip(sks, msgs)]
    rs, ss = [s[:32] for s in sigs], [s[32:] for s in sigs]
    kw = sha512_batch_host([r + pk + m for r, pk, m in zip(rs, pks, msgs)]).astype(np.int32)

    def cols(bs):
        return np.stack([np.frombuffer(b, np.uint8) for b in bs], axis=1).astype(np.int32)

    B = 300
    got = bench._signed_batch(B, CPU)
    for g, w in zip(got, (cols(pks), cols(rs), cols(ss), kw), strict=True):
        assert g.dtype == torch.int32 and g.device == CPU
        assert np.array_equal(g.numpy(), np.tile(w, (1, 3))[:, :B])


def test_records_have_the_jax_names_and_keys():
    """Every run_* and every suite row at B = 8 on the CPU, the chains and
    queues as short as they go: the JAX record's keys (bench.py:130-136,
    :205-210, :229-231, :273-276; bench_suite.py:68-69, :162-164, :181-183,
    :225-228), no error, a positive value, and no kernel launched (the
    plain versions run on the CPU)."""
    jax_keys = {"metric", "value", "unit", "batch", "sec_per_batch"}
    cases = [(bench.run_verify, "ed25519_verify_per_sec_chip", {"chain_totals_s"}, (4, 36)),
             (bench.run_rlc, "ed25519_verify_per_sec_chip", {"chain_totals_s", "method"}, (4, 36)),
             (bench.run_x25519, "x25519_per_sec_chip", set(), (4, 36)),
             (bench.run_fieldmul, "field_mul_25519_per_sec_chip", {"timer"}, (64, 1088))]
    assert set(bench.CHILD_MODES.values()) == {c[0] for c in cases}
    recs = {}
    for fn, metric, more, default in cases:
        assert inspect.signature(fn).parameters["chain"].default == default
        rec = recs[fn] = fn(8, device="cpu", chain=(0, 1) if default == (4, 36) else (1, 2))
        assert set(rec) == jax_keys | more | PORT_KEYS, (fn.__name__, rec)
        assert rec["metric"] == metric and rec["batch"] == 8 and rec["value"] > 0
        assert rec["device"] == {"name": "cpu", "power_limit": None}
        assert rec["launches"] == {} and rec["launch_shapes"] == []
    assert recs[bench.run_rlc]["method"] == "rlc_batch"
    assert recs[bench.run_fieldmul]["timer"] == "eager"

    results = bench_suite.suite(8, device="cpu", reps=(0, 1), msm_n=(8, 16), msm_reps=(0, 1))
    assert [r["metric"] for r in results] == jax_suite_metrics(ROOT / "bench_suite.py")
    for r in results:
        assert set(r) == {"metric", "value", "unit", "batch", "sec"} | PORT_KEYS - {"device"}, r
        assert r["value"] > 0 and r["launches"] == {}
    batches = {r["metric"]: r["batch"] for r in results}
    assert batches["ed25519_verify"] == 8 and batches["msm_p256k1_2e16"] == 16
    assert {r["unit"] for r in results} == {"ops/s", "msgs/s", "pointmuls/s"}


def test_ladder_without_a_card_reports_value_0():
    """``python -m eccoxide_tpu_torch.bench`` with no card visible: every
    rung it tries fails in its child on the device check, before any work,
    and the one line on stdout is the JAX ladder's record of value 0 (a
    budget of 30 s: the fieldmul rung only), rc 0."""
    env = {**os.environ, "ECCOXIDE_BENCH_BUDGET_S": "30", "CUDA_VISIBLE_DEVICES": ""}
    cp = subprocess.run([sys.executable, "-m", "eccoxide_tpu_torch.bench"], cwd=ROOT, env=env,
                        capture_output=True, text=True, timeout=120)
    assert cp.returncode == 0, cp.stderr
    lines = cp.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert (rec["metric"], rec["value"], rec["device"]) == ("ed25519_verify_per_sec_chip", 0, None)
    assert rec["error"].startswith("all fallback measurements failed: fieldmul B=8192: ")
    assert "no CUDA device is available" in rec["error"] and "vs_baseline" not in rec
    tried = [ln for ln in cp.stderr.splitlines() if ln.startswith("# ")]
    assert tried == ["# fieldmul B=8192: RuntimeError: no CUDA device is available; pass "
                     "device='cpu' to run the plain versions on the CPU"]
