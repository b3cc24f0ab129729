"""The x25519_ecdhe configuration and its cell on the CPU, at 16 lanes: the
traffic repeats by seed and holds every planted kind; the control (the
plain reference with bit 255 of u kept) reads ``correct`` false; a traced
run reads the cell's new per-layer metrics; an untraced run leaves the
program's recorder off; planted faults (a secret byte altered where it is
made, a refused lane answered as contributory) and a program without the
batched entry fail. On a card, one short traced run of the command.

    python -m pytest benchmark/tests/test_bench_x25519.py -q
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, spec
from benchmark.protocols import x25519_ecdhe as proto
from benchmark.reference import x25519 as ref

ROOT = Path(__file__).resolve().parents[2]
CELL = "x25519_ecdhe.exchange"
SEED = 2**31 + 7748
NEW = {"core_ms.ladder", "x25519.inputs_ms", "ladder.steps_ms", "ladder.inverse_ms",
       "x25519.outputs_ms"}

torch.set_num_threads(2)


def small() -> spec.Cell:
    """The cell at a test's size: 16 lanes, a pool of 16 with half of it
    planted (every kind, three low-order u's), a ring of 4, one profiled
    batch."""
    cell = spec.load_cell(CELL)
    cell.config.update(batch_per_card=16, distinct_pairs=16)
    cell.traffic.update(ring_batches=4, profile_batches=1, invalid_every=2)
    return cell


def run(traced=False, control=False, seed=SEED):
    return harness.run_cell(small(), seed, 0.05, traced, "cpu", control=control)


def test_traffic_repeats_by_seed_and_holds_every_kind():
    cell = small()
    p1, s1 = harness.make_traffic(cell, SEED)
    p2, s2 = harness.make_traffic(cell, SEED)
    p3, _ = harness.make_traffic(cell, SEED + 1)
    assert p1 == p2 and all((a == b).all() for a, b in zip(s1, s2))
    assert p1["items"] != p3["items"] and sorted(p1["kinds"]) == sorted(p3["kinds"])
    assert {k: p1["kinds"].count(k) for k in set(p1["kinds"])} == {
        "valid": 8, "low_order": 3, "top_bit_set": 3, "noncanonical_u": 2}
    assert all(len(idx) == cell.batch for idx in s1)
    want = proto.reference(p1)
    for (k, u), kind, row in zip(p1["items"], p1["kinds"], want):
        assert row[:32].tobytes() == ref.public_key(k)
        assert row[64] == (kind != "low_order")
        assert (row[32:64].tobytes() == bytes(32)) == (kind == "low_order")
        if kind == "top_bit_set":
            assert u[31] & 0x80 and ref.x25519(k, u, mask=False) != row[32:64].tobytes()
        if kind == "noncanonical_u":
            assert row[32:64].tobytes() == row[:32].tobytes()
    low = {u for (_, u), kind in zip(p1["items"], p1["kinds"]) if kind == "low_order"}
    assert len(low) == 3 and low <= {v.to_bytes(32, "little") for v in ref.LOW_ORDER_U}


def test_control_is_not_correct():
    """The control, on three seeds at the test's size: never correct."""
    for seed in (SEED, SEED + 1, SEED + 2):
        res = run(control=True, seed=seed)
        assert not res["correct"] and res["checks"]["wrong_lanes"]["value"] > 0


def test_traced_run_reads_the_new_metrics():
    cell = small()
    res = harness.run_cell(cell, SEED + 9, 0.05, True, "cpu")
    assert res["correct"] and res["failed"] == 0
    listed = {m["name"] for m in cell.per_layer}
    assert NEW <= listed
    assert {"launches_per_batch", "pow_kernel_roofline", "device_idle_share"} <= listed
    got = res["metrics"]
    assert NEW <= set(got) and all(got[m]["value"] > 0 for m in NEW)
    # the CPU trace holds no device events: the device readers read nothing
    assert not {"launches_per_batch", "pow_kernel_roofline", "device_idle_share"} & set(got)


def test_untraced_run_leaves_the_recorder_off():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.tests.test_bench_x25519 import run\n"
            "from benchmark import harness\n"
            "from eccoxide_tpu_torch import spans\n"
            "res = run()\n"
            "print(res['correct'], sorted(res['metrics']), harness.forbidden_modules())\n"
            "print(spans.enabled(), len(spans.drain()), 'benchmark.program_spans' in sys.modules)\n"
            ) % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    first, last = out.stdout.strip().splitlines()[-2:]
    assert first == "True ['ops_per_s', 'setup_s'] []"
    assert last == "False 0 False"


def _secret_byte_altered(fn):
    def altered(*args):
        shares, secrets, ok = fn(*args)
        secrets = secrets.clone()
        secrets[0, -1] ^= 1
        return shares, secrets, ok
    return altered


def _refusal_dropped(fn):
    def dropped(*args):
        shares, secrets, ok = fn(*args)
        return shares, secrets, torch.ones_like(ok)
    return dropped


def test_faults_and_a_program_without_the_entry(monkeypatch):
    """Each fault planted in the exchange core reads ``correct`` false; a
    program without ``exchange_host`` fails in the entry's prepare."""
    from eccoxide_tpu_torch.protocol import x25519

    cell = small()
    pool, slots = harness.make_traffic(cell, SEED)
    assert any(pool["kinds"][i] == "low_order" for i in slots[0])
    for fault in (_secret_byte_altered, _refusal_dropped):
        with monkeypatch.context() as m:
            m.setattr(x25519, "exchange_core", fault(x25519.exchange_core))
            res = run()
        assert not res["correct"] and res["checks"]["wrong_lanes"]["value"] > 0, fault
    with monkeypatch.context() as m:
        m.delattr(x25519, "exchange_host")
        with pytest.raises(AttributeError, match="exchange_host"):
            spec.entry(cell).prepare(torch.device("cpu"), pool, slots)


@pytest.mark.cuda
def test_traced_command_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELL,
                          "--seed", str(SEED), "--seconds", "3", "--trace", "1"],
                         capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    got = res["metrics"]
    assert NEW | {"launches_per_batch", "pow_kernel_roofline", "device_idle_share"} <= set(got)
    assert all(got[m]["value"] > 0 for m in NEW | {"launches_per_batch", "pow_kernel_roofline"})
    assert np.isfinite(got["device_idle_share"]["value"])
