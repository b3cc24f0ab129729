"""The readers of the program's own spans (``program_spans.py`` and the
per-layer metrics that import it) and the four-card cell, on the CPU:
each reader's arithmetic on synthetic records, the window chosen by the
root span's start; traced runs of both one-card cells at 16 lanes that
read every such metric; an untraced run that never turns the recorder
on.

    python -m pytest benchmark/tests -q
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import harness, program_spans, spec
from benchmark.tests.test_bench_harness import SEED, small
from eccoxide_tpu_torch.spans import Record

ROOT = Path(__file__).resolve().parents[2]
STRAUS, RLC = "ed25519_verify.straus", "ed25519_verify.rlc_valid"
NEW = {"protocol.concat_ms", "protocol.sha512_ms", "protocol.columns_ms", "protocol.copy_ms",
       "protocol.copy_mb", "core.decode_ms", "core.msm_ms", "core.msm_sweeps_ms",
       "rlc.fallback_share"}

torch.set_num_threads(2)


def _read(name, ctx):
    return spec.metric_reader(small(RLC), name).read(ctx)


def _call(first_id, t_s, fallback):
    """The records of one verify_batch_host call starting at t_s seconds:
    each span 1 ms, the copies 1000 and 64 bytes."""
    t = int(t_s * 1e9)
    ms = 1_000_000
    root = first_id
    rows = [("ed25519.host_inputs", root), ("ed25519.concat", root + 1),
            ("sha512.join", root + 1), ("sha512.hash", root + 1), ("sha512.columns", root + 1),
            ("ed25519.columns", root + 1), ("ed25519.copy", root + 1), ("ed25519.copy", root),
            ("ed25519_batch.decode", root), ("msm.multi_prefix", root),
            ("msm.sweeps", root + 10), ("ed25519.release", root + 1)]
    if fallback:
        rows += [("ed25519_batch.fallback", root), ("ed25519.decode", root + 13)]
    recs = [Record(root, None, root, "ed25519_batch.verify_batch_host", t, t + 50 * ms, {})]
    for i, (name, parent) in enumerate(rows, start=1):
        fields = {"bytes": 1000 if parent == root + 1 else 64} if name == "ed25519.copy" else {}
        recs.append(Record(root + i, parent, root, name, t + i * ms, t + (i + 1) * ms, fields))
    return recs


def test_readers_on_synthetic_records(monkeypatch):
    """Two window batches (one with the fallback); a call before the window
    (warm-up) and one after it (the profiled stretch) are left out; no
    record at all reads None."""
    kept = (_call(100, 0.5, True) + _call(200, 1.1, True) + _call(300, 2.1, False)
            + _call(400, 3.0, True))
    monkeypatch.setattr(program_spans, "spans", None)
    monkeypatch.setattr(program_spans, "_kept", list(kept))
    ctx = {"t_start": 0.0, "lanes_per_rank": 16,
           "ranks": [{"start": [1.0, 2.0], "end": [1.9, 2.9], "spans": {}, "profile": None}]}
    want = {"protocol.concat_ms": 3.0, "protocol.sha512_ms": 1.0, "protocol.columns_ms": 2.0,
            "protocol.copy_ms": 2.0, "protocol.copy_mb": 1064 / 1e6,
            "core.decode_ms": 1.5, "core.msm_ms": 1.0, "core.msm_sweeps_ms": 1.0,
            "rlc.fallback_share": 50.0}
    assert set(want) == NEW
    for name, value in want.items():
        assert _read(name, ctx) == pytest.approx(value), name
    monkeypatch.setattr(program_spans, "_kept", [])
    assert all(_read(name, ctx) is None for name in NEW)


@pytest.mark.parametrize("name", (STRAUS, RLC))
def test_traced_runs_read_the_program_spans(name):
    cell = small(name)
    res = harness.run_cell(cell, SEED + 9, 0.05, True, "cpu")
    assert res["correct"]
    listed = {m["name"] for m in cell.per_layer} & NEW
    assert listed == (NEW if name == RLC else NEW - {"core.msm_ms", "core.msm_sweeps_ms",
                                                     "rlc.fallback_share"})
    got = res["metrics"]
    assert listed <= set(got)
    rows = 176 if name == RLC else 160
    assert got["protocol.copy_mb"]["value"] == pytest.approx(rows * 4 * cell.batch / 1e6)
    assert all(got[m]["value"] > 0 for m in listed - {"rlc.fallback_share"})
    if name == RLC:
        # forged_batch_every 2 in a ring of 4 at the test's size: slots 1 and 3
        n = res["_info"]["batches"]
        assert got["rlc.fallback_share"]["value"] == pytest.approx(100 * (n // 2) / n)


def test_untraced_run_leaves_the_recorder_off():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.tests.test_bench_harness import run\n"
            "from eccoxide_tpu_torch import spans\n"
            "assert run('ed25519_verify.straus')['correct']\n"
            "print(spans.enabled(), len(spans.drain()), 'benchmark.program_spans' in sys.modules)\n"
            ) % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "False 0 False"

