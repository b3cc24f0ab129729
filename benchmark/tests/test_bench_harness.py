"""The harness on the CPU, at sizes a test run holds: the traffic, the
metrics' arithmetic on synthetic batches and a synthetic trace, the result
line's keys, the JAX check, a cell made of new files alone, the command
without a card, and the comparison shown to fail: the control (the plain
reference with one guarantee broken) and the faults a cell can have (an
answer altered where it is made, half of a batch left out, the exchange
between ranks left out), each seen as ``correct`` false.

    python -m pytest benchmark/tests -q
"""

import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, readers, spec, trace
from benchmark.roofline.kernels import ed_add

ROOT = Path(__file__).resolve().parents[2]
# The four-card cell is not in BENCHMARK.json; its traffic, entry and skew
# reader are, and ``load`` builds it from them.
SHARDED = "ed25519_verify.straus_4chip"
ONE_CARD = ("ed25519_verify.straus", "ed25519_verify.rlc_valid")
VERIFY_CELLS = ONE_CARD + (SHARDED,)
SEED = 2**31 + 77

torch.set_num_threads(2)


def load(name: str, root: Path = ROOT) -> spec.Cell:
    if name != SHARDED:
        return spec.load_cell(name, root)
    cell = spec.load_cell("ed25519_verify.straus", root)
    cell.name, cell.chips = SHARDED, 4
    cell.traffic = json.loads((cell.root / "traffic" / "straus_4chip.json").read_text())
    return cell


def small(name: str, root: Path = ROOT) -> spec.Cell:
    """The cell at a test's size: 16 lanes, a pool of 8 (half of it
    planted invalid in the Straus cells, every invalid kind's first four
    among them), a ring of 4, one profiled batch."""
    cell = load(name, root)
    cell.config.update(batch_per_card=16, distinct_triples=8)
    t = cell.traffic
    t.update(ring_batches=4, profile_batches=1)
    if t.get("invalid_every"):
        t["invalid_every"] = 2
    if t.get("forged_batch_every"):
        t["forged_batch_every"] = 2
    return cell


def run(name, traced=False, control=False, seed=SEED, **kw):
    return harness.run_cell(small(name), seed, 0.05, traced, "cpu", control=control, **kw)


# ---------------------------------------------------------------------------
# traffic and arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", VERIFY_CELLS)
def test_traffic_repeats_by_seed(name):
    cell = small(name)
    p1, s1 = harness.make_traffic(cell, SEED)
    p2, s2 = harness.make_traffic(cell, SEED)
    p3, s3 = harness.make_traffic(cell, SEED + 1)
    assert p1 == p2 and all((a == b).all() for a, b in zip(s1, s2))
    assert p1["items"] != p3["items"]
    assert sorted(p1["kinds"]) == sorted(p3["kinds"])              # the same mix
    for idx in s1:
        assert len(idx) == cell.batch


def test_message_lengths_are_one_set():
    cell = spec.load_cell("ed25519_verify.straus")
    from benchmark.protocols import ed25519_verify as proto

    assert proto.message_lengths(cell.config, 512) == [1167] * 512    # a full packet's message
    stratified = proto.message_lengths(
        {"message_bytes": {"distribution": "log_uniform", "min": 150, "max": 1167}}, 512)
    assert min(stratified) >= 150 and max(stratified) <= 1167
    assert 450 < np.mean(stratified) < 550
    p1 = proto.make_pool(cell.config, cell.traffic, np.random.default_rng(1), 0)
    assert {len(m) for _, m, _ in p1["items"]} == {1167}


def _ctx(ranks, t_start=0.0, lanes=100):
    return {"t_start": t_start, "lanes_per_rank": lanes, "ranks": ranks}


def test_end_to_end_arithmetic():
    """ops_per_s is all the window's lanes over first start to last end,
    batch_p90_ms is over every batch (across ranks: first start to last
    end), setup_s runs to the first batch's start."""
    starts = [1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0, 4.5, 5.0, 5.5]
    ends = [s + (0.4 if i < 9 else 0.5) for i, s in enumerate(starts)]
    r = {"start": starts, "end": ends, "spans": {}, "profile": None}
    ctx = _ctx([r], t_start=0.25)
    read = {m: spec.metric_reader(small("ed25519_verify.straus"), m).read
            for m in ("ops_per_s", "batch_p90_ms", "setup_s", "sharding.rank_skew_ms")}
    assert read["ops_per_s"](ctx) == pytest.approx(1000 / 5.0)
    assert read["batch_p90_ms"](ctx) == pytest.approx(1e3 * np.percentile([0.4] * 9 + [0.5], 90))
    assert read["setup_s"](ctx) == pytest.approx(0.75)
    assert read["sharding.rank_skew_ms"](ctx) is None
    r2 = {"start": [s + 0.1 for s in starts], "end": [e + 0.2 for e in ends],
          "spans": {}, "profile": None}
    ctx2 = _ctx([r, r2])
    assert read["ops_per_s"](ctx2) == pytest.approx(2000 / (6.2 - 1.0))
    assert readers.batch_seconds(ctx2)[0] == pytest.approx(0.6)
    assert read["sharding.rank_skew_ms"](ctx2) == pytest.approx(100.0)


class _Ev:
    """A stand-in for a kineto event."""

    def __init__(self, name, start, dur, device=False, thread=1, annotation=False):
        self._v = (name, start, dur, device, thread, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[3] else "DeviceType.CPU"

    def start_thread_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def test_trace_arithmetic():
    """A synthetic trace of two batches: busy is the union of the device
    events inside the batch spans, the idle share its complement, each gap
    named by the host event open at it, kernels counted apart from copies,
    and the roofline share the launches' bound over the kernels' time."""
    ms = 1_000_000
    w = 32768
    add_ns = int(1e9 * ed_add.work({"mode": "full", "w": w})[1] / 3.35e12 * 2)   # half the peak
    evs = [
        _Ev("bench.batch", 0, 10 * ms), _Ev("bench.batch", 10 * ms, 10 * ms),
        _Ev("bench.batch", 0, 10 * ms, device=True, annotation=True),
        _Ev("bench.core.straus", 1 * ms, 8 * ms),
        _Ev("aten::mul", 2 * ms, 3 * ms),
        _Ev("ed_add_kernel(int const*, int const*, int*, int, int, long)", 5 * ms, add_ns, device=True),
        _Ev("ed_add_kernel(int const*, int const*, int*, int, int, long)", 12 * ms, add_ns, device=True),
        _Ev("Memcpy HtoD (Pageable -> Device)", 15 * ms, 1 * ms, device=True),
        _Ev("aten::copy_", 14 * ms, 3 * ms, thread=2),
    ]
    s = trace.summarize(evs, 2)
    busy = 2 * add_ns + ms
    assert s["wall_s"] == pytest.approx(0.02) and s["busy_s"] == pytest.approx(busy / 1e9)
    assert sum(n for _, n in s["kernels"].values()) == 2 and len(s["ops"]) == 2
    assert sum(s["gaps"].values()) == pytest.approx((20 * ms - busy) / 1e9)
    assert "bench.core.straus > aten::mul" in s["gaps"]
    s["launches"] = {"ed_add": [{"mode": "full", "w": w}] * 2}
    ctx = _ctx([{"start": [0], "end": [1], "spans": {}, "profile": s}])
    cell = small("ed25519_verify.straus")
    assert spec.metric_reader(cell, "ed_add_roofline").read(ctx) == pytest.approx(50.0, rel=1e-3)
    assert spec.metric_reader(cell, "ed_double_roofline").read(ctx) is None
    assert spec.metric_reader(cell, "launches_per_batch").read(ctx) == 1.0
    idle = spec.metric_reader(cell, "device_idle_share").read(ctx)
    assert idle == pytest.approx(100 * (1 - busy / (20 * ms)))
    s["launches"]["ed_add"].append({"mode": "full", "w": w})       # 3 launches, 2 kernels
    assert spec.metric_reader(cell, "ed_add_roofline").read(ctx) is None


# ---------------------------------------------------------------------------
# the result line and the process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ONE_CARD)
def test_result_keys(name):
    cell = small(name)
    plain = run(name)
    assert plain["correct"] and plain["failed"] == 0 and plain["attempted"] >= cell.batch
    assert list(plain)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(plain)[-2:] == ["checks", "_info"]
    assert set(plain["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert set(plain["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    traced = run(name, traced=True, seed=SEED + 5)
    assert traced["correct"]
    assert "breakdown" in traced and set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(traced["device"])
    spans = [m["name"] for m in cell.per_layer if m["name"].startswith(("core_ms", "protocol"))]
    assert spans and set(spans) <= set(traced["metrics"])


def test_kernel_families_follow_the_readers():
    """Only the families that a cell's per-layer readers name have their
    launches recorded; a family file that no reader names changes nothing."""
    fams = spec.kernel_families(load("ed25519_verify.straus"))
    assert set(fams) == {"ed_add", "ed_double", "pow_kernel"}
    assert fams["ed_add"] is ed_add


def test_forbidden_modules_by_whole_name():
    mods = ["eccoxide_tpu_torch", "eccoxide_tpu_torch.ops", "jaxtyping", "flaxen", "jax",
            "jax.numpy", "jaxlib.xla", "flax", "eccoxide_tpu", "eccoxide_tpu.ops"]
    assert harness.forbidden_modules(mods) == ["eccoxide_tpu", "eccoxide_tpu.ops", "flax",
                                               "jax", "jax.numpy", "jaxlib.xla"]


def test_a_run_loads_no_jax():
    """A run of every one-card cell in a fresh process leaves neither JAX
    nor the JAX package in sys.modules."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.tests.test_bench_harness import run\n"
            "from benchmark import harness\n"
            "for n in ('ed25519_verify.straus', 'ed25519_verify.rlc_valid'):\n"
            "    assert run(n)['correct']\n"
            "print(harness.forbidden_modules(), 'jax' in sys.modules)\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[] False"


def test_command_without_a_card_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ed25519_verify.straus",
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_new_cell_from_new_files_only(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    per-layer metric and a cell by new files and new BENCHMARK.json entries
    alone, and a run finds and reports them."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    (tmp_path / "eccoxide_tpu_torch").symlink_to(ROOT / "eccoxide_tpu_torch")
    (tmp_path / "native").symlink_to(ROOT / "native")
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs/ed25519_verify.json").read_text())
    cfg.update(name="ed25519_verify_short", message_bytes={"distribution": "log_uniform",
                                                            "min": 40, "max": 80})
    (b / "configs/ed25519_verify_short.json").write_text(json.dumps(cfg))
    traffic = json.loads((b / "traffic/straus.json").read_text())
    traffic.update(ring_batches=2, invalid_every=4)
    (b / "traffic/straus_few.json").write_text(json.dumps(traffic))
    (b / "metrics/batches_in_window.py").write_text(
        "def read(ctx):\n    return float(len(ctx['ranks'][0]['start']))\n")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({**bench["configs"][0], "name": "ed25519_verify_short",
                             "file": "benchmark/configs/ed25519_verify_short.json"})
    bench["workloads"].append({"name": "ed25519_verify_short.straus_few", "chips": 1,
                               "config": "ed25519_verify_short", "traffic": "straus_few",
                               "why": "short messages"})
    bench["per_layer"].append({"name": "batches_in_window", "unit": "batches", "better": "higher",
                               "source": "host_clock", "layer": "host entry", "moves": "ops_per_s",
                               "workloads": ["ed25519_verify_short.straus_few"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "from benchmark import spec, harness\n"
            "cell = spec.load_cell('ed25519_verify_short.straus_few')\n"
            "assert spec.__file__.startswith(%r)\n"
            "cell.config.update(batch_per_card=8, distinct_triples=8); cell.traffic['profile_batches'] = 1\n"
            "res = harness.run_cell(cell, 5, 0.05, True, 'cpu')\n"
            "print(json.dumps({'correct': res['correct'], 'metrics': sorted(res['metrics'])}))\n"
            ) % (str(tmp_path), str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and "batches_in_window" in res["metrics"]


# ---------------------------------------------------------------------------
# the comparison fails where it must
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", VERIFY_CELLS)
def test_control_is_not_correct(name):
    """The control, on three seeds at the test's size: never correct."""
    for seed in (SEED, SEED + 1, SEED + 2):
        res = run(name, control=True, seed=seed)
        assert not res["correct"] and res["checks"]["wrong_lanes"]["value"] > 0


def _half(fn, n_cols):
    """fn over the first half of the batch's columns, its answer tiled: half
    of the batch left out."""
    def half(*args, **kwargs):
        b = args[0].shape[-1]
        h = b // 2
        out = fn(*(a[..., :h] if i < n_cols else a for i, a in enumerate(args)), **kwargs)
        return torch.cat([out, out[..., : b - h]], -1) if out.dim() else out
    return half


def _altered(fn):
    """fn's verdicts with the first altered where it is made."""
    def altered(*args, **kwargs):
        out = fn(*args, **kwargs)
        return ~out if out.dim() == 0 else torch.cat([~out[:1], out[1:]])
    return altered


def test_faults_one_card(monkeypatch):
    """Each fault the one-card cells can have, planted under the entry the
    window drives, reads ``correct`` false."""
    from eccoxide_tpu_torch.protocol import ed25519, ed25519_batch

    # the RLC check answers a whole batch, so its half fault shows only where
    # a forged lane lies in the half left out: the first seed from SEED on
    # whose traffic has one there
    cell = small("ed25519_verify.rlc_valid")
    rlc_seed = next(s for s in range(SEED, SEED + 64)
                    if any((idx[cell.batch // 2:] >= p["regular"]).any()
                           for p, slots in [harness.make_traffic(cell, s)] for idx in slots))
    faults = [
        ("ed25519_verify.straus", ed25519, "verify_core", _altered, SEED),
        ("ed25519_verify.straus", ed25519, "verify_core", lambda f: _half(f, 4), SEED),
        ("ed25519_verify.rlc_valid", ed25519_batch, "rlc_verify_core", _altered, SEED),
        ("ed25519_verify.rlc_valid", ed25519_batch, "rlc_verify_core", lambda f: _half(f, 5),
         rlc_seed),
    ]
    for name, mod, attr, fault, seed in faults:
        with monkeypatch.context() as m:
            m.setattr(mod, attr, fault(getattr(mod, attr)))
            res = run(name, seed=seed)
        assert not res["correct"], (name, attr)


def no_exchange():
    """Planted in a rank: the sharded verifier's all_reduce left out."""
    from eccoxide_tpu_torch.parallel import batch_verify

    batch_verify.dist = types.SimpleNamespace(all_reduce=lambda t, *a, **k: None)


def altered_verdict():
    """Planted in a rank: its first verdict altered where it is made."""
    from eccoxide_tpu_torch.parallel import batch_verify

    batch_verify.verify_core = _altered(batch_verify.verify_core)


def half_left_out():
    """Planted in a rank: half of its share left out."""
    from eccoxide_tpu_torch.parallel import batch_verify

    batch_verify.verify_core = _half(batch_verify.verify_core, 4)


def test_sharded_world_of_two():
    """The sharded cell in a gloo world of two CPU ranks: correct as it
    stands, not correct with each fault planted in the ranks."""
    assert run(SHARDED, world=2)["correct"]
    for fault in ("no_exchange", "altered_verdict", "half_left_out"):
        res = run(SHARDED, world=2,
                  rank_setup=f"benchmark.tests.test_bench_harness:{fault}")
        assert not res["correct"], fault
    assert res["checks"]["wrong_counts"]["limit"] == 0
