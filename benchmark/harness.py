"""One run of one cell: inputs from the seed, set-up and warm-up, the
measured window of back-to-back batches (a closed loop), in a traced run
the layers' spans and a profiled stretch, then the comparison with the
plain reference and the result line.

A cell whose entry is sharded runs as a world of ``chips`` ranks, one
process and one card each (``eccoxide_tpu_torch.parallel.world``); every
rank drives its share of every batch, and the ranks agree after each
batch whether the window has closed. Everything else runs in the calling
process."""

from __future__ import annotations

import gc
import importlib
import os
import pickle
import sys
import tempfile
import time

import numpy as np
import torch

from . import spec, trace

clock = time.perf_counter
FORBIDDEN = ("jax", "jaxlib", "flax", "eccoxide_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (``eccoxide_tpu_torch`` is not ``eccoxide_tpu``)."""
    return sorted(m for m in (sys.modules if modules is None else modules)
                  if m.split(".")[0] in FORBIDDEN)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def forged_slots(cell: spec.Cell) -> list[int]:
    every = cell.traffic.get("forged_batch_every", 0)
    return [s for s in range(cell.traffic["ring_batches"]) if every and s % every == every - 1]


def make_traffic(cell: spec.Cell, seed: int, world: int = 1):
    """(pool, slots): the pool of distinct items from the seed, and the
    ring of batches, each an int array of pool indices over ``world``
    cards' lanes: distinct seeded permutations of the regular items end to
    end, one lane of a forged slot replaced by a forged item."""
    rng = np.random.default_rng(seed % 2**64)
    fslots = forged_slots(cell)
    pool = spec.protocol(cell).make_pool(cell.config, cell.traffic, rng, len(fslots))
    n, lanes = pool["regular"], cell.batch * world
    slots = []
    for s in range(cell.traffic["ring_batches"]):
        idx = np.concatenate([rng.permutation(n) for _ in range(-(-lanes // n))])[:lanes]
        if s in fslots:
            idx[rng.integers(lanes)] = pool["forged"][fslots.index(s)]
        slots.append(idx)
    return pool, slots


# ---------------------------------------------------------------------------
# spans and the window
# ---------------------------------------------------------------------------


class Spans:
    """Wrappers around the program's module attributes that a layer's
    calls go through (``"module:attr"``), each call timed to its end, with
    ``torch.cuda.synchronize()`` on a card, and named ``bench.<span>`` in
    the profiler. Only targets whose module is loaded are wrapped."""

    def __init__(self, targets: dict, sync: bool):
        self.targets, self.sync = targets, sync
        self.times = {name: [] for name in targets}
        self._undo = []

    def _wrap(self, name, fn):
        times, sync = self.times[name], self.sync

        def timed(*args, **kwargs):
            t0 = clock()
            with torch.profiler.record_function(f"{trace.SPAN_PREFIX}{name}"):
                out = fn(*args, **kwargs)
                if sync:
                    torch.cuda.synchronize()
            times.append(clock() - t0)
            return out

        return timed

    def install(self):
        for name, targets in self.targets.items():
            for target in targets:
                mod_name, attr = target.split(":")
                mod = sys.modules.get(mod_name)
                if mod is None:
                    continue
                orig = getattr(mod, attr)
                setattr(mod, attr, self._wrap(name, orig))
                self._undo.append((mod, attr, orig))
        return self

    def uninstall(self):
        for mod, attr, orig in reversed(self._undo):
            setattr(mod, attr, orig)
        self._undo.clear()


class _Alone:
    """The window's agreement for a world of one."""

    def barrier(self):
        pass

    def stop(self, flag: bool) -> bool:
        return flag


class _Ranks:
    """The window's agreement across ranks, over a gloo group beside the
    program's own (rank 0's clock decides)."""

    def __init__(self):
        import torch.distributed as dist

        self.dist, self.group = dist, dist.new_group(backend="gloo")

    def barrier(self):
        self.dist.barrier(group=self.group)

    def stop(self, flag: bool) -> bool:
        t = torch.tensor([int(flag)])
        self.dist.broadcast(t, 0, group=self.group)
        return bool(t.item())


class _Control:
    """The control in the program's place: its answers to every slot, made
    in set-up by the protocol's ``control``."""

    def __init__(self, answers):
        self.answers = answers

    def prepare(self, dev, pool, slots):
        return {}

    def call(self, state, k):
        return self.answers[k]


def window(drv, state, n_slots: int, seconds: float, comm, max_batches=None) -> dict:
    """Batches back to back, slot k mod n_slots, until ``seconds`` have
    passed since the first one started and every slot has run once (or
    ``max_batches`` ran): each timed from the call's start to its answers
    on the host."""
    starts, ends, answers = [], [], []
    k = 0
    while True:
        t0 = clock()
        out = drv.call(state, k % n_slots)
        t1 = clock()
        starts.append(t0)
        ends.append(t1)
        answers.append(out)
        k += 1
        done = (t1 - starts[0] >= seconds and k >= n_slots) or k == max_batches
        if comm.stop(done):
            return {"start": starts, "end": ends, "answers": answers}


def profiled(drv, state, first: int, n: int, n_slots: int, families: dict, on_card: bool):
    """n more batches under torch.profiler with the launch hooks of the
    cell's kernel families installed: (answers, trace summary with the launch
    records by family)."""
    from torch.profiler import ProfilerActivity, profile

    launches = {name: [] for name in families}
    undo = [fam.hook(launches[name].append) for name, fam in families.items()]
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    answers = []
    try:
        with profile(activities=activities) as prof:
            for k in range(first, first + n):
                with torch.profiler.record_function(trace.BATCH_SPAN):
                    answers.append(drv.call(state, k % n_slots))
    finally:
        for u in reversed(undo):
            u()
    summary = trace.summarize(prof.profiler.kineto_results.events(), n)
    summary["launches"] = launches
    return answers, summary


def warm_slots(cell: spec.Cell) -> list[int]:
    """One batch of every kind the window meets (the first slot twice, a
    forged slot once), so that nothing builds or warms inside it."""
    return [0, 0] + forged_slots(cell)[:1]


def rank_run(cell: spec.Cell, dev, pool, slots, seconds, traced, control, comm) -> dict:
    """One rank's run: set-up, warm-up, the window and, traced, the spans
    and the profiled stretch. The program's state is freed before it
    returns."""
    on_card = torch.device(dev).type == "cuda"
    proto = spec.protocol(cell)
    if control:
        drv = _Control(proto.control(cell.traffic["control"], pool, slots))
    else:
        drv = spec.entry(cell)
    state = drv.prepare(dev, pool, slots)
    for k in warm_slots(cell):
        drv.call(state, k)
    spans = None
    if traced:
        targets = {}
        for m in cell.per_layer:
            targets.update(getattr(spec.metric_reader(cell, m["name"]), "SPANS", {}))
        spans = Spans(targets, on_card).install()
    if on_card:
        torch.cuda.synchronize()
    comm.barrier()
    rec = window(drv, state, len(slots), seconds, comm,
                 max_batches=len(slots) if control else None)
    rec["spans"] = {k: list(v) for k, v in spans.times.items()} if spans else {}
    rec["profile"] = None
    if traced:
        n = cell.traffic["profile_batches"]
        more, rec["profile"] = profiled(drv, state, len(rec["answers"]), n, len(slots),
                                        spec.kernel_families(cell), on_card)
        rec["answers"] += more
        spans.uninstall()
    rec["counts"] = list(state.get("counts", []))
    rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if on_card else 0
    rec["kind"] = torch.cuda.get_device_name(dev) if on_card else "cpu"
    rec["answers"] = [proto.as_array(a) for a in rec["answers"]]
    del state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# a world of ranks
# ---------------------------------------------------------------------------


def call_named(target: str | None):
    """Call the module-level function ``"module:function"``, if given."""
    if target:
        mod, fn = target.split(":")
        getattr(importlib.import_module(mod), fn)()


def _rank_main(rank, world, device, tmp, cell, pool, slots, seconds, traced, control, rank_setup):
    import torch.distributed as dist

    from eccoxide_tpu_torch.parallel import world as ranks

    call_named(rank_setup)
    dev = ranks.init_world(rank, world, device, "file://" + os.path.join(tmp, "rendezvous"))
    n = len(slots[0]) // world
    mine = [idx[rank * n:(rank + 1) * n] for idx in slots]
    try:
        rec = rank_run(cell, dev, pool, mine, seconds, traced, control, _Ranks())
    finally:
        dist.destroy_process_group()
    rec["forbidden"] = forbidden_modules()
    with open(os.path.join(tmp, f"rank{rank}"), "wb") as f:
        pickle.dump(rec, f)


def run_world(cell, world, device, pool, slots, seconds, traced, control, rank_setup=None) -> list:
    """Every rank's record, in rank order. The ranks meet at a file in a
    fresh directory under TMPDIR; each first calls ``rank_setup``
    (``call_named``)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(world, str(device), tmp, cell, pool, slots, seconds,
                                   traced, control, rank_setup), nprocs=world, join=True)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}"), "rb") as f:
                out.append(pickle.load(f))
    return out


# ---------------------------------------------------------------------------
# the comparison and the result
# ---------------------------------------------------------------------------


def compare(cell: spec.Cell, pool, slots, records: list, want_items) -> dict:
    """The numbers compared, each {"value", "limit"}: lanes whose answer
    differs from the plain reference's or is missing, and, where the entry
    returns the accept count of a whole batch (the sharded verifier), the
    batches whose count differs from the reference's."""
    n_batches = len(records[0]["answers"])
    wrong = attempted = 0
    wrong_counts = 0
    for b in range(n_batches):
        idx = slots[b % len(slots)]
        want = want_items[idx]
        attempted += len(idx)
        try:
            got = np.concatenate([r["answers"][b] for r in records])
        except ValueError:
            wrong += len(idx)
            continue
        if got.shape != want.shape:
            wrong += len(idx)
            continue
        diff = got != want
        wrong += int(diff.reshape(len(idx), -1).any(1).sum())
        for r in records:
            if r["counts"] and r["counts"][b] != int(want.sum()):
                wrong_counts += 1
    checks = {"wrong_lanes": {"value": wrong, "limit": 0}}
    if any(r["counts"] for r in records):
        checks["wrong_counts"] = {"value": wrong_counts, "limit": 0}
    return {"attempted": attempted, "failed": wrong, "checks": checks}


def metric_context(cell, records, t_start) -> dict:
    """What a metric reader reads: the run's start on the window's clock,
    the lanes a rank answers a batch, and per rank the batches' start and
    end times, the spans and the profiled stretch's summary."""
    return {"t_start": t_start, "lanes_per_rank": cell.batch,
            "ranks": [{"start": r["start"], "end": r["end"], "spans": r["spans"],
                       "profile": r["profile"]} for r in records]}


def read_metrics(cell, ctx, names) -> dict:
    out = {}
    for m in names:
        value = spec.metric_reader(cell, m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device="cuda",
             t_start: float | None = None, control: bool = False, world: int | None = None,
             rank_setup: str | None = None) -> dict:
    """One run of ``cell`` on ``device``: the result's keys and the numbers
    compared (``checks``, last). ``world`` overrides the ranks of a sharded
    entry (``cell.chips`` by default); ``rank_setup`` (``"module:function"``)
    runs first in every rank's process, as the tests plant faults."""
    t_start = clock() if t_start is None else t_start
    sharded = getattr(spec.entry(cell), "SHARDED", False)
    world = (world or cell.chips) if sharded else 1
    pool, slots = make_traffic(cell, seed, world)
    if world > 1:
        records = run_world(cell, world, device, pool, slots, seconds, traced, control, rank_setup)
    else:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        call_named(rank_setup)
        records = [rank_run(cell, dev, pool, slots, seconds, traced, control, _Alone())]
    t_ref = clock()
    want = spec.protocol(cell).reference(pool)
    reference_s = clock() - t_ref
    cmp = compare(cell, pool, slots, records, want)
    ctx = metric_context(cell, records, t_start)
    metrics = read_metrics(cell, ctx, cell.per_layer if traced else cell.end_to_end)
    on_card = torch.device(device).type == "cuda"
    dev_info = {"platform": "gpu" if on_card else "cpu", "kind": records[0]["kind"],
                "count": world, "memory_peak_bytes": max(r["memory_peak_bytes"] for r in records)}
    out = {"correct": cmp["failed"] == 0 and cmp["attempted"] > 0
           and all(c["value"] <= c["limit"] for c in cmp["checks"].values()),
           "attempted": cmp["attempted"], "failed": cmp["failed"], "metrics": metrics,
           "device": dev_info}
    if traced:
        profiles = [r["profile"] for r in records]
        dev_info["busy_s"] = float(np.mean([p["busy_s"] for p in profiles]))
        dev_info["window_s"] = float(np.mean([p["wall_s"] for p in profiles]))
        out["breakdown"] = {
            "device_ops": [[k, v / world] for k, v in trace.top(trace.merge_ranks(profiles, "ops"))],
            "idle_gaps": [[k, v / world] for k, v in trace.top(trace.merge_ranks(profiles, "gaps"))]}
    out["checks"] = cmp["checks"]
    batch_s = np.array(records[0]["end"]) - np.array(records[0]["start"])
    out["_info"] = {"reference_s": reference_s, "batches": len(records[0]["start"]),
                    "batch_ms": [round(1e3 * float(t), 1) for t in batch_s],
                    "batch_s_quartiles": [float(np.min(batch_s))]
                    + [float(q) for q in np.percentile(batch_s, [25, 50, 75])]
                    + [float(np.max(batch_s))],
                    "forbidden_in_ranks": sorted({m for r in records for m in r.get("forbidden", [])}),
                    "kinds": {k: pool["kinds"].count(k) for k in set(pool["kinds"])}}
    return out
