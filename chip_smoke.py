"""Drive the PyTorch/CUDA port's Ed25519 verification on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from eccoxide_tpu_torch/ops/csrc/, holds
each kernel against its plain PyTorch version on the card, runs both
verifiers of the main path at B=32768 (the per-signature Straus verifier
through ``verify_host`` and the RLC batch verifier through
``verify_batch_host``) on signatures made by the port's integer oracle,
counts the kernel launches of those two runs, and times kernels, plain
versions and verifiers. Each phase prints one JSON line; the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device the script exits non-zero before printing a result.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

import torch

B = 32768
N_DISTINCT = 128
MSM_LEVEL0 = 48 * (B // 2)       # first up-sweep level of the MSM at c=8
CHECK_WIDTHS = (0, 1, 511, 512, 513, 768)
HBM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_CLK_PER_SM = 64


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


PORT_KERNELS = ("ed_add_kernel", "ed_double_kernel", "pow_kernel")


def device_profile(fn) -> dict:
    """Device time by kernel over one call of fn (torch.profiler, after a
    warm-up call): the busy time is the sum of the kernels' device time,
    the idle share its complement in the profiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if "CUDA" in str(e.device_type)]
    rows = [r for r in rows if r[1] > 0]
    busy = sum(r[1] for r in rows)
    port = sum(r[1] for r in rows if any(k in r[0] for k in PORT_KERNELS))
    top = sorted(rows, key=lambda r: -r[1])[:10]
    return {"wall_ms_profiled": wall_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall_ms if busy else None,
            "port_kernels_ms": port, "other_kernels_ms": busy - port,
            "launches": sum(r[2] for r in rows),
            "top": [{"kernel": k[:90], "ms": ms, "count": n} for k, ms, n in top]}


def ptxas_report(log: str) -> dict:
    """{kernel: {"registers": n, "spill_stores": b, "spill_loads": b,
    "stack_bytes": b}} from an `nvcc -Xptxas -v` log."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*?(ed_add_kernel|ed_double_kernel|pow_kernel)", line)
        if m:
            cur = m.group(1)
            out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from eccoxide_tpu_torch import oracle
    from eccoxide_tpu_torch.field import FQ, P, TIGHT
    from eccoxide_tpu_torch.ops import build, group, sha512
    from eccoxide_tpu_torch.protocol import ed25519 as pe
    from eccoxide_tpu_torch.protocol import ed25519_batch as pb

    dev = torch.device("cuda", 0)
    card_line = smi("name,power.limit")
    card = {"name": torch.cuda.get_device_name(0), "power_limit": smi("power.limit")}
    clock_max_mhz = float(smi("clocks.max.sm").split()[0])

    # -- phase 1: device and build -----------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    build_s = time.perf_counter() - t0
    nvcc_version = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                                  text=True, check=True).stdout.strip().splitlines()[-1]
    regs = ptxas_report(built["kernels"].log)
    if set(regs) != {"ed_add_kernel", "ed_double_kernel", "pow_kernel"}:
        raise RuntimeError(f"ptxas report lacks kernels: {regs}")
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "torch_cuda": torch.version.cuda, "nvcc": nvcc_version,
          "clocks_max_sm_mhz": clock_max_mhz, "clocks_sm_mhz_now": smi("clocks.sm"),
          "build_s": build_s, "kernel_build_s": built["kernels"].seconds,
          "sha512_build_s": built["sha512"].seconds,
          "kernel_library": os.path.relpath(built["kernels"].path),
          "ptxas": regs})

    # -- phase 2: kernels against their plain versions ---------------------
    gen = torch.Generator(device=dev).manual_seed(2024)
    tight = torch.tensor(TIGHT, dtype=torch.int64, device=dev)
    tables = pe.VerifyTables(dev)

    def rand_fe(*batch):
        """TIGHT limbs, uniformly random per limb."""
        r = torch.randint(0, 1 << 62, (10,) + batch, generator=gen, device=dev)
        return (r % (tight.view((10,) + (1,) * len(batch)) + 1)).to(torch.int32)

    def max_fe(*batch):
        return tight.view((10,) + (1,) * len(batch)).expand((10,) + batch).to(torch.int32).contiguous()

    def rand_points(W):
        """Random multiples [k]B (k < 256, k = 0 the identity) in random
        projective coordinates (X, Y, Z, T scaled by one random lambda)."""
        k = torch.randint(0, 256, (W,), generator=gen, device=dev)
        x, y, t = tables.byte[:, :, k]
        lam = rand_fe(W)
        return torch.stack([FQ.mul(x, lam), FQ.mul(y, lam), lam, FQ.mul(t, lam)])

    def canon_pt(a):
        return FQ.canon(a.transpose(0, 1)).transpose(0, 1)

    checks = {"ed_add": [], "ed_double": [], "pow_const_kernel": []}
    max_err = {name: 0 for name in checks}

    def compare(name, got, want, width, case):
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise RuntimeError(f"{name} {case}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
        if name == "pow_const_kernel":
            cg, cw = FQ.canon(got), FQ.canon(want)
        else:
            cg, cw = canon_pt(got), canon_pt(want)
        err = int((cg.to(torch.int64) - cw.to(torch.int64)).abs().max()) if cg.numel() else 0
        max_err[name] = max(max_err[name], err)
        checks[name].append({"width": width, "case": case, "canonical_equal": err == 0,
                             "limbs_equal": bool(torch.equal(got, want))})
        if err:
            raise RuntimeError(f"{name} at width {width} ({case}) differs from its plain version")

    e_sqrt, e_inv = (P - 5) // 8, P - 2
    ident = pe.ED.identity((1,), dev).xyzt[..., 0]
    for W in CHECK_WIDTHS + (B, MSM_LEVEL0):
        p = rand_points(W)
        q = rand_points(W)
        if W >= 1:
            p[:, :, 0] = ident                                  # identity
        if W >= 4:
            q[:, :, 1] = p[:, :, 1]                             # P + P
            q[:, :, 2] = torch.stack([FQ.neg(p[0, :, 2]), p[1, :, 2],
                                      p[2, :, 2], FQ.neg(p[3, :, 2])])  # P + (-P)
            p[:, :, 3] = max_fe(1)[:, 0]                        # largest TIGHT limbs
            q[:, :, 3] = p[:, :, 3]
        compare("ed_add", group.ed_add(p, q), group.ed_add_plain(p, q), W, "points")
        compare("ed_double", group.ed_double(p), group.ed_double_plain(p), W, "points")
        if W in CHECK_WIDTHS or W == B:
            x = rand_fe(W)
            if W >= 3:
                x[:, 0] = 0
                x[:, 1] = max_fe(1)[:, 0]
            for e, tag in ((e_sqrt, "(p-5)/8"), (e_inv, "p-2")):
                compare("pow_const_kernel", group.pow_const_kernel(x, e),
                        group.pow_const_plain(x, e), W, f"e={tag}")
        torch.cuda.synchronize()
    emit({"phase": "kernels_vs_plain", "tolerance": "exact on canonical limbs",
          "max_abs_err": max_err,
          "checks": {k: len(v) for k, v in checks.items()},
          "all_canonical_equal": all(c["canonical_equal"] for v in checks.values() for c in v),
          "all_limbs_equal": all(c["limbs_equal"] for v in checks.values() for c in v)})

    # -- vectors: oracle-signed, tiled to B ----------------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(1234)
    sks = [rng.bytes(32) for _ in range(N_DISTINCT)]
    msgs0 = [rng.bytes(32) for _ in range(N_DISTINCT)]
    pks0 = [oracle.public_key(sk) for sk in sks]
    sigs0 = [oracle.sign(sk, m) for sk, m in zip(sks, msgs0)]
    pks = [pks0[i % N_DISTINCT] for i in range(B)]
    msgs = [msgs0[i % N_DISTINCT] for i in range(B)]
    sigs = [sigs0[i % N_DISTINCT] for i in range(B)]
    vectors_s = time.perf_counter() - t0

    def flip_s(sig):
        return sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]

    bad = {3: "tampered S", 1000: "tampered message", 17000: "non-canonical pk",
           32000: "R with x=0 and sign=1"}
    t_pks, t_msgs, t_sigs = list(pks), list(msgs), list(sigs)
    t_sigs[3] = flip_s(sigs[3])
    t_msgs[1000] = msgs[1000] + b"!"
    t_pks[17000] = (P + 3).to_bytes(32, "little")
    t_sigs[32000] = (1 | 1 << 255).to_bytes(32, "little") + sigs[32000][32:]
    oracle_bad = [oracle.verify(t_pks[i], t_msgs[i], t_sigs[i]) for i in bad]
    oracle_good = [oracle.verify(pks[i], msgs[i], sigs[i]) for i in range(16)]
    if any(oracle_bad) or not all(oracle_good):
        raise RuntimeError("the integer oracle disagrees with the vectors")

    # -- phases 3 and 4: the main path, with launches counted ----------------
    group.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    straus = pe.verify_host(t_pks, t_msgs, t_sigs, device="cuda", tables=tables)
    torch.cuda.synchronize()
    straus_s = time.perf_counter() - t0
    straus_launches = group.launches()
    expected = [i not in bad for i in range(B)]
    if len(straus) != B or straus != expected:
        wrong = [i for i in range(B) if straus[i] != expected[i]][:10]
        raise RuntimeError(f"verify_host wrong at lanes {wrong}")
    emit({"phase": "straus_verify_host", "B": B, "accepted": sum(straus),
          "rejected_lanes": {str(i): bad[i] for i in bad if not straus[i]},
          "vectors_s": vectors_s, "first_call_s": straus_s, "launches": straus_launches})

    before = group.launches()
    t0 = time.perf_counter()
    rlc_ok = pb.verify_batch_host(pks, msgs, sigs, rng=np.random.default_rng(7),
                                  device="cuda", tables=tables)
    torch.cuda.synchronize()
    rlc_s = time.perf_counter() - t0
    after_valid = group.launches()
    forged = 12345
    f_sigs = list(sigs)
    f_sigs[forged] = flip_s(sigs[forged])
    rlc_forged = pb.verify_batch_host(pks, msgs, f_sigs, rng=np.random.default_rng(8),
                                      device="cuda", tables=tables)
    torch.cuda.synchronize()
    counts = group.launches()
    if rlc_ok != [True] * B:
        raise RuntimeError("verify_batch_host rejected a valid batch")
    # the valid batch must pass on the RLC equation alone: two decompressions,
    # no per-signature fallback
    if after_valid["pow_const_kernel"] - before["pow_const_kernel"] != 2:
        raise RuntimeError("the valid batch fell back to the per-signature verifier")
    if [i for i in range(B) if not rlc_forged[i]] != [forged]:
        raise RuntimeError("verify_batch_host did not isolate exactly the forged lane")
    emit({"phase": "rlc_verify_batch_host", "B": B, "msm_c": 8,
          "valid_batch_accepted": True, "forged_lane": forged,
          "rejected_lanes": [i for i in range(B) if not rlc_forged[i]],
          "first_call_s": rlc_s,
          "launches_valid_batch": {k: after_valid[k] - before[k] for k in counts}})
    if min(counts.values()) <= 0:
        raise RuntimeError(f"a kernel of the main path never launched: {counts}")

    # -- phase 6: times --------------------------------------------------------
    clock_hz = clock_max_mhz * 1e6
    int_peak = INT32_MAD_PER_CLK_PER_SM * torch.cuda.get_device_properties(0).multi_processor_count * clock_hz
    n_dig = len(group.exp_digits(e_sqrt))
    shapes = {
        # name: (width, limb multiply-adds per lane, bytes per lane)
        "ed_add": (MSM_LEVEL0, 9 * 100, 3 * 160),
        "ed_double": (B, 4 * 55 + 4 * 100, 3 * 40 + 160),     # T is not read
        "pow_const_kernel": (B, 14 * 100 + (n_dig - 1) * (4 * 55 + 100), 2 * 40),
    }
    sources = {
        "ed_add": "eccoxide_tpu/ops/pallas_group.py:92 (_add_call, via pallas_add :144)",
        "ed_double": "eccoxide_tpu/ops/pallas_group.py:119 (_double_call, via pallas_double :161)",
        "pow_const_kernel": "eccoxide_tpu/ops/pallas_group.py:173 (_pow_call, via pallas_pow :241)",
    }
    kernels = []
    for name, (W, ops, nbytes) in shapes.items():
        if name == "pow_const_kernel":
            x = rand_fe(W)
            k_fn = lambda: group.pow_const_kernel(x, e_sqrt)
            p_fn = lambda: group.pow_const_plain(x, e_sqrt)
        elif name == "ed_add":
            p, q = rand_points(W), rand_points(W)
            k_fn = lambda: group.ed_add(p, q)
            p_fn = lambda: group.ed_add_plain(p, q)
        else:
            p = rand_points(W)
            k_fn = lambda: group.ed_double(p)
            p_fn = lambda: group.ed_double_plain(p)
        ms = cuda_ms(k_fn, 20)
        plain_ms = cuda_ms(p_fn, 3)
        ops_ms = W * ops / int_peak * 1e3
        bytes_ms = W * nbytes / HBM_BYTES_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda",
            "source": "eccoxide_tpu_torch/ops/csrc/group.cu",
            "replaces": sources[name], "launches": counts[name],
            "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None, "shape": [4, 10, W] if name != "pow_const_kernel" else [10, W],
            "ops_ms": ops_ms, "bytes_ms": bytes_ms,
        })
        del k_fn, p_fn
        torch.cuda.synchronize()

    # verifies/s: host clock around whole calls ending in synchronize
    def host_rate(fn, reps=3):
        runs = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        return runs

    straus_runs = host_rate(lambda: pe.verify_host(pks, msgs, sigs, device="cuda", tables=tables), 5)
    rlc_runs = host_rate(lambda: pb.verify_batch_host(
        pks, msgs, sigs, rng=np.random.default_rng(9), device="cuda", tables=tables), 5)
    inputs = pe.host_inputs(pks, msgs, sigs, dev)
    z = torch.from_numpy(pb.sample_z(B, np.random.default_rng(10))).to(dev)
    hash_runs = host_rate(lambda: pe.host_inputs(pks, msgs, sigs, dev))
    straus_core = host_rate(lambda: pe.verify_core(*inputs, tables))
    rlc_core = host_rate(lambda: pb.rlc_verify_core(*inputs, z, tables, msm_c=8))
    torch.cuda.reset_peak_memory_stats()
    pb.rlc_verify_core(*inputs, z, tables, msm_c=8)
    torch.cuda.synchronize()
    rlc_peak = torch.cuda.max_memory_allocated()
    emit({"phase": "times", "card": card, "B": B, "sha512_hasher": sha512.hasher(),
          "straus_verify_host_s": straus_runs,
          "straus_verifies_per_s": B / statistics.median(straus_runs),
          "rlc_verify_batch_host_s": rlc_runs,
          "rlc_verifies_per_s": B / statistics.median(rlc_runs),
          "host_inputs_s": hash_runs, "straus_core_s": straus_core,
          "rlc_core_s": rlc_core, "rlc_core_peak_bytes": rlc_peak,
          "int32_mad_peak_per_s": int_peak, "hbm_bytes_per_s": HBM_BYTES_PER_S})

    # -- where the device time goes: one profiled call of each core ----------
    emit({"phase": "profile", "card": card, "B": B,
          "straus_core": device_profile(lambda: pe.verify_core(*inputs, tables)),
          "rlc_core": device_profile(lambda: pb.rlc_verify_core(*inputs, z, tables, msm_c=8))})

    print(card_line)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
