"""Drive the PyTorch/CUDA port on one NVIDIA card: Ed25519 verification,
key generation and signing, X25519 and X448, the 15 SEC2 curves,
ristretto255, the field API, the MSMs, the sharded layer and the entry
module's verify and weak-scaling harness.

    python3 chip_smoke.py

Builds the port's CUDA kernels from eccoxide_tpu_torch/ops/csrc/, holds
each kernel against its plain PyTorch version on the card (``ed_add`` in
its three modes: full, ``need_t=False`` and mixed; the pow kernels over
2^255-19, over p448 and over the 15 SEC2 primes), runs both verifiers at
B=32768 (the
per-signature Straus verifier through ``verify_host`` and the RLC batch
verifier through ``verify_batch_host``) on signatures made by the port's
integer oracle, then at B=32768 key generation and signing
(``public_keys_host``, ``sign_host``, every signature verified) and the
X25519 and X448 exchanges (both ways, RFC 7748 vectors and low-order u in
fixed lanes), P-256 and secp256k1 key generation and ECDH at B=32768
(comb ``mul_base`` and SEC1 ``compress``; ``decompress``, CT
``scalar_mul``, ``to_affine``; both ways, NIST or sage KATs, bad
encodings in fixed lanes) and the other 13 SEC2 curves at B=256 against
the integer oracle, ristretto255 at B=32768 (comb ``mul_base``,
``compress``, ``decompress`` with the RFC 9496 A.1 and A.2 encodings in
fixed lanes, ``from_uniform_bytes`` with the A.3 inputs; 64 lanes against
the oracle), the JAX ``Field`` API on FL, FQ, FQ448 and the 15 SEC2 group
orders at B=32768 (inverse, square roots, Euler's test, wide reduction;
64 lanes against Python ints; the pow kernel's instances of l and of the
orders against their plain version), and ``msm_local`` with c=8 at
B=32768 on edwards25519 and P-256 (points [a_i]G from the comb, the sum
against the oracle's [sum s_i a_i]G); and the sharded layer in an NCCL
world of one on the card (phase ``sharded``: ``make_sharded_verify`` at
B=32768 with one tampered lane against ``verify_core``, ``make_sharded_msm``
on the edwards25519 MSM inputs against ``msm_local``, ``msm_sharded_example``
and ``entry.dryrun_multichip`` in a spawned process; worlds of 2 and 4 need
a card a rank, and are checked on gloo CPU ranks by the tests);
``msm_local_prefix`` at JAX's c=12 on the edwards25519 MSM inputs against
``msm_local`` and the oracle (timed in turns with it, one profiled call),
and on p192k1 at B=256 with c=5 against the oracle; the JAX entry's
counterpart ``entry.entry`` (its verify all True on the example batch of
8) and ``entry.weak_scaling`` over every card with 32768 signatures a
card; and the two measurement entry points as a user runs them (phase
``bench``: ``python -m eccoxide_tpu_torch.bench``, whose last record must
be RLC verify at B=32768, and ``python -m eccoxide_tpu_torch.bench_suite
8192 --out chiprun_out/suite_torch.json``, which must hold every metric
name of the JAX ``bench_suite.py`` with a positive value; each in its own
process, the launches and launch shapes of their records counted here);
and the entry script as a user runs it (phase ``entry_main``: ``python -m
eccoxide_tpu_torch.entry`` in its own process, the counterpart of the JAX
entry module's ``__main__`` block: the example verify's eight True, ``dryrun
ok``, and the weak-scaling line only with more than one card).
The verifiers' fixed lanes hold the two negative-zero triples (x = 0
with the sign bit as the key or as R), which every verifier refuses. It
counts the kernel launches of each path, with the counts set to 0 just
before it, records the shape of each launch (width in lanes,
mode, run length, field and exponent) and holds the kernel against its
plain version at every such shape the checks before the paths did not
cover, and times kernels, plain versions and paths. It
measures the card's rate of 32x32->64 multiply-adds (IMAD.WIDE.U32, the pow
kernels' product instruction) with a probe kernel (ops/probe.py), and prices
every operation bound at the lower of that rate and the data sheet's 32-bit
IMAD rate. A kernel's time is device time per launch from a
CUDA graph of wrapper calls replayed between CUDA events, printed beside
the host's time per wrapper call and held against the profiler's per-launch
time over one Straus verify. Each phase prints one JSON line; the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device the script exits non-zero before printing a result.
"""

from __future__ import annotations

import ast
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
DOUBLE_RUNS = (1, 4, 8)  # k of ed_double: one step, a Straus run, a Horner window at c=8
# ed_add widths timed in the full mode: MSM level 0, Straus, the widest MSM
# tree launch at or under 24576 (48 * 2^9), a Horner add
ADD_WIDTHS = (MSM_LEVEL0, B, 48 * 2**9, 1)
ADD_MODES = ("full", "need_t=False", "mixed")
# per lane: limb multiply-adds, bytes (inputs read once, output written once)
ADD_COST = {"full": (900, 3 * 160), "need_t=False": (800, 3 * 160),
            "mixed": (800, 160 + 120 + 160)}
STRAUS_ADDS = {"full": 14, "need_t=False": 64, "mixed": 32}   # per Straus call
PUBKEY_ADDS = 64         # mixed adds of one comb [a]B; and one pow (compress)
ORACLE_LANES = 64        # lanes of the sign and ladder paths held against the oracle
HBM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_CLK_PER_SM = 64
GRAPH_LAUNCHES = 20      # wrapper calls captured in one CUDA graph
GRAPH_REPLAYS = 10
E_SHORT = 0x1234         # a short public exponent for the pow kernels' checks
E_SPARSE = 0x1000F       # one with zero digits (no product on them)
# (first lane, width) of the SEC2 pow kernel's checks: widths 0, 1 (the
# largest limbs, then a random lane), 127, 128, 129 and B
SEC2_CHECK_LANES = ((0, 0), (0, 1), (1, 1), (0, 127), (0, 128), (0, 129), (0, B))
# the same for the instances of the group orders and of l: widths 0, 1 (twice),
# 511, 512, 513, 768 and B
ORDER_CHECK_LANES = ((0, 0), (0, 1), (1, 1), (0, 511), (0, 512), (0, 513), (0, 768), (0, B))
FIELD_API_LANES = 64     # lanes of the field_api phase held against Python ints
BINGCD_LANES = 256       # lanes of the binary-GCD inverse (plain torch, thousands of launches)
MSM_C = 8
PREFIX_C = 12            # msm_local_prefix's window: JAX's default
PREFIX_P192K1_B = 256    # the p192k1 check of msm_local_prefix (c = 5)
R_DISTINCT = 512         # distinct oracle encodings tiled over the ristretto255 decode batch
BINGCD_FIELDS = ("FL", "FQ", "FQ448", "p256r1_n", "p521r1_n")
SUITE_B = 8192           # the batch of the bench phase's suite (the JAX suite's default)
BENCH_TIMEOUT_S = 600    # each entry point of the bench and entry_main phases, in its own process


def sec2_exponents(f) -> dict:
    """The exponents of the SEC2 path (``Field.path_exponents``), a short
    one and 0."""
    return {**f.path_exponents(), hex(E_SHORT): E_SHORT, "0": 0}


T_START = time.perf_counter()


def emit(obj):
    """One JSON line; a phase line also says when it ended (host clock, s
    since the script started)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def events_ms(fn, reps: int) -> float:
    """Host-issued calls between two CUDA events, ms per call. Right only
    where the device work outlasts the host's issue of each call: the
    plain versions (hundreds of small torch launches per call)."""
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


def graph_ms(fn, launches: int = GRAPH_LAUNCHES, replays: int = GRAPH_REPLAYS) -> float:
    """Device ms per launch, without the host: `launches` calls of the
    wrapper fn (same input, outputs allocated inside the capture) captured
    in one CUDA graph, warmed up, then replayed between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * launches)
    del g
    torch.cuda.synchronize()
    return ms


def host_us_per_call(fn, calls: int = GRAPH_LAUNCHES, reps: int = 5) -> float:
    """Host clock per wrapper call, no synchronize between calls (checks,
    allocation, ctypes call, launch); median of reps runs of `calls`."""
    runs = []
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs)


# RFC 7748: section 5.2 vectors (scalar, u, out), the section 6 exchange,
# and for X25519 one step of the section 5.2 iteration ([9]9)
X25519_VECTORS = {k: bytes.fromhex(v) if isinstance(v, str) else tuple(map(bytes.fromhex, v))
                  for k, v in {
    "v1": ("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4",
           "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c",
           "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"),
    "v2": ("4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d",
           "e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493",
           "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957"),
    "a_priv": "77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a",
    "a_pub": "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a",
    "b_priv": "5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb",
    "b_pub": "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f",
    "shared": "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742",
    "it1_k": "0900000000000000000000000000000000000000000000000000000000000000",
    "it1_out": "422c8e7a6227d7bca1350b3e2bb7279f7897b87bb6854b783c60e80311ae3079"}.items()}
X448_VECTORS = {k: bytes.fromhex(v) if isinstance(v, str) else tuple(map(bytes.fromhex, v))
                for k, v in {
    "v1": ("3d262fddf9ec8e88495266fea19a34d28882acef045104d0d1aae121700a779c"
           "984c24f8cdd78fbff44943eba368f54b29259a4f1c600ad3",
           "06fce640fa3487bfda5f6cf2d5263f8aad88334cbd07437f020f08f9814dc031"
           "ddbdc38c19c6da2583fa5429db94ada18aa7a7fb4ef8a086",
           "ce3e4ff95a60dc6697da1db1d85e6afbdf79b50a2412d7546d5f239fe14fbaad"
           "eb445fc66a01b0779d98223961111e21766282f73dd96b6f"),
    "v2": ("203d494428b8399352665ddca42f9de8fef600908e0d461cb021f8c538345dd7"
           "7c3e4806e25f46d3315c44e0a5b4371282dd2c8d5be3095f",
           "0fbcc2f993cd56d3305b0b7d9e55d4c1a8fb5dbb52f8e9a1e9b6201b165d0158"
           "94e56c4d3570bee52fe205e28a78b91cdfbde71ce8d157db",
           "884a02576239ff7a2f2f63b2db6a9ff37047ac13568e1e30fe63c4a7ad1b3ee3"
           "a5700df34321d62077e63633c575c1c954514e99da7c179d"),
    "a_priv": "9a8f4925d1519f5775cf46b04b5800d4ee9ee8bae8bc5565d498c28dd9c9baf5"
              "74a9419744897391006382a6f127ab1d9ac2d8c0a598726b",
    "a_pub": "9b08f7cc31b7e3e67d22d5aea121074a273bd2b83de09c63faa73d2c22c5d9bb"
             "c836647241d953d40c5b12da88120d53177f80e532c41fa0",
    "b_priv": "1c306a7ac2a0e2e0990b294470cba339e6453772b075811d8fad0d1d6927c120"
              "bb5ee8972b0d3e21374c9c921b09d1b0366f10b65173992d",
    "b_pub": "3eb7a829b0cd20f5bcfc0b599b6feccf6da4627107bdb0d4f345b43027d8b972"
             "fc3e34fb4232a13ca706dcb57aec3dae07bdc1c67bf33609",
    "shared": "07fff4181ac6cc95ec1c16a94a0f74d12da232ce40a77552281d282bb60c0b56"
              "fd2464c335543936521c24403085d59a449a5037514a879d"}.items()}
_P25519, _P448 = 2**255 - 19, 2**448 - 2**224 - 1
# u of low order and non-canonical encodings of them: the shared secret is 0
X25519_LOW_ORDER = [v.to_bytes(32, "little") for v in (
    0, 1, 325606250916557431795983626356110631294008115727848805560023387167927233504,
    39382357235489614581723060781553021112529911719440698176882885853963445705823,
    _P25519 - 1, _P25519, _P25519 + 1, 2**255 + 1)]
X448_LOW_ORDER = [v.to_bytes(56, "little") for v in (0, 1, _P448 - 1, _P448, _P448 + 1)]

PORT_KERNELS = ("ed_add_kernel", "ed_double_kernel", "pow_kernel", "pow448_kernel",
                "pow_sec2_kernel")
PROBE_KERNEL = "imad_probe_kernel"
# a kernel's name in ptxas and SASS listings: the pow_sec2 instances are
# told apart by their prime (template argument I<len><name>E, e.g. I6p256r1E,
# I8p256r1_nE for the group order of P-256, I6l25519E)
_KERNEL_RE = "(" + "|".join(PORT_KERNELS + (PROBE_KERNEL,)) + r")(?:I\d+([a-z][a-z0-9_]*)E)?"
SEC2_PATH_B = 256        # lanes of the 13 other SEC2 curves
SEC2_ORACLE_LANES = 16
SASS_OPS = ("IMAD.WIDE", "IMAD", "SHF", "IADD3", "LDL", "STL")


def sass_counts(lib_paths) -> dict:
    """Static SASS opcode counts per port kernel from `cuobjdump -sass` of
    the built libraries: IMAD.WIDE* apart from the other IMAD*, SHF*,
    IADD3*, LDL*, STL*, and all instructions. "not available" where the
    toolkit lacks cuobjdump."""
    from eccoxide_tpu_torch.ops import build

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {"not available": f"no cuobjdump beside {build._nvcc()}"}
    out = "\n".join(subprocess.run([tool, "-sass", str(path)], capture_output=True,
                                   text=True, check=True).stdout for path in lib_paths)
    counts, cur = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            m = re.search(r"Function : .*?" + _KERNEL_RE, line)
            cur = counts.setdefault(_kernel_key(m), dict.fromkeys(SASS_OPS + ("all",), 0)) if m else None
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and cur is not None:
            op = m.group(1)
            cur["all"] += 1
            if op.startswith("IMAD.WIDE"):
                cur["IMAD.WIDE"] += 1
            else:
                for name in SASS_OPS[1:]:
                    if op == name or op.startswith(name + "."):
                        cur[name] += 1
    return counts


def _kernel_key(m) -> str:
    return m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")


# why no PyTorch call stands beside a kernel (library_ms null)
LIBRARY_NONE = dict.fromkeys(
    ("ed_add", "ed_double"), "no single PyTorch call computes an Edwards group operation")
LIBRARY_NONE.update(dict.fromkeys(
    ("pow_const_kernel", "pow448_kernel", "pow_sec2_kernel"),
    "no single PyTorch call computes a multi-limb modular pow"))
PROBE_Y = 0x9E3779B9          # the probe's multiplier (odd, 32 bits)
PROBE_BLOCKS_PER_SM = 8       # 8 blocks of 256 threads: 2048 threads per SM
PROBE_TRIPS = 20000           # about 0.09 s per launch on an H100
PROBE_LAUNCHES = 10


def mad_rate(dev, n_sm: int) -> dict:
    """32x32->64 multiply-adds per second on the card, as the pow kernels'
    products compile (IMAD.WIDE.U32, sums by IADD3): the probe
    (ops/probe.py) checked against its plain version on a small launch,
    then PROBE_LAUNCHES launches that fill every SM between CUDA events,
    the SM clock read by nvidia-smi while they run."""
    from eccoxide_tpu_torch.ops import probe

    got = probe.imad_wide_chains(2, 3, PROBE_Y, dev).cpu()
    want = torch.from_numpy(probe.imad_wide_chains_plain(2, 3, PROBE_Y).view("int64"))
    if not torch.equal(got, want):
        raise RuntimeError("the multiply-add probe differs from its plain version")
    blocks = PROBE_BLOCKS_PER_SM * n_sm
    probe.imad_wide_chains(blocks, PROBE_TRIPS, PROBE_Y, dev)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(PROBE_LAUNCHES):
        probe.imad_wide_chains(blocks, PROBE_TRIPS, PROBE_Y, dev)
    end.record()
    clock = smi("clocks.sm")
    torch.cuda.synchronize()
    secs = start.elapsed_time(end) / 1e3
    madds = PROBE_LAUNCHES * probe.madds(blocks, PROBE_TRIPS)
    clock_mhz = float(clock.split()[0])
    return {"madds": madds, "seconds": secs, "madds_per_s": madds / secs,
            "clocks_sm_during": clock,
            "madds_per_clk_per_sm": madds / secs / (n_sm * clock_mhz * 1e6),
            "probe": f"{blocks} blocks of {probe.THREADS} threads, {probe.CHAINS} chains "
                     f"of {probe.UNROLL} x {PROBE_TRIPS} steps each, checked against "
                     "its plain version on 2 blocks"}


def device_profile(fn, cross_check: bool = False) -> dict:
    """Device time by kernel over one call of fn (torch.profiler, after a
    warm-up call): the busy time is the sum of the kernels' device time,
    the idle share its complement in the profiled wall time; per port
    kernel, its device time per launch (device time / count).

    The rows come straight from the trace's device events: a kernel, copy
    or set on the card has no children, so its duration is the self device
    time that ``key_averages()`` reports for it, and the sums are the same.
    ``key_averages()`` first parses the whole trace into a tree of Python
    events, which takes minutes for the ladders' 10^5 launches. With
    ``cross_check`` both are computed, and any difference raises."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if "CUDA" in str(e.device_type()):
            ms, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    rows = [(k, ms, n) for k, (ms, n) in by_name.items() if ms > 0]
    if cross_check:
        ref = {e.key: (e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages() if "CUDA" in str(e.device_type)
               and e.self_device_time_total > 0}
        mine = {k: (ms, n) for k, ms, n in rows}
        if set(ref) != set(mine) or any(
                mine[k][1] != n or abs(mine[k][0] - ms) > 1e-6 * max(ms, 1e-3)
                for k, (ms, n) in ref.items()):
            raise RuntimeError(f"the trace's device events disagree with key_averages(): "
                               f"{sorted(set(ref) ^ set(mine))[:5]}")
    busy = sum(r[1] for r in rows)
    port = sum(r[1] for r in rows if any(k in r[0] for k in PORT_KERNELS))
    top = sorted(rows, key=lambda r: -r[1])[:10]
    per_kernel = {}
    for name in PORT_KERNELS:
        mine = [r for r in rows if name in r[0]]
        n = sum(r[2] for r in mine)
        per_kernel[name] = {"count": n, "ms_per_launch": sum(r[1] for r in mine) / n if n else None}
    return {"wall_ms_profiled": wall_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall_ms if busy else None,
            "port_kernels_ms": port, "other_kernels_ms": busy - port,
            "launches": sum(r[2] for r in rows), "port_kernels": per_kernel,
            "top": [{"kernel": k[:90], "ms": ms, "count": n} for k, ms, n in top]}


def ptxas_report(log: str) -> dict:
    """{kernel: {"registers": n, "spill_stores": b, "spill_loads": b,
    "stack_bytes": b}} from an `nvcc -Xptxas -v` log."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*?" + _KERNEL_RE, line)
        if m:
            cur = _kernel_key(m)
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


def jax_suite_metrics(path) -> list[str]:
    """The metric names of the JAX ``bench_suite.py`` in its order, read from
    its text (the script imports JAX, so it is parsed, not imported): the
    first argument of each ``emit`` call and each constant or f-string
    under a "metric" key, an f-string filled with the values of the
    for-loops around it (a literal list or tuple, or ``<dict>.items()`` of
    a dict literal assigned to that name: its keys)."""
    tree = ast.parse(open(path).read())
    dicts = {t.id: [ast.literal_eval(k) for k in node.value.keys]
             for node in ast.walk(tree) if isinstance(node, ast.Assign)
             and isinstance(node.value, ast.Dict) for t in node.targets
             if isinstance(t, ast.Name)}
    names = []

    def fill(node, env):
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.JoinedStr):
            return "".join(str(env[v.value.id]) if isinstance(v, ast.FormattedValue) else v.value
                           for v in node.values)
        return None                      # a name: emit's own parameter

    def loop_values(node):
        """(target name, values) of a for-loop whose values the text gives."""
        it, target = node.iter, node.target
        if (isinstance(it, (ast.List, ast.Tuple)) and isinstance(target, ast.Name)
                and all(isinstance(e, ast.Constant) for e in it.elts)):
            return target.id, ast.literal_eval(it)
        if (isinstance(it, ast.Call) and isinstance(it.func, ast.Attribute)
                and it.func.attr == "items" and isinstance(it.func.value, ast.Name)
                and isinstance(target, ast.Tuple)):
            return target.elts[0].id, dicts[it.func.value.id]
        return None, [None]

    def visit(node, env):
        if isinstance(node, ast.For):
            var, values = loop_values(node)
            for v in values:
                for child in node.body:
                    visit(child, env if var is None else {**env, var: v})
            return
        found = []
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "emit":
            found.append(node.args[0])
        if isinstance(node, ast.Dict):
            found += [v for k, v in zip(node.keys, node.values)
                      if isinstance(k, ast.Constant) and k.value == "metric"]
        names.extend(n for n in (fill(f, env) for f in found) if n is not None)
        for child in ast.iter_child_nodes(node):
            visit(child, env)

    visit(tree, {})
    return names


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "tests"))
    import numpy as np
    from kats_nist import KATS
    from kats_sage_p256k1 import SAGE_P256K1

    from eccoxide_tpu_torch import field448, oracle
    from eccoxide_tpu_torch.curves import sec2
    from eccoxide_tpu_torch.limbs import windows_from_bytes_le
    from eccoxide_tpu_torch.params.comb import get_weierstrass_comb
    from eccoxide_tpu_torch.curves import ristretto255 as rz
    from eccoxide_tpu_torch.field import FL, FQ, L, P, TIGHT
    from eccoxide_tpu_torch.field_sec2 import field_of
    from eccoxide_tpu_torch.parallel.msm import msm_local, msm_local_prefix
    from eccoxide_tpu_torch.params.comb import mul_base as mul_base_ed
    from eccoxide_tpu_torch.field448 import FQ448
    from eccoxide_tpu_torch.ops import build, group, sha512
    from eccoxide_tpu_torch.protocol import ed25519 as pe
    from eccoxide_tpu_torch.protocol import ed25519_batch as pb
    from eccoxide_tpu_torch.protocol import x448 as px448
    from eccoxide_tpu_torch.protocol import x25519 as px25519

    # the fields of the pow_sec2 instances added with the field API (the
    # curves' scalar fields and l, FL's pow), and every instance's field by
    # instance name
    order_fields = [sec2.get_curve(c).scalar for c in sec2.ALL] + [field_of(L)]
    inst_fields = {build.POW_SEC2_INSTANCES[f.p]: f
                   for f in [sec2.get_curve(c).field for c in sec2.ALL] + order_fields}

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
    libs = {name: built[name] for name in build.KERNEL_SOURCES}
    regs = {}
    for lib in libs.values():
        regs.update(ptxas_report(lib.log))
    want_regs = set(PORT_KERNELS + (PROBE_KERNEL,)) - {"pow_sec2_kernel"} | {
        f"pow_sec2_kernel<{name}>" for name in build.POW_SEC2_INSTANCES.values()}
    spilled = {k: v for k, v in regs.items() if v.get("spill_stores") or v.get("spill_loads")}
    if set(regs) != want_regs:
        raise RuntimeError(f"ptxas report lacks kernels: {regs}")
    sass = sass_counts([lib.path for lib in libs.values()])
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "torch_cuda": torch.version.cuda, "nvcc": nvcc_version,
          "clocks_max_sm_mhz": clock_max_mhz, "clocks_sm_mhz_now": smi("clocks.sm"),
          "build_s": build_s,
          "kernel_build_s": {name: lib.seconds for name, lib in libs.items()},
          "sha512_build_s": built["sha512"].seconds,
          "kernel_libraries": {name: os.path.relpath(lib.path) for name, lib in libs.items()},
          "ptxas": regs,
          "sass_static_opcodes": sass})
    if spilled:
        raise RuntimeError(f"kernels spill: {spilled}")

    # -- the multiply-add rate: the bound of every kernel's operations -------
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    spec_peak = INT32_MAD_PER_CLK_PER_SM * n_sm * clock_max_mhz * 1e6
    mad = mad_rate(dev, n_sm)
    # cuobjdump: the probe's loop is IMAD.WIDE.U32, one per multiply-add
    from eccoxide_tpu_torch.ops import probe
    probe_sass = sass.get(PROBE_KERNEL, {})
    if "not available" not in sass and probe_sass.get("IMAD.WIDE", 0) < probe.CHAINS * probe.UNROLL:
        raise RuntimeError(f"the probe's SASS lacks its IMAD.WIDE chains: {probe_sass}")
    int_peak = min(spec_peak, mad["madds_per_s"])
    bound_rate = "probed IMAD.WIDE.U32" if mad["madds_per_s"] < spec_peak else "spec 32-bit IMAD"
    emit({"phase": "imad_wide_rate", "card": card, **mad, "probe_sass": probe_sass,
          "madds_per_clk_per_sm_at_max_clock": mad["madds_per_s"] / (n_sm * clock_max_mhz * 1e6),
          "clocks_max_sm_mhz": clock_max_mhz, "spec_madds_per_s": spec_peak,
          "bound_madds_per_s": int_peak, "bound_rate": bound_rate})

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

    tight448 = torch.tensor(field448.TIGHT, dtype=torch.int64, device=dev)

    def rand_fe448(W):
        """FQ448 TIGHT limbs, uniformly random per limb."""
        r = torch.randint(0, 1 << 62, (16, W), generator=gen, device=dev)
        return (r % (tight448.view(16, 1) + 1)).to(torch.int32)

    def max_fe448(W):
        return tight448.view(16, 1).expand(16, W).to(torch.int32).contiguous()

    def rand_points(W):
        """Random multiples [k]B (k < 256, k = 0 the identity) in random
        projective coordinates (X, Y, Z, T scaled by one random lambda)."""
        k = torch.randint(0, 256, (W,), generator=gen, device=dev)
        x, y, t = tables.byte[:, :, k]
        lam = rand_fe(W)
        return torch.stack([FQ.mul(x, lam), FQ.mul(y, lam), lam, FQ.mul(t, lam)])

    def rand_affine(W):
        """Random affine multiples [k]B as x|y|t rows (3, 10, W)."""
        return tables.byte[:, :, torch.randint(0, 256, (W,), generator=gen, device=dev)]

    def canon_pt(a):
        return FQ.canon(a.transpose(0, 1)).transpose(0, 1)

    def timed(name, shape, ops, nbytes, k_fn, p_fn):
        """Device ms per launch (graph replay), host us per call and plain
        ms of one case, with its bound for `ops` multiply-adds and
        `nbytes` bytes per lane."""
        W = shape["W"]
        ops_ms = W * ops / int_peak * 1e3
        bytes_ms = W * nbytes / HBM_BYTES_PER_S * 1e3
        row = {"name": name, "shape": shape, "ms": graph_ms(k_fn),
               "host_us_per_call": host_us_per_call(k_fn),
               "plain_ms": events_ms(p_fn, 3),
               "bound_ms": max(ops_ms, bytes_ms),
               "x_bound": None,
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
               "ops_rate": bound_rate,
               "madds_per_lane": ops, "ops_ms": ops_ms, "bytes_ms": bytes_ms}
        row["x_bound"] = row["ms"] / row["bound_ms"]
        torch.cuda.synchronize()
        return row

    def add_case(W, mode="full"):
        p = rand_points(W)
        if mode == "mixed":
            q = rand_affine(W)
            k_fn, p_fn = (lambda: group.ed_add_mixed(p, q)), (lambda: group.ed_add_mixed_plain(p, q))
        else:
            q, need_t = rand_points(W), mode == "full"
            k_fn, p_fn = (lambda: group.ed_add(p, q, need_t)), (lambda: group.ed_add_plain(p, q, need_t))
        return ("ed_add", {"W": W, "mode": mode}, *ADD_COST[mode], k_fn, p_fn)

    checks = {"ed_add": [], "ed_double": [], "pow_const_kernel": [], "pow448_kernel": [],
              "pow_sec2_kernel": []}
    max_err = {name: 0 for name in checks}

    def compare(name, got, want, width, case, canon=None):
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise RuntimeError(f"{name} {case}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
        if canon is not None:
            cg, cw = canon(got), canon(want)
        elif name == "pow_const_kernel":
            cg, cw = FQ.canon(got), FQ.canon(want)
        elif name == "pow448_kernel":
            cg, cw = FQ448.canon(got), FQ448.canon(want)
        else:
            cg, cw = canon_pt(got), canon_pt(want)
        err = int((cg.to(torch.int64) - cw.to(torch.int64)).abs().max()) if cg.numel() else 0
        max_err[name] = max(max_err[name], err)
        checks[name].append({"width": width, "case": case, "canonical_equal": err == 0,
                             "limbs_equal": bool(torch.equal(got, want))})
        if err or not checks[name][-1]["limbs_equal"]:
            raise RuntimeError(f"{name} at width {width} ({case}) differs from its plain version")

    e_sqrt, e_inv = (P - 5) // 8, P - 2
    e_inv448 = field448.P - 2
    ident = pe.ED.identity((1,), dev).xyzt[..., 0]

    def point_inputs(W):
        """p, q and an affine q of W lanes: random multiples, with the
        identity, P + P, P + (-P) and the largest TIGHT limbs in lanes 0..3."""
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
        q_xyt = rand_affine(W)
        if W >= 4:
            q_xyt[:, :, 3] = max_fe(1)[:, 0]
        return p, q, q_xyt

    def field_input(f, W):
        """W lanes of f's limbs, random within the largest limbs f's pow
        kernel takes, with the largest in lane 0 (lane 1 for FQ and FQ448)
        and zero in lane 2 (lane 0)."""
        if f is FQ or f is FQ448:
            x = rand_fe(W) if f is FQ else rand_fe448(W)
            if W >= 3:
                x[:, 0] = 0
                x[:, 1] = (max_fe(1) if f is FQ else max_fe448(1))[:, 0]
            return x
        top = torch.tensor(f.fmt.LARGEST, dtype=torch.int64, device=dev)
        x = (torch.randint(0, 1 << 62, (f.n, W), generator=gen, device=dev)
             % (top.view(-1, 1) + 1)).to(torch.int32)
        if W >= 1:
            x[:, 0] = top.to(torch.int32)
        if W >= 3:
            x[:, 2] = 0
        return x

    pow_plain = {"pow_const_kernel": lambda f, x, e: group.pow_const_plain(x, e),
                 "pow448_kernel": lambda f, x, e: group.pow448_plain(x, e),
                 "pow_sec2_kernel": group.pow_sec2_plain}
    pow_kernel = {"pow_const_kernel": lambda f, x, e: group.pow_const_kernel(x, e),
                  "pow448_kernel": lambda f, x, e: group.pow448_kernel(x, e),
                  "pow_sec2_kernel": group.pow_sec2_kernel}

    def check_shape(name, shape):
        """Kernel `name` against its plain version at one launch shape
        (``group.launch_shapes``), on fresh inputs of that width."""
        if name == "ed_add":
            mode, W = shape
            p, q, q_xyt = point_inputs(W)
            if mode == "mixed":
                got, want = group.ed_add_mixed(p, q_xyt), group.ed_add_mixed_plain(p, q_xyt)
            else:
                got, want = group.ed_add(p, q, mode == "full"), group.ed_add_plain(p, q, mode == "full")
            compare(name, got, want, W, f"path shape {mode}")
        elif name == "ed_double":
            k, need_t, W = shape
            p = point_inputs(W)[0]
            compare(name, group.ed_double(p, need_t, k), group.ed_double_plain(p, need_t, k),
                    W, f"path shape k={k} need_t={need_t}")
        else:
            f, e, W = shape
            x = field_input(f, W)
            compare(name, pow_kernel[name](f, x, e), pow_plain[name](f, x, e), W,
                    f"path shape {getattr(f, 'name', name)} e={e:#x}", f.canon)

    # every launch of this phase is held against the plain version: its
    # shapes are the checked ones, and a path's other shapes are checked
    # after the paths (phase path_shapes_vs_plain)
    group.reset_launches()
    for W in CHECK_WIDTHS + (B, MSM_LEVEL0):
        p, q, q_xyt = point_inputs(W)
        for need_t in (True, False):
            compare("ed_add", group.ed_add(p, q, need_t), group.ed_add_plain(p, q, need_t),
                    W, f"need_t={need_t}")
        compare("ed_add", group.ed_add_mixed(p, q_xyt), group.ed_add_mixed_plain(p, q_xyt),
                W, "mixed")
        for k in (1,) if W == MSM_LEVEL0 else DOUBLE_RUNS:
            for need_t in (True, False):
                compare("ed_double", group.ed_double(p, need_t, k),
                        group.ed_double_plain(p, need_t, k), W, f"k={k} need_t={need_t}")
        if W in CHECK_WIDTHS or W == B:
            x = field_input(FQ, W)
            for e, tag in ((e_sqrt, "(p-5)/8"), (e_inv, "p-2"), (E_SPARSE, hex(E_SPARSE))):
                compare("pow_const_kernel", group.pow_const_kernel(x, e),
                        group.pow_const_plain(x, e), W, f"e={tag}")
            y = field_input(FQ448, W)
            for inp, kind in ((y, "random"), (max_fe448(W), "max limbs")):
                for e, tag in ((e_inv448, "p-2"), (E_SHORT, hex(E_SHORT)), (E_SPARSE, hex(E_SPARSE))):
                    compare("pow448_kernel", group.pow448_kernel(inp, e),
                            group.pow448_plain(inp, e), W, f"{kind} e={tag}")
        torch.cuda.synchronize()
    def pow_sec2_vs_plain(name, f, lanes):
        """The SEC2 pow kernel's instance of f against its plain version:
        one plain call at W = B per exponent, the kernel at each (first
        lane, width) of `lanes` on a slice (lanes are independent); lane 0
        holds the largest limbs the format allows, lane 2 zero."""
        x = field_input(f, B)
        for tag, e in sec2_exponents(f).items():
            want = group.pow_sec2_plain(f, x, e)
            for first, W in lanes:
                compare("pow_sec2_kernel", group.pow_sec2_kernel(f, x[:, first:first + W].contiguous(), e),
                        want[:, first:first + W], W, f"{name} e={tag} lanes {first}..", f.canon)

    for name in sec2.ALL:
        pow_sec2_vs_plain(name, sec2.get_curve(name).field, SEC2_CHECK_LANES)
    checked_shapes = group.launch_shapes()
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
    # negative zero (x = 0 with the sign bit, RFC 8032 5.1.3 step 4) as the
    # key or as R of the identity's equation [0]B = R + [k]A: without the
    # sign bit both triples hold, with it every verifier refuses them
    identity_enc, neg_zero = (1).to_bytes(32, "little"), (1 | 1 << 255).to_bytes(32, "little")
    neg_zero_lanes = {5000: ("A = -0, R = identity, S = 0", neg_zero, identity_enc),
                      6000: ("A = identity, R = -0, S = 0", identity_enc, neg_zero)}

    def put_neg_zero(pks_, sigs_):
        for i, (_, a_enc, r_enc) in neg_zero_lanes.items():
            pks_[i], sigs_[i] = a_enc, r_enc + bytes(32)

    put_neg_zero(t_pks, t_sigs)
    bad.update({i: v[0] for i, v in neg_zero_lanes.items()})
    oracle_bad = [oracle.verify(t_pks[i], t_msgs[i], t_sigs[i]) for i in bad]
    oracle_good = [oracle.verify(pks[i], msgs[i], sigs[i]) for i in range(16)]
    plain_zero = oracle.verify(identity_enc, msgs[0], identity_enc + bytes(32))
    if any(oracle_bad) or not all(oracle_good) or not plain_zero:
        raise RuntimeError("the integer oracle disagrees with the vectors")

    # -- phases 3 and 4: the main path, with launches counted ----------------
    path_shapes = {k: set() for k in checked_shapes}

    def note_path_shapes():
        for k, v in group.launch_shapes().items():
            path_shapes[k] |= v

    group.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    straus = pe.verify_host(t_pks, t_msgs, t_sigs, device="cuda", tables=tables)
    torch.cuda.synchronize()
    straus_s = time.perf_counter() - t0
    straus_launches = group.launches()
    straus_add_modes = dict(group.ed_add.launches_by_mode)
    expected = [i not in bad for i in range(B)]
    if len(straus) != B or straus != expected:
        wrong = [i for i in range(B) if straus[i] != expected[i]][:10]
        raise RuntimeError(f"verify_host wrong at lanes {wrong}")
    emit({"phase": "straus_verify_host", "B": B, "accepted": sum(straus),
          "rejected_lanes": {str(i): bad[i] for i in bad if not straus[i]},
          "vectors_s": vectors_s, "first_call_s": straus_s, "launches": straus_launches,
          "ed_add_launches_by_mode": straus_add_modes})
    if straus_launches["ed_double"] != 64:
        raise RuntimeError(f"Straus ran {straus_launches['ed_double']} doubling launches, not 64")
    if straus_launches["ed_add"] != 110 or straus_add_modes != STRAUS_ADDS:
        raise RuntimeError(f"Straus ran {straus_launches['ed_add']} add launches "
                           f"{straus_add_modes}, not 110 {STRAUS_ADDS}")

    before = group.launches()
    t0 = time.perf_counter()
    rlc_ok = pb.verify_batch_host(pks, msgs, sigs, rng=np.random.default_rng(7),
                                  device="cuda", tables=tables)
    torch.cuda.synchronize()
    rlc_s = time.perf_counter() - t0
    after_valid = group.launches()
    forged = 12345
    f_pks, f_sigs = list(pks), list(sigs)
    f_sigs[forged] = flip_s(sigs[forged])
    put_neg_zero(f_pks, f_sigs)
    rlc_forged = pb.verify_batch_host(f_pks, msgs, f_sigs, rng=np.random.default_rng(8),
                                      device="cuda", tables=tables)
    torch.cuda.synchronize()
    counts = group.launches()
    note_path_shapes()
    if rlc_ok != [True] * B:
        raise RuntimeError("verify_batch_host rejected a valid batch")
    # the valid batch must pass on the RLC equation alone: two decompressions,
    # no per-signature fallback
    if after_valid["pow_const_kernel"] - before["pow_const_kernel"] != 2:
        raise RuntimeError("the valid batch fell back to the per-signature verifier")
    if after_valid["ed_double"] - before["ed_double"] != 33:
        raise RuntimeError("the valid batch did not run 33 doubling launches")
    if [i for i in range(B) if not rlc_forged[i]] != sorted([forged, *neg_zero_lanes]):
        raise RuntimeError("verify_batch_host did not isolate exactly the forged and "
                           "negative-zero lanes")
    emit({"phase": "rlc_verify_batch_host", "B": B, "msm_c": 8,
          "valid_batch_accepted": True, "forged_lane": forged,
          "negative_zero_lanes": {str(i): v[0] for i, v in neg_zero_lanes.items()},
          "rejected_lanes": [i for i in range(B) if not rlc_forged[i]],
          "first_call_s": rlc_s,
          "launches_valid_batch": {k: after_valid[k] - before[k] for k in counts}})
    verify_counts = {k: counts[k] for k in ("pow_const_kernel", "ed_add", "ed_double")}
    if min(verify_counts.values()) <= 0 or counts["pow448_kernel"]:
        raise RuntimeError(f"a kernel of the verify paths never launched: {counts}")
    path_counts = {"verify": verify_counts}

    def counted(path, fn, want, add_mode="mixed"):
        """fn() with the launch counts set to 0 just before and read just
        after; they must equal `want` (kernel -> launches, the others 0),
        every add in `add_mode` (or as many of each mode as a dict says)."""
        group.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = group.launches()
        note_path_shapes()
        full = {k: want.get(k, 0) for k in got}
        if got != full:
            raise RuntimeError(f"{path} launched {got}, not {full}")
        modes = add_mode if isinstance(add_mode, dict) else {add_mode: want.get("ed_add", 0)}
        if want.get("ed_add") and {m: group.ed_add.launches_by_mode[m] for m in modes} != modes:
            raise RuntimeError(f"{path}: adds {group.ed_add.launches_by_mode}, not {modes}")
        path_counts[path] = got
        return out, secs

    # -- phase 5: key generation and signing, every signature verified -------
    sign_tables = pe.SignTables(dev)
    rng = np.random.default_rng(4321)
    sign_sks = [rng.bytes(32) for _ in range(B)]
    sign_msgs = [rng.bytes(32) for _ in range(B)]
    sign_pks, keygen_s = counted("keygen", lambda: pe.public_keys_host(sign_sks, dev, sign_tables),
                                 {"ed_add": PUBKEY_ADDS, "pow_const_kernel": 1})
    signed, sign_s = counted("sign", lambda: pe.sign_host(sign_sks, sign_msgs, dev, sign_tables),
                             {"ed_add": 2 * PUBKEY_ADDS, "pow_const_kernel": 2})
    lanes = [0, B - 1] + sorted(rng.choice(np.arange(1, B - 1), ORACLE_LANES - 2, replace=False).tolist())
    for i in lanes:
        if (sign_pks[i], signed[i]) != (oracle.public_key(sign_sks[i]),
                                        oracle.sign(sign_sks[i], sign_msgs[i])):
            raise RuntimeError(f"sign_host lane {i} differs from the oracle")
    all_ok = pe.verify_host(sign_pks, sign_msgs, signed, device=dev, tables=tables)
    t_signed = list(signed)
    t_signed[777] = flip_s(signed[777])
    one_bad = pe.verify_host(sign_pks, sign_msgs, t_signed, device=dev, tables=tables)
    if all_ok != [True] * B or [i for i in range(B) if not one_bad[i]] != [777]:
        raise RuntimeError("verify_host does not take every signature of sign_host "
                           "and refuse exactly the tampered one")
    emit({"phase": "sign", "B": B, "oracle_lanes": len(lanes), "verified": sum(all_ok),
          "tampered_lane_rejected": 777, "public_keys_host_first_call_s": keygen_s,
          "sign_host_first_call_s": sign_s,
          "launches": {"public_keys_host": path_counts["keygen"],
                       "sign_host": path_counts["sign"]}})

    # -- phases 6 and 7: X25519 and X448, both ways, vectors in fixed lanes ---
    def to_cols(rows_):
        return torch.from_numpy(np.array([list(r) for r in rows_], np.int32).T.copy()).to(dev)

    def ladder_phase(name, mod, n, oracle_fn, vec, low_order, pow_kernel):
        """Scalars a, b at B; lane 0 is the RFC 7748 exchange (a, b its
        secrets), lanes 1 and 2 the section 5.2 vectors (a's scalar and the
        u a is given), lanes 3.. the low-order u; every other lane an
        exchange. Each call is counted: one pow of the field."""
        fn, base = getattr(mod, name), getattr(mod, name + "_base")
        rng_ = np.random.default_rng(len(name))
        a = torch.from_numpy(rng_.integers(0, 256, (n, B), dtype=np.int32)).to(dev)
        b = torch.from_numpy(rng_.integers(0, 256, (n, B), dtype=np.int32)).to(dev)
        fixed = [vec["v1"][1], vec["v2"][1]] + low_order       # the u of lanes 1..
        a[:, 0], b[:, 0] = to_cols([vec["a_priv"]])[:, 0], to_cols([vec["b_priv"]])[:, 0]
        a[:, 1], a[:, 2] = to_cols([vec["v1"][0]])[:, 0], to_cols([vec["v2"][0]])[:, 0]
        if "it1_k" in vec:                      # a lane of the exchange: base(9)
            a[:, len(fixed) + 1] = to_cols([vec["it1_k"]])[:, 0]
        want = {pow_kernel: 1}
        pub_a, base_s = counted(f"{name}_base(a)", lambda: base(a), want)
        pub_b, _ = counted(f"{name}_base(b)", lambda: base(b), want)
        u_for_a = pub_b.clone()
        u_for_a[:, 1:len(fixed) + 1] = to_cols(fixed)
        s_ab, exch_s = counted(f"{name}(a)", lambda: fn(a, u_for_a), want)
        s_ba, _ = counted(f"{name}(b)", lambda: fn(b, pub_a), want)
        rows = {k: pe.rows(v) for k, v in (("pub_a", pub_a), ("pub_b", pub_b),
                                           ("s_ab", s_ab), ("s_ba", s_ba))}
        n_fixed = len(fixed) + 1
        agree = sum(rows["s_ab"][j] == rows["s_ba"][j] for j in range(n_fixed, B))
        if agree != B - n_fixed:
            raise RuntimeError(f"{name}: {B - n_fixed - agree} exchanges disagree")
        vectors_ok = (rows["pub_a"][0] == vec["a_pub"] and rows["pub_b"][0] == vec["b_pub"]
                      and rows["s_ab"][0] == vec["shared"] == rows["s_ba"][0]
                      and rows["s_ab"][1] == vec["v1"][2] and rows["s_ab"][2] == vec["v2"][2])
        if "it1_k" in vec:
            vectors_ok &= rows["pub_a"][len(fixed) + 1] == vec["it1_out"]
        contributory = mod.was_contributory(s_ab).cpu().tolist()
        zero = bytes(n)
        low_ok = all(rows["s_ab"][j] == zero and not contributory[j]
                     for j in range(3, n_fixed)) and all(contributory[n_fixed:])
        if not vectors_ok or not low_ok:
            raise RuntimeError(f"{name}: RFC 7748 vectors {vectors_ok}, low-order u {low_ok}")
        a_rows, u_rows = pe.rows(a), pe.rows(u_for_a)
        lanes_ = [0, B - 1] + sorted(rng_.choice(np.arange(1, B - 1), ORACLE_LANES - 2, replace=False).tolist())
        gen_u = (9 if n == 32 else 5).to_bytes(n, "little")
        for j in lanes_:
            if (rows["s_ab"][j], rows["pub_a"][j]) != (oracle_fn(a_rows[j], u_rows[j]),
                                                       oracle_fn(a_rows[j], gen_u)):
                raise RuntimeError(f"{name} lane {j} differs from the oracle")
        emit({"phase": name, "B": B, "exchanges_agreeing": agree, "fixed_lanes": n_fixed,
              "rfc7748_vectors": vectors_ok, "low_order_zero_and_not_contributory": low_ok,
              "oracle_lanes": len(lanes_), "base_first_call_s": base_s,
              "exchange_first_call_s": exch_s,
              "launches_per_call": {k: v for k, v in path_counts[f"{name}(a)"].items() if v}})
        return a, u_for_a

    x25519_in = ladder_phase("x25519", px25519, 32, oracle.x25519, X25519_VECTORS,
                             X25519_LOW_ORDER, "pow_const_kernel")
    x448_in = ladder_phase("x448", px448, 56, oracle.x448, X448_VECTORS,
                           X448_LOW_ORDER, "pow448_kernel")

    # -- phases 8 and 9: the SEC2 curves ----------------------------------------
    def scalar_cols(spec, ks):
        """(scalar n_bytes, B) LE byte columns of ints ks, on the card."""
        nb = spec.scalar.n_bytes
        raw = np.frombuffer(b"".join(k.to_bytes(nb, "little") for k in ks), np.uint8)
        return torch.from_numpy(raw.reshape(len(ks), nb).T.astype(np.int32)).to(dev)

    def windows_from(spec, sb):
        return windows_from_bytes_le(sb, -(-spec.scalar.bits // 4))

    def distinct_scalars(o, n, rng_):
        ks = list(dict.fromkeys(int.from_bytes(rng_.bytes(o.n_bytes + 8), "big") % (o.order - 1) + 1
                                for _ in range(n + 16)))[:n]
        if len(ks) != n:
            raise RuntimeError("scalars are not distinct")
        return ks

    def col_rows(t):
        return [bytes(r) for r in t.T.cpu().tolist()]

    sec2_kats = {"p256r1": [(int(k, 16), (int(x, 16), int(y, 16))) for k, x, y in KATS["p256r1"]],
                 "p256k1": [(k, (int(x, 16), int(y, 16))) for k, x, y in SAGE_P256K1]}
    sec2_times, sec2_cores = {}, {}

    def sec2_full_width(name):
        """Key generation (mul_base, compress) and ECDH both ways (decompress
        of the peer's key, CT scalar_mul, to_affine, x big-endian) at B.
        Lane 0 and lanes 4.. of a hold the KAT scalars; the key a is given
        in lanes 1, 2, 3 is x = p, an x off the curve, and tag 4."""
        spec, o = sec2.get_curve(name), oracle.sec2_curve(name)
        f, nb = spec.field, spec.field.n_bytes
        rng_ = np.random.default_rng(len(name) * 1000 + 256)
        kats = sec2_kats[name]
        ka, kb = distinct_scalars(o, B, rng_), distinct_scalars(o, B, rng_)
        kat_lanes = [0] + list(range(4, 4 + len(kats) - 1))
        for j, (k, _) in zip(kat_lanes, kats):
            ka[j] = k
        sa, sb_ = scalar_cols(spec, ka), scalar_cols(spec, kb)
        wa, wb = windows_from(spec, sa), windows_from(spec, sb_)
        tables = get_weierstrass_comb(spec).tables(dev)

        def keygen(sc):
            return spec.compress(spec.mul_base(sc, tables))

        def exchange(wins, peer):
            Q, ok = spec.decompress(peer)
            sx, _ = spec.to_affine(spec.scalar_mul(Q, wins))
            return f.to_bytes_be(sx), ok

        pub_a, keygen_s = counted(f"{name}_keygen(a)", lambda: keygen(sa), {"pow_sec2_kernel": 1})
        pub_b, _ = counted(f"{name}_keygen(b)", lambda: keygen(sb_), {"pow_sec2_kernel": 1})
        x_off = next(x for x in range(2, 1000)
                     if o.decompress(bytes([2]) + x.to_bytes(nb, "big")) is None)
        bad = {1: bytes([2]) + o.p.to_bytes(nb, "big"), 2: bytes([2]) + x_off.to_bytes(nb, "big"),
               3: bytes([4]) + col_rows(pub_b[:, 3:4])[0][1:]}
        peer_for_a = pub_b.clone()
        for j, enc in bad.items():
            peer_for_a[:, j] = torch.tensor(list(enc), dtype=torch.int32, device=dev)
        (s_ab, ok_ab), exch_s = counted(f"{name}_ecdh(a)", lambda: exchange(wa, peer_for_a),
                                        {"pow_sec2_kernel": 2})
        (s_ba, ok_ba), _ = counted(f"{name}_ecdh(b)", lambda: exchange(wb, pub_a),
                                   {"pow_sec2_kernel": 2})
        ok_ab, ok_ba = ok_ab.cpu().tolist(), ok_ba.cpu().tolist()
        if [j for j in range(B) if not ok_ab[j]] != sorted(bad) or not all(ok_ba):
            raise RuntimeError(f"{name}: decompress accepted a bad key or refused a good one")
        rows = {"pub_a": col_rows(pub_a), "pub_b": col_rows(pub_b),
                "s_ab": col_rows(s_ab), "s_ba": col_rows(s_ba)}
        agree = sum(rows["s_ab"][j] == rows["s_ba"][j] for j in range(B) if j not in bad)
        if agree != B - len(bad):
            raise RuntimeError(f"{name}: {B - len(bad) - agree} exchanges disagree")
        kat_ok = all(rows["pub_a"][j] == o.compress(pt) for j, (_, pt) in zip(kat_lanes, kats))
        lanes_ = [0, B - 1] + sorted(rng_.choice(np.arange(4, B - 1), ORACLE_LANES - 2,
                                                 replace=False).tolist())
        for j in lanes_:
            shared = o.mul(ka[j], o.mul_base(kb[j]))[0].to_bytes(nb, "big")
            if (rows["pub_a"][j], rows["pub_b"][j], rows["s_ab"][j]) != (
                    o.compress(o.mul_base(ka[j])), o.compress(o.mul_base(kb[j])), shared):
                raise RuntimeError(f"{name} lane {j} differs from the oracle")
        if not kat_ok:
            raise RuntimeError(f"{name}: a KAT lane differs")
        sec2_cores[name] = {"keygen": lambda: keygen(sa), "exchange": lambda: exchange(wb, pub_a)}
        keygen_runs = host_rate(sec2_cores[name]["keygen"])
        exchange_runs = host_rate(sec2_cores[name]["exchange"])
        sec2_times[name] = {"keygen_s": keygen_runs, "keygens_per_s": B / statistics.median(keygen_runs),
                            "exchange_s": exchange_runs,
                            "exchanges_per_s": B / statistics.median(exchange_runs)}
        emit({"phase": f"sec2_{name}", "B": B, "shape": spec.shape, "limbs": f.n,
              "exchanges_agreeing": agree, "bad_keys_rejected": {str(j): "x = p" if j == 1 else
                                                                 "x off the curve" if j == 2 else "tag 4"
                                                                 for j in bad},
              "kat_lanes": len(kats), "kats_ok": kat_ok, "oracle_lanes": len(lanes_),
              "keygen_first_call_s": keygen_s, "exchange_first_call_s": exch_s,
              "launches_per_call": {"keygen": path_counts[f"{name}_keygen(a)"]["pow_sec2_kernel"],
                                    "exchange": path_counts[f"{name}_ecdh(a)"]["pow_sec2_kernel"]},
              **sec2_times[name]})

    def host_rate(fn, reps=3):
        """Host clock around whole calls of fn, each ending in synchronize."""
        runs = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        return runs

    for name in ("p256r1", "p256k1"):
        sec2_full_width(name)

    others = [n for n in sec2.ALL if n not in ("p256r1", "p256k1")]
    small = {}
    for name in others:
        spec, o = sec2.get_curve(name), oracle.sec2_curve(name)
        f = spec.field
        rng_ = np.random.default_rng(len(name) * 7 + SEC2_PATH_B)
        ks = distinct_scalars(o, SEC2_PATH_B, rng_)
        ks[:3] = [1, 2, o.order - 1]
        sb_ = scalar_cols(spec, ks)
        G = spec.generator((SEC2_PATH_B,), dev)
        P, _ = counted(f"{name}_scalar_mul", lambda: spec.scalar_mul(G, windows_from(spec, sb_)), {})
        C, _ = counted(f"{name}_mul_base", lambda: spec.mul_base(sb_), {})
        by, _ = counted(f"{name}_compress", lambda: spec.compress(P), {"pow_sec2_kernel": 1})
        n_sqrt_pows = 2 if f.sqrt_kind == "tonelli" else 1
        (Q, ok), _ = counted(f"{name}_decompress", lambda: spec.decompress(by),
                             {"pow_sec2_kernel": n_sqrt_pows})
        rows = col_rows(by)
        lanes_ = list(range(3)) + sorted(rng_.choice(np.arange(3, SEC2_PATH_B), SEC2_ORACLE_LANES - 3,
                                                     replace=False).tolist())
        oracle_ok = all(rows[j] == o.compress(o.mul_base(ks[j])) for j in lanes_)
        same = bool(spec.eq(C, P).all()) and bool(ok.all()) and bool(spec.eq(Q, P).all())
        if not (oracle_ok and same):
            raise RuntimeError(f"{name}: oracle lanes {oracle_ok}, comb = CT = decompress(compress) {same}")
        small[name] = {"shape": spec.shape, "limbs": f.n, "sqrt": f.sqrt_kind,
                       "decompress_pows": n_sqrt_pows}
    emit({"phase": "sec2_other_curves", "B": SEC2_PATH_B, "oracle_lanes": SEC2_ORACLE_LANES,
          "checks": "scalar_mul and compress vs oracle; mul_base == scalar_mul; "
                    "decompress(compress(P)) == P, all lanes valid",
          "curves": small})

    # -- phase 10: ristretto255 at B ----------------------------------------------
    from kats_rfc9496 import A1_MULTIPLES, A2_BAD, A3_UNIFORM

    def byte_cols(rows_, width):
        raw = np.frombuffer(b"".join(rows_), np.uint8).reshape(len(rows_), width)
        return torch.from_numpy(raw.T.astype(np.int32)).to(dev)

    def int_cols(ks, width):
        return byte_cols([k.to_bytes(width, "little") for k in ks], width)

    rng_ = np.random.default_rng(9496)
    a1 = [bytes.fromhex(h) for h in A1_MULTIPLES]
    a2 = [bytes.fromhex(h) for h in A2_BAD]
    a3 = [(bytes.fromhex(i), bytes.fromhex(o)) for i, o in A3_UNIFORM]
    oracle_lanes = [0, B - 1] + sorted(rng_.choice(np.arange(40, B - 1), ORACLE_LANES - 2,
                                                   replace=False).tolist())
    # mul_base: lanes 0..15 the A.1 multiples, then random scalars below l
    r_ks = list(range(16)) + [int.from_bytes(rng_.bytes(40), "little") % L for _ in range(B - 16)]
    r_sb = int_cols(r_ks, 32)
    r_pts, _ = counted("ristretto_mul_base", lambda: rz.mul_base(r_sb), {"ed_add": PUBKEY_ADDS})
    r_enc, _ = counted("ristretto_compress", lambda: rz.compress(r_pts), {"pow_const_kernel": 1})
    enc_rows = col_rows(r_enc)
    a1_ok = enc_rows[:16] == a1
    enc_oracle_ok = all(enc_rows[j] == oracle.ristretto_compress(oracle.ristretto_mul(r_ks[j]))
                        for j in oracle_lanes)
    # decompress: oracle encodings of R_DISTINCT multiples tiled over B, the
    # A.1 encodings in lanes 0..15 and the A.2 ones in lanes 16..32
    r_distinct = [oracle.ristretto_compress(oracle.ristretto_mul(
        int.from_bytes(rng_.bytes(40), "little") % L)) for _ in range(R_DISTINCT)]
    dec_in = [r_distinct[j % R_DISTINCT] for j in range(B)]
    dec_in[:16] = a1
    dec_in[16:16 + len(a2)] = a2
    dec_cols = byte_cols(dec_in, 32)
    (r_dec, r_ok), _ = counted("ristretto_decompress", lambda: rz.decompress(dec_cols),
                               {"pow_const_kernel": 1})
    r_ok = r_ok.cpu().tolist()
    bad_lanes = set(range(16, 16 + len(a2)))
    rejected_ok = [j for j in range(B) if not r_ok[j]] == sorted(bad_lanes)
    good = torch.tensor([j not in bad_lanes for j in range(B)], device=dev)
    round_trip = bool(((rz.compress(r_dec) == dec_cols) | ~good).all())
    # from_uniform_bytes: the A.3 inputs in lanes 0..6, random elsewhere
    u_in = [rng_.bytes(64) for _ in range(B)]
    u_in[:len(a3)] = [i for i, _ in a3]
    u_cols = byte_cols(u_in, 64)
    r_map, _ = counted("ristretto_from_uniform_bytes", lambda: rz.from_uniform_bytes(u_cols),
                       {"pow_const_kernel": 1, "ed_add": 1}, add_mode="full")
    map_rows = col_rows(rz.compress(r_map))
    a3_ok = map_rows[:len(a3)] == [o for _, o in a3]
    map_oracle_ok = all(map_rows[j] == oracle.ristretto_compress(
        oracle.ristretto_from_uniform_bytes(u_in[j])) for j in oracle_lanes)
    if not (a1_ok and enc_oracle_ok and rejected_ok and round_trip and a3_ok and map_oracle_ok):
        raise RuntimeError(f"ristretto255: A.1 {a1_ok}, oracle encodings {enc_oracle_ok}, "
                           f"A.2 rejected alone {rejected_ok}, round trip {round_trip}, "
                           f"A.3 {a3_ok}, oracle maps {map_oracle_ok}")
    ristretto_cores = {"ristretto_decompress": lambda: rz.decompress(dec_cols),
                       "ristretto_compress": lambda: rz.compress(r_pts),
                       "ristretto_from_uniform_bytes": lambda: rz.from_uniform_bytes(u_cols)}
    r_runs = {name: host_rate(fn) for name, fn in ristretto_cores.items()}
    emit({"phase": "ristretto255", "B": B, "a1_multiples": a1_ok, "a2_rejected_alone": rejected_ok,
          "a3_map": a3_ok, "compress_decompress_round_trip": round_trip,
          "oracle_lanes": len(oracle_lanes), "distinct_oracle_encodings": R_DISTINCT,
          "launches_per_call": {p_: {k: v for k, v in path_counts[p_].items() if v}
                                for p_ in ("ristretto_mul_base", "ristretto_compress",
                                           "ristretto_decompress", "ristretto_from_uniform_bytes")},
          "decompress_s": r_runs["ristretto_decompress"],
          "decodes_per_s": B / statistics.median(r_runs["ristretto_decompress"]),
          "compress_s": r_runs["ristretto_compress"],
          "encodes_per_s": B / statistics.median(r_runs["ristretto_compress"]),
          "from_uniform_bytes_s": r_runs["ristretto_from_uniform_bytes"],
          "maps_per_s": B / statistics.median(r_runs["ristretto_from_uniform_bytes"])})

    # -- phase 11: the JAX Field API on the port's fields ---------------------------
    # values: random wide bytes reduced by from_wide_bytes_le, lanes 0..2 hold
    # 0, 1 and p - 1; FIELD_API_LANES lanes against Python ints
    api_fields = {"FL": (FL, "pow_sec2_kernel"), "FQ": (FQ, "pow_const_kernel"),
                  "FQ448": (FQ448, "pow448_kernel"),
                  **{f.name: (f, "pow_sec2_kernel") for f in order_fields[:-1]}}
    api_ops = {"FL": ("inverse", "sqrt", "is_square"), "FQ": ("sqrt", "is_square"),
               "FQ448": ("sqrt", "is_square"), **{f.name: ("inverse", "sqrt") for f in order_fields[:-1]}}
    api_lanes = [0, 1, 2, B - 1] + sorted(rng_.choice(np.arange(3, B - 1), FIELD_API_LANES - 4,
                                                      replace=False).tolist())
    api_out, api_pows = {}, {}
    for fname, (f, kernel) in api_fields.items():
        wide = torch.from_numpy(rng_.integers(0, 256, (2 * f.n_bytes, B), dtype=np.int32)).to(dev)
        x = f.from_wide_bytes_le(wide)
        x[:, :3] = f.encode_ints([0, 1, f.p - 1], dev)
        want_x = [int.from_bytes(bytes(c), "little") % f.p for c in wide[:, api_lanes].T.cpu().tolist()]
        want_x[:3] = [0, 1, f.p - 1]
        xs = f.decode_ints(x[:, api_lanes])
        if xs != want_x:
            raise RuntimeError(f"{fname}: from_wide_bytes_le differs from Python ints")
        p_ = f.p
        sq = f.square(x)
        res = {}
        for op in api_ops[fname]:
            arg = x if op == "inverse" else sq
            n_pow = 2 if op == "sqrt" and p_ % 8 == 1 else 1
            res[op], _ = counted(f"{fname}_{op}", lambda: getattr(f, op)(arg), {kernel: n_pow})
            api_pows[f"{fname}_{op}"] = n_pow
        ok = True
        if "inverse" in res:
            ok &= f.decode_ints(res["inverse"][:, api_lanes]) == [pow(v, p_ - 2, p_) for v in xs]
        if "sqrt" in res:
            r, r_ok = res["sqrt"]
            ok &= bool(r_ok.all()) and bool(f.eq(f.square(r), sq).all())
            ok &= all(v * v % p_ == w * w % p_ for v, w in zip(f.decode_ints(r[:, api_lanes]), xs))
            _, nr_ok = f.sqrt(x)
            euler = [v == 0 or pow(v, (p_ - 1) // 2, p_) == 1 for v in xs]
            ok &= nr_ok[api_lanes].cpu().tolist() == euler
        if "is_square" in res:
            # is_square of the squares (the counted call), then of x
            ok &= bool(res["is_square"].all())
            ok &= f.is_square(x)[api_lanes].cpu().tolist() == [
                v == 0 or pow(v, (p_ - 1) // 2, p_) == 1 for v in xs]
        if fname in BINGCD_FIELDS:
            xb = x[:, :BINGCD_LANES]
            ok &= f.decode_ints(f.inverse_bingcd(xb)) == f.decode_ints(f.inverse(xb))
        if not ok:
            raise RuntimeError(f"{fname}: the Field API differs from Python ints")
        api_out[fname] = {"ops": list(api_ops[fname]), "limbs": f.n, "bingcd": fname in BINGCD_FIELDS}
    # the pow kernel's instances of the group orders and of l, limb for limb
    group.reset_launches()
    for f in order_fields:
        pow_sec2_vs_plain(f.name, f, ORDER_CHECK_LANES)
    for k, v in group.launch_shapes().items():
        checked_shapes[k] |= v
    emit({"phase": "field_api", "B": B, "oracle_lanes": FIELD_API_LANES,
          "bingcd_lanes": BINGCD_LANES, "fields": api_out, "pows_per_call": api_pows,
          "order_instances_vs_plain": len(order_fields),
          "pow_sec2_checks": len(checks["pow_sec2_kernel"]),
          "pow_sec2_max_abs_err": max_err["pow_sec2_kernel"]})

    # -- phase 12: msm_local over edwards25519 and P-256 ----------------------------
    def msm_launches(B_, nbytes, c):
        """ed_add and ed_double launches of msm_local on edwards25519: the
        Blelloch sweeps (2 log2 B2), the (2^c - 1) total (a run of c
        doublings and 1 add), the halving tree over 2^c - 1 partial sums, 1
        add, then per window one run of c doublings and one add."""
        nw = -(-nbytes * 8 // c)
        nlev = max(0, (B_ - 1).bit_length())
        tree, size = 0, (1 << c) - 1
        while size > 1:
            size, tree = size // 2 + size % 2, tree + 1
        return {"ed_add": 2 * nlev + 1 + tree + 1 + nw, "ed_double": 1 + nw}

    msm_rates, msm_cores, msm_out, msm_inputs = {}, {}, {}, {}
    for cname in ("edwards25519", "p256r1"):
        if cname == "edwards25519":
            grp, order, nb = pe.ED, L, 32
            a = [int.from_bytes(rng_.bytes(40), "little") % (L - 1) + 1 for _ in range(B)]
            pts = mul_base_ed(int_cols(a, 32), sign_tables.comb)
            want = msm_launches(B, nb, MSM_C)
        else:
            grp, o = sec2.get_curve(cname), oracle.sec2_curve(cname)
            order, nb = o.order, grp.scalar.n_bytes
            a = distinct_scalars(o, B, rng_)
            pts = grp.mul_base(int_cols(a, nb), get_weierstrass_comb(grp).tables(dev))
            want = {}
        s_ = [int.from_bytes(rng_.bytes(nb), "little") for _ in range(B)]
        s_[1] = 0
        s_cols = int_cols(s_, nb)
        out, _ = counted(f"msm_local_{cname}", lambda: msm_local(grp, pts, s_cols, c=MSM_C), want,
                         add_mode="full")
        k = sum(si * ai for si, ai in zip(s_, a)) % order
        if cname == "edwards25519":
            got = col_rows(grp.compress(out))[0]
            exp = oracle._compress(oracle._mul(k, oracle.G))
        else:
            got = col_rows(grp.compress(out))[0]
            exp = o.compress(o.mul_base(k))
        if got != exp:
            raise RuntimeError(f"msm_local on {cname} differs from the oracle")
        msm_inputs[cname] = (grp, pts, s_cols, got)
        msm_cores[f"msm_local_{cname}"] = (lambda g_=grp, p2=pts, sc=s_cols:
                                           msm_local(g_, p2, sc, c=MSM_C))
        runs = host_rate(msm_cores[f"msm_local_{cname}"])
        msm_rates[cname] = {"msm_s": runs, "points_per_s": B / statistics.median(runs)}
        msm_out[cname] = {"launches": {k_: v for k_, v in path_counts[f"msm_local_{cname}"].items() if v}}
    emit({"phase": "msm_local", "B": B, "c": MSM_C,
          "check": "compress(sum_i [s_i][a_i]G) == oracle compress([sum_i s_i a_i mod n]G)",
          "curves": msm_out, **msm_rates})

    # -- phase 13: the sharded layer in an NCCL world of one --------------------
    # The card's machine has one H100, and NCCL takes one card a rank
    # ("Duplicate GPU detected" for two ranks on one), so the world is one
    # rank in this process; worlds of 2 and 4 run on gloo in the CPU tests.
    # The sharded verify runs Straus's launches on the whole batch, the
    # sharded MSM msm_local's and one add of width nw (the D = 1 gathered
    # window sums added to the identity, as JAX adds them), the example MSM
    # one pow (its to_affine).
    import tempfile

    import torch.distributed as dist
    from eccoxide_tpu_torch import entry
    from eccoxide_tpu_torch.parallel import world
    from eccoxide_tpu_torch.parallel.batch_verify import make_sharded_verify, shard_batch
    from eccoxide_tpu_torch.parallel.msm import make_sharded_msm, msm_sharded_example

    rendezvous = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    wdev = world.init_world(0, 1, "cuda", "file://" + os.path.join(rendezvous.name, "rendezvous"))
    nccl_init_s = time.perf_counter() - t0
    backend = dist.get_backend()
    # the Straus phase's batch, lane 3's S flipped
    sh_sigs = list(sigs)
    sh_sigs[3] = flip_s(sigs[3])
    sh_inputs = pe.host_inputs(pks, msgs, sh_sigs, wdev)
    sh_cols = [shard_batch(a) for a in sh_inputs]
    sharded_verify = make_sharded_verify(wdev)
    (sh_ok, sh_count), _ = counted(
        "sharded_verify", lambda: sharded_verify(*sh_cols),
        {"ed_add": sum(STRAUS_ADDS.values()), "ed_double": 64, "pow_const_kernel": 2},
        add_mode=STRAUS_ADDS)
    if int(sh_count) != B - 1 or bool(sh_ok[3]) or not torch.equal(
            sh_ok, pe.verify_core(*sh_inputs, tables)):
        raise RuntimeError(f"sharded verify: count {int(sh_count)} of {B}, or its mask "
                           "differs from verify_core")
    grp_e, pts_e, s_cols_e, local_e = msm_inputs["edwards25519"]
    sharded_msm = make_sharded_msm(grp_e, c=MSM_C)
    pts_sh, s_sh = type(pts_e)(shard_batch(pts_e.coords)), shard_batch(s_cols_e)
    want_msm = msm_launches(B, 32, MSM_C)
    sh_msm, _ = counted("sharded_msm", lambda: sharded_msm(pts_sh, s_sh),
                        {"ed_add": want_msm["ed_add"] + 1, "ed_double": want_msm["ed_double"]},
                        add_mode="full")
    if col_rows(grp_e.compress(sh_msm))[0] != local_e:
        raise RuntimeError("sharded MSM differs from msm_local and the oracle")
    example_ok, _ = counted("msm_sharded_example", lambda: msm_sharded_example(wdev),
                            {"pow_sec2_kernel": 1})
    # the dry run's ranks are new processes: they load the kernel libraries
    # built above, and rebuild none
    libs_before = {q.name: q.stat().st_mtime_ns for q in build.BUILD_DIR.glob("*.so")}
    t0 = time.perf_counter()
    n_cards = torch.cuda.device_count()
    dry = entry.dryrun_multichip(n_cards, "cuda")
    dryrun_s = time.perf_counter() - t0
    if dry != {"counts": [2 * n_cards] * n_cards, "msm": True}:
        raise RuntimeError(f"dryrun_multichip: {dry}")
    if {q.name: q.stat().st_mtime_ns for q in build.BUILD_DIR.glob("*.so")} != libs_before:
        raise RuntimeError("the dry run's ranks rebuilt kernel libraries")

    def in_turns(fns, reps=3):
        """host_rate of each of fns, one call at a time, in turns: a, b,
        b, a, a, b."""
        runs = [[] for _ in fns]
        for i in range(reps):
            order = list(enumerate(fns))
            for j, fn in (order if i % 2 == 0 else order[::-1]):
                runs[j] += host_rate(fn, 1)
        return runs

    sh_times = dict(zip(("sharded_verify_s", "verify_core_s"), in_turns(
        [lambda: sharded_verify(*sh_cols), lambda: pe.verify_core(*sh_inputs, tables)])))
    sh_times.update(zip(("sharded_msm_s", "msm_local_s"), in_turns(
        [lambda: sharded_msm(pts_sh, s_sh), msm_cores["msm_local_edwards25519"]])))
    count_t = sh_count.clone()
    sums = torch.zeros((4, 10, -(-32 * 8 // MSM_C)), dtype=torch.int32, device=wdev)
    parts = [torch.empty_like(sums)]
    collectives_ms = {"all_reduce_count": events_ms(lambda: dist.all_reduce(count_t), 100),
                      "all_gather_window_sums": events_ms(lambda: dist.all_gather(parts, sums), 100)}
    sh_profiles = {"sharded_verify": device_profile(lambda: sharded_verify(*sh_cols)),
                   "sharded_msm": device_profile(lambda: sharded_msm(pts_sh, s_sh))}
    dist.destroy_process_group()
    rendezvous.cleanup()
    emit({"phase": "sharded", "card": card, "B": B, "c": MSM_C,
          "world": {"backend": backend, "ranks": 1, "device": str(wdev),
                    "why_one_rank": "one card on this machine; NCCL takes one card a rank, "
                                    "so worlds of 2 and 4 are checked on gloo CPU ranks only"},
          "nccl_init_s": nccl_init_s,
          "verify": {"count": int(sh_count),
                     "rejected_lanes": torch.nonzero(~sh_ok).flatten().tolist(),
                     "mask_equals_verify_core": True,
                     "launches": path_counts["sharded_verify"]},
          "msm": {"check": "compress equals msm_local's and the oracle's",
                  "launches": {k: v for k, v in path_counts["sharded_msm"].items() if v},
                  "msm_local_launches": want_msm},
          "msm_sharded_example": {"ok": example_ok,
                                  "launches": {k: v for k, v in
                                               path_counts["msm_sharded_example"].items() if v}},
          "dryrun_multichip": {"ranks": n_cards, "report": dry, "s": dryrun_s,
                               "kernel_libraries_rebuilt": 0},
          "host_clock": sh_times,
          "collectives_ms": collectives_ms,
          "collectives_timer": "CUDA events around 100 host-issued calls",
          "host_clock_timer": "host_rate of each call, sharded and unsharded in turns",
          "profile": sh_profiles})

    # -- phase 14: msm_local_prefix at JAX's c = 12 -------------------------------
    # edwards25519 on the msm_local phase's inputs, against msm_local's (c =
    # 8) and the oracle's sum; c = 12 gives 22 windows, bucket trees of
    # 4095 partial sums and runs of 12 doublings (new launch shapes, held
    # against the plain versions in path_shapes_vs_plain); then p192k1 at B
    # = 256 and c = 5 (the JAX test's window) against the oracle, not timed
    grp_e, pts_e, s_cols_e, local_e = msm_inputs["edwards25519"]
    want_prefix = msm_launches(B, 32, PREFIX_C)
    prefix_out, _ = counted("msm_local_prefix", lambda: msm_local_prefix(grp_e, pts_e, s_cols_e),
                            want_prefix, add_mode="full")
    prefix_shapes = {k: sorted(v) for k, v in group.launch_shapes().items() if v}
    if col_rows(grp_e.compress(prefix_out))[0] != local_e:
        raise RuntimeError("msm_local_prefix differs from msm_local and the oracle")
    prefix_times = dict(zip(("msm_local_prefix_s", "msm_local_s"), in_turns(
        [lambda: msm_local_prefix(grp_e, pts_e, s_cols_e), msm_cores["msm_local_edwards25519"]])))
    prefix_profile = device_profile(lambda: msm_local_prefix(grp_e, pts_e, s_cols_e))
    k192, o192 = sec2.get_curve("p192k1"), oracle.sec2_curve("p192k1")
    rng192 = np.random.default_rng(192)
    a192 = distinct_scalars(o192, PREFIX_P192K1_B, rng192)
    s192 = [int.from_bytes(rng192.bytes(k192.scalar.n_bytes), "little") % o192.order
            for _ in range(PREFIX_P192K1_B)]
    s192[0] = 0
    pts192 = k192.mul_base(scalar_cols(k192, a192))
    out192, _ = counted("msm_local_prefix_p192k1",
                        lambda: msm_local_prefix(k192, pts192, scalar_cols(k192, s192), c=5), {})
    k_sum = sum(si * ai for si, ai in zip(s192, a192)) % o192.order
    if col_rows(k192.compress(out192))[0] != o192.compress(o192.mul_base(k_sum)):
        raise RuntimeError("msm_local_prefix on p192k1 differs from the oracle")
    emit({"phase": "msm_local_prefix", "card": card, "B": B, "c": PREFIX_C,
          "check": "compress equals msm_local's (c = 8) and the oracle's",
          "launches": {k: v for k, v in path_counts["msm_local_prefix"].items() if v},
          "launch_shapes": prefix_shapes,
          "host_clock": prefix_times,
          "host_clock_timer": "host_rate of each call, prefix (c = 12) and msm_local (c = 8) in turns",
          "profile": prefix_profile,
          "p192k1": {"B": PREFIX_P192K1_B, "c": 5, "check": "compress equals the oracle's",
                     "timed": False}})

    # -- phase 15: the JAX entry's verify and the weak-scaling harness ---------
    fn_entry, entry_args = entry.entry("cuda")
    entry_ok, _ = counted("entry", lambda: fn_entry(*entry_args),
                          {"ed_add": sum(STRAUS_ADDS.values()), "ed_double": 64,
                           "pow_const_kernel": 2}, add_mode=STRAUS_ADDS)
    if entry_ok.tolist() != [True] * 8:
        raise RuntimeError(f"entry's verify: {entry_ok.tolist()}")
    emit({"phase": "entry", "B": 8, "all_true": True,
          "launches": {k: v for k, v in path_counts["entry"].items() if v}})
    try:
        entry.weak_scaling(n_cards + 1, device="cuda")
        raise RuntimeError("weak_scaling ran more ranks than cards")
    except ValueError as err:
        too_many = str(err)
    # the ranks are new processes: they load the kernel libraries built
    # above and rebuild none; their launches are not counted here
    t0 = time.perf_counter()
    scaling = entry.weak_scaling(n_cards, b_per_device=B, device="cuda")
    scaling_s = time.perf_counter() - t0
    if {q.name: q.stat().st_mtime_ns for q in build.BUILD_DIR.glob("*.so")} != libs_before:
        raise RuntimeError("the weak-scaling ranks rebuilt kernel libraries")
    emit({"phase": "weak_scaling", "card": card, "cards": n_cards, "b_per_device": B, "reps": 4,
          "report": scaling, "s": scaling_s,
          "more_ranks_than_cards": too_many,
          "note": ("one card: the only world is one rank, and the efficiency is t1 "
                   "over t1, which says nothing of scaling" if n_cards == 1 else
                   f"{n_cards} cards, one NCCL rank a card")})

    # -- phase 8: kernel times -------------------------------------------------
    sources = {
        "ed_add": "eccoxide_tpu/ops/pallas_group.py:93 (_add_call, pallas_call :110, via pallas_add :144)",
        "ed_double": "eccoxide_tpu/ops/pallas_group.py:120 (_double_call, pallas_call :135, via pallas_double :161)",
        "pow_const_kernel": "eccoxide_tpu/ops/pallas_group.py:174 (_pow_call, pallas_call :222, via pallas_pow :241)",
        "pow448_kernel": "eccoxide_tpu/ops/pallas_group.py:174 (_pow_call, pallas_call :222, via pallas_pow :241, "
                         "for the field of eccoxide_tpu/curves/curve448.py:15)",
        "pow_sec2_kernel": "eccoxide_tpu/ops/pallas_group.py:174 (_pow_call, pallas_call :222, via pallas_pow :241, "
                           "for the fields of eccoxide_tpu/curves/sec2.py:55 and the scalar fields "
                           "of :56, and for l, eccoxide_tpu/field.py:977-987)",
    }
    kernel_of = {"ed_add": "ed_add_kernel", "ed_double": "ed_double_kernel",
                 "pow_const_kernel": "pow_kernel", "pow448_kernel": "pow448_kernel",
                 "pow_sec2_kernel": "pow_sec2_kernel"}
    kernel_source = {"ed_add": "group.cu", "ed_double": "group.cu", "pow_const_kernel": "group.cu",
                     "pow448_kernel": "pow448.cu", "pow_sec2_kernel": "pow_sec2.cuh"}

    def double_case(W, k, need_t):
        p = rand_points(W)
        # limb multiply-adds per lane: 4 squarings and 3 products a step, the
        # T product once; bytes: X, Y, Z read, four coordinates written
        return ("ed_double", {"W": W, "k": k, "need_t": need_t},
                k * (4 * 55 + 3 * 100) + 100 * need_t, 3 * 40 + 160,
                lambda: group.ed_double(p, need_t, k),
                lambda: group.ed_double_plain(p, need_t, k))

    def pow_madds(e, mul, sq):
        """Limb multiply-adds per lane of x^e by the 4-bit chain: 14 products
        for the table x^2..x^15, then per digit after the first 4 squarings,
        and one product unless the digit is 0 (e is public: a product by
        x^0 is not work the function needs)."""
        dig = group.exp_digits(e)[1:]
        return 14 * mul + 4 * sq * len(dig) + mul * sum(1 for d in dig if d)

    def pow_case(W):
        x = rand_fe(W)
        return ("pow_const_kernel", {"W": W, "e": "(p-5)/8"},
                pow_madds(e_sqrt, 100, 55), 2 * 40,
                lambda: group.pow_const_kernel(x, e_sqrt),
                lambda: group.pow_const_plain(x, e_sqrt))

    def pow448_case(W):
        # the ladder's inverse: products of 256 multiply-adds, squarings
        # of 136
        x = rand_fe448(W)
        return ("pow448_kernel", {"W": W, "e": "p-2"},
                pow_madds(e_inv448, 256, 136), 2 * 64,
                lambda: group.pow448_kernel(x, e_inv448),
                lambda: group.pow448_plain(x, e_inv448))

    def pow_sec2_case(name, W, tag="p-2"):
        # x^e for e the path's exponent `tag` of the field; a product or
        # squaring is priced at its schoolbook terms and the nonzero entries
        # of the prime's fold matrix (field_sec2._Format.madds), no product
        # on a zero digit (pow_madds)
        f = inst_fields[name]
        e = f.path_exponents()[tag]
        top = torch.tensor(f.fmt.LARGEST, dtype=torch.int64, device=dev)
        x = (torch.randint(0, 1 << 62, (f.n, W), generator=gen, device=dev)
             % (top.view(-1, 1) + 1)).to(torch.int32)
        dig = group.exp_digits(e)
        return ("pow_sec2_kernel", {"W": W, "e": tag, "field": name, "limbs": f.n,
                                    "zero_digits": sum(1 for d in dig[1:] if d == 0),
                                    "digits": len(dig)},
                pow_madds(e, f.fmt.madds(), f.fmt.madds(square=True)), 2 * 4 * f.n,
                lambda: group.pow_sec2_kernel(f, x, e),
                lambda: group.pow_sec2_plain(f, x, e))

    # every instance (one per prime) on the inverse, p256r1 first, the main
    # case; the fields of the timed paths (p256r1, p256k1) and P-521 also on
    # the exponents of is_square and sqrt
    sec2_timed = {name: ["p-2"] for name in ["p256r1"] + sorted(
        set(build.POW_SEC2_INSTANCES.values()) - {"p256r1"},
        key=lambda c: (inst_fields[c].n, c))}
    for name in ("p256r1", "p256k1", "p521r1"):
        sec2_timed[name] = list(inst_fields[name].path_exponents())

    # the first case of each kernel is its row in the kernels line; the
    # Straus shapes (W = B) are also profiled alone, host-issued, to hold the
    # graph-replay time against the profiler outside the verify path
    cases = ([add_case(W) for W in ADD_WIDTHS]
             + [add_case(B, mode) for mode in ADD_MODES[1:]]
             + [double_case(B, 4, True), double_case(B, 1, True),
                double_case(1, 8, True), double_case(1, 1, True),
                pow_case(B), pow448_case(B), pow448_case(4 * B)]
             + [pow_sec2_case(name, B, tag) for name, tags in sec2_timed.items() for tag in tags])
    timings = []
    for case in cases:
        row = timed(*case)
        if row["shape"]["W"] == B:
            k_fn = case[4]
            alone = device_profile(lambda: [k_fn() for _ in range(GRAPH_LAUNCHES)])
            row["profiler_ms_per_launch_alone"] = alone["port_kernels"][kernel_of[row["name"]]]["ms_per_launch"]
        timings.append(row)
    emit({"phase": "kernel_times", "card": card,
          "timer": f"ms: CUDA graph of {GRAPH_LAUNCHES} wrapper calls, {GRAPH_REPLAYS} "
                   "replays between CUDA events; host_us_per_call: host clock, no "
                   "synchronize between calls; plain_ms: CUDA events around host-issued calls; "
                   f"profiler_ms_per_launch_alone: torch.profiler over {GRAPH_LAUNCHES} "
                   "host-issued calls",
          "timings": timings})

    # verifies/s: host clock around whole calls ending in synchronize (host_rate)
    straus_runs = host_rate(lambda: pe.verify_host(pks, msgs, sigs, device="cuda", tables=tables), 5)
    rlc_runs = host_rate(lambda: pb.verify_batch_host(
        pks, msgs, sigs, rng=np.random.default_rng(9), device="cuda", tables=tables), 5)
    inputs = pe.host_inputs(pks, msgs, sigs, dev)
    z = torch.from_numpy(pb.sample_z(B, np.random.default_rng(10))).to(dev)
    hash_runs = host_rate(lambda: pe.host_inputs(pks, msgs, sigs, dev))
    straus_core = host_rate(lambda: pe.verify_core(*inputs, tables))
    rlc_core = host_rate(lambda: pb.rlc_verify_core(*inputs, z, tables, msm_c=8))
    # the core's own peak: above what the script holds when it starts
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pb.rlc_verify_core(*inputs, z, tables, msm_c=8)
    torch.cuda.synchronize()
    rlc_peak = torch.cuda.max_memory_allocated() - held
    # the sign side and the ladders: host-clock rates of the entry points,
    # and their device cores on inputs already on the card
    keygen_runs = host_rate(lambda: pe.public_keys_host(sign_sks, dev, sign_tables))
    sign_runs = host_rate(lambda: pe.sign_host(sign_sks, sign_msgs, dev, sign_tables))
    a_cols = torch.from_numpy(pe.expand_secret_host(sign_sks)[0]).to(dev)
    r_wide = torch.from_numpy(sha512.sha512_batch(sign_msgs)).to(dev)
    k_wide = torch.from_numpy(sha512.sha512_batch(sign_sks)).to(dev)

    def sign_cores():
        pe.r_point_core(r_wide, sign_tables)
        pe.sign_core(a_cols, r_wide, k_wide)

    cores = {"keygen_core": lambda: pe.public_key_core(a_cols, sign_tables),
             "sign_cores": sign_cores,
             "x25519_core": lambda: px25519.x25519(*x25519_in),
             "x448_core": lambda: px448.x448(*x448_in)}
    core_runs = {name: host_rate(fn) for name, fn in cores.items()}
    emit({"phase": "times", "card": card, "B": B, "sha512_hasher": sha512.hasher(),
          "public_keys_host_s": keygen_runs,
          "keygens_per_s": B / statistics.median(keygen_runs),
          "sign_host_s": sign_runs, "signs_per_s": B / statistics.median(sign_runs),
          "x25519_exchanges_per_s": B / statistics.median(core_runs["x25519_core"]),
          "x448_exchanges_per_s": B / statistics.median(core_runs["x448_core"]),
          "sec2": sec2_times,
          "ristretto255": {k: B / statistics.median(v) for k, v in r_runs.items()},
          "msm_local_points_per_s": {k: v["points_per_s"] for k, v in msm_rates.items()},
          **{f"{name}_s": runs for name, runs in core_runs.items()},
          "straus_verify_host_s": straus_runs,
          "straus_verifies_per_s": B / statistics.median(straus_runs),
          "rlc_verify_batch_host_s": rlc_runs,
          "rlc_verifies_per_s": B / statistics.median(rlc_runs),
          "host_inputs_s": hash_runs, "straus_core_s": straus_core,
          "rlc_core_s": rlc_core, "rlc_core_peak_bytes": rlc_peak,
          "script_held_bytes": held,
          "bound_madds_per_s": int_peak, "bound_rate": bound_rate,
          "hbm_bytes_per_s": HBM_BYTES_PER_S})

    # -- where the device time goes: one profiled call of each core ----------
    profiles = {"straus_core": device_profile(lambda: pe.verify_core(*inputs, tables),
                                              cross_check=True),
                "rlc_core": device_profile(lambda: pb.rlc_verify_core(*inputs, z, tables, msm_c=8)),
                **{name: device_profile(fn) for name, fn in cores.items()},
                "sec2_p256r1_exchange": device_profile(sec2_cores["p256r1"]["exchange"]),
                **{name: device_profile(fn) for name, fn in ristretto_cores.items()},
                **{name: device_profile(fn) for name, fn in msm_cores.items()}}
    emit({"phase": "profile", "card": card, "B": B, **profiles})

    # -- phase 16: the measurement entry points, as a user runs them ---------
    # each in its own process (the ladder starts a child per rung), which
    # loads the kernel libraries built above; a record carries its run's
    # launches and launch shapes (ops.group.launch_report), counted from 0
    # in the process that ran it, and the shapes join the paths' for the
    # check against the plain versions below. It runs after every profile:
    # in a run with this phase before the kernel timings, their profiles
    # of 20 host-issued launches saw none of them
    fields_by_p = {FQ.p: FQ, FQ448.p: FQ448, **{f.p: f for f in inst_fields.values()}}

    def report_counts(path, recs):
        counts = dict.fromkeys(group.launches(), 0)
        for rec in recs:
            for k, v in rec["launches"].items():
                counts[k] += v
            for name, *shape in rec["launch_shapes"]:
                if name in group.POW_WRAPPERS:
                    p, e, w = shape
                    shape = (fields_by_p[int(p, 16)], int(e, 16), w)
                path_shapes[name].add(tuple(shape))
        path_counts[path] = counts
        return counts

    def run_entry(*args):
        t0 = time.perf_counter()
        cp = subprocess.run([sys.executable, "-m", *args], cwd=root, capture_output=True,
                            text=True, timeout=BENCH_TIMEOUT_S)
        if cp.returncode != 0:
            raise RuntimeError(f"{' '.join(args)}: rc {cp.returncode}; {cp.stderr[-2000:]}")
        return cp, time.perf_counter() - t0

    bench_t0 = time.perf_counter()
    ladder, ladder_s = run_entry("eccoxide_tpu_torch.bench")
    ladder_recs = [json.loads(ln) for ln in ladder.stdout.splitlines() if ln.startswith("{")]
    head = ladder_recs[-1] if ladder_recs else {}
    if "error" in head or not head.get("value", 0) > 0:
        raise RuntimeError(f"the bench ladder banked no number: {head}; {ladder.stderr[-2000:]}")
    if (head["metric"], head.get("batch"), head.get("method")) != (
            "ed25519_verify_per_sec_chip", B, "rlc_batch"):
        raise RuntimeError(f"the bench ladder's last line is not RLC verify at {B}: {head}")
    if "vs_baseline" in head or head["device"] != {"name": card_line.rsplit(",", 1)[0].strip(),
                                                   "power_limit": card["power_limit"]}:
        raise RuntimeError(f"the bench record's device or keys are wrong: {head}")
    # every rung the ladder banked printed its record once, and the best again last
    bench_counts = report_counts("bench", ladder_recs[:-1])
    suite_path = os.path.join(root, "chiprun_out", "suite_torch.json")
    os.makedirs(os.path.dirname(suite_path), exist_ok=True)
    _, suite_s = run_entry("eccoxide_tpu_torch.bench_suite", str(SUITE_B), "--out", suite_path)
    with open(suite_path) as fh:
        suite_out = json.load(fh)
    names = [r["metric"] for r in suite_out["results"]]
    missing = [n for n in jax_suite_metrics(os.path.join(root, "bench_suite.py")) if n not in names]
    not_positive = [r["metric"] for r in suite_out["results"] if not r["value"] > 0]
    if missing or not_positive:
        raise RuntimeError(f"bench_suite: names of the JAX suite missing {missing}, "
                           f"values not positive {not_positive}")
    suite_counts = report_counts("bench_suite", suite_out["results"])
    idle = {path: [k for k in want if not counts[k]] for path, counts, want in (
        ("bench", bench_counts, ("ed_add", "ed_double", "pow_const_kernel")),
        ("bench_suite", suite_counts, tuple(group.launches())))}
    if any(idle.values()):
        raise RuntimeError(f"a kernel of the bench paths never launched: {idle}")
    print(json.dumps(head), flush=True)
    print(json.dumps(suite_out), flush=True)
    emit({"phase": "bench", "card": card, "s": time.perf_counter() - bench_t0,
          "ladder_s": ladder_s, "suite_s": suite_s,
          "ladder_records": [{k: r.get(k) for k in ("metric", "batch", "value", "method")}
                             for r in ladder_recs[:-1]],
          "ladder_stderr": ladder.stderr.strip().splitlines()[-12:],
          "suite_out": os.path.relpath(suite_path, root), "suite_rows": len(names),
          "launches": {"bench": {k: v for k, v in bench_counts.items() if v},
                       "bench_suite": {k: v for k, v in suite_counts.items() if v}}})

    # -- phase 17: the entry script, as a user runs it -------------------------
    # python -m eccoxide_tpu_torch.entry in its own process (the JAX entry
    # module's __main__ block, in its order): the example verify's mask as
    # numpy prints it, the dry run in a world of one rank a card (a spawned
    # rank, which loads the kernel libraries built above), and the
    # weak-scaling report only when there is more than one card
    entry_cp, entry_s = run_entry("eccoxide_tpu_torch.entry")
    entry_lines = entry_cp.stdout.splitlines()
    mask_line = "entry verify: [ True  True  True  True  True  True  True  True]"
    scaling_lines = [ln for ln in entry_lines if ln.startswith("weak scaling:")]
    if entry_lines[:2] != [mask_line, "dryrun ok"] or len(scaling_lines) != (n_cards > 1):
        raise RuntimeError(f"python -m eccoxide_tpu_torch.entry printed {entry_lines} on "
                           f"{n_cards} card(s); {entry_cp.stderr[-2000:]}")
    emit({"phase": "entry_main", "card": card, "cards": n_cards, "s": entry_s,
          "lines": entry_lines})

    # -- every launch shape of the paths against the plain version -----------
    # the shapes the paths gave each kernel (group.launch_shapes over every
    # counted run) that phase 2 and the order instances' checks did not hold
    # against the plain version, held now
    t0 = time.perf_counter()
    unchecked = {k: path_shapes[k] - checked_shapes[k] for k in path_shapes}
    for name, shapes in unchecked.items():
        for shape in sorted(shapes, key=lambda s: [getattr(a, "p", a) for a in s]):
            check_shape(name, shape)
    emit({"phase": "path_shapes_vs_plain", "tolerance": "exact on canonical limbs",
          "path_shapes": {k: len(v) for k, v in path_shapes.items()},
          "checked_before": {k: len(path_shapes[k] & checked_shapes[k]) for k in path_shapes},
          "checked_now": {k: len(v) for k, v in unchecked.items()},
          "widths_checked_now": {k: sorted({s[-1] for s in v}) for k, v in unchecked.items()},
          "max_abs_err": max_err, "s": time.perf_counter() - t0})

    # the kernels line: each kernel's first case, its graph-replay time held
    # against the profiler's per-launch time over one Straus verify_core
    # (every launch there is at W = B; the doublings are runs of k = 4; the
    # adds' graph and alone times are weighted by the Straus call's launches
    # of each mode), over one x448 call for pow448, over one p256r1 exchange
    # for pow_sec2 (its two launches: the square root and the inverse).
    # ed_add's other cases are listed under its row as "modes", pow_sec2's
    # other primes and exponents as "fields". Launches: the sum over the paths'
    # counted runs, listed by path.
    kernels = []
    cross_core = {"pow448_kernel": "x448_core", "pow_sec2_kernel": "sec2_p256r1_exchange"}
    for name in sources:
        mine = [t for t in timings if t["name"] == name]
        main_row = mine[0]
        at_b = [t for t in mine if t["shape"]["W"] == B]
        if name != "ed_add":
            at_b = at_b[:1]
        weights = [straus_add_modes[t["shape"]["mode"]] if name == "ed_add" else 1 for t in at_b]
        mix = {key: sum(w * t[key] for w, t in zip(weights, at_b)) / sum(weights)
               for key in ("ms", "profiler_ms_per_launch_alone")}
        row = {
            "name": name, "route": "cuda",
            "source": f"eccoxide_tpu_torch/ops/csrc/{kernel_source[name]}",
            "replaces": sources[name],
            "launches": sum(c.get(name, 0) for c in path_counts.values()),
            "launches_by_path": {path: c[name] for path, c in path_counts.items()
                                 if c.get(name)},
            "max_abs_err": max_err[name], "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"], "library_ms": None,
            "library_ms_why_null": LIBRARY_NONE[name],
            "ops_rate": main_row["ops_rate"],
            "shape": main_row["shape"], "host_us_per_call": main_row["host_us_per_call"],
            "cross_check": {
                "shape": {"W": B, "mode": "Straus mix"} if name == "ed_add" else at_b[0]["shape"],
                "graph_ms": mix["ms"],
                "profiler_ms_per_launch_alone": mix["profiler_ms_per_launch_alone"],
                "profiler_ms_per_launch_in": cross_core.get(name, "straus_core"),
                "profiler_ms_per_launch": profiles[cross_core.get(name, "straus_core")][
                    "port_kernels"][kernel_of[name]]["ms_per_launch"]},
        }
        if name == "ed_add":
            row["modes"] = [{k: v for k, v in t.items() if k != "name"} for t in mine[1:]]
        if name == "pow_sec2_kernel":
            row["fields"] = [{k: v for k, v in t.items() if k != "name"} for t in mine[1:]]
        kernels.append(row)

    print(card_line)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
