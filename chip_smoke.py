"""Drive the PyTorch/CUDA port on one NVIDIA card: Ed25519 verification,
key generation and signing, X25519 and X448, and the 15 SEC2 curves.

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
the integer oracle. It counts the kernel launches of each path, with the counts
set to 0 just before it, and times kernels, plain versions and paths. It
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
# told apart by their prime (template argument I<len><name>E, e.g. I6p256r1E)
_KERNEL_RE = "(" + "|".join(PORT_KERNELS + (PROBE_KERNEL,)) + r")(?:I\d+(p\d+[a-z]\d)E)?"
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


def device_profile(fn) -> dict:
    """Device time by kernel over one call of fn (torch.profiler, after a
    warm-up call): the busy time is the sum of the kernels' device time,
    the idle share its complement in the profiled wall time; per port
    kernel, its device time per launch (self_device_time_total / count)."""
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
    from eccoxide_tpu_torch.field import FQ, P, TIGHT
    from eccoxide_tpu_torch.field448 import FQ448
    from eccoxide_tpu_torch.ops import build, group, sha512
    from eccoxide_tpu_torch.protocol import ed25519 as pe
    from eccoxide_tpu_torch.protocol import ed25519_batch as pb
    from eccoxide_tpu_torch.protocol import x448 as px448
    from eccoxide_tpu_torch.protocol import x25519 as px25519

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
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
               "ops_rate": bound_rate,
               "madds_per_lane": ops, "ops_ms": ops_ms, "bytes_ms": bytes_ms}
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
        q_xyt = rand_affine(W)
        if W >= 4:
            q_xyt[:, :, 3] = max_fe(1)[:, 0]
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
            x = rand_fe(W)
            if W >= 3:
                x[:, 0] = 0
                x[:, 1] = max_fe(1)[:, 0]
            for e, tag in ((e_sqrt, "(p-5)/8"), (e_inv, "p-2"), (E_SPARSE, hex(E_SPARSE))):
                compare("pow_const_kernel", group.pow_const_kernel(x, e),
                        group.pow_const_plain(x, e), W, f"e={tag}")
            y = rand_fe448(W)
            if W >= 3:
                y[:, 0] = 0
                y[:, 1] = max_fe448(1)[:, 0]
            for inp, kind in ((y, "random"), (max_fe448(W), "max limbs")):
                for e, tag in ((e_inv448, "p-2"), (E_SHORT, hex(E_SHORT)), (E_SPARSE, hex(E_SPARSE))):
                    compare("pow448_kernel", group.pow448_kernel(inp, e),
                            group.pow448_plain(inp, e), W, f"{kind} e={tag}")
        torch.cuda.synchronize()
    # the SEC2 pow kernel, every field: one plain call at W = B per exponent,
    # the kernel at each check width on a prefix (lanes are independent);
    # lane 0 holds the largest limbs the format allows, lane 2 zero
    for name in sec2.ALL:
        f = sec2.get_curve(name).field
        top = torch.tensor(f.fmt.LARGEST, dtype=torch.int64, device=dev)
        x = (torch.randint(0, 1 << 62, (f.n, B), generator=gen, device=dev)
             % (top.view(-1, 1) + 1)).to(torch.int32)
        x[:, 0] = top.to(torch.int32)
        x[:, 2] = 0
        for tag, e in sec2_exponents(f).items():
            want = group.pow_sec2_plain(f, x, e)
            for first, W in SEC2_CHECK_LANES:
                compare("pow_sec2_kernel", group.pow_sec2_kernel(f, x[:, first:first + W].contiguous(), e),
                        want[:, first:first + W], W, f"{name} e={tag} lanes {first}..", f.canon)
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
    if after_valid["ed_double"] - before["ed_double"] != 33:
        raise RuntimeError("the valid batch did not run 33 doubling launches")
    if [i for i in range(B) if not rlc_forged[i]] != [forged]:
        raise RuntimeError("verify_batch_host did not isolate exactly the forged lane")
    emit({"phase": "rlc_verify_batch_host", "B": B, "msm_c": 8,
          "valid_batch_accepted": True, "forged_lane": forged,
          "rejected_lanes": [i for i in range(B) if not rlc_forged[i]],
          "first_call_s": rlc_s,
          "launches_valid_batch": {k: after_valid[k] - before[k] for k in counts}})
    verify_counts = {k: counts[k] for k in ("pow_const_kernel", "ed_add", "ed_double")}
    if min(verify_counts.values()) <= 0 or counts["pow448_kernel"]:
        raise RuntimeError(f"a kernel of the verify paths never launched: {counts}")
    path_counts = {"verify": verify_counts}

    def counted(path, fn, want):
        """fn() with the launch counts set to 0 just before and read just
        after; they must equal `want` (kernel -> launches, the others 0)."""
        group.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = group.launches()
        full = {k: want.get(k, 0) for k in got}
        if got != full:
            raise RuntimeError(f"{path} launched {got}, not {full}")
        if want.get("ed_add") and group.ed_add.launches_by_mode["mixed"] != want["ed_add"]:
            raise RuntimeError(f"{path}: adds {group.ed_add.launches_by_mode}, not all mixed")
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

    # -- phase 8: kernel times -------------------------------------------------
    sources = {
        "ed_add": "eccoxide_tpu/ops/pallas_group.py:92 (_add_call, via pallas_add :144)",
        "ed_double": "eccoxide_tpu/ops/pallas_group.py:119 (_double_call, via pallas_double :161)",
        "pow_const_kernel": "eccoxide_tpu/ops/pallas_group.py:173 (_pow_call, via pallas_pow :241)",
        "pow448_kernel": "eccoxide_tpu/ops/pallas_group.py:173 (_pow_call, via pallas_pow :241, "
                         "for the field of eccoxide_tpu/curves/curve448.py:15)",
        "pow_sec2_kernel": "eccoxide_tpu/ops/pallas_group.py:173 (_pow_call, via pallas_pow :241, "
                           "for the fields of eccoxide_tpu/curves/sec2.py:55)",
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
        f = sec2.get_curve(name).field
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
        key=lambda c: (sec2.get_curve(c).field.n, c))}
    for name in ("p256r1", "p256k1", "p521r1"):
        sec2_timed[name] = list(sec2.get_curve(name).field.path_exponents())

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
    profiles = {"straus_core": device_profile(lambda: pe.verify_core(*inputs, tables)),
                "rlc_core": device_profile(lambda: pb.rlc_verify_core(*inputs, z, tables, msm_c=8)),
                **{name: device_profile(fn) for name, fn in cores.items()},
                "sec2_p256r1_exchange": device_profile(sec2_cores["p256r1"]["exchange"])}
    emit({"phase": "profile", "card": card, "B": B, **profiles})

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
