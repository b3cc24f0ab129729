"""Drive the PyTorch/CUDA port on one NVIDIA card: Ed25519 verification,
key generation and signing, X25519 and X448.

    python3 chip_smoke.py

Builds the port's CUDA kernels from eccoxide_tpu_torch/ops/csrc/, holds
each kernel against its plain PyTorch version on the card (``ed_add`` in
its three modes: full, ``need_t=False`` and mixed; the pow kernels over
2^255-19 and over p448), runs both verifiers at B=32768 (the
per-signature Straus verifier through ``verify_host`` and the RLC batch
verifier through ``verify_batch_host``) on signatures made by the port's
integer oracle, then at B=32768 key generation and signing
(``public_keys_host``, ``sign_host``, every signature verified) and the
X25519 and X448 exchanges (both ways, RFC 7748 vectors and low-order u in
fixed lanes). It counts the kernel launches of each path, with the counts
set to 0 just before it, and times kernels, plain versions and paths. A kernel's time is device time per launch from a
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

PORT_KERNELS = ("ed_add_kernel", "ed_double_kernel", "pow_kernel", "pow448_kernel")
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
            m = re.search(r"Function : .*?(" + "|".join(PORT_KERNELS) + ")", line)
            cur = counts.setdefault(m.group(1), dict.fromkeys(SASS_OPS + ("all",), 0)) if m else None
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
        m = re.search(r"Compiling entry function '.*?(" + "|".join(PORT_KERNELS) + ")", line)
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

    from eccoxide_tpu_torch import field448, oracle
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
    if set(regs) != set(PORT_KERNELS):
        raise RuntimeError(f"ptxas report lacks kernels: {regs}")
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "torch_cuda": torch.version.cuda, "nvcc": nvcc_version,
          "clocks_max_sm_mhz": clock_max_mhz, "clocks_sm_mhz_now": smi("clocks.sm"),
          "build_s": build_s,
          "kernel_build_s": {name: lib.seconds for name, lib in libs.items()},
          "sha512_build_s": built["sha512"].seconds,
          "kernel_libraries": {name: os.path.relpath(lib.path) for name, lib in libs.items()},
          "ptxas": regs,
          "sass_static_opcodes": sass_counts([lib.path for lib in libs.values()])})

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

    clock_hz = clock_max_mhz * 1e6
    int_peak = INT32_MAD_PER_CLK_PER_SM * torch.cuda.get_device_properties(0).multi_processor_count * clock_hz

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
               "ops_ms": ops_ms, "bytes_ms": bytes_ms}
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

    checks = {"ed_add": [], "ed_double": [], "pow_const_kernel": [], "pow448_kernel": []}
    max_err = {name: 0 for name in checks}

    def compare(name, got, want, width, case):
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise RuntimeError(f"{name} {case}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
        if name == "pow_const_kernel":
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
            for e, tag in ((e_sqrt, "(p-5)/8"), (e_inv, "p-2")):
                compare("pow_const_kernel", group.pow_const_kernel(x, e),
                        group.pow_const_plain(x, e), W, f"e={tag}")
            y = rand_fe448(W)
            if W >= 3:
                y[:, 0] = 0
                y[:, 1] = max_fe448(1)[:, 0]
            for inp, kind in ((y, "random"), (max_fe448(W), "max limbs")):
                for e, tag in ((e_inv448, "p-2"), (E_SHORT, hex(E_SHORT))):
                    compare("pow448_kernel", group.pow448_kernel(inp, e),
                            group.pow448_plain(inp, e), W, f"{kind} e={tag}")
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

    # -- phase 8: kernel times -------------------------------------------------
    n_dig = len(group.exp_digits(e_sqrt))
    sources = {
        "ed_add": "eccoxide_tpu/ops/pallas_group.py:92 (_add_call, via pallas_add :144)",
        "ed_double": "eccoxide_tpu/ops/pallas_group.py:119 (_double_call, via pallas_double :161)",
        "pow_const_kernel": "eccoxide_tpu/ops/pallas_group.py:173 (_pow_call, via pallas_pow :241)",
        "pow448_kernel": "eccoxide_tpu/ops/pallas_group.py:173 (_pow_call, via pallas_pow :241, "
                         "for the field of eccoxide_tpu/curves/curve448.py:15)",
    }
    kernel_of = {"ed_add": "ed_add_kernel", "ed_double": "ed_double_kernel",
                 "pow_const_kernel": "pow_kernel", "pow448_kernel": "pow448_kernel"}
    kernel_source = {"ed_add": "group.cu", "ed_double": "group.cu", "pow_const_kernel": "group.cu",
                     "pow448_kernel": "pow448.cu"}

    def double_case(W, k, need_t):
        p = rand_points(W)
        # limb multiply-adds per lane: 4 squarings and 3 products a step, the
        # T product once; bytes: X, Y, Z read, four coordinates written
        return ("ed_double", {"W": W, "k": k, "need_t": need_t},
                k * (4 * 55 + 3 * 100) + 100 * need_t, 3 * 40 + 160,
                lambda: group.ed_double(p, need_t, k),
                lambda: group.ed_double_plain(p, need_t, k))

    def pow_case(W):
        x = rand_fe(W)
        return ("pow_const_kernel", {"W": W, "e": "(p-5)/8"},
                14 * 100 + (n_dig - 1) * (4 * 55 + 100), 2 * 40,
                lambda: group.pow_const_kernel(x, e_sqrt),
                lambda: group.pow_const_plain(x, e_sqrt))

    def pow448_case(W):
        # the ladder's inverse: 14 products of 256 multiply-adds for the
        # table, then per digit 4 squarings of 136 and one product
        x = rand_fe448(W)
        nd = len(group.exp_digits(e_inv448))
        return ("pow448_kernel", {"W": W, "e": "p-2"},
                14 * 256 + (nd - 1) * (4 * 136 + 256), 2 * 64,
                lambda: group.pow448_kernel(x, e_inv448),
                lambda: group.pow448_plain(x, e_inv448))

    # the first case of each kernel is its row in the kernels line; the
    # Straus shapes (W = B) are also profiled alone, host-issued, to hold the
    # graph-replay time against the profiler outside the verify path
    cases = ([add_case(W) for W in ADD_WIDTHS]
             + [add_case(B, mode) for mode in ADD_MODES[1:]]
             + [double_case(B, 4, True), double_case(B, 1, True),
                double_case(1, 8, True), double_case(1, 1, True),
                pow_case(B), pow448_case(B), pow448_case(4 * B)])
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
          **{f"{name}_s": runs for name, runs in core_runs.items()},
          "straus_verify_host_s": straus_runs,
          "straus_verifies_per_s": B / statistics.median(straus_runs),
          "rlc_verify_batch_host_s": rlc_runs,
          "rlc_verifies_per_s": B / statistics.median(rlc_runs),
          "host_inputs_s": hash_runs, "straus_core_s": straus_core,
          "rlc_core_s": rlc_core, "rlc_core_peak_bytes": rlc_peak,
          "script_held_bytes": held,
          "int32_mad_peak_per_s": int_peak, "hbm_bytes_per_s": HBM_BYTES_PER_S})

    # -- where the device time goes: one profiled call of each core ----------
    profiles = {"straus_core": device_profile(lambda: pe.verify_core(*inputs, tables)),
                "rlc_core": device_profile(lambda: pb.rlc_verify_core(*inputs, z, tables, msm_c=8)),
                **{name: device_profile(fn) for name, fn in cores.items()}}
    emit({"phase": "profile", "card": card, "B": B, **profiles})

    # the kernels line: each kernel's first case, its graph-replay time held
    # against the profiler's per-launch time over one Straus verify_core
    # (every launch there is at W = B; the doublings are runs of k = 4; the
    # adds' graph and alone times are weighted by the Straus call's launches
    # of each mode), over one x448 call for pow448. ed_add's other cases are
    # listed under its row as "modes". Launches: the sum over the paths'
    # counted runs, listed by path.
    kernels = []
    cross_core = {"pow448_kernel": "x448_core"}
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
        kernels.append(row)

    print(card_line)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
