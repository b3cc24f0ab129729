"""The benchmark of eccoxide_tpu_torch, the PyTorch and CUDA port, on
NVIDIA cards. From the root of a checkout:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json: its inputs made from the seed, set-up and
warm-up, a closed loop of batches for ``--seconds``, and the comparison of
every answer with the plain reference. The last line of standard output is
the result as one JSON object; the numbers compared, each beside its
limit, are the last lines of standard error. With ``--trace 0`` the metrics
are the cell's end-to-end ones, with ``--trace 1`` its per-layer ones.
Without as many CUDA cards as the cell asks for it exits with 2 and prints
no result; with JAX or the JAX package loaded, with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the checkout's root, not this directory, heads the path: the harness is
# the package ``benchmark`` beside the program's
sys.path[:] = [str(ROOT)] + [p for p in sys.path if Path(p or ".").resolve() != HERE]

# Build and kernel caches inside the checkout, at fixed paths: the program
# builds its own libraries into eccoxide_tpu_torch/_build/.
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(HERE / "_cache" / sub)


def card(index: int = 0) -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness, spec

    cell = spec.load_cell(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s), this machine has {found}: "
              "no result", file=sys.stderr)
        return 2
    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    info = res.pop("_info")
    bad = harness.forbidden_modules() + info["forbidden_in_ranks"]
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}: no result", file=sys.stderr)
        return 3
    print(f"card: {card()}; run: {info}", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
