"""The command on a card: one short run of a one-card cell, correct, with
the result line's keys. Skips without a card (decided inside the test).

    python -m pytest -m cuda benchmark/tests/test_bench_card.py -q
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_straus_on_the_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ed25519_verify.straus",
                          "--seed", str(2**31 + 3 + trace), "--seconds", "3", "--trace", str(trace)],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
    assert ("breakdown" in res) == bool(trace)
