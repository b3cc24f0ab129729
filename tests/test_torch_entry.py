"""The port's counterparts of the JAX entry module's entry and weak_scaling
(eccoxide_tpu_torch/entry.py), on the CPU: the verify with its example
arguments, and the weak-scaling harness in a gloo world of two CPU
processes (spawned as in test_torch_sharded.py), with JAX's keys. Its
times there say nothing of cards: the two ranks share the host's cores.
Then ``python -m eccoxide_tpu_torch.entry``, the counterpart of the JAX
entry module's ``__main__`` block, as a user runs it. The example columns
are held against the JAX entry's bytes in test_torch_parity_prefix.py.
(Three tests: see test_torch_sign.py for why the port's files stay
small.)"""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from eccoxide_tpu_torch import entry
from eccoxide_tpu_torch.protocol import ed25519 as pe
from world_limit import world_limited

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_entry_verifies_its_example_batch():
    fn, args = entry.entry(device="cpu")
    assert fn is pe.verify_core and len(args) == 5
    assert [tuple(a.shape) for a in args[:4]] == [(32, 8), (32, 8), (32, 8), (64, 8)]
    assert all(a.device.type == "cpu" and a.dtype == torch.int32 for a in args[:4])
    assert isinstance(args[4], pe.VerifyTables)
    assert fn(*args).tolist() == [True] * 8


@world_limited
def test_weak_scaling_in_a_gloo_world_of_two(monkeypatch):
    """JAX's keys and rounding; on the card, more ranks than cards raise
    before any process starts (NCCL refuses two ranks on one card)."""
    out = entry.weak_scaling(2, b_per_device=4, reps=1, device="cpu")
    assert set(out) == {"t1_s", "t2_s", "weak_scaling_efficiency"}
    assert out["t1_s"] > 0 and out["t2_s"] > 0 and out["weak_scaling_efficiency"] > 0
    assert round(out["t1_s"], 4) == out["t1_s"] and round(out["weak_scaling_efficiency"], 3) == \
        out["weak_scaling_efficiency"]
    monkeypatch.setattr(entry, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="weak scaling over 2 ranks needs 2 cards, this machine has 1"):
        entry.weak_scaling(2, device="cuda")


def test_module_main_runs_the_entry_blocks_steps():
    """``--device cpu``: the mask line as numpy prints it, then ``dryrun
    ok`` from a spawned gloo world of one, and no weak-scaling line (one
    device). With no card visible and no ``--device``, it refuses before
    any work."""
    cmd = [sys.executable, "-m", "eccoxide_tpu_torch.entry"]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    cp = subprocess.run(cmd + ["--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
                        text=True, timeout=300)
    assert cp.returncode == 0, cp.stderr
    assert cp.stdout.splitlines() == [
        "entry verify: [ True  True  True  True  True  True  True  True]", "dryrun ok"]
    cp = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert cp.returncode != 0 and cp.stdout == ""
    assert "no CUDA device is available" in cp.stderr
