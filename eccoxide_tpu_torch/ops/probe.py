"""The multiply-add rate probe (``csrc/imad_probe.cu``): chains of 32x32->64
multiply-adds (``madw``, an IMAD.WIDE.U32 each), compiled as the partial
products of the pow kernels over 28-bit limbs are. ``chip_smoke.py`` times it
on the card and prices the kernels' operation bounds at the lower of its
rate and the data sheet's.

``imad_wide_chains(blocks, trips, y, device)`` returns the kernel's
accumulators (blocks * 256 * 8 of them, uint64 held in int64); on the CPU it
runs the plain version, which repeats the chains in numpy uint64.
``imad_wide_chains.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build

THREADS, CHAINS, UNROLL = 256, 8, 16       # csrc/imad_probe.cu kThreads, kChains, kUnroll


def madds(blocks: int, trips: int) -> int:
    """The multiply-adds one launch runs."""
    return blocks * THREADS * CHAINS * UNROLL * trips


def imad_wide_chains_plain(blocks: int, trips: int, y: int) -> np.ndarray:
    """The accumulators of the probe, in numpy uint64 (wrapping as the
    kernel's do): per trip acc_k += x_k (y + 2u) for u < UNROLL, then
    x_k += lo32(acc_{k+1 mod CHAINS}) mod 2^32; from acc_k = lane CHAINS +
    k + 1 and x_k = 7 lane + k mod 2^32."""
    lane = np.arange(blocks * THREADS, dtype=np.uint64)[:, None]
    k = np.arange(CHAINS, dtype=np.uint64)[None, :]
    lo = np.uint64(0xFFFFFFFF)
    acc = lane * np.uint64(CHAINS) + k + np.uint64(1)
    x = (lane * np.uint64(7) + k) & lo
    with np.errstate(over="ignore"):
        for _ in range(trips):
            for u in range(UNROLL):
                acc = acc + x * np.uint64(y + 2 * u)
            x = (x + (np.roll(acc, -1, axis=1) & lo)) & lo
    return acc.reshape(-1)


def imad_wide_chains(blocks: int, trips: int, y: int, device) -> torch.Tensor:
    """The probe's accumulators as int64 (the bits of the uint64 values)."""
    if not 0 < y < (1 << 32) - 2 * UNROLL or blocks < 1 or trips < 0:
        raise ValueError(f"bad probe arguments: blocks {blocks}, trips {trips}, y {y}")
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.from_numpy(imad_wide_chains_plain(blocks, trips, y).view(np.int64))
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    out = torch.empty(blocks * THREADS * CHAINS, dtype=torch.int64, device=dev)
    rc = build.kernels("imad_probe").imad_probe_launch(
        out.data_ptr(), y, trips, blocks, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"imad_probe: kernel launch failed with CUDA error {rc}")
    imad_wide_chains.launches += 1
    return out


imad_wide_chains.launches = 0
