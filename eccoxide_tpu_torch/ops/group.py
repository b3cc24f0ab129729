"""The Edwards group-law and pow kernels, counterpart of
the JAX package's ``ops/pallas_group.py``.

Three wrappers, each with its plain PyTorch version beside it:

- ``ed_add(p, q)``: complete a=-1 addition (add-2008-hwcd-3), T included;
- ``ed_double(p)``: dbl-2008-hwcd, T included;
- ``pow_const_kernel(x, e)``: x^e over FQ for a public constant e.

Points are packed int32 tensors ``(4, 10, *batch)`` (X|Y|Z|T, limbs of
``field.py``); field batches are ``(10, *batch)``. A wrapper given CPU
tensors runs the plain version; given CUDA tensors it launches its kernel
(``csrc/group.cu``) or raises. Each wrapper counts its launches in a plain
integer attribute ``launches``; nothing else touches the count.

The JAX package's adapter ``PallasGroup`` has no class here: the curve
``curves.curve25519.EDWARDS`` sends every add and double through these
wrappers, so the curve itself is the group the MSM and the verifiers use.
"""

from __future__ import annotations

import torch

from ..field import FQ, P
from . import build

D = (-121665 * pow(121666, -1, P)) % P
D2 = 2 * D % P


def _check_point(p: torch.Tensor):
    if p.dtype != torch.int32 or p.dim() < 3 or tuple(p.shape[:2]) != (4, 10):
        raise ValueError(f"expected an int32 (4, 10, *batch) point, got "
                         f"{p.dtype} {tuple(p.shape)}")


def _on_cuda(*ts: torch.Tensor) -> bool:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return True


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# ---------------------------------------------------------------------------
# plain versions (the arithmetic of group.cu, op for op)
# ---------------------------------------------------------------------------


def ed_add_plain(p, q, need_t: bool = True):
    """p + q on packed points; with need_t=False the E*H product is skipped
    and T is returned as zeros (the caller marks it unusable)."""
    f = FQ
    x1, y1, z1, t1 = p.unbind(0)
    x2, y2, z2, t2 = q.unbind(0)
    a = f.mul(f.sub(y1, x1), f.sub(y2, x2))
    b = f.mul(f.add(y1, x1), f.add(y2, x2))
    d2 = f.const(D2, (1,) * (p.dim() - 2), p.device)
    c = f.mul(f.mul(t1, t2), d2)
    zz = f.mul(z1, z2)
    d = f.add(zz, zz)
    e, fv, g, h = f.sub(b, a), f.sub(d, c), f.add(d, c), f.add(b, a)
    t3 = f.mul(e, h) if need_t else torch.zeros_like(x1)
    return torch.stack([f.mul(e, fv), f.mul(g, h), f.mul(fv, g), t3])


def ed_double_plain(p, need_t: bool = True):
    """2p on packed points; need_t as in ed_add_plain."""
    f = FQ
    x, y, z, _ = p.unbind(0)
    a = f.square(x)
    b = f.square(y)
    zz = f.square(z)
    c = f.add(zz, zz)
    d = f.neg(a)
    e = f.sub(f.sub(f.square(f.add(x, y)), a), b)
    g = f.add(d, b)
    fv = f.sub(g, c)
    h = f.sub(d, b)
    t3 = f.mul(e, h) if need_t else torch.zeros_like(x)
    return torch.stack([f.mul(e, fv), f.mul(g, h), f.mul(fv, g), t3])


def exp_digits(e: int) -> list[int]:
    """4-bit digits of e > 0, most significant first."""
    nd = max(1, -(-e.bit_length() // 4))
    return [(e >> (4 * (nd - 1 - i))) & 15 for i in range(nd)]


def pow_const_plain(x, e: int):
    """x^e: table x^0..x^15, then per digit 4 squarings and 1 multiply."""
    f = FQ
    if e == 0:
        return f.one(x.shape[1:], x.device)
    tab = [f.one(x.shape[1:], x.device), x]
    for _ in range(2, 16):
        tab.append(f.mul(tab[-1], x))
    dig = exp_digits(e)
    acc = tab[dig[0]]
    for d in dig[1:]:
        for _ in range(4):
            acc = f.square(acc)
        acc = f.mul(acc, tab[d])
    return acc


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def ed_add(p: torch.Tensor, q: torch.Tensor,
           need_t: bool = True) -> torch.Tensor:
    """p + q for packed (4, 10, *batch) int32 points of one shape. The
    kernel always computes T; need_t=False lets the plain version skip it."""
    _check_point(p)
    if p.shape != q.shape:
        raise ValueError(f"shape mismatch {tuple(p.shape)} vs {tuple(q.shape)}")
    if not _on_cuda(p, q):
        return ed_add_plain(p, q, need_t)
    w = p[0, 0].numel()
    if w == 0:
        return p
    p, q = p.contiguous(), q.contiguous()
    out = torch.empty_like(p)
    rc = build.kernels().ed_add_launch(
        p.data_ptr(), q.data_ptr(), out.data_ptr(), w, _stream(p.device))
    _raise_on(rc, "ed_add")
    ed_add.launches += 1
    return out


ed_add.launches = 0


def ed_double(p: torch.Tensor, need_t: bool = True) -> torch.Tensor:
    """2p for a packed (4, 10, *batch) int32 point; need_t as in ed_add."""
    _check_point(p)
    if not _on_cuda(p):
        return ed_double_plain(p, need_t)
    w = p[0, 0].numel()
    if w == 0:
        return p
    p = p.contiguous()
    out = torch.empty_like(p)
    rc = build.kernels().ed_double_launch(
        p.data_ptr(), out.data_ptr(), w, _stream(p.device))
    _raise_on(rc, "ed_double")
    ed_double.launches += 1
    return out


ed_double.launches = 0

_digit_cache: dict = {}


def _digits_on(e: int, device) -> torch.Tensor:
    key = (e, torch.device(device))
    t = _digit_cache.get(key)
    if t is None:
        t = torch.tensor(exp_digits(e), dtype=torch.int32, device=device)
        _digit_cache[key] = t
    return t


def pow_const_kernel(x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e over FQ for an int32 (10, *batch) batch and a public e >= 0."""
    if x.dtype != torch.int32 or x.shape[0] != 10:
        raise ValueError(f"expected int32 (10, *batch), got {x.dtype} "
                         f"{tuple(x.shape)}")
    if e < 0:
        raise ValueError("negative exponent")
    if not _on_cuda(x):
        return pow_const_plain(x, e)
    if e == 0:
        return FQ.one(x.shape[1:], x.device)
    w = x[0].numel()
    if w == 0:
        return x
    x = x.contiguous()
    dig = _digits_on(e, x.device)
    out = torch.empty_like(x)
    rc = build.kernels().pow_launch(
        x.data_ptr(), out.data_ptr(), dig.data_ptr(), dig.numel(), w,
        _stream(x.device))
    _raise_on(rc, "pow_const_kernel")
    pow_const_kernel.launches += 1
    return out


pow_const_kernel.launches = 0

WRAPPERS = (pow_const_kernel, ed_add, ed_double)


def reset_launches():
    for w in WRAPPERS:
        w.launches = 0


def launches() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}

