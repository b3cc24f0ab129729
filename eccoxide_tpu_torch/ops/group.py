"""The Edwards group-law and pow kernels, counterpart of
the JAX package's ``ops/pallas_group.py``.

Three wrappers, each with its plain PyTorch version beside it:

- ``ed_add(p, q, need_t)``: complete a=-1 addition (add-2008-hwcd-3); T
  (the E*H product) only when ``need_t``, zeros otherwise, on the card and
  in the plain version alike;
- ``ed_add_mixed(p, q_xyt)``: the same addition with an affine second
  operand ``(3, 10, *batch)`` = x|y|t (Z2 = 1, so D = 2 Z1 takes no
  product); the same kernel, counted in ``ed_add.launches``;
- ``ed_double(p, need_t, k)``: [2^k]p by k steps of dbl-2008-hwcd in one
  launch, X, Y, Z kept in registers between steps; T (the E*H product of
  the last step) only when ``need_t``, zeros otherwise, on the card and
  in the plain version alike;
- ``pow_const_kernel(x, e)``: x^e over FQ for a public constant e.

Points are packed int32 tensors ``(4, 10, *batch)`` (X|Y|Z|T, limbs of
``field.py``); field batches are ``(10, *batch)``. A wrapper given CPU
tensors runs the plain version; given CUDA tensors it launches its kernel
(``csrc/group.cu``) or raises. Each wrapper counts its launches in a plain
integer attribute ``launches``, and ``ed_add`` splits its count by mode in
``ed_add.launches_by_mode``; nothing else touches the counts.

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


def _check_k(k: int):
    if not isinstance(k, int) or not 1 <= k < 1 << 16:
        raise ValueError(f"a run of doublings needs 1 <= k < 65536, got {k!r}")


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


def _add_plain(p, x2, y2, z2, t2, need_t: bool):
    f = FQ
    x1, y1, z1, t1 = p.unbind(0)
    a = f.mul(f.sub_lazy(y1, x1), f.sub_lazy(y2, x2))
    b = f.mul(f.add_lazy(y1, x1), f.add_lazy(y2, x2))
    d2 = f.const(D2, (1,) * (p.dim() - 2), p.device)
    c = f.mul(f.mul(t1, t2), d2)
    zz = z1 if z2 is None else f.mul(z1, z2)
    d = f.add(zz, zz)
    # every sum below feeds only a product: no carry (field.py LAZY)
    e, fv = f.sub_lazy(b, a), f.sub_lazy(d, c)
    g, h = f.add_lazy(d, c), f.add_lazy(b, a)
    t3 = f.mul(e, h) if need_t else torch.zeros_like(x1)
    return torch.stack([f.mul(e, fv), f.mul(g, h), f.mul(fv, g), t3])


def ed_add_plain(p, q, need_t: bool = True):
    """p + q on packed points; with need_t=False the E*H product is skipped
    and T is returned as zeros (the caller marks it unusable)."""
    x2, y2, z2, t2 = q.unbind(0)
    return _add_plain(p, x2, y2, z2, t2, need_t)


def ed_add_mixed_plain(p, q_xyt):
    """p + q for an affine q = x|y|t (Z2 = 1): D = 2 Z1, no Z product."""
    x2, y2, t2 = q_xyt.unbind(0)
    return _add_plain(p, x2, y2, None, t2, True)


def ed_double_plain(p, need_t: bool = True, k: int = 1):
    """[2^k]p on packed points: k doubling steps, T (E*H of the last step)
    only when need_t, zeros otherwise."""
    _check_k(k)
    f = FQ
    x, y, z, _ = p.unbind(0)
    for _ in range(k):
        a = f.square(x)
        b = f.square(y)
        zz = f.square(z)
        c = f.add(zz, zz)
        d = f.neg(a)
        e = f.sub(f.sub(f.square(f.add(x, y)), a), b)
        g = f.add(d, b)
        fv = f.sub(g, c)
        h = f.sub(d, b)
        x, y, z = f.mul(e, fv), f.mul(g, h), f.mul(fv, g)
    t3 = f.mul(e, h) if need_t else torch.zeros_like(x)
    return torch.stack([x, y, z, t3])


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


def _add_launch(p, q, mixed: bool, need_t: bool) -> torch.Tensor:
    w = p[0, 0].numel()
    if w == 0:
        return p
    p, q = p.contiguous(), q.contiguous()
    out = torch.empty_like(p)
    rc = build.kernels().ed_add_launch(
        p.data_ptr(), q.data_ptr(), out.data_ptr(), int(mixed), int(need_t), w,
        _stream(p.device))
    _raise_on(rc, "ed_add")
    ed_add.launches += 1
    ed_add.launches_by_mode["mixed" if mixed else "full" if need_t else "need_t=False"] += 1
    return out


def ed_add(p: torch.Tensor, q: torch.Tensor,
           need_t: bool = True) -> torch.Tensor:
    """p + q for packed (4, 10, *batch) int32 points of one shape; T only
    when need_t (zeros otherwise)."""
    _check_point(p)
    if p.shape != q.shape:
        raise ValueError(f"shape mismatch {tuple(p.shape)} vs {tuple(q.shape)}")
    if not _on_cuda(p, q):
        return ed_add_plain(p, q, need_t)
    return _add_launch(p, q, False, need_t)


def ed_add_mixed(p: torch.Tensor, q_xyt: torch.Tensor) -> torch.Tensor:
    """p + q for a packed (4, 10, *batch) int32 point p and an affine
    (3, 10, *batch) int32 q = x|y|t of the same batch; T computed."""
    _check_point(p)
    if q_xyt.dtype != torch.int32 or tuple(q_xyt.shape) != (3, 10) + tuple(p.shape[2:]):
        raise ValueError(f"expected an int32 (3, 10, *batch) affine point for "
                         f"batch {tuple(p.shape[2:])}, got {q_xyt.dtype} "
                         f"{tuple(q_xyt.shape)}")
    if not _on_cuda(p, q_xyt):
        return ed_add_mixed_plain(p, q_xyt)
    return _add_launch(p, q_xyt, True, True)


ed_add.launches = 0
ed_add.launches_by_mode = dict.fromkeys(("full", "need_t=False", "mixed"), 0)


def ed_double(p: torch.Tensor, need_t: bool = True, k: int = 1) -> torch.Tensor:
    """[2^k]p for a packed (4, 10, *batch) int32 point, one launch for the
    whole run; T only when need_t (zeros otherwise)."""
    _check_point(p)
    _check_k(k)
    if not _on_cuda(p):
        return ed_double_plain(p, need_t, k)
    w = p[0, 0].numel()
    if w == 0:
        return p
    p = p.contiguous()
    out = torch.empty_like(p)
    rc = build.kernels().ed_double_launch(
        p.data_ptr(), out.data_ptr(), k, int(need_t), w, _stream(p.device))
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
    ed_add.launches_by_mode = dict.fromkeys(ed_add.launches_by_mode, 0)


def launches() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}

