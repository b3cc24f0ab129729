"""The Edwards group-law and pow kernels, counterpart of
the JAX package's ``ops/pallas_group.py``.

The wrappers, each with its plain PyTorch version beside it:

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
- ``pow_const_kernel(x, e)``: x^e over FQ for a public constant e;
- ``pow448_kernel(x, e)``: the same chain over FQ448 (``field448.py``), the
  JAX package's pow kernel instantiated for the field of curve448;
- ``pow_sec2_kernel(f, x, e)``: the same chain over a field f of
  ``field_sec2``'s format, the JAX package's pow kernel instantiated for
  any ``Field`` it is handed: one kernel instance per prime of
  ``build.POW_SEC2_INSTANCES`` (the SEC2 coordinate primes, the 15 SEC2
  group orders and l), its fold matrix compiled in
  (``build.pow_sec2_source``).

Points are packed int32 tensors ``(4, 10, *batch)`` (X|Y|Z|T, limbs of
``field.py``); field batches are ``(10, *batch)``, ``(16, *batch)`` for
FQ448, ``(f.n, *batch)`` for a SEC2 field. A wrapper given CPU tensors
runs the plain version; given CUDA tensors it launches its kernel
(``csrc/group.cu``, ``csrc/pow448.cu``, ``csrc/pow_sec2.cuh``) or raises. Each wrapper counts its launches in a plain
integer attribute ``launches``, and ``ed_add`` splits its count by mode in
``ed_add.launches_by_mode``; nothing else touches the counts. Beside the
count, each launch adds its shape to the wrapper's set ``shapes``: the
arguments that select the kernel's work, with the width in lanes
(``ed_add``: (mode, W); ``ed_double``: (k, need_t, W); a pow: (field, e,
W)), so that a caller can hold the kernel against its plain version at
every shape a path gave it; ``launch_report`` gives counts and shapes as
JSON values, for a record read in another process.

The JAX package's adapter ``PallasGroup`` has no class here: the curve
``curves.curve25519.EDWARDS`` sends every add and double through these
wrappers, so the curve itself is the group the MSM and the verifiers use.
"""

from __future__ import annotations

import torch

from ..field import FQ, P
from ..field448 import FQ448
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


def _pow_plain(f, x, e: int):
    """x^e over field f: table x^0..x^15, then per digit 4 squarings and,
    unless the digit is 0, 1 multiply (group.cu pow_kernel, pow448.cu
    pow448_kernel, pow_sec2.cuh pow_sec2_kernel). e is public, so skipping
    the product by x^0 depends on nothing secret; it changes the limbs (a
    product's carry and fold do not run), which is why the kernels and
    this chain share the rule."""
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
        if d:
            acc = f.mul(acc, tab[d])
    return acc


def pow_const_plain(x, e: int):
    """x^e over FQ, the chain of the pow kernel."""
    return _pow_plain(FQ, x, e)


def pow448_plain(x, e: int):
    """x^e over FQ448, the chain of the pow448 kernel."""
    return _pow_plain(FQ448, x, e)


def pow_sec2_plain(f, x, e: int):
    """x^e over the SEC2 field f, the chain of the pow_sec2 kernel."""
    return _pow_plain(f, x, e)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _add_launch(p, q, mixed: bool, need_t: bool) -> torch.Tensor:
    w = p[0, 0].numel()
    if w == 0:
        return p
    p, q = p.contiguous(), q.contiguous()
    out = torch.empty_like(p)
    rc = build.kernels("group").ed_add_launch(
        p.data_ptr(), q.data_ptr(), out.data_ptr(), int(mixed), int(need_t), w,
        _stream(p.device))
    _raise_on(rc, "ed_add")
    mode = "mixed" if mixed else "full" if need_t else "need_t=False"
    ed_add.launches += 1
    ed_add.launches_by_mode[mode] += 1
    ed_add.shapes.add((mode, w))
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
    rc = build.kernels("group").ed_double_launch(
        p.data_ptr(), out.data_ptr(), k, int(need_t), w, _stream(p.device))
    _raise_on(rc, "ed_double")
    ed_double.launches += 1
    ed_double.shapes.add((k, bool(need_t), w))
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


def _pow(f, x: torch.Tensor, e: int, lib: str, entry: str, wrapper) -> torch.Tensor:
    """x^e over field f for an int32 (f.n, *batch) batch and a public
    e >= 0: the plain version on a CPU tensor, else one launch of the C
    entry point ``entry`` of kernel library ``lib``."""
    if x.dtype != torch.int32 or x.dim() < 1 or x.shape[0] != f.n:
        raise ValueError(f"expected int32 ({f.n}, *batch), got {x.dtype} "
                         f"{tuple(x.shape)}")
    if e < 0:
        raise ValueError("negative exponent")
    if not _on_cuda(x):
        return _pow_plain(f, x, e)
    if e == 0:
        return f.one(x.shape[1:], x.device)
    w = x[0].numel()
    if w == 0:
        return x
    x = x.contiguous()
    dig = _digits_on(e, x.device)
    out = torch.empty_like(x)
    launch = getattr(build.kernels(lib), entry)
    rc = launch(x.data_ptr(), out.data_ptr(), dig.data_ptr(), dig.numel(), w,
                _stream(x.device))
    _raise_on(rc, wrapper.__name__)
    wrapper.launches += 1
    wrapper.shapes.add((f, e, w))
    return out


def pow_const_kernel(x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e over FQ for an int32 (10, *batch) batch and a public e >= 0."""
    return _pow(FQ, x, e, "group", "pow_launch", pow_const_kernel)


pow_const_kernel.launches = 0


def pow448_kernel(x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e over FQ448 for an int32 (16, *batch) batch and a public e >= 0."""
    return _pow(FQ448, x, e, "pow448", "pow448_launch", pow448_kernel)


pow448_kernel.launches = 0


def pow_sec2_kernel(f, x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e over the field f (``field_sec2.Field``) for an int32 (f.n,
    *batch) batch and a public e >= 0: on a CPU tensor the plain chain, for
    any odd prime; on a CUDA tensor the kernel instance of f's prime, and a
    prime with no instance raises."""
    name = build.POW_SEC2_INSTANCES.get(f.p)
    if name is None and _on_cuda(x):
        raise ValueError(f"no pow_sec2 kernel for p = {f.p:#x}")
    return _pow(f, x, e, f"pow_sec2_{f.n}", f"pow_sec2_launch_{name}", pow_sec2_kernel)


pow_sec2_kernel.launches = 0

WRAPPERS = (pow_const_kernel, ed_add, ed_double, pow448_kernel, pow_sec2_kernel)
POW_WRAPPERS = ("pow_const_kernel", "pow448_kernel", "pow_sec2_kernel")


for _w in WRAPPERS:
    _w.shapes = set()


def reset_launches():
    """Every count to 0 and every set of shapes emptied."""
    for w in WRAPPERS:
        w.launches = 0
        w.shapes = set()
    ed_add.launches_by_mode = dict.fromkeys(ed_add.launches_by_mode, 0)


def launches() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}


def launch_shapes() -> dict:
    """Wrapper name -> the shapes of its launches since the last reset."""
    return {w.__name__: set(w.shapes) for w in WRAPPERS}


def launch_report() -> dict:
    """The counts and shapes since the last reset as JSON values, for a
    record that another process reads: {"launches": {wrapper: count} of
    the wrappers that launched, "launch_shapes": sorted [wrapper, *shape]}
    with a pow's field written as its prime and its exponent in hex."""
    def row(name, shape):
        if name in POW_WRAPPERS:
            f, e, w = shape
            return [name, hex(f.p), hex(e), w]
        return [name, *shape]

    return {"launches": {w.__name__: w.launches for w in WRAPPERS if w.launches},
            "launch_shapes": sorted((row(w.__name__, s) for w in WRAPPERS for s in w.shapes),
                                    key=str)}
