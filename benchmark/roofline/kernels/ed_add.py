"""``ed_add_kernel`` (ops/csrc/group.cu): the extended twisted-Edwards
addition add-2008-hwcd-3 over 2^255-19 in its three modes, as
``ops.group._add_launch`` launches it."""

from __future__ import annotations

from ..formula import element_bytes, madds

TRACE = r"\bed_add_kernel\b"
BITS = 255
# per lane: (multiplications, coordinates read, coordinates written). The
# full addition: A, B, T1 T2, its product by 2d, Z1 Z2, X3, Y3, Z3, T3.
# need_t=False skips T3; mixed (Z2 = 1, q read as x|y|t) skips Z1 Z2.
MODES = {"full": (9, 8, 4), "need_t=False": (8, 8, 3), "mixed": (8, 7, 4)}


def hook(record):
    from eccoxide_tpu_torch.ops import group

    orig = group._add_launch

    def launch(p, q, mixed, need_t):
        before = group.ed_add.launches
        out = orig(p, q, mixed, need_t)
        if group.ed_add.launches > before:
            mode = "mixed" if mixed else "full" if need_t else "need_t=False"
            record({"mode": mode, "w": int(p[0, 0].numel())})
        return out

    group._add_launch = launch
    return lambda: setattr(group, "_add_launch", orig)


def work(rec: dict) -> tuple[int, int]:
    m, read, written = MODES[rec["mode"]]
    return rec["w"] * madds(BITS, m, 0), rec["w"] * (read + written) * element_bytes(BITS)
