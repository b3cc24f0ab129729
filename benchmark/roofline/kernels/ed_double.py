"""``ed_double_kernel`` (ops/csrc/group.cu): k doublings dbl-2008-hwcd
over 2^255-19 in one launch. Recorded at the library's C entry point
``ed_double_launch`` (p, out, k, need_t, lanes, stream), which
``ops.group.ed_double`` reaches through ``ops.build.kernels("group")``."""

from __future__ import annotations

from ..formula import element_bytes, madds

TRACE = r"\bed_double_kernel\b"
BITS = 255


class _Recording:
    """The kernel library, its ``ed_double_launch`` recording each launch
    that returned no error."""

    def __init__(self, lib, record):
        self._lib, self._record = lib, record

    def __getattr__(self, attr):
        fn = getattr(self._lib, attr)
        if attr != "ed_double_launch":
            return fn

        def launch(p, out, k, need_t, w, stream):
            rc = fn(p, out, k, need_t, w, stream)
            if rc == 0:
                self._record({"k": int(k), "need_t": bool(need_t), "w": int(w)})
            return rc

        return launch


def hook(record):
    from eccoxide_tpu_torch.ops import build

    orig = build.kernels

    def kernels(name):
        lib = orig(name)
        return _Recording(lib, record) if name == "group" else lib

    build.kernels = kernels
    return lambda: setattr(build, "kernels", orig)


def work(rec: dict) -> tuple[int, int]:
    """Per step 4 squarings (X^2, Y^2, Z^2, (X+Y)^2) and 3 products (X3,
    Y3, Z3); T3 once at the end when asked for. X, Y, Z read, X, Y, Z (and
    T) written."""
    k, t = rec["k"], int(rec["need_t"])
    return (rec["w"] * madds(BITS, 3 * k + t, 4 * k),
            rec["w"] * (3 + 3 + t) * element_bytes(BITS))
