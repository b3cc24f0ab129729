"""The work of a pow kernel, x^e by the 4-bit fixed-window chain over the
field of the launch, recorded through ``ops.group._pow`` for the wrapper
that launched it."""

from __future__ import annotations

from .formula import element_bytes, madds, pow_counts


def hook_for(wrapper_name: str):
    def hook(record):
        from eccoxide_tpu_torch.ops import group

        orig = group._pow

        def pow_(f, x, e, lib, entry, wrapper):
            before = wrapper.launches
            out = orig(f, x, e, lib, entry, wrapper)
            if wrapper.__name__ == wrapper_name and wrapper.launches > before:
                record({"bits": f.p.bit_length(), "e": int(e), "w": int(x[0].numel())})
            return out

        group._pow = pow_
        return lambda: setattr(group, "_pow", orig)

    return hook


def work(rec: dict) -> tuple[int, int]:
    """The chain's products and squarings; one element read, one written."""
    m, s = pow_counts(rec["e"])
    return rec["w"] * madds(rec["bits"], m, s), rec["w"] * 2 * element_bytes(rec["bits"])
