"""``pow_sec2_kernel``: x^e over a SEC2 prime, a SEC2 group order or l
(ops/csrc/pow_sec2.cuh, one instance per prime), launched by
``ops.group.pow_sec2_kernel``."""

from __future__ import annotations

from ..pow_chain import hook_for, work  # noqa: F401

TRACE = r"\bpow_sec2_kernel\b"
hook = hook_for("pow_sec2_kernel")
