"""``pow448_kernel``: x^e over p448 (ops/csrc/pow448.cu),
launched by ``ops.group.pow448_kernel``."""

from __future__ import annotations

from ..pow_chain import hook_for, work  # noqa: F401

TRACE = r"\bpow448_kernel\b"
hook = hook_for("pow448_kernel")
