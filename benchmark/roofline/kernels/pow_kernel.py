"""``pow_kernel``: x^e over 2^255-19 (ops/csrc/group.cu),
launched by ``ops.group.pow_const_kernel``."""

from __future__ import annotations

from ..pow_chain import hook_for, work  # noqa: F401

TRACE = r"\bpow_kernel\b"
hook = hook_for("pow_const_kernel")
