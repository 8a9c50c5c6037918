"""Kernel kinds by device-event name.

Copied from ``chip_smoke.py`` ``_kind`` at commit
cb64fea1c63dc5ff4d7b3fa90baae8ccbbb73fb8.  Later changes to the program
do not change this copy.
"""
from __future__ import annotations

import re

__all__ = ["kind", "is_phase2"]

_KERNEL = re.compile(r"(vsconv_dw_halo|vsconv_dw_stack|vsconv_halo|"
                     r"vsconv_stack|vsmm|flash_fwd)_(?:stem_)?(int8_|bf16_)?"
                     r"(?:reduce_)?kernel")


def kind(name: str) -> str:
    """A stem body is filed under its kernel, a second phase (``reduce``)
    under its kernel; other device events are ``copy``, ``gemm`` or
    ``other``."""
    m = _KERNEL.search(name)
    if m:
        return m.group(1) + ("_int8" if m.group(2) == "int8_" else "")
    if "flash_mma_kernel" in name or "flash_simt_kernel" in name:
        return "flash_fwd"
    if "Memcpy" in name or "Memset" in name:
        return "copy"
    if any(key in name for key in ("gemm", "nvjet", "xmma", "cutlass",
                                   "splitK")):
        return "gemm"
    return "other"


def is_phase2(name: str) -> bool:
    """True for a kernel's second phase (the split sums' reduction), which
    is not a launch of its own layer."""
    return "reduce_kernel" in name
