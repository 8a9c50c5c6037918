"""Datasheet peaks of the cards the port runs on.

Copied from ``src/repro_torch/utils/roofline.py`` (``HW``, ``CARDS``,
``card``) at commit cb64fea1c63dc5ff4d7b3fa90baae8ccbbb73fb8: NVIDIA's
datasheets, dense rates.  Only the fields the benchmark reads are kept.
Later changes to the program do not change this copy.
"""
from __future__ import annotations

import dataclasses

__all__ = ["Peaks", "CARDS", "card"]


@dataclasses.dataclass(frozen=True)
class Peaks:
    """One SKU: ``name`` is matched against the card's reported name."""

    name: str
    f32_flops: float    # FLOP/s on the CUDA cores (FMA), no tensor cores
    hbm_bw: float       # bytes/s


# First match wins, so the longer names come before "H100".
CARDS = (
    Peaks("H100 NVL", 60e12, 3.9e12),
    Peaks("H100 PCIe", 51e12, 2.0e12),
    Peaks("H100", 67e12, 3.35e12),      # SXM5 80GB HBM3
    Peaks("H200", 67e12, 4.8e12),
)


def card(device_name: str) -> Peaks:
    """The row whose name is in ``device_name``; KeyError for a card the
    table does not hold."""
    for hw in CARDS:
        if hw.name in device_name:
            return hw
    raise KeyError(f"no datasheet peaks for {device_name!r}")
