"""The datasheet peaks of the cards the port runs on: the one table that
``chip_smoke.py``'s bounds and the calibration's byte term read, and the
card's name and power limit as ``nvidia-smi`` reports them.

The counterpart of `repro/utils/roofline.py`'s `HW` rows.  Its
`RooflineReport` and `report` read a compiled XLA program's cost
(`repro/utils/hlo.py`) and have no counterpart yet.
"""
from __future__ import annotations

import dataclasses
import subprocess

__all__ = ["HW", "CARDS", "card", "smi_name_and_power"]


@dataclasses.dataclass(frozen=True)
class HW:
    """One SKU's peaks, from NVIDIA's datasheet (dense rates, the
    sparsity figures halved).  ``name`` is matched against the name the
    card reports (`torch.cuda.get_device_name`, ``nvidia-smi``)."""

    name: str
    f32_flops: float    # FLOP/s on the CUDA cores, no tensor cores
    hbm_bw: float       # bytes/s
    bf16_flops: float   # dense bf16 tensor-core FLOP/s
    int8_ops: float     # dense int8 tensor-core OP/s

    @property
    def hbm_gbps(self) -> float:
        return self.hbm_bw / 1e9


# First match wins, so the longer names come before "H100".
CARDS = (
    HW("H100 NVL", 60e12, 3.9e12, 835e12, 1670e12),
    HW("H100 PCIe", 51e12, 2.0e12, 756e12, 1513e12),
    HW("H100", 67e12, 3.35e12, 989e12, 1979e12),   # H100 SXM5 80GB HBM3
    HW("H200", 67e12, 4.8e12, 989e12, 1979e12),
)


def card(device_name: str) -> HW:
    """The row whose name is in ``device_name``; raises KeyError for a
    card the table does not hold."""
    for hw in CARDS:
        if hw.name in device_name:
            return hw
    raise KeyError(f"no datasheet peaks for {device_name!r}")


def smi_name_and_power() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (the
    first card); every number kept from a run is written beside it.
    Raises where ``nvidia-smi`` is missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout
    return out.strip().splitlines()[0]
