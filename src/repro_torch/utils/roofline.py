"""The datasheet peaks of the cards the port runs on, and the roofline
report of a counted step.

The counterpart of `repro/utils/roofline.py`.  `HW` rows are the one
table that ``chip_smoke.py``'s bounds, the calibration's byte term and
the dry run read; `smi_name_and_power` gives the card's name and power
limit as ``nvidia-smi`` reports them.  `RooflineReport` / `report`
(`repro/utils/roofline.py:42-146`) keep the reference's fields,
properties and `row()` keys, read from a step counted by `utils.cost`
(the reference reads a compiled XLA program, `repro/utils/hlo.py`):

    compute term    = FLOPs / the card's dense bf16 peak
    memory term     = bytes / the card's HBM rate
    collective term = 0 (one card: no wire)

Stated differences: ``mfu`` divides by the `HW` row's bf16 peak where
the reference divides by v5e's 197e12 (`repro/utils/roofline.py:84`),
and the report adds ``fits``: the step's arguments and temporaries
within the card's memory.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
from typing import Any

__all__ = ["HW", "CARDS", "card", "card_hw", "smi_name_and_power",
           "RooflineReport", "report", "save_rows"]


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
    hbm_bytes: float    # device memory (the datasheet's GB, 1e9 bytes)

    @property
    def hbm_gbps(self) -> float:
        return self.hbm_bw / 1e9


# First match wins, so the longer names come before "H100".
CARDS = (
    HW("H100 NVL", 60e12, 3.9e12, 835e12, 1670e12, 94e9),
    HW("H100 PCIe", 51e12, 2.0e12, 756e12, 1513e12, 80e9),
    HW("H100", 67e12, 3.35e12, 989e12, 1979e12, 80e9),  # SXM5 80GB HBM3
    HW("H200", 67e12, 4.8e12, 989e12, 1979e12, 141e9),
)


def card(device_name: str) -> HW:
    """The row whose name is in ``device_name``; raises KeyError for a
    card the table does not hold."""
    for hw in CARDS:
        if hw.name in device_name:
            return hw
    raise KeyError(f"no datasheet peaks for {device_name!r}")


def card_hw() -> HW:
    """The row of the card this process sees (device 0), its memory
    taken from the card itself
    (``torch.cuda.get_device_properties(0).total_memory``) in place of
    the datasheet's."""
    import torch
    props = torch.cuda.get_device_properties(0)
    return dataclasses.replace(card(props.name),
                               hbm_bytes=float(props.total_memory))


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


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    device_flops: float
    device_bytes: float
    device_coll_bytes: float
    model_flops: float            # 6*N*D useful-work reference (global)
    arg_bytes: float              # per-device argument residency
    temp_bytes: float
    coll_by_kind: dict
    peak_flops: float             # the bf16 peak that ``mfu`` divides by
    hbm_bytes: float              # the card's memory that ``fits`` reads
    notes: str = ""

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """compute term / max term — 1.0 means pure compute-bound."""
        return self.compute_s / max(self.step_time_s, 1e-30)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs (remat/redundancy/attention waste)."""
        global_flops = self.device_flops * self.chips
        return self.model_flops / max(global_flops, 1e-30)

    @property
    def mfu(self) -> float:
        """model FLOPs / (chips * peak * step_time) — the MFU the roofline
        model predicts if the step ran exactly at its dominant bound."""
        return self.model_flops / (self.chips * self.peak_flops
                                   * max(self.step_time_s, 1e-30))

    @property
    def fits(self) -> bool:
        """The step's arguments and temporaries fit in the card's memory."""
        return self.arg_bytes + self.temp_bytes <= self.hbm_bytes

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "compute_ms": self.compute_s * 1e3,
            "memory_ms": self.memory_s * 1e3,
            "collective_ms": self.collective_s * 1e3,
            "dominant": self.dominant,
            "roofline_fraction": self.roofline_fraction,
            "useful_flops_ratio": self.useful_flops_ratio,
            "predicted_mfu": self.mfu,
            "device_flops": self.device_flops,
            "device_bytes": self.device_bytes,
            "device_coll_bytes": self.device_coll_bytes,
            "model_flops": self.model_flops,
            "arg_gb": self.arg_bytes / 1e9,
            "temp_gb": self.temp_bytes / 1e9,
            "coll_by_kind": {k: v for k, v in sorted(
                self.coll_by_kind.items(), key=lambda kv: -kv[1])},
            "notes": self.notes,
            "fits": self.fits,
        }

    def summary(self) -> str:
        r = self.row()
        return (
            f"{self.arch} x {self.shape} @ {self.mesh} ({self.chips} chips)\n"
            f"  compute {r['compute_ms']:9.3f} ms | memory {r['memory_ms']:9.3f} ms"
            f" | collective {r['collective_ms']:9.3f} ms  -> {self.dominant}-bound\n"
            f"  roofline fraction {self.roofline_fraction:5.1%}"
            f" | useful-FLOPs ratio {self.useful_flops_ratio:5.2f}"
            f" | predicted MFU {self.mfu:5.1%}\n"
            f"  per-device: {self.device_flops/1e12:.2f} TFLOP,"
            f" {self.device_bytes/1e9:.2f} GB HBM, {self.device_coll_bytes/1e9:.3f} GB wire,"
            f" args {self.arg_bytes/1e9:.2f} GB, temps {self.temp_bytes/1e9:.2f} GB"
            f" ({'fits' if self.fits else 'does not fit'} in"
            f" {self.hbm_bytes/1e9:.1f} GB)"
        )


def report(*, arch: str, shape: str, mesh_name: str, chips: int, cost: Any,
           model_flops: float, mem_stats: Any = None, hw: HW,
           notes: str = "") -> RooflineReport:
    """The reference's `report` over a counted step: ``cost`` has
    ``flops``, ``bytes``, ``coll_bytes`` and ``coll_by_kind``
    (`utils.cost.StepCost`); ``mem_stats`` ``argument_size_in_bytes``
    and ``temp_size_in_bytes`` (a `StepCost` has both).  The collective
    term is 0: one card has no wire."""
    arg_b = getattr(mem_stats, "argument_size_in_bytes", 0) if mem_stats else 0
    tmp_b = getattr(mem_stats, "temp_size_in_bytes", 0) if mem_stats else 0
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        compute_s=cost.flops / hw.bf16_flops,
        memory_s=cost.bytes / hw.hbm_bw,
        collective_s=0.0,
        device_flops=cost.flops,
        device_bytes=cost.bytes,
        device_coll_bytes=cost.coll_bytes,
        model_flops=model_flops,
        arg_bytes=arg_b,
        temp_bytes=tmp_b,
        coll_by_kind=cost.coll_by_kind,
        peak_flops=hw.bf16_flops,
        hbm_bytes=hw.hbm_bytes,
        notes=notes,
    )


def save_rows(path: str, rows: list[dict]) -> None:
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)
