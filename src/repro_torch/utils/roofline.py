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
    collective term = sum over the mesh dims of that dim's wire bytes /
                      the rate of the slowest link its groups cross

The per-device step of a mesh (`launch.dryrun` with a mesh) prices each
mesh dim at its own link (`dim_links`): ranks are laid out with the last
dim (``model``) fastest, `HW.node_gpus` to a node; a dim whose groups
stay inside a node rides NVLink, any other the network.  So at 16x16 a
``model`` group of 16 spans two nodes, and ``data`` and ``pod`` groups
always leave the node.  The rates are the datasheets' (each way, per
GPU): predictions, not measurements.  One card moves no byte over a
wire: its collective term is 0.

Stated differences: ``mfu`` divides by the `HW` row's bf16 peak where
the reference divides by v5e's 197e12 (`repro/utils/roofline.py:84`),
the reference prices every collective at one ICI link rate, and the
report adds ``fits``: the step's arguments and temporaries within the
card's memory.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
from typing import Any

__all__ = ["HW", "CARDS", "card", "card_hw", "smi_name_and_power",
           "RooflineReport", "report", "save_rows", "dim_links",
           "collective_seconds", "LINK_NOTE"]


@dataclasses.dataclass(frozen=True)
class HW:
    """One SKU's peaks, from NVIDIA's datasheet (dense rates, the
    sparsity figures halved).  ``name`` is matched against the name the
    card reports (`torch.cuda.get_device_name`, ``nvidia-smi``).  The
    link rates are per GPU, each way; 0 where the row has none."""

    name: str
    f32_flops: float    # FLOP/s on the CUDA cores, no tensor cores
    hbm_bw: float       # bytes/s
    bf16_flops: float   # dense bf16 tensor-core FLOP/s
    int8_ops: float     # dense int8 tensor-core OP/s
    hbm_bytes: float    # device memory (the datasheet's GB, 1e9 bytes)
    nvlink_bw: float = 0.0   # bytes/s to a GPU of the same node
    node_gpus: int = 1       # GPUs a node joins by NVLink
    net_bw: float = 0.0      # bytes/s to a GPU of another node

    @property
    def hbm_gbps(self) -> float:
        return self.hbm_bw / 1e9


# First match wins, so the longer names come before "H100".
# The SXM rows' links: NVLink 4 inside an 8-GPU HGX/DGX node, 900 GB/s
# a GPU both ways together, 450 GB/s each way (NVIDIA H100 / H200
# datasheets); between nodes one 400 Gb/s ConnectX-7 port a GPU, 50 GB/s
# each way (NVIDIA DGX H100 user guide).  The NVL and PCIe rows carry no
# link figures: a mesh of more than one of them is not priced.
_NVLINK4, _NODE, _CX7 = 450e9, 8, 50e9
CARDS = (
    HW("H100 NVL", 60e12, 3.9e12, 835e12, 1670e12, 94e9),
    HW("H100 PCIe", 51e12, 2.0e12, 756e12, 1513e12, 80e9),
    HW("H100", 67e12, 3.35e12, 989e12, 1979e12, 80e9,    # SXM5 80GB HBM3
       _NVLINK4, _NODE, _CX7),
    HW("H200", 67e12, 4.8e12, 989e12, 1979e12, 141e9, _NVLINK4, _NODE, _CX7),
)

LINK_NOTE = ("collective term priced at datasheet link rates (NVLink "
             "450 GB/s inside an 8-GPU node, 50 GB/s between nodes, each "
             "way): a prediction")


def dim_links(mesh_shape: dict[str, int], hw: HW) -> dict[str, float]:
    """{mesh dim: the rate (bytes/s each way) of the slowest link its
    groups cross}.  Ranks are laid out with the last dim fastest and
    ``hw.node_gpus`` to a node, so the groups of a dim stay inside a
    node when the dims from it to the last span a divisor of the node;
    otherwise they cross the network."""
    out, span = {}, 1
    for name, size in reversed(list(mesh_shape.items())):
        span *= size
        inside = span <= hw.node_gpus and hw.node_gpus % span == 0
        out[name] = hw.nvlink_bw if inside else hw.net_bw
    return dict(reversed(list(out.items())))


def collective_seconds(coll_by_dim: dict[str, float],
                       mesh_shape: dict[str, int], hw: HW) -> float:
    """The collective term: each mesh dim's wire bytes over its link
    (`dim_links`), summed; bytes of a group of no mesh dim (``"?"``) at
    the slowest link.  Raises where bytes meet a link of no rate."""
    links = dim_links(mesh_shape, hw)
    slowest = min(links.values(), default=0.0)
    total = 0.0
    for dim, nbytes in coll_by_dim.items():
        if not nbytes:
            continue
        bw = links.get(dim, slowest)
        if bw <= 0:
            raise ValueError(f"{hw.name}: no link rate for mesh dim {dim!r}")
        total += nbytes / bw
    return total


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
           notes: str = "", mesh_shape: dict | None = None
           ) -> RooflineReport:
    """The reference's `report` over a counted step: ``cost`` has
    ``flops``, ``bytes``, ``coll_bytes`` and ``coll_by_kind``, and under
    a mesh ``coll_by_dim`` (`utils.cost.StepCost`); ``mem_stats``
    ``argument_size_in_bytes`` and ``temp_size_in_bytes`` (a `StepCost`
    has both).  ``mesh_shape`` ({dim: size}) prices the collective term
    per mesh dim (`collective_seconds`); without it the step is one
    card's, whose term is 0."""
    arg_b = getattr(mem_stats, "argument_size_in_bytes", 0) if mem_stats else 0
    tmp_b = getattr(mem_stats, "temp_size_in_bytes", 0) if mem_stats else 0
    coll_s = 0.0
    if mesh_shape is not None:
        coll_s = collective_seconds(cost.coll_by_dim, mesh_shape, hw)
    elif cost.coll_bytes:
        raise ValueError("wire bytes without a mesh to price them on")
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        compute_s=cost.flops / hw.bf16_flops,
        memory_s=cost.bytes / hw.hbm_bw,
        collective_s=coll_s,
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
