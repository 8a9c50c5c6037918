"""The work each layer needs, counted from its shapes and the pruning's
kept weights: what these inputs need, whatever implements it.

  FLOPs = 2 x kept weights x output pixels (x rows of the wave)
  bytes = 4 x (input activations + kept weights + index entries + bias
          + output + residual), each once

The input counted is what the output depends on: the whole input of a
kh x kw > 1 conv, the sampled pixels of a strided 1x1 conv.  Weights and
indices are read once a launch, activations once a row.  `kernel` names
the source file that runs the layer in the port: an FC or an ungrouped
1x1 conv runs ``vsmm.cu``, every other conv ``vsconv.cu``.
"""
from __future__ import annotations

import dataclasses

from portbench.reference.common import Layer, kept_weights

__all__ = ["LayerWork", "layer_work", "wave_work"]

F32 = 4


@dataclasses.dataclass(frozen=True)
class LayerWork:
    name: str
    kernel: str     # "vsconv" | "vsmm"
    macs: int       # per image
    act_bytes: int  # per image: input + output + residual
    weight_bytes: int   # per launch: kept weights + indices + bias


def kernel_of(l: Layer) -> str:
    if l.op == "fc" or (l.kh == 1 and l.kw == 1):
        return "vsmm"
    return "vsconv"


def layer_work(l: Layer, density: float, *, vk: int, vn: int
               ) -> LayerWork:
    kept, tiles = kept_weights(l, density, vk=vk, vn=vn)
    pix_out = l.h_out * l.w_out
    if l.op == "conv" and l.kh * l.kw == 1:
        pix_in = pix_out
    else:
        pix_in = l.h_in * l.w_in
    act = l.cin * pix_in + l.cout * pix_out * (2 if l.residual else 1)
    return LayerWork(l.name, kernel_of(l), kept * pix_out, F32 * act,
                     F32 * (kept + tiles + l.cout))


def wave_work(works: list[LayerWork], rows: int, kernel: str, *,
              flops_peak: float, bytes_peak: float) -> float:
    """The least time, in seconds, that the layers of ``kernel`` need for
    one wave of ``rows`` images: each launch's max(FLOPs / peak, bytes /
    bandwidth), summed."""
    t = 0.0
    for w in works:
        if w.kernel != kernel:
            continue
        flops = 2.0 * w.macs * rows
        nbytes = w.act_bytes * rows + w.weight_bytes
        t += max(flops / flops_peak, nbytes / bytes_peak)
    return t
