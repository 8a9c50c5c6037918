"""Device selection for the port's entry points."""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "card_path"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (explicitly or by default) and
    there is no card — there is no silent fall back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def card_path(t: torch.Tensor) -> bool:
    """True where ``t`` takes the card's path: a CUDA tensor, or a meta
    tensor (the dry run's abstract device, `utils.cost`), so that a count
    taken on meta follows the ops the card runs.  CPU tensors take the
    plain paths."""
    return t.device.type in ("cuda", "meta")
