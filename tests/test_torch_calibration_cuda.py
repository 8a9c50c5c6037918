"""The calibration's measurement on the card (`repro_torch.core.calibration`
through ``calibrate_torch.collect_records``).

Marked ``gpu``: the ``cuda`` fixture skips where there is no card (decided
inside the fixture, never at import time).  Run on a machine with an H100:

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q \
        tests/test_torch_calibration_cuda.py

ResNet-18's layers at 32 px, batch 2, on the card and on the CPU from the
same seeds: the modeled rows are equal (the paper-model cycles, which
count the nonzero activations, within 0.1%: a ReLU output at f32 noise
around 0 can differ between cuDNN and the CPU), and each layer's measured
time on the card (a CUDA graph, timed by CUDA events) is positive.
"""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import calibrate_torch  # noqa: E402

pytestmark = pytest.mark.gpu

LAYERS = {"resnet18/conv1", "resnet18/layer2_0_conv1",
          "resnet18/layer2_0_down", "resnet18/fc"}
GEOMETRY = dict(image_size=32, batch=2, num_classes=200)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_card_rows_match_the_cpu_rows(cuda):
    card = calibrate_torch.collect_records(
        ("vgg16", "resnet18"), layers=LAYERS, repeats=3, warmup=1,
        device=cuda, **GEOMETRY)
    cpu = calibrate_torch.collect_records(
        ("vgg16", "resnet18"), layers=LAYERS, measure=False, device="cpu",
        **GEOMETRY)
    assert [r["name"] for r in card] == [r["name"] for r in cpu]
    assert len(card) == len(LAYERS)
    for a, b in zip(card, cpu):
        assert a.pop("measured_us") > 0
        ca, cb = a.pop("modeled_cycles"), b.pop("modeled_cycles")
        fa, fb = a["features"].pop("cycles"), b["features"].pop("cycles")
        assert ca == fa and cb == fb
        assert abs(ca - cb) <= 1e-3 * cb, a["name"]
        assert a == b
