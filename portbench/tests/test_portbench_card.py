"""On the card: the control (the reference in TF32) fails the limit that
the program's f32 logits meet, at a size a test run holds, and one short
run of each offline cell is correct.  Run on the chip:

    python -m pytest portbench/tests/test_portbench_card.py -q
"""
import numpy as np
import pytest
import torch

from portbench.harness.check import logit_rel_err, reference_logits
from portbench.harness.manifest import load_cell
from portbench.tests.conftest import ROOT, load_run


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["resnet50.offline", "vgg16.offline"])
def test_control_fails_the_limit(card, cell):
    import portbench.reference.resnet50 as r50
    import portbench.reference.vgg16 as v16
    c = load_cell(cell, manifest=ROOT / "BENCHMARK.json")
    ref = r50 if c.config["reference"] == "resnet50" else v16
    images = torch.randn(32, 224, 224, 3, generator=torch.Generator()
                         .manual_seed(1)).numpy()
    f32, tf32 = reference_logits(c.config, ref, 2**31 + 77, images, card,
                                 tf32=(False, True))
    assert logit_rel_err(tf32, f32) > c.config["limits"]["logit_rel_err"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["resnet50.offline", "vgg16.offline"])
def test_short_run_is_correct(card, cell):
    run = load_run()
    c = load_cell(cell, manifest=ROOT / "BENCHMARK.json")
    result = run.run(c, 2**31 + 78, 2.0, False, "cuda")
    assert result["correct"] is True, result["checks"]
    assert np.isfinite(result["metrics"]["images_per_s"]["value"])
