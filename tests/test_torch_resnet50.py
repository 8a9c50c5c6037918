"""ResNet-50 (the reference's headline net) through the port against the
JAX reference, on the CPU; see `_torch_resnet_parity.py` for the inputs
and tolerances.

ResNet-50 brings onto a served path the residual fused into `vsmm`'s
epilogue (every bottleneck's conv3), a 1x1 stride-1 projection
(``layer1_0_down``), 32 block 1x1 convs through `vsmm` and 53 sparse
layers in one forward.

Marked ``gpu`` (they skip here): the reduced net served on the card, f32
and int8, against eager and plain `net_apply`, with exact launch counts.
"""
import importlib

import pytest

import _torch_resnet_parity as P
from _torch_threads import one_torch_thread  # noqa: F401
from repro.models import graph as jg
from repro_torch.configs import get_config
from repro_torch.models import graph as tg

jcfg = importlib.import_module("repro.configs.vscnn_resnet50").CONFIG

CFG = get_config("vscnn-resnet50")
SMALL = CFG.reduce()
CASES = [(d, t) for d in P.DENSITIES for t in (None, "int8")]


@pytest.fixture(scope="module")
def nets():
    return (jg.build_resnet50(SMALL.num_classes, image_size=32),
            SMALL.build())


@pytest.fixture(scope="module")
def tree(nets):
    return P.weights(nets[0])


@pytest.fixture(scope="module")
def x():
    return P.images()


@pytest.fixture(scope="module")
def ref(nets, tree, x):
    return P.reference(nets[0], tree, x)


def test_config_matches_reference():
    P.check_config(CFG, SMALL, jcfg)


def test_builder_matches_reference(nets):
    P.check_builder(*nets, CFG.build(), jg.build_resnet50())
    assert tg.RESNET50_STAGES == jg.RESNET50_STAGES
    convs = CFG.build().conv_layers()
    three = [l for l in convs if l.kh * l.kw > 1]
    ones = [l for l in convs if l.kh * l.kw == 1]
    # the kernels of a forward: 17 vsconv_halo (stem + 16 3x3s), 37 vsmm
    # (32 block 1x1s, 4 projections, the head)
    assert (len(three), len(ones) + 1) == (17, 36 + 1)
    assert sum(l.residual is not None for l in ones) == 16
    down = {l.name: l for l in ones}["layer1_0_down"]
    assert (down.cin, down.cout, down.stride) == (64, 256, 1)


@pytest.mark.parametrize("density,dtype", CASES)
def test_sparsify_reproduces_reference_encoding(nets, tree, ref, density,
                                                dtype):
    P.check_encoding(nets[1], tree, ref, density, dtype)


@pytest.mark.parametrize("density,dtype", CASES)
def test_logits_match_reference_jnp(nets, tree, x, ref, density, dtype):
    P.check_logits(nets[1], tree, x, ref, density, dtype)


@pytest.mark.parametrize("dtype", [None, "int8"])
def test_server_equals_net_apply(dtype):
    P.check_server(SMALL, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [None, "int8"])
def test_served_on_the_card(dtype):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    P.check_served_on_card(SMALL, dtype, {"vsconv_halo": 17, "vsmm": 37})
