"""ResNet-34 (ResNet-18's basic blocks at the (3, 4, 6, 3) stage depths)
through the port against the JAX reference, on the CPU; see
`_torch_resnet_parity.py` for the inputs and tolerances.

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

jcfg = importlib.import_module("repro.configs.vscnn_resnet34").CONFIG

CFG = get_config("vscnn-resnet34")
SMALL = CFG.reduce()
CASES = [(d, t) for d in P.DENSITIES for t in (None, "int8")]


@pytest.fixture(scope="module")
def nets():
    return (jg.build_resnet34(SMALL.num_classes, image_size=32),
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
    P.check_builder(*nets, CFG.build(), jg.build_resnet34())
    assert tg.RESNET34_STAGES == jg.RESNET34_STAGES
    convs = CFG.build().conv_layers()
    # the kernels of a forward: 33 vsconv_halo (stem + 32 3x3s), 4 vsmm
    # (3 projections, the head)
    assert (sum(l.kh * l.kw > 1 for l in convs),
            sum(l.kh * l.kw == 1 for l in convs) + 1) == (33, 4)


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
    P.check_served_on_card(SMALL, dtype, {"vsconv_halo": 33, "vsmm": 4})
