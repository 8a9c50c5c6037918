"""vscheck's IR gate in the port (`repro_torch.analysis`) against the
reference's (`repro.analysis.ir`), on the CPU.

`check_net` walks every registered CNN (reduced and full size) and a set
of malformed nets, each built twice from one description (once from each
package's layer specs): the diagnostics (rule, severity, path, message,
hint), the conv and FC sites and the output shape must equal the
reference's.  `CNNServer(validate=True)` must refuse a malformed net
before it makes any weights.
"""
import dataclasses
from unittest import mock

import pytest
from _torch_threads import one_torch_thread  # noqa: F401

from repro.analysis.ir import check_net as ref_check_net
from repro.launch import serve as ref_serve
from repro.models import graph as jg
from repro_torch.analysis import RULES, VSCheckError, check_net
from repro_torch.analysis.diagnostics import RULES as PORT_RULES
from repro_torch.configs import get_config, list_cnn_archs
from repro_torch.launch import serve as ts
from repro_torch.models import graph as tg

REF_BUILDERS = {"vgg16": jg.build_vgg16, "resnet18": jg.build_resnet18,
                "resnet34": jg.build_resnet34, "resnet50": jg.build_resnet50,
                "mobilenet_v1": jg.build_mobilenet_v1}


def _asdict(nc) -> dict:
    return {"diagnostics": [dataclasses.asdict(d)
                            for d in nc.report.diagnostics],
            "conv_sites": [dataclasses.asdict(s) for s in nc.conv_sites],
            "fc_sites": [dataclasses.asdict(s) for s in nc.fc_sites],
            "out_shape": nc.out_shape}


def test_rule_catalog_is_the_reference_one():
    from repro.analysis.diagnostics import RULES as REF_RULES
    assert RULES is PORT_RULES
    assert RULES == REF_RULES


@pytest.mark.parametrize("size", [32, 224])
@pytest.mark.parametrize("arch", list_cnn_archs())
def test_registered_nets_match_reference(arch, size):
    cfg = get_config(arch)
    cfg = cfg.reduce() if size == 32 else cfg
    net = cfg.build()
    jnet = REF_BUILDERS[net.name](cfg.num_classes, image_size=size)
    for density in (cfg.weight_density, 1.0):
        got = check_net(net, (2, size, size, 3), density=density)
        want = ref_check_net(jnet, (2, size, size, 3), density=density)
        assert _asdict(got) == _asdict(want)
        assert not got.report.errors, got.report.render()
        assert got.conv_sites and got.fc_sites
    ts.validate_net(net, size, density=cfg.weight_density)


# name -> (layers from a graph module M, input shape, the rules expected)
MALFORMED = {
    "channel_mismatch": (lambda M: (M.Conv("c0", 3, 64, 3, 3),
                                    M.Conv("c1", 32, 64, 3, 3)),
                         (1, 16, 16, 3), {"VSC101"}),
    "residual_shape": (lambda M: (M.Save("skip"),
                                  M.Conv("c0", 3, 64, 3, 3, stride=2),
                                  M.ResidualAdd("skip")),
                       (1, 16, 16, 3), {"VSC105"}),
    "fused_residual_shape": (lambda M: (M.Conv("c0", 3, 64, 3, 3),
                                        M.Save("s"),
                                        M.Conv("c1", 64, 128, 3, 3,
                                               residual="s")),
                             (1, 16, 16, 3), {"VSC105"}),
    "unsaved_slot": (lambda M: (M.Conv("c0", 3, 64, 3, 3),
                                M.ResidualAdd("nowhere")),
                     (1, 16, 16, 3), {"VSC104"}),
    "unsaved_src": (lambda M: (M.Conv("c0", 3, 64, 1, 1, src="nowhere"),),
                    (1, 16, 16, 3), {"VSC104"}),
    "pool_collapse": (lambda M: (M.Conv("c0", 3, 64, 3, 3),
                                 M.Pool("max", 4), M.Pool("max", 4),
                                 M.Pool("max", 4)),
                      (1, 16, 16, 3), {"VSC108"}),
    "grouped_divisibility": (lambda M: (M.Conv("c0", 32, 64, 3, 3,
                                               groups=3),),
                             (1, 16, 16, 32), {"VSC102"}),
    "non_positive": (lambda M: (M.Conv("c0", 3, 64, 3, 3, stride=0),),
                     (1, 16, 16, 3), {"VSC103"}),
    "fc_fan_in": (lambda M: (M.Conv("c0", 3, 64, 3, 3), M.Pool(kind="gap"),
                             M.Flatten(), M.FC("fc", 128, 10)),
                  (1, 16, 16, 3), {"VSC106"}),
    "fc_on_4d": (lambda M: (M.Conv("c0", 3, 64, 3, 3), M.FC("fc", 64, 10)),
                 (1, 16, 16, 3), {"VSC107"}),
    "conv_after_flatten": (lambda M: (M.Flatten(),
                                      M.Conv("c0", 3, 64, 3, 3)),
                           (1, 16, 16, 3), {"VSC107"}),
    "channel_multiplier": (lambda M: (M.Conv("c0", 32, 64, 3, 3,
                                             groups=32),),
                           (1, 16, 16, 32), {"VSC109"}),
}

# warnings only: valid nets the gate lets through
WARNINGS = {
    "channel_multiplier_allowed": (
        lambda M: (M.Conv("c0", 32, 64, 3, 3, groups=32,
                          allow_fallback=True),),
        (1, 16, 16, 32), {"VSC109", "VSC110"}),
    "kernel_exceeds_input": (lambda M: (M.Conv("c0", 32, 64, 7, 7),),
                             (1, 4, 4, 32), {"VSC112"}),
    "narrow_strip": (lambda M: (M.Conv("c0", 32, 131, 3, 3),),
                     (1, 8, 8, 32), {"VSC110"}),
    "dense_fc": (lambda M: (M.Flatten(), M.FC("fc", 48, 10)),
                 (1, 4, 4, 3), {"VSC116"}),
}


def _pair(layers):
    return (tg.SparseNet("bad", layers(tg)), jg.SparseNet("bad", layers(jg)))


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_nets_match_reference(name):
    layers, shape, rules = MALFORMED[name]
    net, jnet = _pair(layers)
    got, want = check_net(net, shape), ref_check_net(jnet, shape)
    assert _asdict(got) == _asdict(want)
    assert {d.rule for d in got.report.errors} == rules
    with pytest.raises(VSCheckError) as port_err:
        got.report.raise_errors()
    assert [dataclasses.asdict(d) for d in port_err.value.diagnostics] == \
        [dataclasses.asdict(d) for d in want.report.errors]


@pytest.mark.parametrize("name", sorted(WARNINGS))
def test_warnings_match_reference(name):
    layers, shape, rules = WARNINGS[name]
    net, jnet = _pair(layers)
    got, want = check_net(net, shape), ref_check_net(jnet, shape)
    assert _asdict(got) == _asdict(want)
    assert not got.report.errors
    assert {d.rule for d in got.report.warnings} == rules


def test_non_positive_input_shape_matches_reference():
    net, jnet = _pair(lambda M: (M.Conv("c0", 3, 64, 3, 3),))
    for shape in ((1, 0, 16, 3), (1, 16, 3)):
        assert _asdict(check_net(net, shape)) == \
            _asdict(ref_check_net(jnet, shape))


@dataclasses.dataclass(frozen=True)
class _BadCfg:
    """A config whose net feeds 32 channels into a conv that takes 3."""

    name: str = "bad"
    image_size: int = 16
    num_classes: int = 10
    weight_density: float = 0.5
    vk: int = 32
    vn: int = 128
    fixed_image_size: bool = False

    def build(self):
        return tg.SparseNet("bad", MALFORMED["channel_mismatch"][0](tg))


@pytest.mark.parametrize("replicas", [1, 2])
def test_server_refuses_malformed_net_before_weights(replicas):
    """`CNNServer(validate=True)` raises the reference's diagnostics
    before `init_params` runs; with ``validate=False`` it gets as far as
    making the weights."""
    want = ref_check_net(jg.SparseNet("bad", MALFORMED["channel_mismatch"][0](
        jg)), (1, 16, 16, 3)).report.errors
    with mock.patch.object(ts, "init_params",
                           side_effect=AssertionError("weights made")) as ip:
        with pytest.raises(VSCheckError) as err:
            ts.CNNServer(_BadCfg(), batch=2, device="cpu",
                         replicas=replicas)
        assert ip.call_count == 0
        assert [dataclasses.asdict(d) for d in err.value.diagnostics] == \
            [dataclasses.asdict(d) for d in want]
        with pytest.raises(AssertionError, match="weights made"):
            ts.CNNServer(_BadCfg(), batch=2, device="cpu", validate=False)
        assert ip.call_count == 1


def test_validate_net_matches_reference_gate():
    net, jnet = _pair(MALFORMED["pool_collapse"][0])
    with pytest.raises(VSCheckError) as got:
        ts.validate_net(net, 16)
    from repro.analysis import VSCheckError as RefError
    with pytest.raises(RefError) as want:
        ref_serve.validate_net(jnet, 16)
    assert [dataclasses.asdict(d) for d in got.value.diagnostics] == \
        [dataclasses.asdict(d) for d in want.value.diagnostics]
    assert str(got.value) == str(want.value)
