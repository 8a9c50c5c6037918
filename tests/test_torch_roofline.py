"""The roofline report (`utils.roofline`) against the reference's.

`report` and `RooflineReport.row()` are fed the same cost numbers as the
reference's `repro.utils.roofline.report` (an `HloCost` and XLA-style
memory stats) with an `HW` row of the H100's peaks: every key of the
reference's row is equal but ``predicted_mfu``, which the port divides
by the card's bf16 peak where the reference divides by v5e's 197e12, so
it is the reference's x 197e12 / 989e12.  The port adds ``fits``.  The
card's rows carry their memory (the datasheet's; on the card
`card_hw` takes it from the card).
"""
from types import SimpleNamespace
from unittest import mock

import pytest

from repro.utils import roofline as RR
from repro.utils.hlo import HloCost
from repro_torch.utils import roofline as R
from repro_torch.utils.cost import StepCost

H100 = R.card("NVIDIA H100 80GB HBM3")


def _cost(flops, nbytes, arg, temp):
    return StepCost(flops=flops, bytes=nbytes, arg_bytes=arg,
                    peak_bytes=arg + temp)


def _reports(flops, nbytes, arg, temp, mf):
    ref_hw = RR.HW(name="h100", peak_flops=H100.bf16_flops,
                   hbm_bw=H100.hbm_bw, link_bw=450e9,
                   hbm_bytes=H100.hbm_bytes)
    ref = RR.report(arch="a", shape="s", mesh_name="m", chips=1,
                    cost=HloCost(flops=flops, bytes=nbytes),
                    model_flops=mf, hw=ref_hw,
                    mem_stats=SimpleNamespace(argument_size_in_bytes=arg,
                                              temp_size_in_bytes=temp))
    cost = _cost(flops, nbytes, arg, temp)
    port = R.report(arch="a", shape="s", mesh_name="m", chips=1, cost=cost,
                    model_flops=mf, mem_stats=cost, hw=H100)
    return ref, port


@pytest.mark.parametrize("flops,nbytes", [(3.4e16, 4.9e14), (2.6e12, 5.3e12),
                                          (0.0, 1e9)])
def test_row_matches_the_reference_but_mfu(flops, nbytes):
    ref, port = _reports(flops, nbytes, 3.9e10, 2.6e10, 2.1e16)
    r, p = ref.row(), port.row()
    assert set(p) == set(r) | {"fits"}
    for key in r:
        if key == "predicted_mfu":
            assert p[key] == pytest.approx(r[key] * 197e12 / H100.bf16_flops,
                                           rel=1e-12)
        else:
            assert p[key] == r[key], key
    assert port.summary().startswith(ref.summary().split("\n")[0])
    assert port.dominant == ref.dominant
    assert port.step_time_s == ref.step_time_s


def test_collective_term_is_zero_on_one_card():
    _, port = _reports(1e15, 1e12, 1e9, 1e9, 1e15)
    assert port.collective_s == 0 and port.row()["collective_ms"] == 0
    assert port.row()["device_coll_bytes"] == 0


def test_fits_reads_the_cards_memory():
    _, small = _reports(1e12, 1e9, 40e9, 39e9, 1e12)
    _, large = _reports(1e12, 1e9, 40e9, 41e9, 1e12)
    assert small.fits and small.row()["fits"] is True
    assert not large.fits and large.row()["fits"] is False
    assert "does not fit in 80.0 GB" in large.summary()


def test_datasheet_memory_and_the_cards_own():
    assert [c.hbm_bytes for c in R.CARDS] == [94e9, 80e9, 80e9, 141e9]
    props = SimpleNamespace(name="NVIDIA H100 80GB HBM3",
                            total_memory=85_029_158_912)
    with mock.patch("torch.cuda.get_device_properties", return_value=props):
        hw = R.card_hw()
    assert hw.hbm_bytes == 85_029_158_912 and hw.name == "H100"
    assert hw.bf16_flops == H100.bf16_flops


def test_save_rows(tmp_path):
    out = tmp_path / "rows.json"
    R.save_rows(str(out), [{"arch": "a", "fits": True}])
    assert out.read_text().startswith("[")


def test_link_rates_are_the_datasheets():
    assert (H100.nvlink_bw, H100.node_gpus, H100.net_bw) == (450e9, 8, 50e9)
    for name in ("H100 NVL", "H100 PCIe"):
        assert R.card(name).nvlink_bw == R.card(name).net_bw == 0


@pytest.mark.parametrize("mesh,links", [
    ({"data": 32, "model": 8}, {"data": 50e9, "model": 450e9}),
    ({"data": 16, "model": 16}, {"data": 50e9, "model": 50e9}),
    ({"pod": 2, "data": 16, "model": 16},
     {"pod": 50e9, "data": 50e9, "model": 50e9}),
    ({"data": 2, "model": 4}, {"data": 450e9, "model": 450e9}),
    ({"data": 4, "model": 4}, {"data": 50e9, "model": 450e9}),
])
def test_each_mesh_dim_rides_the_slowest_link_it_crosses(mesh, links):
    """``model`` fastest, 8 GPUs a node: a model dim of 8 stays on
    NVLink, one of 16 spans two nodes, and ``data`` and ``pod`` leave
    the node unless the whole mesh fits in one."""
    assert R.dim_links(mesh, H100) == links


def test_collective_term_prices_each_dim_at_its_link():
    mesh = {"data": 32, "model": 8}
    wire = {"data": 5e9, "model": 9e9, "?": 1e9}
    assert R.collective_seconds(wire, mesh, H100) == pytest.approx(
        5e9 / 50e9 + 9e9 / 450e9 + 1e9 / 50e9)
    with pytest.raises(ValueError, match="no link rate"):
        R.collective_seconds({"data": 1.0}, {"data": 2, "model": 1},
                             R.card("H100 PCIe"))


def test_dominant_can_be_the_collective_term():
    cost = StepCost(flops=1e12, bytes=1e9, coll_bytes=8e9,
                    coll_by_kind={"all-gather": 8e9},
                    coll_by_dim={"data": 8e9}, arg_bytes=1, peak_bytes=2)
    rep = R.report(arch="a", shape="s", mesh_name="data16xmodel16",
                   chips=256, cost=cost, model_flops=1e14, mem_stats=cost,
                   hw=H100, mesh_shape={"data": 16, "model": 16})
    assert rep.collective_s == pytest.approx(8e9 / 50e9)
    assert rep.dominant == "collective"
    assert rep.row()["collective_ms"] == pytest.approx(160.0)
    assert rep.step_time_s == rep.collective_s
    with pytest.raises(ValueError, match="without a mesh"):
        R.report(arch="a", shape="s", mesh_name="m", chips=1, cost=cost,
                 model_flops=1.0, mem_stats=cost, hw=H100)
