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
