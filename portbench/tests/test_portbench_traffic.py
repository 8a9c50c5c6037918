"""The traffic generators' schedules from a seed."""
import json

import numpy as np

from portbench.harness.data import stream_seed
from portbench.harness.manifest import cell_of, load_module
from portbench.tests.conftest import BENCH, ROOT

poisson = load_module(BENCH / "traffic" / "poisson.py")
closed = load_module(BENCH / "traffic" / "closed.py")


def _rng(seed):
    return np.random.default_rng(stream_seed(seed, "traffic"))


def test_poisson_same_seed_same_schedule():
    a = poisson.arrivals(2000.0, 20.0, _rng(2**31 + 5))
    b = poisson.arrivals(2000.0, 20.0, _rng(2**31 + 5))
    np.testing.assert_array_equal(a, b)


def test_poisson_seeds_share_the_gaps_in_another_order():
    a = poisson.arrivals(1500.0, 10.0, _rng(1))
    b = poisson.arrivals(1500.0, 10.0, _rng(2))
    assert not np.array_equal(a, b)
    ga = np.sort(np.diff(np.concatenate([[0.0], a])))
    gb = np.sort(np.diff(np.concatenate([[0.0], b])))
    n = min(len(ga), len(gb))
    # every arrival but the last few lies inside the window on both
    assert abs(len(a) - len(b)) <= 3 and len(a) >= 15000 - 20
    np.testing.assert_allclose(ga[:n - 5], gb[:n - 5], rtol=0, atol=1e-12)


def test_poisson_gaps_are_exponential_quantiles():
    rate, secs = 1000.0, 30.0
    due = poisson.arrivals(rate, secs, _rng(7))
    gaps = np.diff(np.concatenate([[0.0], due]))
    assert np.all(gaps > 0) and np.all(np.diff(due) > 0)
    assert due[-1] < secs
    assert abs(gaps.mean() * rate - 1.0) < 0.01
    # the median of Exp(rate) is ln 2 / rate
    assert abs(np.median(gaps) * rate - np.log(2)) < 0.01


def test_warm_sizes_cover_every_wave_shape():
    assert poisson.warm_sizes({}, 32) == [1, 2, 4, 8, 16, 32, 32]
    shapes = {min(32, 1 << max(n - 1, 0).bit_length())
              for n in range(1, 33)}
    assert shapes == set(poisson.warm_sizes({}, 32))
    t = json.loads((BENCH / "traffic" / "offline.json").read_text())
    assert closed.warm_sizes(t, 32) == [128, 128]


def test_traffic_files_name_a_generator():
    for f in (BENCH / "traffic").glob("*.json"):
        d = json.loads(f.read_text())
        assert (BENCH / "traffic" / f"{d['kind']}.py").exists(), f.name
        assert d["pool"] >= 1


def test_a_mix_that_no_cell_runs_is_found_by_name():
    # how sweep.py sets up a configuration under a server mix
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = cell_of(m, {"name": "r50.sweep", "config": "resnet50-vs235-f32",
                       "traffic": "server-resnet50", "chips": 1})
    assert cell.traffic["kind"] == "poisson" and cell.traffic["rate_per_s"] > 0
    assert cell.config["arch"] == "vscnn-resnet50"
    assert [e["name"] for e in cell.end_to_end] == ["setup_s"]
    assert cell.per_layer == []
