"""A traffic mix, a per-layer metric and a cell are added as new files
(and a manifest entry), with no edit to a file that is there."""
import json

from portbench.harness.manifest import load_cell
from portbench.tests.conftest import add_cell, load_run


def test_added_mix_and_metric_are_found_by_name(reduced_copy):
    bench = reduced_copy / "portbench"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "traffic" / "trickle.json").write_text(json.dumps(
        {"kind": "poisson", "rate_per_s": 20, "pool": 4}))
    (bench / "metrics" / "calls_per_s.py").write_text(
        "def read(ctx):\n"
        "    return len(ctx.calls) / max(c.end for c in ctx.calls)\n")
    (bench / "metrics" / "never.py").write_text(
        "def read(ctx):\n    return None\n")
    add_cell(reduced_copy, "vgg16.trickle", "vgg16-vs235-f32", "trickle",
             ("latency_p95_ms",))
    manifest = reduced_copy / "BENCHMARK.json"
    m = json.loads(manifest.read_text())
    m["per_layer"] += [
        {"name": "calls_per_s", "unit": "calls/s", "better": "higher",
         "source": "host_clock", "layer": "scheduler",
         "moves": "latency_p95_ms", "workloads": ["vgg16.trickle"]},
        {"name": "never", "unit": "ms", "better": "lower",
         "source": "host_clock", "layer": "scheduler",
         "moves": "latency_p95_ms", "workloads": ["vgg16.trickle"]}]
    manifest.write_text(json.dumps(m))
    after = {p: p.read_bytes() for p in before}
    assert after == before      # nothing that was there changed

    cell = load_cell("vgg16.trickle", bench_dir=bench)
    assert cell.traffic["rate_per_s"] == 20
    assert [x["name"] for x in cell.per_layer] == ["calls_per_s", "never"]
    assert {x["name"] for x in cell.end_to_end} == {
        "latency_p95_ms", "setup_s"}
    run = load_run()
    result = run.run(cell, 5, 1.0, True, "cpu")
    assert set(result["metrics"]) == {"calls_per_s"}   # None is left out
    assert result["metrics"]["calls_per_s"]["value"] > 0
    assert result["correct"] is True
