#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on one card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout (the program in ``src/repro_torch``).  Set-up
makes the weights and a pool of images from the seed on the card, builds
the port's serving path (`harness.program`), and serves every wave shape
the cell's traffic can make once (each shape's CUDA graph is captured
then).  The window then runs the cell's traffic generator
(``traffic/<kind>.py``) for ``--seconds``; with ``--trace 1`` a
`torch.profiler` trace covers its last `TRACE_S` seconds and the
per-layer metrics (``metrics/<name>.py``) are read, otherwise the
end-to-end ones.  Once the window has closed the program's state is freed
and the plain reference checks a seeded sample of the delivered logits
(`harness.check`).

The last line on standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its
limit, which also close standard error.  The run exits non-zero and
prints no result where there is no card (or fewer than the cell asks
for), where the program is missing, where a shape is built inside the
window, or where JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)
# build and kernel caches at fixed paths inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".portbench_cache" / "triton")
# one process, few threads: the host work of a wave is single-threaded
# numpy and Python, and idle pools of BLAS and OpenMP threads only add
# noise on a host whose cores other machines share
for _v in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_v] = "1"

import numpy as np  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
TRACE_S = 4.0     # the traced stretch: the window's last seconds


def setup_clock() -> float:
    """Seconds since this process started (the kernel's start time, in
    clock ticks since boot), or since this module was imported where that
    cannot be read."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
        start = int(fields.split()[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - T_IMPORT


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def end_to_end(cell, session, setup_s: float) -> dict:
    """The cell's end-to-end metrics, of those the harness takes itself:
    ``setup_s``, ``images_per_s`` (delivered images over the window, to
    the end of its last call) and the latency percentiles over all of
    the window's delivered requests."""
    r = session.arrays()
    ok = r["ok"]
    lat = (r["end"] - r["due"])[ok] * 1e3
    last = max(c.end for c in session.calls)
    known = {
        "setup_s": setup_s,
        "images_per_s": float(ok.sum()) / last,
        "latency_p95_ms": float(np.percentile(lat, 95)),
        "latency_p50_ms": float(np.percentile(lat, 50)),
    }
    return {m["name"]: {"value": known[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}


def per_second(session) -> list[int]:
    """Images delivered in each whole second of the window, by the end of
    the call that served them."""
    r = session.arrays()
    ends = r["end"][r["ok"]]
    return np.bincount(ends.astype(int)).tolist() if len(ends) else []


class Bench:
    """A cell set up for ``seed``: the program built and warmed on every
    wave shape of the cell's traffic."""

    def __init__(self, cell, seed: int, device):
        from portbench.harness import check
        from portbench.harness.data import make_images, make_params
        from portbench.harness.manifest import load_module
        from portbench.harness.program import Program
        from portbench.reference.common import schema

        t = [time.perf_counter()]
        self.cell, self.seed, self.device = cell, seed, device
        self.config, self.traffic = cell.config, cell.traffic
        self.ref = importlib.import_module(
            f"portbench.reference.{self.config['reference']}")
        self.gen = load_module(cell.bench_dir / "traffic"
                               / f"{self.traffic['kind']}.py")
        self.layers = check.ref_layers(self.config, self.ref)
        sch = schema(self.layers)
        params = make_params(sch, seed, device,
                             kept=check.kept_share(self.config, self.layers))
        t.append(time.perf_counter())
        self.program = Program(self.config, params, device)
        del params
        t.append(time.perf_counter())
        if self.program.schema() != sch:
            raise RuntimeError("the served net's layers are not the "
                               "reference's: " + json.dumps(
                                   {"program": list(self.program.schema()),
                                    "reference": list(sch)})[:2000])
        self.width = self.config["width"]
        self.images = make_images(seed, self.traffic["pool"],
                                  self.config["image_size"], 3, device)
        rid = -1
        for n in self.gen.warm_sizes(self.traffic, self.width):
            self.program.serve(self.program.requests(
                [self.images[i % len(self.images)] for i in range(n)],
                rid * 10**6))
            rid -= 1
        _sync(device)
        t.append(time.perf_counter())
        self.compiles = self.program.compiles
        print("setup: s since start %.3f, params %.3f, program %.3f, "
              "images and warm-up %.3f (%d shapes)"
              % (setup_clock(), t[1] - t[0], t[2] - t[1], t[3] - t[2],
                 self.compiles), file=sys.stderr)

    def window(self, seconds: float, trace: bool,
               traffic: dict | None = None):
        """Run the traffic for ``seconds``: (session, generator's out)."""
        import torch

        from portbench.harness import check
        from portbench.harness.data import stream_seed
        from portbench.harness.session import Session
        from portbench.harness.trace import Tracer

        cuda = torch.device(self.device).type == "cuda"
        tracer = Tracer(trace and cuda, max(0.0, seconds - TRACE_S),
                        TRACE_S)
        session = Session(self.program, self.images, self.width,
                          check.Sampler(self.seed), tracer)
        rng = np.random.default_rng(stream_seed(self.seed, "traffic"))
        gc.collect()
        gc.freeze()
        try:
            out = self.gen.run(session, traffic or self.traffic, seconds,
                               rng)
            _sync(self.device)
        finally:
            gc.unfreeze()
        if self.program.compiles != self.compiles:
            raise RuntimeError(f"{self.program.compiles - self.compiles} "
                               f"shapes were built inside the window")
        return session, out

    def close(self) -> None:
        self.program.close()
        self.program = None
        gc.collect()

    def reference(self, sample: list, *, tf32: tuple = (False,)) -> list:
        """The reference's logits of the sampled requests' images, one
        array for each TF32 setting."""
        from portbench.harness import check
        from portbench.harness.data import make_images
        pool = make_images(self.seed, self.traffic["pool"],
                           self.config["image_size"], 3, self.device)
        return check.reference_logits(
            self.config, self.ref, self.seed, pool[[i for i, _ in sample]],
            self.device, tf32=tf32)


def run(cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """One run of ``cell``: the result line's fields, ``checks`` last."""
    import torch

    from portbench._frozen.peaks import card
    from portbench.harness import check
    from portbench.harness.context import Context
    from portbench.harness.manifest import load_module
    from portbench.harness.trace import reduce
    from portbench.harness.work import layer_work

    bench = Bench(cell, seed, device)
    setup_s = setup_clock()
    config = bench.config
    session, out = bench.window(seconds, trace)
    print("window: images delivered a second, by second: "
          + " ".join(str(n) for n in per_second(session)), file=sys.stderr)
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
           if cuda else 0}
    attempted = out["attempted"]
    delivered = int(session.arrays()["ok"].sum())
    result: dict = {"attempted": attempted, "failed": attempted - delivered}

    if trace:
        tr = reduce(session.tracer) if session.tracer.done else None
        peaks = card(dev["kind"]) if cuda else card("H100")
        ctx = Context(session.calls, session.arrays(), tr,
                      [layer_work(l, config["weight_density"],
                                  vk=config["vk"], vn=config["vn"])
                       for l in bench.layers],
                      peaks.f32_flops, peaks.hbm_bw, bench.width)
        metrics = {}
        for m in cell.per_layer:
            v = load_module(cell.bench_dir / "metrics"
                            / f"{m['name']}.py").read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["metrics"] = metrics
        if tr is not None:
            dev["busy_s"] = tr.busy_s
            dev["window_s"] = tr.window_s
            result["breakdown"] = {"device_ops": tr.device_ops,
                                   "idle_gaps": tr.idle_by_host}
        if cuda:
            dev["power"] = power_limit()
    else:
        result["metrics"] = end_to_end(cell, session, setup_s)
    result["device"] = dev

    sample = session.sampler.items()
    del session
    bench.close()
    ref_logits, = bench.reference(sample)
    served = np.stack([y for _, y in sample]) if sample else ref_logits[:0]
    err = check.logit_rel_err(served, ref_logits) if sample else float("inf")
    checks = {"logit_rel_err": {"value": err,
                                "limit": config["limits"]["logit_rel_err"]},
              "undelivered": {"value": result["failed"], "limit": 0}}
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result


def result_line(result: dict) -> dict:
    """The result's fields in the line's order: ``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown``
    where there is one, and ``checks`` last."""
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if "breakdown" in result:
        keys.append("breakdown")
    return {k: result[k] for k in keys + ["checks"]}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness.manifest import load_cell

    torch.set_num_threads(1)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    seed = args.seed % 2**63
    result = run(cell, seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {bad} (JAX or the JAX package)",
              file=sys.stderr)
        return 3
    line = result_line(result)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
