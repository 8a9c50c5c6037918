"""vscheck CLI — ``python -m repro_torch.analysis`` (the port's copy of
`repro/analysis/__main__.py`).

Runs the three static passes (IR validation, kernel contract checking,
repo lint) over the registered nets and the port's source tree, prints
the diagnostics, and exits non-zero on errors.  Pure Python and numpy: it
runs on the CPU, and in a few seconds on every net at 224 px.

Usage:
  python -m repro_torch.analysis --all-nets [--size 32] [--batch 1]
  python -m repro_torch.analysis --net resnet50 --density 0.25 -v
  python -m repro_torch.analysis --lint-only
  python -m repro_torch.analysis --selftest    # seeded-violation self-check
  python -m repro_torch.analysis --rules       # print the rule catalog
"""
from __future__ import annotations

import argparse
import pathlib
import sys
from typing import Callable

from repro_torch.models.graph import (
    Conv, SparseNet, build_mobilenet_v1, build_resnet18, build_resnet34,
    build_resnet50, build_vgg16,
)

from .contracts import check_contracts
from .diagnostics import RULES, Report
from .ir import check_net
from .lint import lint_paths

NETS: dict[str, Callable[..., SparseNet]] = {
    "vgg16": build_vgg16,
    "resnet18": build_resnet18,
    "resnet34": build_resnet34,
    "resnet50": build_resnet50,
    "mobilenet_v1": build_mobilenet_v1,
}

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]


def check_one_net(name: str, *, size: int, batch: int, density: float,
                  verbose: bool = False, rows: list | None = None) -> Report:
    """IR + contract passes for one registered net at one input shape;
    ``rows`` (a list) collects the verified plans' `PlanSummary` rows."""
    net = NETS[name](image_size=size)
    nc = check_net(net, (batch, size, size, 3), density=density)
    rep = Report()
    rep.extend(nc.report)
    if nc.report.ok():  # contract checks need well-formed sites
        crep, plans = check_contracts(nc)
        rep.extend(crep)
        if rows is not None:
            rows.extend(plans)
        if verbose:
            for r in plans:
                print(f"  {r.path:<44} {r.kind:<9} grid={r.grid} "
                      f"bytes={r.bytes_derived} flops={r.flops}")
    return rep


def run_selftest() -> bool:
    """Seeded-violation self-check: perturb the shared index-map/cost
    machinery in-process and assert the analyzer catches each seed.
    Guards against the nightmare failure mode of a verifier that silently
    verifies nothing."""
    import repro_torch.kernels.plan as plan_mod

    from .diagnostics import Report as R
    from .lint import lint_source

    net = SparseNet("selftest", (
        Conv("c1", 32, 128, 3, 3),
        Conv("dw1", 128, 128, 3, 3, groups=128),
    ))
    shape = (1, 16, 16, 32)
    ok = True

    nc = check_net(net, shape)
    rep, _ = check_contracts(nc)
    if not (nc.report.ok() and rep.ok()):
        print("selftest: baseline net unexpectedly fails:")
        print(nc.report.render() or rep.render())
        return False

    def expect(label: str, rule: str, got: Report) -> None:
        nonlocal ok
        caught = any(d.rule == rule for d in got.errors)
        print(f"  seeded {label}: "
              f"{'caught ' + rule if caught else 'MISSED ' + rule}")
        ok = ok and caught

    # seed 1: shift the streaming halo window one row-block down — the
    # last row-block's reads escape the padded buffer (VSC201)
    orig_halo = plan_mod.halo_in_index_map

    def bad_halo(hb: int, stride: int, bh: int, cbg: int,
                 spg: int) -> Callable:
        inner = orig_halo(hb, stride, bh, cbg, spg)

        def index_map(j: object, m: object, s: object,
                      idx: object) -> tuple:
            o = inner(j, m, s, idx)
            return (o[0], o[1] + stride * bh, *o[2:])
        return index_map

    plan_mod.halo_in_index_map = bad_halo
    try:
        r, _ = check_contracts(check_net(net, shape))
    finally:
        plan_mod.halo_in_index_map = orig_halo
    expect("halo window shift", "VSC201", r)

    # seed 2: drop the sparse-step term from the weight stream — the
    # derived DMA count falls below the CostEstimate contract (VSC202)
    orig_w = plan_mod.conv_weight_index_map

    def bad_weights(resident: bool = False) -> Callable:
        inner = orig_w(resident)

        def index_map(g0: object, g1: object, s: object,
                      idx: object) -> tuple:
            o = inner(g0, g1, s, idx)
            return (o[0], 0 * o[1], *o[2:])
        return index_map

    plan_mod.conv_weight_index_map = bad_weights
    try:
        r, _ = check_contracts(check_net(net, shape))
    finally:
        plan_mod.conv_weight_index_map = orig_w
    expect("weight stream collapse", "VSC202", r)

    # seed 3: a depthwise channel-multiplier conv without allow_fallback
    # must be refused at the IR pass (VSC109)
    bad_net = SparseNet("selftest_vsc109",
                        (Conv("dwm", 32, 64, 3, 3, groups=32),))
    r = check_net(bad_net, shape).report
    expect("channel-multiplier depthwise", "VSC109", r)

    # seed 4: lint rules on a synthetic source
    lrep = R()
    lint_source(
        "import os, time\n"
        "os.environ['CUDA_LAUNCH_BLOCKING'] = '1'\n"
        "y = ops.vsconv(x, vs, impl='hallo')\n",
        "selftest_snippet.py", rep=lrep)
    expect("env mutation", "VSC303", lrep)
    expect("impl typo", "VSC301", lrep)
    lrep2 = R()
    lint_source(
        "import time\n"
        "while time.monotonic() < deadline:\n"
        "    pass\n",
        "scheduler.py", rep=lrep2)
    expect("clock in scheduler branch", "VSC302", lrep2)

    # seed 5: a blanket except in the launch layer must be flagged
    # (VSC304) — and the same source outside launch/ must stay clean
    blanket = ("try:\n"
               "    run.dispatch()\n"
               "except Exception:\n"
               "    pass\n")
    lrep3 = R()
    lint_source(blanket, "src/repro_torch/launch/scheduler.py", rep=lrep3)
    expect("blanket except in launch", "VSC304", lrep3)
    lrep4 = R()
    lint_source(blanket, "src/repro_torch/kernels/ops.py", rep=lrep4)
    clean = not any(d.rule == "VSC304" for d in lrep4.errors)
    print(f"  negative (non-launch blanket except): "
          f"{'clean' if clean else 'FALSE POSITIVE VSC304'}")
    ok = ok and clean
    return ok


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="vscheck: static IR/kernel contract verifier")
    p.add_argument("--net", choices=sorted(NETS), action="append",
                   default=None, help="net(s) to check (repeatable)")
    p.add_argument("--all-nets", action="store_true",
                   help="check every registered net")
    p.add_argument("--size", type=int, default=32,
                   help="input image size (default 32)")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--density", type=float, default=0.25)
    p.add_argument("--lint-only", action="store_true",
                   help="run only the source lint pass")
    p.add_argument("--no-lint", action="store_true",
                   help="skip the source lint pass")
    p.add_argument("--selftest", action="store_true",
                   help="seeded-violation self-check (must catch each)")
    p.add_argument("--rules", action="store_true",
                   help="print the rule catalog and exit")
    p.add_argument("--suppress", action="append", default=[],
                   metavar="RULE", help="drop findings of this rule id")
    p.add_argument("--warnings-as-errors", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="print every verified kernel plan")
    args = p.parse_args(argv)

    if args.rules:
        for rule, desc in RULES.items():
            print(f"{rule}  {desc}")
        return 0

    if args.selftest:
        ok = run_selftest()
        print("selftest:", "OK" if ok else "FAILED")
        return 0 if ok else 1

    rep = Report()
    names = sorted(NETS) if args.all_nets or args.net is None else args.net
    if not args.lint_only:
        rows: list = []
        for name in names:
            print(f"vscheck {name} @ {args.batch}x{args.size}x{args.size}x3 "
                  f"density={args.density}")
            rep.extend(check_one_net(
                name, size=args.size, batch=args.batch,
                density=args.density, verbose=args.verbose, rows=rows))
        print(f"contracts: {len(rows)} kernel plans")
    if args.lint_only or not args.no_lint:
        n = lint_paths(_REPO_ROOT, rep=rep)
        print(f"lint: {n} files")

    rep = rep.suppress(set(args.suppress))
    if rep.diagnostics:
        print(rep.render())
    print(f"vscheck: {len(rep.errors)} error(s), "
          f"{len(rep.warnings)} warning(s)")
    return 0 if rep.ok(warnings_as_errors=args.warnings_as_errors) else 1


if __name__ == "__main__":
    sys.exit(main())
