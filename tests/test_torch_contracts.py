"""vscheck passes 2 and 3 in the port (`repro_torch.analysis.contracts`,
`.lint`, `.intervals`, the CLI, and `repro_torch.kernels.plan` with the
index-map factories) against the reference's, on the CPU.

* `check_contracts` gives the reference's `PlanSummary` rows (path,
  variant, kind, grid, bytes, FLOPs) and diagnostics for all five nets at
  32 px, batch 1, under both dtype contracts;
* `conv_plan` / `fc_plan` give the reference's plans (kind, grid, buffer
  geometry and policies, cost), and every index map the reference's
  offsets on random grid points;
* the selftest catches every seeded violation;
* `lint_source` gives the reference's rule hits on seeded snippets, and
  the port's tree has no unwaived finding.
"""
import dataclasses
import importlib
import sys

import numpy as np
import pytest
from _torch_threads import one_torch_thread  # noqa: F401

from repro.analysis import contracts as RCt
from repro.analysis import intervals as RI
from repro.analysis import lint as RL
from repro.analysis.diagnostics import Report as RReport
from repro.analysis.ir import check_net as ref_check_net
from repro.kernels import plan as RP
from repro.models import graph as jg
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import check_contracts, check_net
from repro_torch.analysis import intervals as TI
from repro_torch.analysis import lint as TL
from repro_torch.analysis.diagnostics import Report
from repro_torch.kernels import plan as TP
from repro_torch.models import graph as tg

# the modules, not the functions of the same name the packages export
RV, RM = (importlib.import_module(f"repro.kernels.{m}")
          for m in ("vsconv", "vsmm"))
TV, TD, TM = (importlib.import_module(f"repro_torch.kernels.{m}")
              for m in ("vsconv", "vsconv_dw", "vsmm"))

NETS = {"vgg16": (jg.build_vgg16, tg.build_vgg16),
        "resnet18": (jg.build_resnet18, tg.build_resnet18),
        "resnet34": (jg.build_resnet34, tg.build_resnet34),
        "resnet50": (jg.build_resnet50, tg.build_resnet50),
        "mobilenet_v1": (jg.build_mobilenet_v1, tg.build_mobilenet_v1)}


def _diags(rep):
    return [(d.rule, d.severity, d.path, d.message, d.hint)
            for d in rep.diagnostics]


@pytest.mark.parametrize("density", [0.25, 1.0])
@pytest.mark.parametrize("net", sorted(NETS))
def test_check_contracts_matches_reference(net, density):
    jb, tb = NETS[net]
    shape = (1, 32, 32, 3)
    j_rep, j_rows = RCt.check_contracts(
        ref_check_net(jb(image_size=32), shape, density=density))
    t_rep, t_rows = check_contracts(
        check_net(tb(image_size=32), shape, density=density))
    assert [dataclasses.asdict(r) for r in t_rows] == \
        [dataclasses.asdict(r) for r in j_rows]
    assert _diags(t_rep) == _diags(j_rep) == []
    kinds = {r.kind for r in t_rows}
    assert {"vsmm"} <= kinds and any(r.path.endswith(":int8]")
                                     for r in t_rows)


# conv_plan geometries: (x_shape, kh, kw, stride, groups, dilation, cout,
# s_steps, vk, vn)
PLANS = {
    "halo": ((2, 14, 14, 64), 3, 3, 1, 1, 1, 128, 9, 32, 128),
    "halo_s2": ((1, 15, 15, 64), 3, 3, 2, 1, 1, 128, 7, 32, 64),
    "resident": ((2, 3, 3, 128), 3, 3, 1, 1, 1, 256, 20, 32, 128),
    "stem": ((1, 32, 32, 8), 7, 7, 2, 1, 1, 64, 49, 8, 64),
    "grouped": ((1, 12, 12, 128), 3, 3, 1, 2, 1, 128, 5, 32, 64),
    "depthwise": ((1, 14, 14, 256), 3, 3, 2, 256, 1, 256, 4, 1, 128),
    "dilated": ((1, 16, 16, 32), 3, 3, 1, 1, 2, 64, 4, 32, 64),
    "pointwise": ((2, 8, 8, 64), 1, 1, 2, 1, 1, 128, 1, 32, 128),
}


def _buffers(plan, grid_points):
    """Each buffer's geometry, and its index map's offsets at the grid
    points (idx a random table below kb)."""
    rng = np.random.default_rng(0)
    idx = rng.integers(0, plan.kb, (plan.nb, plan.s_steps))
    out = []
    for b in plan.buffers:
        offs = [tuple(int(o) for o in b.index_map(*g, idx))
                for g in grid_points]
        out.append((b.name, b.block, b.dims, b.valid, b.policy, b.itemsize,
                    b.unblocked, b.sweep_axes, offs))
    return out


@pytest.mark.parametrize("impl", ["halo", "stack"])
@pytest.mark.parametrize("case", sorted(PLANS))
@pytest.mark.parametrize("int8", [False, True])
def test_conv_plan_matches_reference(case, impl, int8):
    shape, kh, kw, s, g, d, cout, steps, vk, vn = PLANS[case]
    kw_ = dict(kh=kh, kw=kw, stride=s, groups=g, dilation=d, cout=cout,
               s_steps=steps, vk=vk, vn=vn, impl=impl, has_bias=True,
               has_residual=case in ("halo_s2", "grouped", "pointwise"),
               has_scale=int8)
    if int8:
        kw_.update(itemsize=1, w_itemsize=1, out_itemsize=4)
    got, want = TP.conv_plan(shape, **kw_), RP.conv_plan(shape, **kw_)
    assert (got.kind, got.grid, got.kb, got.nb, got.s_steps,
            got.flops_per_step) == (want.kind, want.grid, want.kb, want.nb,
                                    want.s_steps, want.flops_per_step)
    assert got.cost == {"flops": want.cost.flops,
                        "bytes_accessed": want.cost.bytes_accessed}
    rng = np.random.default_rng(1)
    points = [tuple(int(rng.integers(0, n)) for n in got.grid)
              for _ in range(16)]
    assert _buffers(got, points) == _buffers(want, points)


def test_fc_plan_matches_reference():
    for m, k, nb, steps, vk, vn in ((8, 512, 8, 4, 32, 128),
                                    (37, 2048, 2, 16, 32, 128),
                                    (1000, 64, 1, 2, 32, 64)):
        kw = dict(m=m, k=k, s_steps=steps, vk=vk, vn=vn, nb=nb,
                  has_bias=True, has_residual=m == 37)
        got, want = TP.fc_plan(**kw), RP.fc_plan(**kw)
        assert (got.kind, got.grid, got.kb) == (want.kind, want.grid,
                                                want.kb)
        assert got.cost == {"flops": want.cost.flops,
                            "bytes_accessed": want.cost.bytes_accessed}
        assert _buffers(got, [(0, 0, 0), (nb - 1, 0, steps - 1)]) == \
            _buffers(want, [(0, 0, 0), (nb - 1, 0, steps - 1)])


MAPS = [
    ("halo_in_index_map", TV, RV, (4, 2, 8, 6, 3)),
    ("resident_in_index_map", TV, RV, (4, 1, 8)),
    ("stack_in_index_map", TV, RV, (4, 6, 3, 3, 2, 2)),
    ("conv_weight_index_map", TV, RV, (True,)),
    ("conv_weight_index_map", TV, RV, (False,)),
    ("conv_out_index_map", TV, RV, (4, True)),
    ("conv_out_index_map", TV, RV, (4,)),
    ("conv_bias_index_map", TV, RV, (True,)),
    ("conv_bias_index_map", TV, RV, ()),
    ("dw_halo_in_index_map", TD, RV, (4, 2, 8)),
    ("dw_stack_in_index_map", TD, RV, (4, 3, 2, 2)),
    ("vsmm_x_index_map", TM, RM, ()),
    ("vsmm_w_index_map", TM, RM, ()),
    ("vsmm_out_index_map", TM, RM, ()),
    ("vsmm_bias_index_map", TM, RM, ()),
]


@pytest.mark.parametrize("name,port,ref,args", MAPS)
def test_index_maps_match_reference(name, port, ref, args):
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 54, (12, 9))
    g0, g1, g2 = (rng.integers(0, n, 200) for n in (12, 12, 9))
    got = getattr(port, name)(*args)(g0, g1, g2, idx)
    want = getattr(ref, name)(*args)(g0, g1, g2, idx)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.broadcast_to(a, g0.shape),
                                      np.broadcast_to(b, g0.shape))
    # over intervals (the bounds proof's evaluation) too
    ivs = [TI.Interval(0, 11), TI.Interval(0, 11), TI.Interval(0, 8)]
    rivs = [RI.Interval(0, 11), RI.Interval(0, 11), RI.Interval(0, 8)]
    got = getattr(port, name)(*args)(*ivs, TI.AbstractIdx(54))
    want = getattr(ref, name)(*args)(*rivs, RI.AbstractIdx(54))
    assert [(TI.Interval.of(a).lo, TI.Interval.of(a).hi) for a in got] == \
        [(RI.Interval.of(b).lo, RI.Interval.of(b).hi) for b in want]


def test_intervals_match_reference():
    rng = np.random.default_rng(3)
    for _ in range(200):
        lo, hi = sorted(int(v) for v in rng.integers(0, 50, 2))
        c = int(rng.integers(1, 9))
        t, r = TI.Interval(lo, hi), RI.Interval(lo, hi)
        for op in (lambda a: a + c, lambda a: a - c, lambda a: a * c,
                   lambda a: a // c, lambda a: a % c, lambda a: c - a,
                   lambda a: a * a, lambda a: a + a):
            x, y = op(t), op(r)
            assert (x.lo, x.hi) == (y.lo, y.hi)
        assert t.within(lo, hi) and repr(t) == repr(r)
    with pytest.raises(ValueError):
        TI.Interval(2, 1)
    with pytest.raises(ValueError):
        TI.Interval(-3, 2) % 4
    assert TI.AbstractIdx(7)[3, 4] == TI.Interval(0, 6)


def test_selftest_catches_every_seeded_violation(capsys):
    assert cli.run_selftest()
    out = capsys.readouterr().out
    assert out.count("caught") == 7 and "MISSED" not in out
    assert cli.main(["--selftest"]) == 0


LINT_SNIPPETS = {
    "env_and_impl": ("import os, time\n"
                     "os.environ['CUDA_LAUNCH_BLOCKING'] = '1'\n"
                     "y = ops.vsconv(x, vs, impl='hallo')\n"
                     "z = ops.vsconv(x, vs, impl='stack')\n",
                     "snippet.py"),
    "env_in_main": ("import os\n"
                    "def main():\n"
                    "    os.environ['A'] = '1'\n"
                    "if __name__ == '__main__':\n"
                    "    os.environ.update(B='2')\n"
                    "os.environ.setdefault('C', '3')  "
                    "# vscheck: ignore[VSC303]\n"
                    "os.environ.pop('D')\n",
                    "snippet.py"),
    "clock_in_scheduler": ("import time\n"
                           "while time.monotonic() < deadline:\n"
                           "    pass\n"
                           "if time.perf_counter() - t0 > 1:\n"
                           "    stats = time.time()\n",
                           "src/pkg/launch/scheduler.py"),
    "clock_elsewhere": ("import time\n"
                        "if time.time() > 0:\n"
                        "    pass\n", "src/pkg/kernels/ops.py"),
    "blanket_in_launch": ("try:\n"
                          "    run()\n"
                          "except Exception:\n"
                          "    pass\n"
                          "try:\n"
                          "    run()\n"
                          "except (KeyError, BaseException):\n"
                          "    pass\n"
                          "try:\n"
                          "    run()\n"
                          "except:\n"
                          "    raise\n"
                          "try:\n"
                          "    run()\n"
                          "except KeyError:\n"
                          "    pass\n",
                          "src/pkg/launch/serve.py"),
    "blanket_elsewhere": ("try:\n    run()\nexcept Exception:\n    pass\n",
                          "src/pkg/kernels/ops.py"),
    "syntax_error": ("def f(:\n", "broken.py"),
}


@pytest.mark.parametrize("case", sorted(LINT_SNIPPETS))
def test_lint_source_matches_reference(case):
    src, filename = LINT_SNIPPETS[case]
    t, r = Report(), RReport()
    TL.lint_source(src, filename, rep=t)
    RL.lint_source(src, filename, rep=r)
    # the VSC301 message quotes each side's vocabulary (the port's has
    # 'plain'); every other field is the reference's
    assert [(d.rule, d.path, d.severity) for d in t.diagnostics] == \
        [(d.rule, d.path, d.severity) for d in r.diagnostics]
    assert [(d.message, d.hint) for d in t.diagnostics
            if d.rule != "VSC301"] == \
        [(d.message, d.hint) for d in r.diagnostics if d.rule != "VSC301"]


def test_impl_vocabulary_is_the_port_dispatch():
    assert TL.IMPL_VOCAB == RL.IMPL_VOCAB | {"plain"}
    rep = Report()
    TL.lint_source("f(impl='plain')\nf(impl='pallas-halo')\n", "a.py",
                   rep=rep)
    assert rep.ok()


def test_port_tree_lints_clean_and_cli_passes(capsys):
    rep = Report()
    n = TL.lint_paths(cli._REPO_ROOT, rep=rep)
    assert rep.diagnostics == []
    port = sorted((cli._REPO_ROOT / "src" / "repro_torch").rglob("*.py"))
    assert n == len(port) + len(TL.ROOT_SCRIPTS)
    assert cli.main(["--all-nets", "--no-lint"]) == 0
    out = capsys.readouterr().out
    assert "vscheck: 0 error(s)" in out
    assert cli.main(["--rules"]) == 0
    assert "VSC204" in capsys.readouterr().out
    assert cli.main(["--net", "resnet18", "--lint-only"]) == 0


def test_package_exports_load_lazily():
    import subprocess
    probe = ("import sys, repro_torch.analysis as a\n"
             "lazy = [m for m in ('contracts', 'lint', '__main__') if\n"
             "        f'repro_torch.analysis.{m}' in sys.modules]\n"
             "assert a.check_contracts and a.lint_paths and a.main\n"
             "print(lazy)\n")
    out = subprocess.run([sys.executable, "-c", probe], check=True,
                         capture_output=True, text=True,
                         env={"PYTHONPATH": str(cli._REPO_ROOT / "src")})
    assert out.stdout.strip() == "[]"
    mod = importlib.import_module("repro_torch.analysis")
    assert mod.PlanSummary.__module__ == "repro_torch.analysis.contracts"
    assert mod.check_one_net is cli.check_one_net
