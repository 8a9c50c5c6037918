"""The dry run (`launch.dryrun`) and its step builders, on meta.

- FLOPs: the count on meta of reduced Qwen1.5-4B and RWKV-6 decode and
  prefill steps (B 2, T 32) against `repro.utils.hlo.analyze` of the
  reference's mesh-free step compiled on the CPU, within 5%.  Matmul
  FLOPs agree exactly; the rest is elementwise multiplies that XLA makes
  and PyTorch's single ops hide (SiLU, means), and the flash kernel's
  causal half (its cost function halves it, the reference's jnp flash
  computes every block).  A miss names each side's FLOPs by kind.
- `run_cell` rows for every reduced arch at each supported kind (small
  shapes): the reference's row keys with ``fits``, ``trace_s``, the
  kernels' launches; skipped shapes with the reference's reasons; the
  sparse-FFN cells; the CLI (one cell written; ``--multipod`` writes
  ``*_multipod.json``, its skip rows the reference's ``pod2x16x16``).
- The builders: `param_structs` on meta matches the schema; the train,
  prefill and decode steps' arguments.
"""
import ast
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import get_config as ref_get_config
from repro.models import transformer as RT
from repro.models.layers import init_params as ref_init_params
from repro.utils import hlo
from repro.utils import roofline as RR
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import SHAPES, ShapeSpec
from repro_torch.launch import dryrun as D
from repro_torch.launch import step_builders as sb
from repro_torch.models import transformer as TT
from repro_torch.models.layers import P, init_params
from repro_torch.utils.cost import count
from repro_torch.utils.tree import leaves

FLOP_RTOL = 0.05
B, T = 2, 32
MATMULS = ("mm", "bmm", "addmm", "baddbmm", "convolution")


def _ref_step_text(arch: str, kind: str) -> str:
    cfg = ref_get_config(arch).reduce()
    params = jax.eval_shape(lambda: ref_init_params(
        RT.lm_schema(cfg), jax.random.PRNGKey(0), cfg.dtype))
    if kind == "prefill":
        batch = {"tokens": jax.ShapeDtypeStruct((B, T), jnp.int32)}
        fn = jax.jit(lambda p, b: RT.prefill(p, b, cfg, capacity=T))
        return fn.lower(params, batch).compile().as_text()
    caches = jax.eval_shape(lambda: RT.init_cache(cfg, B, T))
    tok = jax.ShapeDtypeStruct((B, 1), jnp.int32)
    pos = jax.ShapeDtypeStruct((), jnp.int32)
    fn = jax.jit(lambda p, c, t, q: RT.decode_step(p, c, t, q, cfg))
    return fn.lower(params, caches, tok, pos).compile().as_text()


def _port_by_kind(cost) -> dict:
    out = {"matmul": 0.0, "mul": 0.0, "kernels": 0.0, "other": 0.0}
    for op, (_, flops, _) in cost.ops.items():
        ns, name = op.split(".")[:2]
        kind = ("kernels" if ns == "repro_torch" else "matmul"
                if name in MATMULS else "mul" if name in ("mul", "mul_")
                else "other")
        out[kind] += flops
    return out


@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("arch", ["qwen1.5-4b", "rwkv6-3b"])
def test_flops_match_the_references_compiled_step(arch, kind):
    text = _ref_step_text(arch, kind)
    ref = hlo.analyze(text).flops
    ref_dots = hlo.analyze(text.replace(" multiply(", " subtract(")).flops
    step = sb.build(get_config(arch).reduce(), ShapeSpec("s", T, B, kind))
    _, cost = count(step.fn, *step.args)
    ratio = cost.flops / ref
    assert abs(ratio - 1) <= FLOP_RTOL, (
        f"{arch} {kind}: port {cost.flops:.4g} / reference {ref:.4g} = "
        f"{ratio:.4f}; reference by kind: dot {ref_dots:.4g}, multiply "
        f"{ref - ref_dots:.4g}; port by kind: {_port_by_kind(cost)}")
    # the matmuls are the reference's dots (its jnp flash's aside)
    if arch == "rwkv6-3b" or kind == "decode":
        assert _port_by_kind(cost)["matmul"] == ref_dots


def _small(name: str) -> ShapeSpec:
    sh = SHAPES[name]
    return ShapeSpec(name, 16, 2 if sh.kind == "train" else 3, sh.kind)


def _ref_row_keys() -> set:
    rep = RR.RooflineReport("a", "s", "m", 1, 1.0, 1.0, 0.0, 1.0, 1.0, 0.0,
                            1.0, 0.0, 0.0, {})
    return set(rep.row())


def _attention_layers(cfg) -> int:
    return sum(seg.repeat * sum(sp.mixer == "attn" for sp in seg.layers)
               for seg in cfg.segments)


@pytest.mark.parametrize("arch", list_archs())
def test_run_cell_every_reduced_arch_at_each_supported_kind(arch):
    cfg = get_config(arch).reduce()
    keys = _ref_row_keys() | {"fits", "trace_s", "status", "tag",
                              "overrides", "kernels", "ops"}
    reasons = ref_get_config(arch).supported_shapes()
    kinds = set()
    for name in SHAPES:
        row = D.run_cell(arch, name, cfg=cfg, shape=_small(name),
                         verbose=False)
        if reasons[name]:
            assert row == {"arch": arch, "shape": name, "mesh": "H100x1",
                           "status": "skip", "reason": reasons[name]}
            continue
        kinds.add(SHAPES[name].kind)
        assert set(row) == keys
        assert row["status"] == "ok" and row["mesh"] == "H100x1"
        assert row["chips"] == 1 and row["collective_ms"] == 0
        assert row["device_flops"] > 0 and row["device_bytes"] > 0
        assert row["fits"] is True and row["arg_gb"] > 0
        assert row["model_flops"] == sb.model_flops(cfg, _small(name))
        attn = _attention_layers(cfg)
        want = {"train": 2 * attn * cfg.microbatches,  # forward + remat
                "prefill": attn, "decode": 0}[SHAPES[name].kind]
        assert row["kernels"] == ({"flash_fwd": want} if want else {})
    assert kinds == {"train", "prefill", "decode"} - (
        {"decode"} if cfg.encoder_only else set())


def test_skips_carry_the_references_reasons():
    for arch in list_archs():
        ours = get_config(arch).supported_shapes()
        assert ours == ref_get_config(arch).supported_shapes(), arch
    row = D.run_cell("qwen1.5-4b", "long_500k", verbose=False)
    assert row["status"] == "skip"
    assert row["reason"] == ref_get_config(
        "qwen1.5-4b").supported_shapes()["long_500k"]


def test_sparse_ffn_cells():
    cfg = get_config("qwen1.5-4b").reduce()
    layers = cfg.total_layers
    for name in ("prefill_32k", "decode_32k"):
        row = D.run_cell("qwen1.5-4b", name, cfg=cfg, shape=_small(name),
                         overrides={"use_sparse_ffn": True}, verbose=False)
        assert row["status"] == "ok"
        assert row["kernels"]["vsmm"] == 3 * layers   # gate, up, merged wo
        assert row["overrides"] == {"use_sparse_ffn": "True"}
    row = D.run_cell("qwen1.5-4b", "train_4k", cfg=cfg,
                     shape=_small("train_4k"),
                     overrides={"use_sparse_ffn": True}, verbose=False)
    assert row["status"] == "skip" and "no training step" in row["reason"]
    assert [c[:2] for c in D.EXTRA_CELLS] == [("qwen1.5-4b", "prefill_32k"),
                                              ("qwen1.5-4b", "decode_32k")]


def test_optimized_flags_are_the_references():
    src = Path(__file__).resolve().parent.parent / "src/repro/launch/dryrun.py"
    tree = ast.parse(src.read_text())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", "") == "OPTIMIZED_FLAGS")
    assert D.OPTIMIZED_FLAGS == ast.literal_eval(node.value)
    row = D.run_cell("qwen1.5-4b", "decode_32k",
                     cfg=get_config("qwen1.5-4b").reduce(),
                     shape=_small("decode_32k"),
                     overrides=D.OPTIMIZED_FLAGS["decode"], verbose=False)
    assert "moe_dispatch: read only under a mesh" in row["notes"]


def test_cli(tmp_path, capsys):
    out = tmp_path / "rows.json"
    assert D.main(["--multipod", "--arch", "qwen1.5-4b", "--shape",
                   "long_500k", "--out", str(out)]) == 0
    (row,) = json.loads((tmp_path / "rows_multipod.json").read_text())
    assert row["status"] == "skip" and row["mesh"] == "pod2x16x16"
    assert not out.exists()
    assert "2x16x16" in capsys.readouterr().out
    assert D.main(["--arch", "rwkv6-3b", "--shape", "decode_32k",
                   "--out", str(out)]) == 0
    (row,) = json.loads(out.read_text())
    assert row["status"] == "ok" and row["shape"] == "decode_32k"
    assert row["overrides"] == {"microbatches": "1"}
    assert row["tag"] == "baseline" and row["fits"] is True
    assert "1 ok / 0 skip / 0 error" in capsys.readouterr().out


def test_param_structs_on_meta_match_the_schema():
    cfg = get_config("jamba-v0.1-52b")
    structs = sb.param_structs(cfg)
    schema = leaves(TT.lm_schema(cfg), lambda n: isinstance(n, P))
    assert [(tuple(t.shape), t.dtype) for t in leaves(structs)] == \
        [(p.shape, p.dtype or cfg.dtype) for p in schema]
    assert all(t.device.type == "meta" for t in leaves(structs))
    small = get_config("qwen1.5-4b").reduce()
    real = init_params(TT.lm_schema(small), 0, dtype=small.dtype,
                       device="cpu")
    assert [(t.shape, t.dtype) for t in leaves(sb.param_structs(small))] \
        == [(t.shape, t.dtype) for t in leaves(real)]


def test_builders_arguments():
    cfg = get_config("qwen1.5-4b")
    step = sb.build(cfg, SHAPES["train_4k"])
    params, opt_state, batch, at = step.args
    assert at == sb.TRAIN_STEP
    assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == {
        "tokens": ((256, 4096), torch.int32),
        "labels": ((256, 4096), torch.int32)}
    assert set(opt_state) == {"m", "v", "count"}
    step = sb.build(cfg, SHAPES["decode_32k"])
    _, caches, tokens, pos = step.args
    assert tokens.shape == (128, 1) and pos.dtype == torch.int64
    assert caches[0]["l0"]["mix"]["k"].shape == (40, 128, 32768, 20, 128)
    hubert = get_config("hubert-xlarge")
    step = sb.build(dataclasses.replace(hubert, microbatches=1),
                    SHAPES["prefill_32k"])
    assert step.args[1]["embeds"].shape == (32, 32768, hubert.d_model)
