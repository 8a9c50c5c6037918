"""The port's optimizers, clip and schedules against the reference's,
fed the same numpy params and grads.

Three updates each (the step count and the bias corrections move).
Tolerance: 1e-6 relative of max|x| for updates, moments, scales and the
norm; `adamw8bit`'s int8 codes bit for bit; the schedules bit for bit
(the same f32 operations in the same order).  The port's ``update_``
writes the state and ``p + u`` in place: its update is read exactly as
the change of float64 copies of the params; params of the trainer's
dtypes are held after three steps.

The global norm is held to the exact (float64) norm of the same values
within 1e-6, and to the reference's within 1e-6 plus the reference's own
distance from the exact norm: over bf16 grads the reference's f32
reduction is ~1.5e-6 off it (the port's ~5e-8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as RO
from repro.optim import schedules as RS
from repro_torch.optim import optimizers as TO
from repro_torch.optim import schedules as TS
from repro_torch.utils.tree import leaves, leaves_with_path, tree_map

from _torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-6


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _tree(seed: int, scale: float = 1.0) -> dict:
    """Leaves of every kind the optimizers treat apart: a factored matrix
    (both trailing dims >= 128), a stacked one, vectors, a leaf of 1000
    values (not a multiple of 256), a scalar-like one."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (128, 160), "stack": (2, 128, 128), "b": (160,),
              "odd": (10, 100), "one": (1,),
              "segments": [{"wq": (64, 4, 32)}, {"ln": (64,)}]}
    mk = lambda s: (scale * rng.standard_normal(s)).astype(np.float32)
    return jax.tree.map(mk, shapes, is_leaf=lambda x: isinstance(x, tuple))


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _compare(ref_tree, port_tree, *, exact_int8=True):
    ref = {jax.tree_util.keystr(p): v for p, v in
           jax.tree_util.tree_flatten_with_path(ref_tree)[0]}
    port = dict(leaves_with_path(port_tree))
    assert sorted(ref) == sorted(port)
    for k, v in ref.items():
        a, b = np.asarray(v), port[k]
        if b.dtype == torch.bfloat16:
            a, b = a.astype(np.float32), b.float()
        b = b.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if a.dtype == np.int8 and exact_int8:
            np.testing.assert_array_equal(a, b, err_msg=k)
        elif a.dtype == np.int32:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert _rel(b, a) <= RTOL, (k, _rel(b, a))


OPTS = {
    "adamw": (RO.adamw, TO.adamw),
    "adamw8bit": (RO.adamw8bit, TO.adamw8bit),
    "adafactor": (RO.adafactor, TO.adafactor),
    "adafactor_wd": (lambda: RO.adafactor(weight_decay=0.1),
                     lambda: TO.adafactor(weight_decay=0.1)),
    "adamw_bf16_moments": (lambda: RO.adamw(moment_dtype=jnp.bfloat16),
                           lambda: TO.adamw(moment_dtype=torch.bfloat16)),
}


@pytest.mark.parametrize("name", sorted(OPTS))
def test_updates_and_state_match_reference(name):
    """Each step from the reference's params: the port's update, taken
    exactly as ``p_after - p_before`` of float64 copies of those params
    (the f32 update added to a float64 param loses nothing), and its
    state against the reference's ``update``."""
    ref_opt, port_opt = OPTS[name][0](), OPTS[name][1]()
    params = _tree(0)
    rp = jax.tree.map(jnp.asarray, params)
    rs = ref_opt.init(rp)
    ts = port_opt.init(_torch(params))
    _compare(rs, ts)
    for step in range(3):
        grads = _tree(10 + step, scale=0.01)
        lr = RS.warmup_cosine(3e-4, 200, 10_000)(100 + step)
        ru, rs = ref_opt.update(jax.tree.map(jnp.asarray, grads), rs, rp, lr)
        before = tree_map(lambda a: a.double(), _torch(
            jax.tree.map(np.asarray, rp)))
        tp = tree_map(torch.clone, before)
        port_opt.update_(_torch(grads), ts, tp,
                         TS.warmup_cosine(3e-4, 200, 10_000)(100 + step))
        tu = tree_map(lambda a, b: (a - b).float(), tp, before)
        _compare(ru, tu)
        _compare(rs, ts)
        assert max(float(u.abs().max()) for u in leaves(tu)) > 0
        rp = jax.tree.map(lambda p, u: p + u, rp, ru)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_params_in_place_match_reference(name, dtype):
    """Three steps on params of the trainer's dtypes, updated in place:
    equal to the reference's ``p + u`` (f32 within 1e-6 of max|p|; bf16,
    where an update may round to the neighbouring value, within 2^-8)."""
    ref_opt, port_opt = OPTS[name][0](), OPTS[name][1]()
    rp = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), _tree(0))
    tp = tree_map(lambda a: a.to(getattr(torch, dtype)), _torch(_tree(0)))
    rs, ts = ref_opt.init(rp), port_opt.init(tp)
    for step in range(3):
        grads = _tree(30 + step, scale=0.01)
        lr = RS.warmup_cosine(3e-4, 200, 10_000)(150 + step)
        ru, rs = ref_opt.update(jax.tree.map(jnp.asarray, grads), rs, rp, lr)
        rp = jax.tree.map(lambda p, u: p + u, rp, ru)
        port_opt.update_(_torch(grads), ts, tp,
                         TS.warmup_cosine(3e-4, 200, 10_000)(150 + step))
    for (k, b), a in zip(leaves_with_path(tp), jax.tree.leaves(rp)):
        assert b.dtype == getattr(torch, dtype)
        assert _rel(b.float().numpy(), np.asarray(a.astype(jnp.float32))
                    ) <= (RTOL if dtype == "float32" else 2 ** -8), k


def test_update_in_pieces_equals_whole_leaves(monkeypatch):
    """AdamW takes a leaf of more than ``PIECE`` values in pieces: the
    same bits as the whole leaf at once."""
    opt = TO.adamw()
    grads = _torch(_tree(40, scale=0.01))
    out = []
    for piece in (TO.PIECE, 1000):
        monkeypatch.setattr(TO, "PIECE", piece)
        tp = _torch(_tree(0))
        state = opt.init(tp)
        for _ in range(2):
            opt.update_(grads, state, tp, 1e-3)
        out.append(leaves(tp) + leaves(state))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_adamw8bit_codes_bit_equal():
    """The quantizer alone on values of every scale, the tail block
    padded: codes bit for bit, scales within 1e-6."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(1000) * np.logspace(-6, 2, 1000)
         ).astype(np.float32)
    rq, rsc = RO._q8(jnp.asarray(x))
    tq, tsc = TO._q8(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(rq), tq.numpy())
    assert _rel(tsc.numpy(), rsc) <= RTOL
    np.testing.assert_array_equal(
        np.asarray(RO._dq8(rq, rsc, (10, 100))),
        TO._dq8(tq, tsc, (10, 100)).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_by_global_norm(dtype, scale, monkeypatch):
    grads = _tree(5, scale=scale)
    rg = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), grads)
    rc, rn = RO.clip_by_global_norm(rg, 1.0)
    exact = np.sqrt(sum(np.sum(np.asarray(x.astype(jnp.float32),
                                          np.float64) ** 2)
                        for x in jax.tree.leaves(rg)))
    clipped = []
    for piece in (TO.PIECE, 1000):  # large leaves go in pieces
        monkeypatch.setattr(TO, "PIECE", piece)
        tc = tree_map(lambda a: a.to(getattr(torch, dtype)), _torch(grads))
        tn = TO.clip_by_global_norm_(tc, 1.0)
        assert _rel(float(tn), exact) <= RTOL
        assert _rel(float(tn), float(rn)) <= RTOL + _rel(float(rn), exact)
        clipped.append(tc)
    for (k, a), b in zip(leaves_with_path(clipped[0]), jax.tree.leaves(rc)):
        assert str(a.dtype).endswith(dtype)
        assert _rel(a.float().numpy(),
                    np.asarray(b.astype(jnp.float32))) <= (
            RTOL if dtype == "float32" else 2 ** -8), k
    for a, b in zip(leaves(clipped[0]), leaves(clipped[1])):
        assert _rel(a.float().numpy(), b.float().numpy()) <= 2 * RTOL


@pytest.mark.parametrize("make", [
    lambda m: m.warmup_cosine(3e-4, 200, 10_000),
    lambda m: m.warmup_cosine(1e-3, 0, 50, floor=0.0),
    lambda m: m.warmup_linear(3e-4, 200, 10_000),
    lambda m: m.constant(2e-4),
])
def test_schedules_bit_equal(make):
    ref, port = make(RS), make(TS)
    for step in (0, 1, 57, 199, 200, 201, 5_000, 9_999, 10_000, 12_345):
        a, b = float(ref(step)), port(step)
        assert b.dtype == torch.float32 and b.device.type == "cpu"
        assert float(b) == a, step
    assert float(port(torch.tensor(150, dtype=torch.int32))) == \
        float(ref(jnp.int32(150)))
