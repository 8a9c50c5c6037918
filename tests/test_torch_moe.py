"""The port's MoE FFN against the JAX reference's, on the CPU.

`route_and_pack` against the reference's `_route_and_pack` (every expert
local, no mesh): ``slot_tok`` equal, so the same (token, expert)
assignments land in the same slots and the same ones are dropped, with
dead padding experts, capacity drops and exact ties in the router's
probabilities; ``slot_w`` zero in the same slots and within 1e-6 of
max|slot_w| elsewhere (f32 rounding of the router's products and softmax);
``aux`` within 1e-6.  `moe_apply` against the
reference's (its ``ctx is None`` path), gated and plain, within relative
1e-5 of max|y|; the capacity rule is the reference's `_capacity`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_threads import one_torch_thread  # noqa: F401
from repro.models import moe as RM
from repro_torch.models import moe as TM

RTOL = 1e-5


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _cfgs(n_experts, top_k, d_ff=24, **kw):
    return (RM.MoEConfig(n_experts=n_experts, top_k=top_k, d_ff=d_ff, **kw),
            TM.MoEConfig(n_experts=n_experts, top_k=top_k, d_ff=d_ff, **kw))


# n tokens, d, n_experts, padded experts, top_k, capacity, tie columns
ROUTE_CASES = [
    (48, 16, 8, 8, 2, 16, False),      # the reduced configs' shape
    (40, 16, 6, 8, 2, 8, False),       # 2 dead padding experts
    (64, 16, 8, 8, 2, 8, False),       # 128 assignments into 64 slots
    (30, 16, 40, 48, 8, 8, False),     # Granite's 40 -> 48, top-8
    (32, 16, 8, 8, 3, 8, True),        # exact ties between experts
]


@pytest.mark.parametrize("n,d,ne,ep,k,cap,ties", ROUTE_CASES)
def test_routing_equals_the_reference(n, d, ne, ep, k, cap, ties):
    rng = np.random.default_rng(n + ne + k)
    ref_moe, moe = _cfgs(ne, k)
    xf = rng.standard_normal((n, d)).astype(np.float32)
    router = rng.standard_normal((d, ep)).astype(np.float32)
    if ties:  # experts 1, 4 and 6 see the same logits as expert 0
        router[:, [1, 4, 6]] = router[:, [0]]
    slot_tok, slot_w, aux = RM._route_and_pack(
        jnp.asarray(xf), jnp.asarray(router), ref_moe, ep, ep, 0, cap)
    r = TM.route_and_pack(torch.from_numpy(xf), torch.from_numpy(router),
                          moe, cap)
    np.testing.assert_array_equal(r.slot_tok.numpy(), np.asarray(slot_tok))
    # the weights: zero in the same (empty) slots, elsewhere within f32
    # rounding (the router's products and softmax sum in another order)
    want_w = np.asarray(slot_w)
    np.testing.assert_array_equal(r.slot_w.numpy() == 0, want_w == 0)
    assert _rel(r.slot_w, want_w) <= 1e-6
    assert abs(float(r.aux) - float(aux)) <= 1e-6 * max(abs(float(aux)), 1)
    # every assignment is in the slot that reads its token, or dropped
    kept = r.slot_of < ep * cap
    toks = torch.arange(n).repeat_interleave(k)
    assert torch.equal(r.slot_tok[r.slot_of[kept]], toks[kept])
    assert int(kept.sum()) == int((r.slot_w > 0).sum())
    if n * k > ne * cap:                     # more assignments than slots
        assert not bool(kept.all())


def test_capacity_is_the_reference_rule():
    for ne, k in [(8, 2), (40, 8), (384, 8), (16, 2)]:
        ref_moe, moe = _cfgs(ne, k)
        for tokens in (1, 8, 48, 1000, 4096):
            assert TM.capacity(tokens, moe) == RM._capacity(tokens, ref_moe)


@pytest.mark.parametrize("gated,ne,ep,k,shape", [
    (True, 8, 8, 2, (2, 24)),
    (True, 6, 8, 2, (2, 17)),
    (False, 8, 8, 2, (3, 10)),
    (True, 40, 48, 8, (1, 12)),
])
def test_moe_apply_matches_the_reference(gated, ne, ep, k, shape):
    rng = np.random.default_rng(ne * 7 + k)
    d = 32
    ref_moe, moe = _cfgs(ne, k)
    schema = RM.moe_schema(d, ref_moe, gated=gated,
                           tp_hint=ep if ep != ne else 1)
    assert schema["router"].shape == (d, ep)
    params = {name: (rng.standard_normal(p.shape)
                     * p.shape[-2 if name != "router" else 0] ** -0.5
                     ).astype(np.float32) for name, p in schema.items()}
    x = rng.standard_normal((*shape, d)).astype(np.float32)
    act_ref = jax.nn.silu if gated else jax.nn.gelu
    ref_y, ref_aux = RM.moe_apply(jax.tree.map(jnp.asarray, params),
                                  jnp.asarray(x), ref_moe, gated=gated,
                                  activation_fn=act_ref)
    act = F.silu if gated else (lambda g: F.gelu(g, approximate="tanh"))
    y, aux = TM.moe_apply({n: torch.from_numpy(a) for n, a in params.items()},
                          torch.from_numpy(x), moe, gated=gated,
                          activation_fn=act)
    assert y.shape == x.shape
    assert _rel(y, ref_y) <= RTOL
    assert abs(float(aux) - float(ref_aux)) <= 1e-6


def test_schema_matches_the_reference():
    for gated in (True, False):
        for ne, tp in [(40, 16), (384, 16), (16, 16), (8, 1)]:
            ref_moe, moe = _cfgs(ne, 2, d_ff=64)
            ref = RM.moe_schema(96, ref_moe, gated=gated, tp_hint=tp)
            got = TM.moe_schema(96, moe, gated=gated, tp_hint=tp)
            assert {k: (p.shape, p.fan_in) for k, p in got.items()} == \
                {k: (p.shape, p.fan_in) for k, p in ref.items()}
            assert moe.padded_experts(tp) == ref_moe.padded_experts(tp)
