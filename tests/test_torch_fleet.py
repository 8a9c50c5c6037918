"""The port's replica fleet and fault harness (`launch.scheduler.
FleetScheduler`, `launch.faults.FaultPlan` / `ChaosBackend`,
`launch.serve.ReplicaGroup`) against the reference's, on the CPU.

The scripted pure-python backends of the reference's own tests
(`tests/test_scheduler.py`, `tests/test_faults.py`) drive the port's
fleet through the reference's fleet and fault cases, and drive both fleets
side by side: the same backend script and `FaultPlan` must give equal
outcomes, stats, fault events, health, waves and steals.  A seed gives the
reference's plan.

The CNN cases serve the reduced ResNet-18 on a fleet of `ReplicaGroup`
backends, one `BatchedApply` and one weight tree a replica.  Logits depend
on the wave a request runs in: f32 on its padded size (on the card the
kernels' plans follow it; on the CPU PyTorch's own kernels give other
bits at batch 1 than at 2 or more), int8 on its members (the activations'
per-tensor scale is taken over the wave; the zero rows of the padding do
not move it).  So the death sweep holds every request to the fault-free
fleet bit for bit where its wave kept its size, and within 1e-5 where it
did not.

Marked ``gpu`` (they skip here): on the card, two replicas bit-identical
to one, f32 and int8, with exact launch counts; two replicas each
dispatching a wave before either is collected.
"""
import dataclasses

import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from _hypothesis_compat import given, settings, st
from _torch_threads import one_torch_thread  # noqa: F401
from test_faults import ResetFleetScript, _check_terminal, _mk_reqs
from test_scheduler import FleetScript, Req, ScriptBackend

from repro.launch import faults as ref_faults
from repro.launch import scheduler as ref_sched
from repro_torch.configs import get_config
from repro_torch.launch import faults as port_faults
from repro_torch.launch import scheduler as port_sched
from repro_torch.launch.faults import (ChaosBackend, Fault, FaultPlan,
                                       ReplicaDead)
from repro_torch.launch.scheduler import (DRAINED, HEALTHY, SUSPECT,
                                          FleetScheduler, LockstepScheduler)
from repro_torch.launch.serve import CNNServer, ImageRequest
from repro_torch.models import graph as tg

RTOL = 1e-5


def _fleet(n, batch, **kw):
    events = []
    bes = [FleetScript(i, events, **kw) for i in range(n)]
    return FleetScheduler(bes, batch=batch), bes, events


def _chaos_fleet(n, batch, plan, *, be_cls=FleetScript, sched_kw=None,
                 **kw):
    events = []
    bes = [ChaosBackend(be_cls(i, events, **kw), plan, replica=i)
           for i in range(n)]
    return FleetScheduler(bes, batch=batch, **(sched_kw or {})), bes, events


# -- the fleet (tests/test_scheduler.py::TestFleet) -------------------------

class TestFleet:
    def test_stalled_replica_never_blocks_retirement_and_steal(self):
        sched, bes, events = _fleet(2, 1)
        a = Req(0, [9] * 10, 10)
        b, c, d = (Req(i, [i], 1) for i in (1, 2, 3))
        stats = sched.serve([a, b, c, d])
        assert len(a.out) == 10
        assert all(len(r.out) == 1 for r in (b, c, d))
        assert sched.steals == 1
        assert ("start", 1, [2]) in events
        first_r0_step = events.index(("step", 0))
        assert all(e[1] == 0 for e in events[first_r0_step:])
        assert [s["replica"] for s in stats] == [1, 1, 0]
        assert stats[-1]["steps"] == 9 and stats[-1]["finished"] == 1

    def test_per_replica_wave_dispatch_interleaves(self):
        sched, bes, events = _fleet(2, 2)
        reqs = [Req(i, [i] * 4, 4) for i in range(4)]
        sched.serve(reqs)
        assert [e[1] for e in events if e[0] == "step"] == [0, 1] * 3
        assert all(len(r.out) == 4 for r in reqs)

    def test_least_loaded_chunk_placement(self):
        sched, bes, events = _fleet(3, 2)
        reqs = [Req(i, [i] * 2, 2) for i in range(10)]
        sched.serve(reqs)
        waves = {e[1]: e[2] for e in events if e[0] == "start"}
        assert waves == {0: [0, 1], 1: [2, 3], 2: [4, 5]}
        assert all(len(r.out) == 2 for r in reqs)
        assert sched.steals == 0

    def test_fleet_of_one_matches_lockstep(self):
        def mk():
            return [Req(0, [1] * 8, 2), Req(1, [2] * 8, 6),
                    Req(2, [3] * 8, 3)]
        solo_be = ScriptBackend()
        solo_reqs = mk()
        solo = LockstepScheduler(solo_be, batch=2).serve(solo_reqs)
        sched, bes, _ = _fleet(1, 2)
        fleet_reqs = mk()
        fleet = sched.serve(fleet_reqs)
        assert [r.out for r in fleet_reqs] == [r.out for r in solo_reqs]
        assert bes[0].started == solo_be.started
        keys = ("steps", "finished", "backfills", "emissions")
        assert [{k: s[k] for k in keys} for s in fleet] == \
            [{k: s[k] for k in keys} for s in solo]

    @pytest.mark.parametrize("n", [2, 3, 5])
    def test_n_replica_outputs_match_single(self, n):
        def serve(k):
            reqs = [Req(i, [10 + i] * 6, 1 + i % 4) for i in range(12)]
            _fleet(k, 2)[0].serve(reqs)
            return [r.out for r in reqs]
        assert serve(n) == serve(1)

    def test_leftover_queue_gets_fresh_run(self):
        sched, bes, _ = _fleet(1, 2, admit=lambda req: req.rid != 2)
        reqs = [Req(0, [1] * 4, 2), Req(1, [2] * 4, 2), Req(2, [3] * 4, 2)]
        stats = sched.serve(reqs)
        assert [len(r.out) for r in reqs] == [2, 2, 2]
        assert len(stats) == 2
        assert bes[0].started == [[0, 1], [2]]

    def test_bad_arguments_raise(self):
        with pytest.raises(ValueError):
            FleetScheduler([], batch=2)
        with pytest.raises(ValueError):
            FleetScheduler([ScriptBackend()], batch=0)


# -- plans and chaos (tests/test_faults.py) ---------------------------------

class TestPlan:
    @pytest.mark.parametrize("seed,replicas", [(0, 2), (7, 3), (11, 3),
                                               (3, 1)])
    def test_seed_gives_the_reference_plan(self, seed, replicas):
        got = FaultPlan.random(seed, replicas=replicas)
        want = ref_faults.FaultPlan.random(seed, replicas=replicas)
        assert [dataclasses.astuple(f) for f in got.faults] == \
            [dataclasses.astuple(f) for f in want.faults]
        assert got.describe() == want.describe()
        assert got.counts() == want.counts()

    def test_seeded_plan_is_deterministic(self):
        a = FaultPlan.random(7, replicas=3)
        assert FaultPlan.random(7, replicas=3).faults == a.faults
        assert FaultPlan.random(8, replicas=3).faults != a.faults

    def test_plan_indexing_and_counts(self):
        plan = FaultPlan([Fault("nan", 0, 2), Fault("stall", 0, 2, ticks=3),
                          Fault("transient", 1, 0)])
        assert [f.kind for f in plan.at(0, 2)] == ["nan", "stall"]
        assert plan.at(2, 0) == []
        assert plan.counts() == {"nan": 1, "stall": 1, "transient": 1}
        assert len(plan) == 3
        assert FaultPlan().describe() == "(empty)"

    def test_invalid_faults_rejected(self):
        with pytest.raises(ValueError, match="unknown fault kind"):
            Fault("explode", 0, 0)
        with pytest.raises(ValueError, match="invalid fault"):
            Fault("nan", 0, -1)


class TestChaos:
    def test_empty_plan_fleet_of_one_matches_lockstep(self):
        def mk():
            return [Req(0, [1] * 8, 2), Req(1, [2] * 8, 6),
                    Req(2, [3] * 8, 3)]
        solo_be = ScriptBackend()
        solo_reqs = mk()
        solo_sched = LockstepScheduler(solo_be, batch=2)
        solo = solo_sched.serve(solo_reqs)
        sched, bes, _ = _chaos_fleet(1, 2, FaultPlan())
        fleet_reqs = mk()
        fleet = sched.serve(fleet_reqs)
        assert [r.out for r in fleet_reqs] == [r.out for r in solo_reqs]
        assert bes[0].inner.started == solo_be.started
        keys = ("steps", "finished", "backfills", "emissions")
        assert [{k: s[k] for k in keys} for s in fleet] == \
            [{k: s[k] for k in keys} for s in solo]
        assert sched.health == [HEALTHY] and sched.fault_events == []
        assert {rid: o.status for rid, o in sched.outcomes.items()} == \
            {rid: o.status for rid, o in solo_sched.outcomes.items()}

    def test_empty_plan_never_fires(self):
        sched, bes, _ = _chaos_fleet(2, 2, FaultPlan())
        reqs = _mk_reqs(8)
        sched.serve(reqs)
        _check_terminal(sched, reqs)
        assert all(be.injected == [] for be in bes)

    @pytest.mark.parametrize("kind", ["die_dispatch", "die_collect"])
    def test_death_requeues_on_survivor(self, kind):
        sched, bes, _ = _chaos_fleet(2, 2, FaultPlan([Fault(kind, 0, 1)]),
                                     be_cls=ResetFleetScript)
        reqs = _mk_reqs(8, script_len=4, max_new=3)
        sched.serve(reqs)
        assert sched.health == [DRAINED, HEALTHY]
        assert [e["fault"] for e in sched.fault_events] == ["ReplicaDead"]
        _check_terminal(sched, reqs)
        assert all(o.status == "delivered" for o in sched.outcomes.values())
        assert all(o.replica == 1 for o in sched.outcomes.values()
                   if o.wave > sched.fault_events[0]["wave"])

    def test_partial_stream_lost_without_reset(self):
        sched, _, _ = _chaos_fleet(2, 1, FaultPlan([Fault("die_dispatch",
                                                          0, 2)]))
        long, short = Req(0, [7] * 6, 6), Req(1, [8] * 2, 2)
        sched.serve([long, short])
        assert short.outcome.status == "delivered"
        assert (long.outcome.status, long.outcome.reason) == (
            "refused", "partial_stream_lost")
        assert 0 < len(long.out) < 6

    def test_all_replicas_dead_refuses_everything_then_at_admission(self):
        sched, _, _ = _chaos_fleet(1, 2, FaultPlan([Fault("die_dispatch",
                                                          0, 0)]))
        reqs = _mk_reqs(4)
        assert sched.serve(reqs) == []
        assert sched.health == [DRAINED]
        _check_terminal(sched, reqs)
        later = _mk_reqs(2)
        assert sched.serve(later) == []
        assert all(r.outcome.reason == "no_healthy_replicas"
                   for r in reqs + later)

    def test_transient_marks_suspect_then_quarantines(self):
        sched, _, _ = _chaos_fleet(2, 2, FaultPlan([Fault("transient", 0,
                                                          1)]),
                                   be_cls=ResetFleetScript)
        reqs = _mk_reqs(8, max_new=3)
        sched.serve(reqs)
        assert (sched.health[0], sched.fault_counts[0]) == (SUSPECT, 1)
        _check_terminal(sched, reqs)
        plan2 = FaultPlan([Fault("transient", 0, 1),
                           Fault("transient", 0, 2)])
        sched2, _, _ = _chaos_fleet(2, 2, plan2, be_cls=ResetFleetScript)
        reqs2 = _mk_reqs(8, max_new=3)
        sched2.serve(reqs2)
        assert sched2.health[0] == DRAINED
        _check_terminal(sched2, reqs2)
        assert all(o.status == "delivered" for o in sched2.outcomes.values())

    def test_start_fail_quarantines_and_replaces(self):
        sched, _, _ = _chaos_fleet(2, 2, FaultPlan([Fault("start_fail", 0,
                                                          0)]))
        reqs = _mk_reqs(4)
        sched.serve(reqs)
        assert sched.health == [DRAINED, HEALTHY]
        assert [e["fault"] for e in sched.fault_events] == ["CompileFault"]
        assert all(o.status == "delivered" for o in sched.outcomes.values())

    def test_stall_lets_survivors_steal(self):
        sched, bes, _ = _chaos_fleet(2, 1, FaultPlan([Fault("stall", 0, 1,
                                                            ticks=4)]))
        reqs = [Req(i, [i + 10] * 2, 2) for i in range(6)]
        sched.serve(reqs)
        _check_terminal(sched, reqs)
        assert sched.health == [HEALTHY, HEALTHY]
        assert sched.steals >= 1
        assert "stall" in [k for _, k in bes[0].injected]

    def test_dead_replica_raises_on_every_call(self):
        be = ChaosBackend(ScriptBackend(), FaultPlan([Fault("die_collect",
                                                            0, 1)]),
                          replica=0)
        state, _ = be.start([Req(0, [1] * 4, 4)], 1)
        handle = be.dispatch(state, [Req(0, [1] * 4, 4)])
        with pytest.raises(ReplicaDead):
            be.collect(state, handle, [None])
        with pytest.raises(ReplicaDead):
            be.dispatch(state, [None])


class TestBudgets:
    def test_retry_budget_exhausted(self):
        plan = FaultPlan([Fault("transient", 0, w) for w in range(30)])
        sched, _, _ = _chaos_fleet(1, 2, plan, sched_kw={
            "max_attempts": 2, "suspect_limit": 100})
        reqs = _mk_reqs(4)
        sched.serve(reqs)
        _check_terminal(sched, reqs)
        assert all((o.status, o.reason, o.attempts) == (
            "refused", "retry_budget_exhausted", 3)
            for o in sched.outcomes.values())

    def test_deadline_refuses_queued_not_inflight(self):
        sched, _, _ = _chaos_fleet(1, 1, FaultPlan(),
                                   sched_kw={"deadline_waves": 3})
        slow, waiting = Req(0, [5] * 10, 10), Req(1, [6] * 2, 2)
        sched.serve([slow, waiting])
        assert slow.outcome.status == "delivered"
        assert (waiting.outcome.reason, waiting.outcome.wave) == (
            "deadline_exceeded", 3)

    def test_per_request_deadline_overrides_default(self):
        sched, _, _ = _chaos_fleet(1, 1, FaultPlan(),
                                   sched_kw={"deadline_waves": 100})
        slow, waiting = Req(0, [5] * 10, 10), Req(1, [6] * 2, 2)
        waiting.deadline_waves = 2
        sched.serve([slow, waiting])
        assert waiting.outcome.reason == "deadline_exceeded"
        assert slow.outcome.status == "delivered"

    def test_fleet_max_queue_sheds(self):
        sched, _, _ = _chaos_fleet(2, 2, FaultPlan(),
                                   sched_kw={"max_queue": 3})
        reqs = _mk_reqs(5)
        sched.serve(reqs)
        _check_terminal(sched, reqs)
        assert [r.outcome.status for r in reqs] == \
            ["delivered"] * 3 + ["refused"] * 2
        assert all(r.outcome.reason == "queue_full" for r in reqs[3:])


# -- the port against the reference, on one script --------------------------

def _run(sched_mod, faults_mod, n, batch, plan_faults, sched_kw, mk_reqs,
         be_cls=ResetFleetScript):
    """One chaos serve through a package's fleet: everything it decided."""
    plan = faults_mod.FaultPlan([faults_mod.Fault(*f) for f in plan_faults])
    events: list = []
    bes = [faults_mod.ChaosBackend(be_cls(i, events), plan, replica=i)
           for i in range(n)]
    sched = sched_mod.FleetScheduler(bes, batch=batch, **sched_kw)
    reqs = mk_reqs()
    stats = sched.serve(reqs)
    for s in stats:
        del s["start_s"], s["run_s"]
    return {"outcomes": {rid: dataclasses.astuple(o)
                         for rid, o in sched.outcomes.items()},
            "stats": stats, "fault_events": sched.fault_events,
            "health": sched.health, "fault_counts": sched.fault_counts,
            "waves": sched.waves, "steals": sched.steals,
            "outs": [r.out for r in reqs], "events": events,
            "injected": [b.injected for b in bes]}


def _both(*args, **kw):
    return (_run(ref_sched, ref_faults, *args, **kw),
            _run(port_sched, port_faults, *args, **kw))


def _plan(seed, replicas, horizon=12, rate=0.3):
    return [dataclasses.astuple(f) for f in ref_faults.FaultPlan.random(
        seed, replicas=replicas, horizon=horizon, rate=rate).faults]


SCRIPTS = {
    "death": (2, 2, [("die_dispatch", 0, 1)], {},
              lambda: _mk_reqs(8, script_len=4, max_new=3)),
    "die_collect": (2, 2, [("die_collect", 1, 1)], {},
                    lambda: _mk_reqs(8, script_len=4, max_new=3)),
    "transients": (2, 2, [("transient", 0, 1), ("transient", 0, 2)], {},
                   lambda: _mk_reqs(8, max_new=3)),
    "stall": (2, 1, [("stall", 0, 1, 4)], {},
              lambda: [Req(i, [i + 10] * 2, 2) for i in range(6)]),
    "budgets": (1, 2, [("transient", 0, w) for w in range(30)],
                {"max_attempts": 2, "suspect_limit": 100},
                lambda: _mk_reqs(4)),
    "deadline": (1, 1, [], {"deadline_waves": 3},
                 lambda: [Req(0, [5] * 10, 10), Req(1, [6] * 2, 2)]),
    "shed": (2, 2, [], {"max_queue": 3}, lambda: _mk_reqs(5)),
    "random_3": (3, 2, _plan(3, 3, horizon=8), {"deadline_waves": 12,
                                                "max_attempts": 2},
                 lambda: _mk_reqs(10, script_len=5, max_new=4)),
    "random_11": (3, 1, _plan(11, 3, horizon=10, rate=0.25),
                  {"max_attempts": 4},
                  lambda: _mk_reqs(9, script_len=3, max_new=3)),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_fleet_matches_reference_on_one_script(name):
    want, got = _both(*SCRIPTS[name])
    assert got == want


def test_fleet_without_reset_matches_reference():
    want, got = _both(2, 1, [("die_dispatch", 0, 2)], {},
                      lambda: [Req(0, [7] * 6, 6), Req(1, [8] * 2, 2)],
                      be_cls=FleetScript)
    assert got == want
    assert got["outcomes"][0][2] == "partial_stream_lost"


class TestProperties:
    @settings(max_examples=25, deadline=None)
    @given(seed=st.integers(0, 10_000), replicas=st.integers(1, 4),
           rate=st.floats(0.0, 0.5), nreq=st.integers(1, 12))
    def test_every_admitted_request_gets_one_terminal_outcome(
            self, seed, replicas, rate, nreq):
        plan = FaultPlan.random(seed, replicas=replicas, horizon=12,
                                rate=rate)
        sched, _, _ = _chaos_fleet(
            replicas, 2, plan, be_cls=ResetFleetScript,
            sched_kw={"deadline_waves": 40, "max_attempts": 3})
        reqs = _mk_reqs(nreq, script_len=4, max_new=3)
        sched.serve(reqs)
        _check_terminal(sched, reqs)
        for h, c in zip(sched.health, sched.fault_counts):
            if h == HEALTHY:
                assert c == 0

    @settings(max_examples=15, deadline=None)
    @given(seed=st.integers(0, 10_000))
    def test_work_stealing_never_duplicates(self, seed):
        plan = FaultPlan.random(seed, replicas=3, horizon=10, rate=0.25)
        sched, _, _ = _chaos_fleet(3, 1, plan, be_cls=ResetFleetScript,
                                   sched_kw={"max_attempts": 4})
        reqs = _mk_reqs(9, script_len=3, max_new=3)
        sched.serve(reqs)
        _check_terminal(sched, reqs)
        for r in reqs:
            if sched.outcomes[r.rid].status == "delivered":
                assert r.out == r.script[:3]

    @settings(max_examples=20, deadline=None)
    @given(seed=st.integers(0, 10_000), replicas=st.integers(1, 4),
           rate=st.floats(0.0, 0.5), nreq=st.integers(1, 12),
           batch=st.integers(1, 3))
    def test_port_and_reference_decide_alike(self, seed, replicas, rate,
                                             nreq, batch):
        want, got = _both(replicas, batch,
                          _plan(seed, replicas, rate=rate),
                          {"deadline_waves": 20, "max_attempts": 3},
                          lambda: _mk_reqs(nreq, script_len=4, max_new=3))
        assert got == want


# -- the CNN fleet ----------------------------------------------------------

@pytest.fixture(scope="module")
def cfg():
    return get_config("vscnn-resnet18").reduce()


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((32, 32, 3)).astype(np.float32)
            for _ in range(n)]


def _requests(ims):
    return [ImageRequest(rid=i, image=im) for i, im in enumerate(ims)]


@pytest.fixture(scope="module")
def group(cfg):
    """Three replicas of the reduced ResNet-18 on the CPU, f32."""
    srv = CNNServer(cfg, batch=2, seed=0, replicas=3, device="cpu")
    return srv


def _record(backends, waves):
    for be in backends:
        def dispatch(state, slots, _orig=be.dispatch):
            occ, y = _orig(state, slots)
            for j in occ:
                waves[slots[j].rid] = (tuple(slots[k].rid for k in occ),
                                       int(y.shape[0]))
            return occ, y
        be.dispatch = dispatch


def _chaos_serve(backends, plan, ims, batch=2):
    waves: dict = {}
    _record(backends, waves)
    try:
        sched = FleetScheduler([ChaosBackend(b, plan, replica=i)
                                for i, b in enumerate(backends)],
                               batch=batch)
        reqs = _requests(ims)
        sched.serve(reqs)
    finally:
        for b in backends:
            del b.dispatch
    return sched, reqs, waves


def test_replica_group_copies_weights_per_replica(cfg, group):
    """One weight tree a replica: replica 0 serves the server's own
    tensors, replicas 1 and 2 copies of them."""
    bes = group.group.backends
    assert len(bes) == 3 and len({id(b.apply) for b in bes}) == 3
    for name in ("conv1", "fc"):
        ws = [b.apply.params[name]["w"] for b in bes]
        assert len({w.data_ptr() for w in ws}) == 3
        assert ws[0].data_ptr() == group.params[name]["w"].data_ptr()
        assert all(torch.equal(w, group.params[name]["w"]) for w in ws)
        vs = [b.apply.sparse[name].vs.vals for b in bes]
        assert len({v.data_ptr() for v in vs}) == 3
        assert vs[0].data_ptr() == group.sparse[name].vs.vals.data_ptr()
        assert all(torch.equal(v, group.sparse[name].vs.vals) for v in vs)
    assert group.group.devices == [torch.device("cpu")] * 3


def test_shard_sparse_places_and_refuses_a_model_axis(group):
    placed = tg.shard_sparse(group.sparse, "cpu")
    assert placed.keys() == group.sparse.keys()
    fc = placed["fc"]
    assert fc.dout == group.sparse["fc"].dout
    assert torch.equal(fc.vs.vals, group.sparse["fc"].vs.vals)
    assert fc.vs.vals.data_ptr() != group.sparse["fc"].vs.vals.data_ptr()
    kept = tg.shard_sparse(group.sparse, "cpu", copy=False)["fc"]
    assert kept.vs.vals.data_ptr() == group.sparse["fc"].vs.vals.data_ptr()
    with pytest.raises(NotImplementedError, match="multi-card cell"):
        tg.shard_sparse(group.sparse, "cpu", model=2)


def test_shard_fc_on_one_device_only_places(cfg):
    srv = CNNServer(cfg, batch=2, seed=0, replicas=2, shard_fc=True,
                    device="cpu")
    reqs = _requests(_images(4))
    srv.serve(reqs)
    assert all(r.outcome.status == "delivered" for r in reqs)


def test_wave_size_and_members_set_the_bits(cfg):
    """What the death sweep's bounds rest on, on the CPU: one request at
    padded batch sizes 1, 2, 4 and 8 (zero rows) agrees within 1e-5 in
    f32 and bit for bit in int8; in int8 a wave-mate of larger magnitude
    changes its logits (the per-wave activation scale), and the result
    equals `net_apply` on that wave."""
    im = _images(1)[0]
    for dtype in (None, "int8"):
        srv = CNNServer(cfg, batch=4, seed=0, dtype=dtype, device="cpu")
        outs = []
        for nb in (1, 2, 4, 8):
            x = np.zeros((nb, 32, 32, 3), np.float32)
            x[0] = im
            outs.append(tg.net_apply(srv.net, srv.params, torch.from_numpy(x),
                                     sparse=srv.sparse).numpy()[0])
        for o in outs[1:]:
            if dtype == "int8":
                assert_array_equal(o, outs[0])
            else:
                err = np.abs(o - outs[0]).max() / np.abs(outs[0]).max()
                assert err <= RTOL
        reqs = _requests([im, 10 * _images(1, seed=3)[0]])
        srv.serve(reqs)
        pair = tg.net_apply(srv.net, srv.params, torch.from_numpy(
            np.stack([r.image for r in reqs])), sparse=srv.sparse).numpy()
        assert_array_equal(reqs[0].logits, pair[0])
        if dtype == "int8":
            assert not np.array_equal(reqs[0].logits, outs[0])


def test_death_at_every_position_matches_the_fault_free_fleet(group):
    """Replica death (dispatch or collect) and NaN corruption at every
    (kind, replica, wave) of a 3-replica fleet: every request delivered
    once, the faulting replica drained, logits equal to the fault-free
    fleet's bit for bit where the request's wave kept its padded size,
    within 1e-5 where it did not."""
    bes = group.group.backends
    ims = _images(8)
    ref_sched, ref_reqs, ref_waves = _chaos_serve(bes, FaultPlan(), ims)
    assert all(o.status == "delivered" for o in ref_sched.outcomes.values())
    ref = {r.rid: r.logits for r in ref_reqs}
    for kind in ("die_dispatch", "die_collect", "nan"):
        for replica in range(3):
            for wave in range(3):
                pos = f"{kind}@r{replica}w{wave}"
                sched, reqs, waves = _chaos_serve(
                    bes, FaultPlan([Fault(kind, replica, wave)]), ims)
                _check_outcomes(sched, reqs, pos)
                for r in reqs:
                    if waves[r.rid][1] == ref_waves[r.rid][1]:
                        assert_array_equal(r.logits, ref[r.rid], pos)
                    else:
                        err = (np.abs(r.logits - ref[r.rid]).max()
                               / np.abs(ref[r.rid]).max())
                        assert err <= RTOL, pos
                if any(b.injected for b in sched.backends):
                    assert sched.fault_events, pos
                    assert sched.health[replica] == DRAINED, pos


def _check_outcomes(sched, reqs, pos):
    assert set(sched.outcomes) == {r.rid for r in reqs}, pos
    for r in reqs:
        assert r.outcome is sched.outcomes[r.rid], pos
        assert r.outcome.status == "delivered", pos
        assert len(r.out) == 1 and np.isfinite(r.logits).all(), pos


def test_nan_guard_quarantines_producer(group):
    sched, reqs, _ = _chaos_serve(group.group.backends,
                                  FaultPlan([Fault("nan", 0, 1)]),
                                  _images(8))
    _check_outcomes(sched, reqs, "nan")
    assert sched.health[0] == DRAINED
    assert [e["fault"] for e in sched.fault_events] == ["NonFiniteOutput"]


def test_cnn_chaos_replays_identically(group):
    plan = FaultPlan.random(11, replicas=3, horizon=6, rate=0.3)

    def run():
        sched, reqs, _ = _chaos_serve(group.group.backends, plan,
                                      _images(8))
        return ({rid: dataclasses.astuple(o)
                 for rid, o in sched.outcomes.items()},
                sched.fault_events, sched.health, sched.waves, sched.steals,
                [None if r.logits is None else r.logits.tobytes()
                 for r in reqs])
    assert run() == run()


def test_cnnserver_chaos_integration(cfg):
    plan = FaultPlan([Fault("die_dispatch", 0, 1)])
    srv = CNNServer(cfg, batch=2, seed=0, replicas=2, fault_plan=plan,
                    device="cpu")
    assert all(isinstance(b, ChaosBackend) for b in srv.backends)
    reqs = _requests(_images(6))
    stats = srv.serve(reqs)
    assert all(o.status == "delivered" for o in srv.outcomes.values())
    assert srv.scheduler.health == [DRAINED, HEALTHY]
    assert sum(s["images"] for s in stats) == 6
    # one replica and no plan keeps the lockstep path
    assert isinstance(CNNServer(cfg, batch=2, device="cpu").scheduler,
                      LockstepScheduler)
    assert isinstance(CNNServer(cfg, batch=2, device="cpu",
                                deadline_waves=4).scheduler, FleetScheduler)


def test_fleet_logits_equal_one_replica(cfg, group):
    """Three replicas on the CPU deliver the one-replica server's logits
    bit for bit (every wave keeps its size: 8 requests at batch 2)."""
    one = CNNServer(cfg, batch=2, seed=0, device="cpu")
    ims = _images(8)
    a, b = _requests(ims), _requests(ims)
    one.serve(a)
    group.serve(b)
    assert_array_equal(np.stack([r.logits for r in b]),
                       np.stack([r.logits for r in a]))
    assert {s["replica"] for s in group.scheduler.serve(_requests(ims))} \
        == {0, 1, 2}


def test_check_emission_and_reset(group):
    be = group.group.backends[0]
    assert be.check_emission(np.ones(3, np.float32))
    assert not be.check_emission(np.array([1.0, np.nan], np.float32))
    req = ImageRequest(rid=0, image=_images(1)[0])
    be.append(req, np.ones(3, np.float32))
    be.reset(req)
    assert req.out == [] and req.logits is None


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [None, "int8"])
def test_two_replicas_bit_identical_to_one_on_the_card(cuda, cfg, dtype):
    from repro_torch.kernels.capture import add_counts, counts, wrappers
    one = CNNServer(cfg, batch=4, seed=0, dtype=dtype, device=cuda)
    two = CNNServer(cfg, batch=4, seed=0, dtype=dtype, device=cuda,
                    replicas=2)
    ims = _images(16)
    a, b = _requests(ims), _requests(ims)
    one.serve(a)
    add_counts({k: -n for k, n in counts().items()})
    stats = two.serve(b)
    torch.cuda.synchronize()
    assert_array_equal(np.stack([r.logits for r in b]),
                       np.stack([r.logits for r in a]))
    forwards = 0
    for i, be in enumerate(two.group.backends):
        waves = sum(s["steps"] for s in stats if s["replica"] == i)
        assert (be.apply.compiles, be.apply.replays) == (1, waves)
        forwards += waves + 1
    launches = {n: k.launches for n, k in wrappers().items() if k.launches}
    assert launches == {"vsconv_halo": 17 * forwards, "vsmm": 4 * forwards}


@pytest.mark.gpu
def test_dispatch_before_collect_on_the_card(cuda, cfg):
    """Each replica's logits are its own graph's static output: replica 1
    dispatching before replica 0 is collected leaves replica 0's intact."""
    two = CNNServer(cfg, batch=4, seed=0, device=cuda, replicas=2)
    ims = _images(8, seed=5)
    waves = [_requests(ims[:4]), _requests(ims[4:])]
    bes = two.group.backends
    handles = []
    for be, wave in zip(bes, waves):
        state, _ = be.start(wave, 4)
        handles.append((state, be.dispatch(state, wave)))
    for be, wave, (state, h) in zip(bes, waves, handles):
        _, emis = be.collect(state, h, wave)
        with torch.inference_mode():
            eager = tg.net_apply(
                be.apply.net, be.apply.params,
                torch.from_numpy(np.stack([r.image for r in wave])).to(cuda),
                sparse=be.apply.sparse, impl=be.apply.impl).cpu().numpy()
        assert_array_equal(np.stack(emis), eager)


def test_captures_hold_the_collector_off():
    """A dead fleet's graphs can sit in a reference cycle (a fault's
    traceback holds the scheduler's frames); destroying them during
    another capture would invalidate it.  `no_collection`, around every
    capture, keeps the garbage collector off, and gives back its state."""
    import gc

    from repro_torch.kernels.capture import no_collection

    assert gc.isenabled()
    with no_collection():
        assert not gc.isenabled()
        with no_collection():
            assert not gc.isenabled()
        assert not gc.isenabled()
    assert gc.isenabled()
