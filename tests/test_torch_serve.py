"""The port's CNN serving path on the CPU: scheduler, backend, server.

The reduced ResNet-18 config (32 px, 200 classes) served through the
port's `CNNServer` with ``device="cpu"`` (the plain path).  The lockstep
scheduler is also run side by side with the reference's on one scripted
backend: the port keeps its own copy, and the two must behave alike.
"""
import numpy as np
import pytest
import torch

from repro.launch import scheduler as jsched
from repro_torch import params as tparams_mod
from repro_torch.configs import get_config, list_cnn_archs
from repro_torch.launch import faults, scheduler
from repro_torch.launch.serve import CNNServer, ImageRequest
from repro_torch.models import graph as tg
from repro_torch.models import layers as tl


@pytest.fixture(scope="module")
def cfg():
    return get_config("vscnn-resnet18").reduce()


def _images(n, size=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((size, size, 3)).astype(np.float32)
            for _ in range(n)]


def test_registry_holds_resnet18():
    assert list_cnn_archs() == ["vscnn-mobilenet-v1", "vscnn-resnet18",
                                "vscnn-vgg16"]
    full = get_config("vscnn-resnet18")
    assert (full.image_size, full.num_classes, full.weight_density,
            full.vk, full.vn) == (224, 1000, 0.235, 32, 128)
    with pytest.raises(KeyError):
        get_config("vscnn-resnet50")


def test_served_logits_bit_identical_to_direct_apply(cfg):
    """Five requests at batch 4: one run, a backfilled fifth image on a
    width-1 wave, logits bit-identical to net_apply on the same waves."""
    srv = CNNServer(cfg, batch=4, density=0.5, seed=0, device="cpu")
    imgs = _images(5)
    reqs = [ImageRequest(rid=i, image=im) for i, im in enumerate(imgs)]
    stats = srv.serve(reqs)
    assert len(stats) == 1
    s = stats[0]
    assert (s["steps"], s["backfills"], s["finished"], s["images"]) == (
        2, 1, 5, 5)
    assert s["compiles"] == 2  # the full wave and the shrunk width-1 wave
    with torch.inference_mode():
        ref = torch.cat([
            tg.net_apply(srv.net, srv.params,
                         torch.from_numpy(np.stack(imgs[a:b])),
                         sparse=srv.sparse)
            for a, b in ((0, 4), (4, 5))]).numpy()
    for i, r in enumerate(reqs):
        assert r.logits.shape == (cfg.num_classes,)
        np.testing.assert_array_equal(r.logits, ref[i])
        assert r.out == [int(ref[i].argmax())]
        assert r.outcome.status == "delivered"


def test_final_wave_shrinks_to_pow2(cfg):
    srv = CNNServer(cfg, batch=4, density=0.5, seed=0, device="cpu")
    srv.serve([ImageRequest(rid=i, image=im)
               for i, im in enumerate(_images(7))])
    widths = {k[-1][0] for k in srv.backend.apply.buckets}
    assert widths == {4}  # 4, then 3 occupied slots of a width-4 wave
    srv.serve([ImageRequest(rid=9, image=_images(1, seed=2)[0])])
    widths = {k[-1][0] for k in srv.backend.apply.buckets}
    assert widths == {4, 1}


def test_malformed_requests_refused(cfg):
    srv = CNNServer(cfg, batch=2, density=0.5, seed=0, device="cpu")
    s = cfg.image_size
    good = ImageRequest(rid=0, image=np.ones((s, s, 3), np.float32))
    bad = [
        ImageRequest(rid=1, image=[[1.0]]),
        ImageRequest(rid=2, image=np.ones((s, s), np.float32)),
        ImageRequest(rid=3, image=np.ones((s, s, 3), np.int32)),
        ImageRequest(rid=4, image=np.full((s, s, 3), np.nan, np.float32)),
        ImageRequest(rid=5, image=np.ones((s, s, 4), np.float32)),
    ]
    srv.serve([good] + bad)
    assert good.outcome.status == "delivered" and good.out
    reasons = [r.outcome.reason for r in bad]
    for reason, want in zip(reasons, ["invalid:not_an_array",
                                      "invalid:bad_rank", "invalid:bad_dtype",
                                      "invalid:non_finite_input",
                                      "invalid:bad_channels"]):
        assert reason.startswith(want), reason
    assert all(r.outcome.status == "refused" for r in bad)
    assert srv.outcomes[0] is good.outcome


def test_queue_full_sheds_load(cfg):
    srv = CNNServer(cfg, batch=2, density=0.5, seed=0, device="cpu",
                    max_queue=2)
    reqs = [ImageRequest(rid=i, image=im) for i, im in enumerate(_images(3))]
    srv.serve(reqs)
    assert [r.outcome.status for r in reqs] == ["delivered", "delivered",
                                                "refused"]
    assert reqs[2].outcome.reason == "queue_full"


def test_entry_points_run_on_cuda_unless_told(monkeypatch, cfg):
    """With no card and no ``device="cpu"``, the entry points raise rather
    than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CNNServer(cfg, batch=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.init_params(cfg.build().schema(), 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tparams_mod.params_from_numpy({"w": np.ones(3)})


class _Scripted:
    """A backend whose requests need ``req.need`` emissions each."""

    def __init__(self):
        self.calls = []

    def bucket_key(self, req):
        return req.bucket

    def sort_key(self, req):
        return req.rid

    def validate_request(self, req):
        return "bad" if req.need < 1 else None

    def start(self, reqs, width):
        self.calls.append(("start", [r.rid for r in reqs], width))
        return {}, None

    def step(self, state, slots):
        self.calls.append(("step", [None if r is None else r.rid
                                    for r in slots]))
        return state, [None if r is None else r.rid for r in slots]

    def append(self, req, emission):
        req.got.append(emission)
        return len(req.got) >= req.need

    def can_backfill(self, state, req):
        return True

    def backfill(self, state, slot, req):
        return state, None

    def finish(self, state):
        return {}


class _Req:
    def __init__(self, rid, need, bucket):
        self.rid, self.need, self.bucket, self.got = rid, need, bucket, []


def _plan():
    rng = np.random.default_rng(7)
    return [(i, int(rng.integers(0, 4)), int(rng.integers(0, 2)))
            for i in range(11)]


def test_scheduler_copy_behaves_like_reference():
    runs = []
    for mod in (scheduler, jsched):
        be = _Scripted()
        sched = mod.LockstepScheduler(be, batch=3, max_queue=9)
        reqs = [_Req(*p) for p in _plan()]
        stats = sched.serve(reqs)
        for s in stats:
            s.pop("start_s")
            s.pop("run_s")
        outcomes = {rid: (o.status, o.reason)
                    for rid, o in sched.outcomes.items()}
        runs.append((stats, outcomes, be.calls, [r.got for r in reqs]))
    assert runs[0] == runs[1]


def test_fault_hierarchy():
    for cls in (faults.ReplicaDead, faults.TransientFault,
                faults.CompileFault, faults.NonFiniteOutput):
        assert issubclass(cls, faults.FAULT_TYPES)
    assert faults.TransientFault.transient
    assert not faults.ReplicaDead.transient
    assert not issubclass(ValueError, faults.FAULT_TYPES)
