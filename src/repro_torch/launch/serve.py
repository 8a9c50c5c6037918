"""Batched serving: the lockstep scheduler and the replica fleet, two
backends, and the serving CLI.

The port of `repro/launch/serve.py`.  The LM arm:

* `LMBackend` — continuous batching over `models.transformer`'s prefill
  and decode: a sequence retires the moment it emits ``eos_id`` (or
  exhausts ``max_new``) and its slot is backfilled from the queue in the
  same run.  Admission prompts are left-padded to a ``len_bucket``
  multiple; a backfill prefill right-pads the context to the same ladder
  at the full batch width and reads its logits at the true position, and
  its cache rows are copied into the live caches in place.  Every prefill
  runs the flash kernel once per attention layer; decode steps run none.
  The backend owns the caches; on the card a decode step replays one
  CUDA graph per (width, capacity), the reference's jitted ``_decode``.
  Requests carry per-request sampling (``temperature`` / ``top_k``),
  keyed by (seed, rid, emission count) through the reference's threefry
  (`core.threefry`), so a sampled stream is the reference's; temperature
  0 is the plain argmax, bit-identical whatever the lane's neighbours
  do.  Recurrent archs (RWKV, Mamba) backfill at the exact context
  length, attention archs on the ``len_bucket`` ladder.
* `Server` — seeded (or bridged) weights in their served form
  (`transformer.prepare_params`: each vector-sparse FFN's ``wo`` merged
  once) and an `LMBackend` behind a `LockstepScheduler`.  It serves
  token-input archs, dense or with the vector-sparse FFN
  (``use_sparse_ffn``: its vsmm launches are captured in the decode
  graph like every other kernel) and with or without ``bf16_flow``; it
  refuses an embedding-input arch (``embed_inputs=False``), as the
  reference's does: those run through `models.transformer`'s
  ``lm_apply`` / ``prefill`` / ``decode_step``.

The CNN arm:

* `CNNBackend` — requests carry images, batches pad/bucket on image shape,
  every request finishes in one lockstep step, and freed slots are refilled
  from the queue so one batch shape serves wave after wave; a partial final
  wave shrinks to its occupied slots (pow2 ladder) instead of computing
  zero images.  ``step`` is split into ``dispatch`` (build the batch on the
  device and enqueue the forward — on the card a CUDA-graph replay per
  shape bucket, `BatchedApply` — which returns before the card finishes)
  and ``collect`` (copy the logits to the host, which waits).
* `CNNServer` — checks the net with vscheck's IR gate (`validate_net`)
  before it makes any weights, makes seeded params, sparsifies them and
  serves through a `LockstepScheduler`; ``impl="auto"`` takes the CUDA
  kernels on the card and the plain path on the CPU.

The replica fleet: ``replicas > 1`` (or ``shard_fc``, a ``fault_plan`` or
``deadline_waves``) serves a `ReplicaGroup` — N `CNNBackend`s, each with
its own weight tree on its device (replica 0 the server's, the others
copies) and its own `BatchedApply`
(graphs, memory pool, page-locked buffers) — behind
`launch.scheduler.FleetScheduler`, which dispatches every replica's wave
before it collects any.  On one card every replica shares the device and
its stream, so what overlaps is one replica's host padding with another's
graph replay.  A ``fault_plan`` (`launch.faults.FaultPlan`) wraps every
replica in a `ChaosBackend` for replayable chaos runs.

Every entry point runs on CUDA unless ``device="cpu"``.

Under a mesh (a `torch.distributed` world, `launch.mesh`): `Server(mesh=)`
shards its weights over a ``("data", "model")`` mesh and its `LMBackend`
serves inside it (`LMBackend.context`); `CNNServer` / `ReplicaGroup`
with ``shard_fc`` cout-shard the FC heads over each replica's ranks: the
world laid out as the reference's (data, model) grid, one ``("model",)``
group of ranks a replica, the logits of each wave sent from its group to
every rank.  Every rank runs the same scheduler on the same requests
(SPMD); only wave counts drive its decisions.  The CLI joins a world with
``--dist-store`` (``RANK`` / ``WORLD_SIZE`` from the environment) and
serves an LM under ``--mesh DATAxMODEL``.

Usage (the reduced configs; add ``--device cpu`` to run on the CPU):
  python -m repro_torch.launch.serve --arch qwen1.5-4b --requests 4 --tokens 8
  python -m repro_torch.launch.serve --cnn vscnn-resnet50 --replicas 2 \\
      --chaos-seed 0
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs import get_config
from repro_torch.core import threefry
from repro_torch.core.device import resolve_device
from repro_torch.kernels.capture import Captured, capture
from repro_torch.launch.faults import ChaosBackend, FaultPlan
from repro_torch.launch.mesh import (init_process_group, make_local_mesh,
                                     make_model_mesh)
from repro_torch.launch.scheduler import FleetScheduler, LockstepScheduler
from repro_torch.models.graph import (FC, BatchedApply, SparseNet,
                                      input_refusal, output_finite,
                                      place_params, shard_sparse)
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import init_params
from repro_torch.parallel import sharding as shd

__all__ = ["Request", "ImageRequest", "LMBackend", "CNNBackend",
           "ReplicaGroup", "Server", "CNNServer", "validate_net",
           "random_prompt_lengths", "main"]


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


# --------------------------------------------------------------------------
# LM backend: prefill/decode lockstep with EOS retirement + cache-merge
# backfill
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    """One LM generation request.

    ``temperature``/``top_k`` select per-request sampling for every token
    this request emits: 0 temperature (the default) is greedy argmax;
    ``top_k > 0`` restricts sampling to the k highest logits.  Requests
    with different sampling params share a batch — the sampler is per-slot.
    """

    rid: int
    prompt: np.ndarray           # (L,) integer token ids
    max_new: int
    temperature: float = 0.0
    top_k: int = 0
    out: list = dataclasses.field(default_factory=list)
    outcome: Any = None          # the scheduler's RequestOutcome


def _sample_tokens(logits: torch.Tensor, temp: torch.Tensor,
                   top_k: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Per-slot temperature/top-k sampling over (B, V) logits.

    Slots with ``temp == 0`` take the plain argmax of the raw logits, so a
    zero-temperature slot reproduces the greedy path bit-exactly even when
    its neighbours sample.  ``top_k == 0`` means no truncation.  Ranking
    uses a stable double argsort, so ``top_k=1`` keeps exactly the argmax
    candidate (first max on ties, like argmax itself).  A sampling slot
    takes the argmax of its scaled logits plus Gumbel noise drawn under
    its threefry key (``keys`` (B, 2), `core.threefry`) on the logits'
    device: the reference's categorical draw, the same bits of noise up
    to the last ulp of its logarithms.
    """
    greedy = torch.argmax(logits, dim=-1)
    order = torch.argsort(-logits, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)  # 0 = largest logit
    k = torch.where(top_k > 0, top_k, logits.shape[-1])[:, None]
    masked = torch.where(rank < k, logits, -torch.inf)
    scaled = masked / torch.clamp_min(temp, 1e-30)[:, None]
    noise = threefry.gumbel(keys, logits.shape[-1])
    sampled = torch.argmax(scaled + noise, dim=-1)
    return torch.where(temp > 0.0, sampled, greedy)


def _positional_caches(cfg: Any) -> bool:
    """True when every cached layer state is plain positional attention K/V.

    Recurrent mixers (rwkv/mamba and the RWKV channel mix) fold every
    processed token into their state, so a backfill prefill right-padded
    past the true context would corrupt it.  Sliding-window attention is
    excluded too: its K/V cache is *circular* (slot = pos % window), so
    the right-pad junk at positions [cur, curb) would wrap onto slots
    holding real in-window history and be attended as it.  Only plain
    full-context attention caches (slot == position; future slots masked,
    then overwritten) survive the right-pad, and they gate the bucketed
    backfill; the others backfill at the exact context length.
    """
    return all(
        sp.mixer in ("attn", "none") and sp.window is None
        and sp.ffn in ("mlp", "moe", "none")
        for seg in cfg.segments for sp in seg.layers
    )


def _tree_clone(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, list):
        return [_tree_clone(v) for v in tree]
    return {k: _tree_clone(v) for k, v in tree.items()}


def _full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value on every rank (an all-gather); a plain
    tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _tree_copy(dst: Any, src: Any) -> None:
    """Copy every leaf of ``src`` into the same leaf of ``dst``."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, list):
        for d, s in zip(dst, src):
            _tree_copy(d, s)
    else:
        for k in dst:
            _tree_copy(dst[k], src[k])


def _copy_rows(dst: Any, src: Any, j: int) -> None:
    """Copy batch row ``j`` of every cache leaf of ``src`` into ``dst`` in
    place; leaves are (repeat, batch, ...).  A DTensor leaf (under a
    mesh) is copied by the ranks that hold row ``j``."""
    if isinstance(dst, DTensor):
        if src.placements != dst.placements:
            src = src.redistribute(dst.device_mesh, dst.placements)
        dl, sl = dst.to_local(), src.to_local()
        mesh, owner = dst.device_mesh, 0
        for i, p in enumerate(dst.placements):
            if isinstance(p, Shard) and p.dim == 1:
                owner = owner * mesh.size(i) + mesh.get_coordinate()[i]
        r = j - owner * dl.shape[1]
        if 0 <= r < dl.shape[1]:
            dl[:, r].copy_(sl[:, r])
    elif isinstance(dst, torch.Tensor):
        dst[:, j].copy_(src[:, j])
    elif isinstance(dst, list):
        for d, s in zip(dst, src):
            _copy_rows(d, s, j)
    else:
        for k in dst:
            _copy_rows(dst[k], src[k], j)


@dataclasses.dataclass
class _DecodeGraph:
    """One decode step captured at a (width, capacity): its static inputs
    (``tokens`` (B, 1), ``pos`` a 0-d int64) and output (``logits`` (B,
    Vp) f32)."""

    graph: Captured
    tokens: torch.Tensor
    pos: torch.Tensor
    logits: torch.Tensor


class LMBackend:
    """Continuous-batching backend over the transformer prefill / decode.

    Backfill prefills the newcomer at the full batch width (idle lanes
    zero) and copies only its cache rows into the live caches, so a
    backfilled request computes as the same request served alone at that
    context length.  For plain attention caches the backfill context is
    right-padded from the true length ``cur`` up to the ``len_bucket``
    ladder and the first token is read at position ``cur - 1``
    (`tfm.prefill(logit_pos=...)`); the pad rows' K/V junk is causally
    masked and overwritten by the following decode steps before any query
    attends it.

    The backend owns the decode caches, one set per batch width
    (``caches``): an admission prefill fills them in place and a backfill
    copies its rows into them.  On the card each decode step replays one
    CUDA graph per (width, capacity) (``graphs``), captured over those
    caches at its first step, with the step's tokens and position copied
    into its static inputs; sampling reads its static logits.  Prefills
    run eagerly.  On the CPU a decode step runs eagerly.

    Under a ``mesh`` (a `DeviceMesh` of the SPMD world; ``params`` then
    DTensors, `transformer.shard_params`) every rank runs the same
    scheduler on the same requests: `context` enters the mesh with the
    serving rules, tokens are laid out on the batch dims, the caches are
    DTensors (K/V sequence-sharded), and each forward's logits are
    gathered whole on every rank before sampling, so every rank takes the
    same tokens and the same branches.  A decode graph captures the
    step's collectives with it.
    """

    def __init__(self, cfg: Any, params: dict, *, capacity: int,
                 eos_id: int | None = None, len_bucket: int = 16,
                 sample_seed: int = 0,
                 device: str | torch.device | None = None,
                 mesh: Any = None):
        self.cfg = cfg
        self.params = params
        self.mesh = mesh
        self.capacity = capacity
        self.eos_id = eos_id
        self.len_bucket = max(1, len_bucket)
        self.backfill_bucket = (self.len_bucket if _positional_caches(cfg)
                                else 1)
        self.sample_seed = sample_seed
        self.device = resolve_device(device)
        self.caches: dict = {}   # width -> the decode caches
        self.graphs: dict = {}   # (width, capacity) -> _DecodeGraph

    # -- per-slot sampling --------------------------------------------------

    @staticmethod
    def _greedy_lane() -> list:
        return [0.0, 0, -1, 0]           # temperature, top_k, rid, count

    def _emit_tokens(self, state: dict, logits: torch.Tensor, js
                     ) -> torch.Tensor:
        """Next token for each slot index in ``js``; ``logits[i]`` is slot
        ``js[i]``'s row.  All-greedy batches take the plain argmax;
        otherwise each sampling slot draws under the key folded from
        (seed, rid, emission count) as the reference folds it, so a
        request's stream is reproducible wherever its slot lands and
        equals the reference's.  The keys are made on the host (a few
        integer operations a slot); the noise is drawn on the device."""
        sel = [state["samp"][j] for j in js]
        if not any(s[0] > 0 for s in sel):
            return torch.argmax(logits, dim=-1)
        dev = logits.device
        temps = torch.tensor([s[0] for s in sel], dtype=torch.float32,
                             device=dev)
        topks = torch.tensor([s[1] for s in sel], dtype=torch.int64,
                             device=dev)
        base = threefry.prng_key(self.sample_seed)
        keys = torch.tensor([threefry.fold_in(
            threefry.fold_in(base, s[2] & 0x7FFFFFFF), s[3]) for s in sel],
            dtype=torch.int64, device=dev)
        toks = _sample_tokens(logits, temps, topks, keys)
        for s in sel:
            s[3] += 1
        return toks

    def _tokens(self, toks: np.ndarray) -> dict:
        return {"tokens": self._laid_out(torch.from_numpy(toks).to(
            self.device))}

    def _laid_out(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token ids (B, T) as the forward takes them: under a mesh a
        DTensor on the batch dims (each rank's rows cut from its copy)."""
        if self.mesh is None:
            return tokens
        return shd.distribute(tokens, ("batch", None))

    def context(self) -> Any:
        """Entered around each run: under a mesh, the mesh with the
        serving rules (the reference's ``use_mesh(mesh, SERVE_RULES)``)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return shd.use_mesh(self.mesh, shd.SERVE_RULES)

    # -- scheduler protocol -------------------------------------------------

    def validate_request(self, req: Request) -> str | None:
        """Admission-time validation: a reason string refuses the request
        (structured `RequestOutcome`) before it can poison a batch."""
        p = req.prompt
        if not isinstance(p, np.ndarray):
            return f"not_an_array:{type(p).__name__}"
        if p.ndim != 1:
            return f"bad_rank:{p.ndim}"
        if not np.issubdtype(p.dtype, np.integer):
            return f"bad_dtype:{p.dtype}"
        if len(p) == 0:
            return "empty_prompt"
        if req.max_new < 1:
            return f"bad_max_new:{req.max_new}"
        padded = _round_up(len(p), self.len_bucket)
        if padded >= self.capacity:
            return f"prompt_too_long:{padded}>={self.capacity}"
        return None

    def reset(self, req: Request) -> None:
        """Clear partial progress before a fault-displaced re-serve.  A
        greedy stream regenerates bit for bit; a sampling stream too, since
        its keys fold (seed, rid, emission count) and the count restarts
        at 0 with the request."""
        req.out.clear()

    def bucket_key(self, req: Request) -> int:
        return _round_up(max(len(req.prompt), 1), self.len_bucket)

    def sort_key(self, req: Request) -> int:
        # longest prompts first: every later backfill then fits the
        # already-grown context (can_backfill below)
        return -len(req.prompt)

    def start(self, requests: list[Request], width: int
              ) -> tuple[dict, list]:
        lens = [len(r.prompt) for r in requests]
        max_len = _round_up(max(max(lens), 1), self.len_bucket)
        if max_len >= self.capacity:
            raise ValueError(
                f"padded prompt length {max_len} >= capacity {self.capacity}")
        toks = np.zeros((width, max_len), np.int64)
        for i, r in enumerate(requests):  # left-pad
            toks[i, max_len - len(r.prompt):] = r.prompt
        if width not in self.caches:
            self.caches[width] = tfm.init_cache(self.cfg, width,
                                                self.capacity, self.device)
        logits, caches = tfm.prefill(self.params, self._tokens(toks),
                                     self.cfg, capacity=self.capacity,
                                     caches=self.caches[width])
        logits = _full(logits)
        samp = [[r.temperature, r.top_k, r.rid, 0] for r in requests]
        samp += [self._greedy_lane() for _ in range(width - len(requests))]
        state = {"caches": caches, "nxt": None, "len": max_len, "i": 0,
                 "samp": samp}
        nxt = self._emit_tokens(state, logits, range(width))
        state["nxt"] = nxt[:, None]
        first = nxt.cpu().numpy()
        emis = [int(first[j]) if j < len(requests) else None
                for j in range(width)]
        return state, emis

    def _decode(self, state: dict, pos: int) -> torch.Tensor:
        """One decode step on the card: replay the (width, capacity) graph
        with this step's tokens and position, capturing it first over the
        backend's caches.  The capture's warm-up runs the same step
        eagerly and advances the caches (a recurrent state would then
        take this step twice), so the caches are copied before it and
        put back after, and the first replay takes the step once.
        Returns the graph's static logits."""
        width = int(state["nxt"].shape[0])
        key = (width, self.capacity)
        g = self.graphs.get(key)
        if g is None:
            caches = self.caches[width]
            saved = _tree_clone(caches)
            tokens = state["nxt"].clone()
            p = torch.full((), pos, dtype=torch.int64, device=self.device)
            graph, logits = capture(lambda: _full(tfm.decode_step(
                self.params, caches, self._laid_out(tokens), p,
                self.cfg)[0]))
            _tree_copy(caches, saved)
            del saved
            g = self.graphs[key] = _DecodeGraph(graph, tokens, p, logits)
        else:
            g.tokens.copy_(state["nxt"])
            g.pos.fill_(pos)
        g.graph.replay()
        return g.logits

    def step(self, state: dict, slots: list) -> tuple[dict, list]:
        pos = state["len"] + state["i"]
        if self.device.type == "cuda":
            logits = self._decode(state, pos)
        else:
            logits, _ = tfm.decode_step(self.params, state["caches"],
                                        self._laid_out(state["nxt"]), pos,
                                        self.cfg)
            logits = _full(logits)
        for j, s in enumerate(slots):
            if s is None:                # retired lane: back to greedy
                state["samp"][j] = self._greedy_lane()
        nxt = self._emit_tokens(state, logits, range(len(slots)))
        state.update(nxt=nxt[:, None], i=state["i"] + 1)
        return state, [int(t) for t in nxt.cpu().numpy()]

    def can_backfill(self, state: dict, req: Request) -> bool:
        cur = state["len"] + state["i"]
        return (len(req.prompt) <= cur
                and cur + req.max_new <= self.capacity)

    def backfill(self, state: dict, slot: int, req: Request
                 ) -> tuple[dict, int]:
        cur = state["len"] + state["i"]
        width = int(state["nxt"].shape[0])
        # right-pad the context to the bucket ladder: positions [0, cur)
        # are exactly the exact-length prefill's, logits are read at
        # cur - 1, and the junk K/V rows beyond cur are masked/overwritten
        curb = min(_round_up(cur, self.backfill_bucket), self.capacity)
        toks = np.zeros((width, curb), np.int64)
        toks[slot, cur - len(req.prompt):cur] = req.prompt
        logits, caches1 = tfm.prefill(self.params, self._tokens(toks),
                                      self.cfg, capacity=self.capacity,
                                      logit_pos=cur - 1)
        logits = _full(logits)
        state["samp"][slot] = [req.temperature, req.top_k, req.rid, 0]
        tok = int(self._emit_tokens(state, logits[slot][None], [slot])[0])
        _copy_rows(state["caches"], caches1, slot)
        state["nxt"][slot, 0] = tok
        return state, tok

    def append(self, req: Request, tok: int) -> bool:
        req.out.append(tok)
        if self.eos_id is not None and tok == self.eos_id:
            return True
        return len(req.out) >= req.max_new

    def finish(self, state: dict) -> dict:
        return {}


class Server:
    """Batched LM serving: prefill/decode behind the lockstep scheduler.

    Weights are initialized from ``seed`` in the config's dtype on
    ``device`` (CUDA by default; on the card drawn there by a CUDA
    generator), or taken as given (``params``, e.g. the
    reference's through `repro_torch.params.params_from_numpy`), then put
    in their served form (`transformer.prepare_params`).  With a ``mesh``
    (a `DeviceMesh` over ``("data", "model")``, `launch.mesh`) every rank
    builds the same full tree and keeps its own shards of it
    (`transformer.shard_params`, the serving rules) before that, and the
    backend serves under the mesh; every rank must call `serve` with the
    same requests.  An embedding-input config raises ``ValueError``.
    """

    def __init__(self, cfg: Any, *, batch: int, capacity: int, seed: int = 0,
                 eos_id: int | None = None, len_bucket: int = 16,
                 max_queue: int | None = None,
                 device: str | torch.device | None = None,
                 params: dict | None = None, mesh: Any = None):
        if not cfg.embed_inputs:
            raise ValueError(f"{cfg.name}: the LM server expects "
                             f"token-input archs (embed_inputs=False)")
        self.cfg = cfg
        self.batch = batch
        self.capacity = capacity
        self.mesh = mesh
        self.device = resolve_device(device)
        if params is None:
            params = init_params(tfm.lm_schema(cfg), seed, dtype=cfg.dtype,
                                 device=self.device, draw_on_device=True)
        with (shd.use_mesh(mesh, shd.SERVE_RULES) if mesh is not None
              else contextlib.nullcontext()):
            if mesh is not None:
                params = tfm.shard_params(params, cfg)
            self.params = tfm.prepare_params(params, cfg)
        self.backend = LMBackend(cfg, self.params, capacity=capacity,
                                 eos_id=eos_id, len_bucket=len_bucket,
                                 device=self.device, mesh=mesh)
        self.scheduler = LockstepScheduler(self.backend, batch=batch,
                                           max_queue=max_queue)

    @property
    def outcomes(self) -> dict:
        """Per-request terminal outcomes of the last `serve` call."""
        return self.scheduler.outcomes

    @staticmethod
    def _legacy_stats(s: dict) -> dict:
        return {
            "prefill_s": s["start_s"],
            "decode_s": s["run_s"],
            "decode_steps": s["steps"],
            "new_tokens": s["emissions"],
            "decode_tok_s": s["emissions"] / max(s["run_s"], 1e-9),
            "finished": s["finished"],
            "backfills": s["backfills"],
        }

    def run_batch(self, requests: list[Request]) -> dict:
        """One lockstep run: the first ``batch`` requests are admitted, the
        rest backfill retired slots.  Returns its stats.  Raises if a
        request can never join this run (capacity or context limits): use
        `serve`, which gives leftovers a fresh run, for the general case."""
        queue = list(requests)
        stats = self.scheduler.run_lockstep(queue)
        if queue:
            raise ValueError(
                f"{len(queue)} request(s) could not backfill into this "
                f"lockstep run (capacity/context limits); use serve()")
        return self._legacy_stats(stats)

    def serve(self, requests: list[Request]) -> list[dict]:
        """Bucket the queue by prompt length, then run lockstep batches with
        retirement + backfill until it drains (continuous batching)."""
        return [self._legacy_stats(s)
                for s in self.scheduler.serve(list(requests))]


def _pad_batch(out: np.ndarray, images: list) -> np.ndarray:
    """Write ``images`` (H, W, C) into the first rows of the batch ``out``
    (N, Hb, Wb, C), each zero-padded to Hb x Wb, and zero the other
    rows."""
    for i, im in enumerate(images):
        h, w, _ = im.shape
        out[i, :h, :w] = im
        out[i, h:] = 0
        out[i, :h, w:] = 0
    out[len(images):] = 0
    return out


@dataclasses.dataclass
class ImageRequest:
    """One CNN inference request."""

    rid: int
    image: np.ndarray            # (H, W, C) float
    max_new: int = 1             # one-shot: a single emission finishes it
    out: list = dataclasses.field(default_factory=list)  # [predicted class]
    logits: np.ndarray | None = None
    outcome: Any = None          # the scheduler's RequestOutcome


class CNNBackend:
    """One-shot image backend: a request finishes in a single lockstep step.

    ``image_size`` pins the bucket to the net's fixed input; when None the
    bucket pads each image's H/W up to ``pad_multiple`` (size-agnostic nets
    like the GAP-headed ResNets).  A partial wave computes on a batch
    shrunk to the occupied slots, rounded up to the next power of two and
    capped at the full width, so a shape bucket sees at most
    log2(width)+1 batch shapes.

    The forward runs where ``params`` lie (`BatchedApply`).  Each backend
    owns its `BatchedApply`, and so its graphs, memory pool and
    page-locked buffers: a fleet gives every replica a backend of its own
    (`ReplicaGroup`).  ``mesh`` and ``rules`` go to `BatchedApply` (FC
    heads cout-sharded over the replica's ranks, `models.graph.shard_sparse`).
    """

    def __init__(self, net: SparseNet, params: dict, *,
                 sparse: dict | None = None, impl: str = "auto",
                 density: float | None = None, image_size: int | None = None,
                 pad_multiple: int = 8,
                 device: str | torch.device | None = None,
                 mesh: Any = None, rules: Any = None):
        self.device = resolve_device(device)
        self.image_size = image_size
        self.pad_multiple = pad_multiple
        self.channels = next((l.cin for l in net.conv_layers()), None)
        self.mesh, self.rules = mesh, rules
        self.apply = BatchedApply(net, params, sparse=sparse, impl=impl,
                                  key=(density,), mesh=mesh, rules=rules)

    # -- scheduler protocol -------------------------------------------------

    def validate_request(self, req: ImageRequest) -> str | None:
        """Admission-time validation: malformed images (wrong type, rank,
        dtype, channels, non-finite values, oversize for a fixed-input net)
        become structured refusals."""
        return input_refusal(req.image, max_size=self.image_size,
                             channels=self.channels)

    def check_emission(self, emission: np.ndarray) -> bool:
        """Output guard: non-finite logits quarantine the replica that
        produced them (`models.graph.output_finite`)."""
        return output_finite(emission)

    def reset(self, req: ImageRequest) -> None:
        req.out.clear()
        req.logits = None

    def context(self) -> Any:
        """Entered around each run: the weights' card as the current CUDA
        device (a replica on another card captures and replays there),
        and under a mesh the mesh with the backend's rules."""
        stack = contextlib.ExitStack()
        if self.device.type == "cuda":
            stack.enter_context(torch.cuda.device(self.device))
        if self.mesh is not None:
            stack.enter_context(shd.use_mesh(
                self.mesh, self.rules or shd.SERVE_RULES))
        return stack

    def bucket_key(self, req: ImageRequest) -> tuple[int, int, int]:
        h, w, c = req.image.shape
        if self.image_size is not None:
            if max(h, w) > self.image_size:
                raise ValueError(
                    f"image {h}x{w} exceeds the net's fixed input size "
                    f"{self.image_size}")
            return (self.image_size, self.image_size, c)
        m = self.pad_multiple
        return (_round_up(h, m), _round_up(w, m), c)

    def sort_key(self, req: ImageRequest) -> int:
        return req.rid  # arrival order; all images in a bucket are equal

    def start(self, requests: list[ImageRequest], width: int
              ) -> tuple[dict, None]:
        return {"width": width, "bucket": self.bucket_key(requests[0])}, None

    def dispatch(self, state: dict, slots: list
                 ) -> tuple[list[int], torch.Tensor]:
        """Issue one wave: pad the occupied slots into a batch and enqueue
        the forward (`BatchedApply`, on the card a graph replay).  The
        returned logits may still be in flight — `collect` waits for them.

        On the card they are the graph's static output, which this
        backend's next dispatch rewrites, so that must come after this
        wave's `collect`.  Both schedulers keep that order per backend:
        the fleet dispatches every replica before it collects any, but it
        collects each replica before it dispatches that replica again, and
        each replica's backend has its own `BatchedApply`, so one
        replica's replay never touches another's output.  One backend
        shared by several replicas would break it."""
        occ, shape = self._wave(state, slots)
        images = [slots[j].image for j in occ]
        return occ, self.apply(shape, lambda out: _pad_batch(out, images))

    @staticmethod
    def _wave(state: dict, slots: list) -> tuple[list[int], tuple]:
        """The occupied slots and the wave's batch shape: the occupied
        count rounded up to a power of two, at most the width."""
        occ = [j for j, r in enumerate(slots) if r is not None]
        nb = min(state["width"], 1 << max(len(occ) - 1, 0).bit_length())
        return occ, (nb, *state["bucket"])

    def collect(self, state: dict, handle: tuple[list[int], torch.Tensor],
                slots: list) -> tuple[dict, list]:
        occ, y_dev = handle
        y = y_dev.to("cpu", copy=True).numpy()  # a static buffer on the card
        emis: list = [None] * state["width"]
        for i, j in enumerate(occ):
            emis[j] = y[i]
        return state, emis

    def step(self, state: dict, slots: list) -> tuple[dict, list]:
        return self.collect(state, self.dispatch(state, slots), slots)

    def can_backfill(self, state: dict, req: ImageRequest) -> bool:
        return self.bucket_key(req) == state["bucket"]

    def backfill(self, state: dict, slot: int, req: ImageRequest
                 ) -> tuple[dict, None]:
        return state, None  # computed on the next lockstep step

    def append(self, req: ImageRequest, logits: np.ndarray) -> bool:
        req.logits = np.asarray(logits)
        req.out.append(int(req.logits.argmax()))
        return True

    def finish(self, state: dict) -> dict:
        return {"compiles": self.apply.compiles}


class ReplicaGroup:
    """N data-parallel CNN backend replicas, each with its own weights.

    The devices form a (data, model) grid, the reference's: one device
    group a replica along ``data`` (replicas beyond the grid wrap around,
    so one card serves any number of replicas, each on its own copy of the
    weights), and with ``shard_fc`` a ``model`` axis of ``devices //
    replicas`` devices a replica, over which the reference shards the FC
    heads' strips.  Each replica holds ``params`` and ``sparse`` on its
    device and a `CNNBackend` of its own, with its own `BatchedApply`.
    Replica 0 uses the caller's tensors wherever they already lie on its
    device and every other replica gets a copy, so N replicas hold N
    weight trees.  The caller owns the net's check (`CNNServer` runs
    `validate_net` before it makes the weights).

    ``shard_fc`` in a `torch.distributed` world of W ranks (or with a
    ``mesh``): every rank runs the same fleet on the same requests, and
    each FC head's strips are cout-sharded over a replica's ``("model",)``
    mesh (`models.graph.shard_sparse`, ``rules`` the serving rules by
    default; a ``conv`` rule on ``model`` cout-shards the convs too).
    The ranks form the reference's grid: ``model = max(1, W // replicas)``
    ranks a group, ``data = max(1, W // model)`` groups, replica i on
    group ``i % data`` (replicas beyond the grid wrap; ranks past ``data
    * model`` hold no replica).  One group (``replicas`` 1) spans the
    world (`launch.mesh.make_model_mesh`); over several
    (`_place_on_groups`) only a replica's own ranks hold its weights and
    run its waves, and the logits of each wave are broadcast from its
    group to every rank (`_GroupReplica`).  A ``mesh`` given puts every
    replica on it.  Without a world every replica has one device, and
    ``shard_fc`` only places the tree, as the reference's grid does on
    one device.
    """

    def __init__(self, net: SparseNet, params: dict, *,
                 sparse: dict | None = None, impl: str = "auto",
                 density: float | None = None, image_size: int | None = None,
                 pad_multiple: int = 8, replicas: int = 1,
                 shard_fc: bool = False,
                 device: str | torch.device | None = None,
                 mesh: Any = None, rules: Any = None):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        dev = resolve_device(device)
        self.replicas = replicas
        self.shard_fc = shard_fc
        self.rules = rules or shd.SERVE_RULES
        if mesh is None and shard_fc and dist.is_initialized():
            world = dist.get_world_size()
            model = max(1, world // replicas)
            data = max(1, world // model)
            if data > 1:
                self._place_on_groups(net, params, sparse, impl, density,
                                      image_size, pad_multiple, dev, data,
                                      model)
                return
            mesh = make_model_mesh()
        self.mesh = mesh
        if mesh is not None:
            self._place_on_mesh(net, params, sparse, impl, density,
                                image_size, pad_multiple, dev)
            return
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if dev.type == "cuda" else [dev])
        ndev = len(devices)
        model = max(1, ndev // replicas) if shard_fc else 1
        data = max(1, ndev // model)
        grid = [devices[d * model:(d + 1) * model] for d in range(data)]
        self.devices: list[torch.device] = []
        self.backends: list[CNNBackend] = []
        for i in range(replicas):
            group = grid[i % data]
            d_i = group[0]
            s_i = (None if sparse is None
                   else shard_sparse(sparse, d_i, model=len(group),
                                     copy=i > 0))
            self.devices.append(d_i)
            self.backends.append(CNNBackend(
                net, place_params(params, d_i, copy=i > 0), sparse=s_i,
                impl=impl, density=density, image_size=image_size,
                pad_multiple=pad_multiple, device=d_i))

    def _place_on_mesh(self, net: SparseNet, params: dict,
                       sparse: dict | None, impl: str,
                       density: float | None, image_size: int | None,
                       pad_multiple: int, dev: torch.device) -> None:
        """Every replica on the one mesh: this rank's device, its copy of
        the params, the sparse tree sharded under the mesh."""
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        self.devices, self.backends = [], []
        for i in range(self.replicas):
            with shd.use_mesh(self.mesh, self.rules):
                s_i = (None if sparse is None
                       else shard_sparse(sparse, dev, copy=i > 0))
            self.devices.append(dev)
            self.backends.append(CNNBackend(
                net, place_params(params, dev, copy=i > 0), sparse=s_i,
                impl=impl, density=density, image_size=image_size,
                pad_multiple=pad_multiple, device=dev, mesh=self.mesh,
                rules=self.rules))

    def _place_on_groups(self, net: SparseNet, params: dict,
                         sparse: dict | None, impl: str,
                         density: float | None, image_size: int | None,
                         pad_multiple: int, dev: torch.device, data: int,
                         model: int) -> None:
        """The fleet over ``data`` groups of ``model`` ranks (the
        reference's grid, ``serve.py:555``): this rank's group is a
        ``("model",)`` slice of a ``("data", "model")`` `DeviceMesh` over
        the first ``data * model`` ranks (``self.mesh``; None on a rank
        past them), replica i lives on group ``i % data``.  On the ranks
        of its group a replica holds the weights, the sparse tree sharded
        over the group; everywhere else it holds none (`_GroupReplica`)."""
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        rank = dist.get_rank()
        grid = DeviceMesh(dev.type,
                          torch.arange(data * model).reshape(data, model),
                          mesh_dim_names=("data", "model"))
        mine = rank // model if rank < data * model else None
        self.mesh = None if mine is None else grid["model"]
        width = _logits_width(net)
        self.devices, self.backends = [], []
        for i in range(self.replicas):
            g = i % data
            kw = dict(src=g * model, width=width, impl=impl,
                      density=density, image_size=image_size,
                      pad_multiple=pad_multiple, device=dev)
            if g == mine:
                with shd.use_mesh(self.mesh, self.rules):
                    s_i = (None if sparse is None
                           else shard_sparse(sparse, dev, copy=i > 0))
                be = _GroupReplica(net, place_params(params, dev,
                                                     copy=i > 0),
                                   sparse=s_i, mesh=self.mesh,
                                   rules=self.rules, **kw)
            else:
                be = _GroupReplica(net, None, **kw)
            self.devices.append(dev)
            self.backends.append(be)


def _logits_width(net: SparseNet) -> int:
    """The width of a classifier net's output (its last layer, an FC)."""
    last = net.layers[-1]
    if not isinstance(last, FC):
        raise ValueError(f"{net.name}: a fleet over rank groups serves a "
                         f"net whose last layer is an FC head")
    return last.dout


class _GroupReplica(CNNBackend):
    """One replica of a fleet laid over several rank groups
    (`ReplicaGroup._place_on_groups`), as one rank sees it.

    On the ranks of the replica's group (``params`` given) it is the
    `CNNBackend` over the group's ``("model",)`` mesh; elsewhere it holds
    no weights and runs nothing (``params`` None).  ``collect`` sends the
    wave's logits (N, ``width``) f32 from the group's first rank ``src``
    to every rank of the world (one broadcast a wave), so every rank's
    scheduler sees the same emissions and makes the same decisions.  A
    collect that the scheduler skips (a fault) is skipped on every rank
    alike, so each rank enters the same broadcasts in the same order.
    The group's ranks send a copy of the logits, not the graph's static
    buffer that the next wave rewrites."""

    def __init__(self, net: SparseNet, params: dict | None, *, src: int,
                 width: int, sparse: dict | None = None, impl: str = "auto",
                 density: float | None = None, image_size: int | None = None,
                 pad_multiple: int = 8,
                 device: str | torch.device | None = None,
                 mesh: Any = None, rules: Any = None):
        self.src, self.width, self.shapes = src, width, set()
        if params is not None:
            super().__init__(net, params, sparse=sparse, impl=impl,
                             density=density, image_size=image_size,
                             pad_multiple=pad_multiple, device=device,
                             mesh=mesh, rules=rules)
            return
        self.device = resolve_device(device)
        self.image_size = image_size
        self.pad_multiple = pad_multiple
        self.channels = next((l.cin for l in net.conv_layers()), None)
        self.mesh = self.rules = self.apply = None

    def dispatch(self, state: dict, slots: list
                 ) -> tuple[list[int], tuple]:
        occ, shape = self._wave(state, slots)
        self.shapes.add(shape)
        y = None if self.apply is None else \
            super().dispatch(state, slots)[1]
        return occ, (shape[0], y)

    def collect(self, state: dict, handle: tuple, slots: list
                ) -> tuple[dict, list]:
        occ, (nb, y) = handle
        out = (y.clone() if y is not None else
               torch.empty((nb, self.width), dtype=torch.float32,
                           device=self.device))
        dist.broadcast(out, src=self.src)
        return super().collect(state, (occ, out), slots)

    def finish(self, state: dict) -> dict:
        """The shape buckets this replica served (the same count on every
        rank)."""
        return {"compiles": len(self.shapes)}


def validate_net(net: SparseNet, image_size: int, *,
                 density: float | None = None, vk: int = 32,
                 vn: int = 128) -> None:
    """vscheck's IR gate before any weights are made or placed: walk the
    net's shapes and tile geometry at the serving input size and refuse
    (`analysis.VSCheckError`) on structural errors, which would otherwise
    fail mid-forward after the weights are on the card."""
    from repro_torch.analysis.ir import check_net
    cin = next((l.cin for l in net.conv_layers()), 3)
    nc = check_net(net, (1, image_size, image_size, cin),
                   density=density if density is not None else 0.25,
                   vk=vk, vn=vn)
    nc.report.raise_errors()


class CNNServer:
    """Batched CNN serving: `net_apply` behind the lockstep scheduler or
    the replica fleet.

    ``cfg`` is a config from `repro_torch.configs`: ``cfg.build()`` gives the
    `SparseNet`, ``cfg.weight_density`` the default pruning point.  With
    ``validate`` (the default) the net passes vscheck's IR gate
    (`validate_net`) before any weights are made.  Params are initialized
    from ``seed`` and sparsified; ``sparse=False`` serves the dense path.
    ``dtype="int8"`` serves the compound sparsity x precision path:
    per-cout power-of-two weight scales fixed at sparsify time,
    activations quantized per tensor as each layer runs.

    ``replicas > 1``, ``shard_fc``, a ``fault_plan`` or ``deadline_waves``
    serve a `ReplicaGroup` behind the `FleetScheduler` (a ``fault_plan``
    wraps each replica in a `ChaosBackend`); otherwise one `CNNBackend`
    runs behind the `LockstepScheduler`.  ``shard_fc`` in a
    `torch.distributed` world (or with a ``mesh``) cout-shards the FC
    heads over each replica's group of ranks (`ReplicaGroup`), and the
    convs too where ``rules`` map ``conv`` to ``model``; every rank must
    then serve the same requests.
    """

    def __init__(self, cfg: Any, *, batch: int, impl: str = "auto",
                 density: float | None = None, sparse: bool = True,
                 dtype: str | None = None,
                 seed: int = 0, pad_multiple: int = 8, replicas: int = 1,
                 shard_fc: bool = False, validate: bool = True,
                 fault_plan: FaultPlan | None = None,
                 max_queue: int | None = None,
                 deadline_waves: int | None = None, max_attempts: int = 3,
                 device: str | torch.device | None = None,
                 mesh: Any = None, rules: Any = None):
        self.cfg = cfg
        self.replicas = replicas
        self.fault_plan = fault_plan
        self.device = resolve_device(device)
        self.net = cfg.build()
        self.density = cfg.weight_density if density is None else density
        if validate:
            validate_net(self.net, cfg.image_size, density=self.density,
                         vk=cfg.vk, vn=cfg.vn)
        self.params = init_params(self.net.schema(), seed,
                                  device=self.device)
        self.sparse = None
        if sparse:
            self.sparse, _ = self.net.sparsify(
                self.params, self.density, vk=cfg.vk, vn=cfg.vn, dtype=dtype)
        image_size = cfg.image_size if cfg.fixed_image_size else None
        fleet = (replicas > 1 or shard_fc or fault_plan is not None
                 or deadline_waves is not None)
        if not fleet:
            self.backend = CNNBackend(
                self.net, self.params, sparse=self.sparse, impl=impl,
                density=self.density if sparse else None,
                image_size=image_size, pad_multiple=pad_multiple,
                device=self.device)
            self.backends: list = [self.backend]
            self.scheduler: Any = LockstepScheduler(
                self.backend, batch=batch, max_queue=max_queue)
        else:
            self.group = ReplicaGroup(
                self.net, self.params, sparse=self.sparse, impl=impl,
                density=self.density if sparse else None,
                image_size=image_size, pad_multiple=pad_multiple,
                replicas=replicas, shard_fc=shard_fc, device=self.device,
                mesh=mesh, rules=rules)
            self.backends = list(self.group.backends)
            if fault_plan is not None:
                self.backends = [ChaosBackend(b, fault_plan, replica=i)
                                 for i, b in enumerate(self.backends)]
            self.backend = self.backends[0]
            self.scheduler = FleetScheduler(
                self.backends, batch=batch, max_queue=max_queue,
                deadline_waves=deadline_waves, max_attempts=max_attempts)

    @property
    def outcomes(self) -> dict:
        """Per-request terminal outcomes of the last `serve` call."""
        return self.scheduler.outcomes

    def serve(self, requests: list[ImageRequest]) -> list[dict]:
        stats = self.scheduler.serve(list(requests))
        for s in stats:
            s["images"] = s.pop("emissions")
            s["images_per_s"] = s["images"] / max(s["run_s"], 1e-9)
        return stats


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def random_prompt_lengths(rng: np.random.Generator, n: int, max_len: int,
                          lo: int = 8) -> list[int]:
    """n prompt lengths in [lo', max_len), with lo' clamped so that the
    range is never empty (``--prompt-len 8`` gives lengths in [7, 8))."""
    if max_len < 2:
        raise ValueError(f"--prompt-len must be >= 2, got {max_len}")
    lo = max(1, min(lo, max_len - 1))
    return [int(rng.integers(lo, max_len)) for _ in range(n)]


def _fmt(stats: dict) -> dict:
    return {k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in stats.items()}


def main(argv: list[str] | None = None) -> None:
    """Serve seeded requests on a reduced config and print a summary."""
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--arch", default=None, help="LM arch to serve")
    ap.add_argument("--cnn", default=None,
                    help="CNN arch to serve (e.g. vscnn-resnet50) instead "
                         "of an LM")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--impl", default="auto",
                    choices=["auto", "plain", "pallas", "pallas-halo",
                             "pallas-stack"],
                    help="CNN sparse path: auto = the CUDA kernels (halo "
                         "layout) on the card, the plain path on the CPU")
    ap.add_argument("--replicas", type=int, default=1,
                    help="CNN data-parallel replica fleet size")
    ap.add_argument("--shard-fc", action="store_true",
                    help="cout-shard FC heads over each replica's model-"
                         "axis devices")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="LM sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="LM top-k truncation (0 = full vocab)")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="CNN fleet: inject a seeded FaultPlan "
                         "(deterministic chaos; forces the fleet path)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded admission depth (load shedding)")
    ap.add_argument("--deadline-waves", type=int, default=None,
                    help="CNN fleet: per-request deadline in fleet ticks")
    ap.add_argument("--device", default="cuda",
                    help="where to serve (cuda, or cpu for the plain path)")
    ap.add_argument("--dist-store", default=None,
                    help="join a torch.distributed world (RANK, WORLD_SIZE "
                         "from the environment) through this file:// store "
                         "path; every rank serves the same requests and "
                         "rank 0 prints")
    ap.add_argument("--mesh", default=None,
                    help="LM: serve under a DATAxMODEL mesh over the world "
                         "(needs --dist-store)")
    args = ap.parse_args(argv)
    if (args.arch is None) == (args.cnn is None):
        ap.error("choose exactly one of --arch (LM) or --cnn")
    if args.mesh and not args.dist_store:
        ap.error("--mesh needs --dist-store")
    if args.dist_store:
        init_process_group(args.dist_store, device=args.device)
        atexit.register(dist.destroy_process_group)
    # every rank serves; rank 0 reports
    say = print if not dist.is_initialized() or dist.get_rank() == 0 \
        else (lambda *a, **k: None)

    rng = np.random.default_rng(0)
    if args.cnn:
        cfg = get_config(args.cnn).reduce()
        if getattr(cfg, "modality", "lm") != "cnn":
            ap.error(f"{cfg.name} is an LM arch; serve it with --arch")
        s = cfg.image_size
        reqs = [ImageRequest(
                    rid=i,
                    image=rng.standard_normal((s, s, 3)).astype(np.float32))
                for i in range(args.requests)]
        plan = (None if args.chaos_seed is None else FaultPlan.random(
            args.chaos_seed, replicas=max(args.replicas, 1)))
        srv = CNNServer(cfg, batch=args.batch, impl=args.impl,
                        replicas=args.replicas, shard_fc=args.shard_fc,
                        fault_plan=plan, max_queue=args.max_queue,
                        deadline_waves=args.deadline_waves,
                        device=args.device)
        t0 = time.time()
        stats = srv.serve(reqs)
        wall = time.time() - t0
        tot = sum(st["images"] for st in stats)
        say(f"served {tot} images in {len(stats)} lockstep runs, "
              f"{tot / max(wall, 1e-9):.1f} img/s "
              f"(density {srv.density}, batch {args.batch}, "
              f"replicas {args.replicas}"
              f"{', shard-fc' if args.shard_fc else ''}"
              f"{f', chaos seed {args.chaos_seed}' if plan else ''})")
        outcomes = list(srv.outcomes.values())
        refused = [o for o in outcomes if o.status == "refused"]
        if plan is not None or refused:
            say(f"  outcomes: {len(outcomes) - len(refused)} delivered, "
                  f"{len(refused)} refused "
                  f"{sorted({o.reason for o in refused})}")
            if plan is not None:
                sch = srv.scheduler
                say(f"  plan: {plan.describe()}")
                say(f"  health: {sch.health}  "
                      f"faults fired: {len(sch.fault_events)}")
        for st in stats:
            say("  ", _fmt(st))
        return

    cfg = get_config(args.arch).reduce()
    if getattr(cfg, "modality", "lm") != "lm":
        ap.error(f"{cfg.name} is a CNN arch; serve it with --cnn")
    lens = random_prompt_lengths(rng, args.requests, args.prompt_len)
    reqs = [
        Request(rid=i,
                prompt=rng.integers(0, cfg.vocab, lens[i], dtype=np.int32),
                max_new=args.tokens, temperature=args.temperature,
                top_k=args.top_k)
        for i in range(args.requests)
    ]
    mesh = None
    if args.mesh:
        data, model = (int(v) for v in args.mesh.lower().split("x"))
        mesh = make_local_mesh(data, model)
    srv = Server(cfg, batch=args.batch,
                 capacity=_round_up(args.prompt_len, 16) + args.tokens + 8,
                 eos_id=args.eos_id, device=args.device, mesh=mesh)
    stats = srv.serve(reqs)
    tot_new = sum(s["new_tokens"] for s in stats)
    tot_dec = sum(s["decode_s"] for s in stats)
    say(f"served {len(reqs)} requests in {len(stats)} lockstep runs: "
          f"{tot_new} tokens, {tot_new / max(tot_dec, 1e-9):.1f} tok/s "
          f"decode")
    for s in stats:
        say("  ", _fmt(s))


if __name__ == "__main__":
    main()
