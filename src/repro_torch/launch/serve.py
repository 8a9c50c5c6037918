"""Batched serving: one lockstep scheduler, two backends.

The port of `repro/launch/serve.py` with one replica.  The LM arm:

* `LMBackend` — continuous batching over `models.transformer`'s prefill
  and decode: a sequence retires the moment it emits ``eos_id`` (or
  exhausts ``max_new``) and its slot is backfilled from the queue in the
  same run.  Admission prompts are left-padded to a ``len_bucket``
  multiple; a backfill prefill right-pads the context to the same ladder
  at the full batch width and reads its logits at the true position, and
  its cache rows are copied into the live caches in place.  Every prefill
  runs the flash kernel once per attention layer; decode steps run none.
  Requests carry per-request sampling (``temperature`` / ``top_k``);
  temperature 0 is the plain argmax, bit-identical whatever the lane's
  neighbours do.
* `Server` — seeded (or bridged) weights and an `LMBackend` behind a
  `LockstepScheduler`.

The CNN arm:

* `CNNBackend` — requests carry images, batches pad/bucket on image shape,
  every request finishes in one lockstep step, and freed slots are refilled
  from the queue so one batch shape serves wave after wave; a partial final
  wave shrinks to its occupied slots (pow2 ladder) instead of computing
  zero images.  ``step`` is split into ``dispatch`` (build the batch on the
  device and enqueue the forward — CUDA launches return before the card
  finishes) and ``collect`` (copy the logits to the host, which waits).
* `CNNServer` — builds the net from a config, makes seeded params,
  sparsifies them and serves through a `LockstepScheduler`.  It runs on
  CUDA unless ``device="cpu"``; ``impl="auto"`` takes the CUDA kernels on
  the card and the plain path on the CPU.

Both run on CUDA unless ``device="cpu"``.  The replica fleet, sharded
heads and chaos injection come in later slices.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.launch.scheduler import LockstepScheduler
from repro_torch.models.graph import BatchedApply, SparseNet, input_refusal
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import init_params

__all__ = ["Request", "ImageRequest", "LMBackend", "CNNBackend", "Server",
           "CNNServer"]


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
                   top_k: torch.Tensor,
                   gens: list[torch.Generator | None]) -> torch.Tensor:
    """Per-slot temperature/top-k sampling over (B, V) logits.

    Slots with ``temp == 0`` take the plain argmax of the raw logits, so a
    zero-temperature slot reproduces the greedy path bit-exactly even when
    its neighbours sample.  ``top_k == 0`` means no truncation.  Ranking
    uses a stable double argsort, so ``top_k=1`` keeps exactly the argmax
    candidate (first max on ties, like argmax itself).  A sampling slot
    draws Gumbel noise from its own CPU generator (``gens[i]``; None for a
    greedy slot) and takes the argmax of the noisy scaled logits.
    """
    greedy = torch.argmax(logits, dim=-1)
    order = torch.argsort(-logits, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)  # 0 = largest logit
    k = torch.where(top_k > 0, top_k, logits.shape[-1])[:, None]
    masked = torch.where(rank < k, logits, -torch.inf)
    scaled = masked / torch.clamp_min(temp, 1e-30)[:, None]
    vocab = logits.shape[-1]
    noise = torch.stack([
        torch.zeros(vocab) if g is None else
        -torch.log(-torch.log(torch.rand(vocab, generator=g)))
        for g in gens]).to(logits.device)
    sampled = torch.argmax(scaled + noise, dim=-1)
    return torch.where(temp > 0.0, sampled, greedy)


def _positional_caches(cfg: Any) -> bool:
    """True when every cached layer state is plain positional attention K/V
    (the port's configs hold only attention mixers and MLPs).

    Sliding-window attention is excluded: its K/V cache is *circular*
    (slot = pos % window), so the right-pad junk of a bucketed backfill
    would wrap onto slots holding real in-window history.  Only plain
    full-context caches (slot == position; future slots masked, then
    overwritten) survive the right-pad, and they gate the bucketed
    backfill.
    """
    return all(sp.window is None
               for seg in cfg.segments for sp in seg.layers)


def _copy_rows(dst: Any, src: Any, j: int) -> None:
    """Copy batch row ``j`` of every cache leaf of ``src`` into ``dst`` in
    place; leaves are (repeat, batch, ...)."""
    if isinstance(dst, torch.Tensor):
        dst[:, j].copy_(src[:, j])
    elif isinstance(dst, list):
        for d, s in zip(dst, src):
            _copy_rows(d, s, j)
    else:
        for k in dst:
            _copy_rows(dst[k], src[k], j)


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
    """

    def __init__(self, cfg: Any, params: dict, *, capacity: int,
                 eos_id: int | None = None, len_bucket: int = 16,
                 sample_seed: int = 0,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.params = params
        self.capacity = capacity
        self.eos_id = eos_id
        self.len_bucket = max(1, len_bucket)
        self.backfill_bucket = (self.len_bucket if _positional_caches(cfg)
                                else 1)
        self.sample_seed = sample_seed
        self.device = resolve_device(device)

    # -- per-slot sampling --------------------------------------------------

    @staticmethod
    def _greedy_lane() -> list:
        return [0.0, 0, -1, 0]           # temperature, top_k, rid, count

    def _emit_tokens(self, state: dict, logits: torch.Tensor, js
                     ) -> torch.Tensor:
        """Next token for each slot index in ``js``; ``logits[i]`` is slot
        ``js[i]``'s row.  All-greedy batches take the plain argmax;
        otherwise each sampling slot draws from a generator seeded from
        (seed, rid, emission count), so a request's stream is reproducible
        wherever its slot lands."""
        sel = [state["samp"][j] for j in js]
        if not any(s[0] > 0 for s in sel):
            return torch.argmax(logits, dim=-1)
        dev = logits.device
        temps = torch.tensor([s[0] for s in sel], dtype=torch.float32,
                             device=dev)
        topks = torch.tensor([s[1] for s in sel], dtype=torch.int64,
                             device=dev)
        gens = [torch.Generator().manual_seed(zlib.crc32(
            f"{self.sample_seed}:{s[2] & 0x7FFFFFFF}:{s[3]}".encode()))
            if s[0] > 0 else None for s in sel]
        toks = _sample_tokens(logits, temps, topks, gens)
        for s in sel:
            s[3] += 1
        return toks

    def _tokens(self, toks: np.ndarray) -> dict:
        return {"tokens": torch.from_numpy(toks).to(self.device)}

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
        logits, caches = tfm.prefill(self.params, self._tokens(toks),
                                     self.cfg, capacity=self.capacity)
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

    def step(self, state: dict, slots: list) -> tuple[dict, list]:
        logits, caches = tfm.decode_step(
            self.params, state["caches"], state["nxt"],
            state["len"] + state["i"], self.cfg)
        for j, s in enumerate(slots):
            if s is None:                # retired lane: back to greedy
                state["samp"][j] = self._greedy_lane()
        nxt = self._emit_tokens(state, logits, range(len(slots)))
        state.update(caches=caches, nxt=nxt[:, None], i=state["i"] + 1)
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
    ``device`` (CUDA by default), or taken as given (``params``, e.g. the
    reference's through `repro_torch.params.params_from_numpy`).
    """

    def __init__(self, cfg: Any, *, batch: int, capacity: int, seed: int = 0,
                 eos_id: int | None = None, len_bucket: int = 16,
                 max_queue: int | None = None,
                 device: str | torch.device | None = None,
                 params: dict | None = None):
        self.cfg = cfg
        self.batch = batch
        self.capacity = capacity
        self.device = resolve_device(device)
        self.params = params if params is not None else init_params(
            tfm.lm_schema(cfg), seed, dtype=cfg.dtype, device=self.device)
        self.backend = LMBackend(cfg, self.params, capacity=capacity,
                                 eos_id=eos_id, len_bucket=len_bucket,
                                 device=self.device)
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

    def serve(self, requests: list[Request]) -> list[dict]:
        """Bucket the queue by prompt length, then run lockstep batches with
        retirement + backfill until it drains (continuous batching)."""
        return [self._legacy_stats(s)
                for s in self.scheduler.serve(list(requests))]


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
    """

    def __init__(self, net: SparseNet, params: dict, *,
                 sparse: dict | None = None, impl: str = "auto",
                 density: float | None = None, image_size: int | None = None,
                 pad_multiple: int = 8,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.image_size = image_size
        self.pad_multiple = pad_multiple
        self.channels = next((l.cin for l in net.conv_layers()), None)
        self.apply = BatchedApply(net, params, sparse=sparse, impl=impl,
                                  key=(density,))

    # -- scheduler protocol -------------------------------------------------

    def validate_request(self, req: ImageRequest) -> str | None:
        """Admission-time validation: malformed images (wrong type, rank,
        dtype, channels, non-finite values, oversize for a fixed-input net)
        become structured refusals."""
        return input_refusal(req.image, max_size=self.image_size,
                             channels=self.channels)

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
        """Issue one wave: pad the occupied slots into a batch, copy it to
        the device and enqueue the forward.  The returned logits may still
        be in flight — `collect` waits for them."""
        hb, wb, c = state["bucket"]
        occ = [j for j, r in enumerate(slots) if r is not None]
        nb = min(state["width"], 1 << max(len(occ) - 1, 0).bit_length())
        x = np.zeros((nb, hb, wb, c), np.float32)
        for i, j in enumerate(occ):
            h, w, _ = slots[j].image.shape
            x[i, :h, :w] = slots[j].image
        return occ, self.apply(torch.from_numpy(x).to(self.device))

    def collect(self, state: dict, handle: tuple[list[int], torch.Tensor],
                slots: list) -> tuple[dict, list]:
        occ, y_dev = handle
        y = y_dev.cpu().numpy()
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


class CNNServer:
    """Batched CNN serving: `net_apply` behind the lockstep scheduler.

    ``cfg`` is a config from `repro_torch.configs`: ``cfg.build()`` gives the
    `SparseNet`, ``cfg.weight_density`` the default pruning point.  Params
    are initialized from ``seed`` and sparsified; ``sparse=False`` serves
    the dense path.  ``dtype="int8"`` serves the compound sparsity x
    precision path: per-cout power-of-two weight scales fixed at sparsify
    time, activations quantized per tensor as each layer runs.
    """

    def __init__(self, cfg: Any, *, batch: int, impl: str = "auto",
                 density: float | None = None, sparse: bool = True,
                 dtype: str | None = None,
                 seed: int = 0, pad_multiple: int = 8,
                 max_queue: int | None = None,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.net = cfg.build()
        self.density = cfg.weight_density if density is None else density
        self.params = init_params(self.net.schema(), seed,
                                  device=self.device)
        self.sparse = None
        if sparse:
            self.sparse, _ = self.net.sparsify(
                self.params, self.density, vk=cfg.vk, vn=cfg.vn, dtype=dtype)
        self.backend = CNNBackend(
            self.net, self.params, sparse=self.sparse, impl=impl,
            density=self.density if sparse else None,
            image_size=cfg.image_size if cfg.fixed_image_size else None,
            pad_multiple=pad_multiple, device=self.device)
        self.scheduler = LockstepScheduler(self.backend, batch=batch,
                                           max_queue=max_queue)

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
