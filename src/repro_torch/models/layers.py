"""Param schema leaves, deterministic initialization, and the LM's layers.

A model's schema is a nested dict (or list) whose leaves are `P` entries
(shape, logical axes, init law); `init_params` turns it into the same
nesting of tensors.  The laws are the reference's `_leaf_init`: ``normal``
draws N(0, 1) scaled by fan_in^-1/2, ``embed`` by shape[-1]^-1/2,
``zeros`` / ``ones`` are constant, ``a_log`` is Mamba's A init (each row
log(1..N), so A_n = -(n + 1)), ``vs_idx`` the vector-sparse FFN's K-tile
ids (S of the fan_in = KB tiles, evenly spaced and sorted, the same in
every strip: the reference's, value for value).  Each leaf draws from
its own generator, seeded from the run's seed and a CRC of the leaf's
path, so no leaf's draw depends on another's.  That is a CPU `torch.Generator`, so the
weights do not depend on the device, unless the caller asks to draw on
the device (``draw_on_device``, the LM `Server`: a 14 B-parameter tree
drawn on the host would take minutes): a CUDA generator with the same
seed then draws on the card, and the card's weights differ from the
CPU's for the same seed.  A leaf with a leading
``stack`` axis (`stack`) draws each slice of that axis from its own
generator (seed, path, index), so host memory holds one layer's slice at
a time, not the whole stack.  (The numbers differ from the JAX package's;
tests that need both sides equal hand the same numpy weights to both.)

The layers are the reference's `rms_norm`, `rope`, `dense`, `mlp_schema`
and `mlp_apply`, with its precision: norms, rotary angles and activations
in f32, matmuls accumulated in f32 and returned in the input's dtype.
`matmul_f32` and `dense_f32` keep a product's f32 sum as it is, for the
reference's products that stay in f32 (``preferred_element_type=f32``
without a cast back); on the card under autograd `matmul_f32` has a
derivative of its own (`_MatmulF32`), since PyTorch has none for a
product with an ``out_dtype``.

Matmul output precision (the reference's ``bf16_flow`` knob): by default
the activation products named by `matmul_out_dtype` emit f32 (f32-out);
inside ``precision_flow(True)`` (the model entries open it from
``cfg.bf16_flow``) they emit the input's dtype, still summed in f32 by
the library, rounded once.  `matmul_out` and `dense_out` are those
products.  Where the reference casts the f32 product straight back
(`dense`, here and at its other sites) both settings give the same
function; the port then computes in the input dtype either way.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import zlib
from typing import Any, Iterator

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.device import card_path, resolve_device
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import logical
from repro_torch.utils.cost import scan

__all__ = ["P", "init_params", "axes_tree", "stack", "rms_norm", "dense", "dense_f32",
           "dense_out", "matmul_f32", "matmul_out", "matmul_out_dtype",
           "precision_flow", "rope", "mlp_schema", "mlp_apply",
           "chunked_remat_scan", "scan_chunk_size"]

_MATMUL_OUT_F32 = contextvars.ContextVar("matmul_out_f32", default=True)


def matmul_out_dtype() -> torch.dtype | None:
    """The output dtype of the activation products: f32, or None (the
    input's dtype) inside ``precision_flow(True)``."""
    return torch.float32 if _MATMUL_OUT_F32.get() else None


@contextlib.contextmanager
def precision_flow(bf16_flow: bool) -> Iterator[None]:
    """Within the block, `matmul_out_dtype` is None if ``bf16_flow``, else
    f32."""
    tok = _MATMUL_OUT_F32.set(not bf16_flow)
    try:
        yield
    finally:
        _MATMUL_OUT_F32.reset(tok)


@dataclasses.dataclass(frozen=True)
class P:
    """Schema leaf: one parameter array."""

    shape: tuple
    axes: tuple  # logical axis name (or None) per dim
    init: str = "normal"  # 'normal' | 'embed' | 'zeros' | 'ones' |
                          # 'a_log' | 'vs_idx'
    fan_in: int | None = None  # scaled normal: std = 1/sqrt(fan_in);
                               # vs_idx: the K-tiles KB
    dtype: Any = None  # None -> the init_params default

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


_DRAW_CHUNK = 1 << 26


def _draw(p: P, shape: tuple, key: str, dtype: torch.dtype,
          device: torch.device | None = None) -> torch.Tensor:
    """One tensor of law ``p.init`` and ``shape``, drawn on ``device``
    (the CPU by default)."""
    dev = torch.device("cpu") if device is None else device
    if p.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=dev)
    if p.init == "ones":
        return torch.ones(shape, dtype=dtype, device=dev)
    if p.init == "a_log":  # Mamba A init: A_n = -(n+1), stored as log
        row = torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                                     device=dev))
        return row.expand(shape).to(dtype).contiguous()
    if p.init == "vs_idx":  # VectorSparse indices: S evenly-spaced K-tiles
        kb, s = p.fan_in, shape[-1]
        stride = max(1, kb // s)
        row = torch.sort((torch.arange(s, dtype=torch.int64, device=dev)
                          * stride) % kb).values
        return row.to(dtype).expand(shape).contiguous()
    if p.init == "embed":
        std = p.shape[-1] ** -0.5
    elif p.init == "normal":
        fan_in = p.fan_in or (p.shape[0] if p.shape else 1)
        std = fan_in ** -0.5
    else:
        raise ValueError(f"unknown init law {p.init!r}")
    # the generator keeps 32 bits of its seed: hash seed and path into 32
    gen = torch.Generator(device=dev).manual_seed(zlib.crc32(key.encode()))
    if dev.type == "cpu":
        return (std * torch.randn(shape, generator=gen,
                                  dtype=torch.float32)).to(dtype)
    # on the card, f32 draws of at most _DRAW_CHUNK values at a time, in
    # order, into the output (a Kimi-K2 expert slice is 11 G values)
    out = torch.empty(shape, dtype=dtype, device=dev)
    flat = out.view(-1)
    for a in range(0, flat.numel(), _DRAW_CHUNK):
        n = min(_DRAW_CHUNK, flat.numel() - a)
        flat[a:a + n] = std * torch.randn(n, generator=gen,
                                          dtype=torch.float32, device=dev)
    return out


def _leaf_init(p: P, seed: int, path: str, default_dtype: torch.dtype,
               device: torch.device, on_device: bool) -> torch.Tensor:
    dtype = p.dtype or default_dtype
    key = f"{seed}:{path}"
    at = device if on_device and device.type == "cuda" else None
    if not p.axes or p.axes[0] != "stack":
        return _draw(p, p.shape, key, dtype, at).to(device)
    out = torch.empty(p.shape, dtype=dtype, device=device)
    for i in range(p.shape[0]):
        out[i] = _draw(p, p.shape[1:], f"{key}:{i}", dtype, at)
    return out


def init_params(schema: Any, seed: int = 0, *,
                dtype: torch.dtype = torch.float32,
                device: str | torch.device | None = None,
                draw_on_device: bool = False) -> Any:
    """Deterministic init of a schema on ``device`` (CUDA by default).
    With ``draw_on_device`` a CUDA device draws its own numbers (the LM
    servers: billions of values); otherwise every value is the CPU law's,
    whatever the device."""
    dev = resolve_device(device)

    def walk(node: Any, path: str) -> Any:
        if isinstance(node, P):
            return _leaf_init(node, seed, path, dtype, dev, draw_on_device)
        if isinstance(node, list):
            return [walk(v, f"{path}[{i}]") for i, v in enumerate(node)]
        return {k: walk(v, f"{path}[{k!r}]") for k, v in node.items()}

    return walk(schema, "")


def axes_tree(schema: Any) -> Any:
    """Schema -> the same nesting of logical-axes tuples (leaves are
    tuples)."""
    if isinstance(schema, P):
        return schema.axes
    if isinstance(schema, list):
        return [axes_tree(v) for v in schema]
    return {k: axes_tree(v) for k, v in schema.items()}


def stack(schema: Any, n: int) -> Any:
    """Prepend a layer-group dim of size n (axis ``stack``) to every leaf."""
    if isinstance(schema, P):
        return P((n, *schema.shape), ("stack", *schema.axes), schema.init,
                 schema.fan_in, schema.dtype)
    return {k: stack(v, n) for k, v in schema.items()}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last dim.  A DTensor whose last dim is whole on
    every rank (the residual stream under a mesh) is normed shard by
    shard: one local op chain, not one DTensor dispatch per op, with the
    gradients of `sharding.shard_of` and `sharding.wrap` (the scale's
    summed over every rank's rows)."""
    if isinstance(x, DTensor) and all(
            p.is_replicate() or (isinstance(p, Shard)
                                 and p.dim not in (-1, x.ndim - 1))
            for p in x.placements):
        if isinstance(scale, DTensor):
            scale = shd.shard_of(scale.redistribute(
                scale.device_mesh, (Replicate(),) * len(scale.placements)))
        if x.dtype != torch.float32:
            return shd.wrap(rms_norm(shd.shard_of(x), scale, eps=eps),
                            x.device_mesh, x.placements, x.shape)
        # in f32 ``x.float()`` is x itself: the mesh-free norm's two uses
        # of x sum into x's own gradient after the residual's, the square
        # last.  Two shard views, the product's made after the square's,
        # sum in that order (a one-rank mesh gives the mesh-free bits).
        var = torch.mean(torch.square(shd.shard_of(x)), dim=-1,
                         keepdim=True)
        y = shd.shard_of(x) * torch.rsqrt(var + eps)
        return shd.wrap(y * (1.0 + scale.float()), x.device_mesh,
                        x.placements, x.shape)
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, ...out), accumulated in f32, in x.dtype.

    A bf16 product accumulates in f32 and rounds its output once, as the
    reference's ``preferred_element_type=f32`` then ``astype`` does, and
    as its bf16-flow product (``preferred_element_type=None``) does: the
    same function in both settings (reference ``layers.py:160``).
    """
    return torch.tensordot(x, w, dims=([x.ndim - 1], [0])).to(x.dtype)


def matmul_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., K) @ b (K, N) (or batched (E, M, K) @ (E, K, N)) in
    `matmul_out_dtype`: `matmul_f32`, or inside ``precision_flow(True)``
    the product in the input dtype (summed in f32, rounded once)."""
    if matmul_out_dtype() is not None:
        return matmul_f32(a, b)
    return torch.matmul(a, b)


def dense_out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`dense_f32`, or inside ``precision_flow(True)`` the product in x's
    dtype: x (..., K) @ w (K, ...out) in `matmul_out_dtype`."""
    out = w.shape[1:]
    y = matmul_out(x, w.reshape(w.shape[0], -1))
    return y.reshape(*x.shape[:-1], *out)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One ``mm`` / ``bmm`` of two low-precision operands, f32 out."""
    if b.ndim == 3:
        return torch.bmm(a, b, out_dtype=torch.float32)
    y = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
    return y.reshape(*a.shape[:-1], b.shape[-1])


class _MatmulF32(torch.autograd.Function):
    """`matmul_f32` on the card's low-precision operands, with a
    derivative: PyTorch registers none for ``mm`` / ``bmm`` with an
    ``out_dtype``.  The f32 output's gradient g is taken against each
    operand taken to f32 (a bf16 value is exact in f32), summed in f32
    and rounded once to the operand's dtype, as the reference's
    derivative of a product with ``preferred_element_type=f32`` rounds
    it.  The f32 copy of an operand lives only for its product."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.matmul(g, b.float().transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            if b.ndim == 3:
                db = torch.bmm(a.float().transpose(1, 2), g)
            else:
                db = torch.mm(a.reshape(-1, a.shape[-1]).float().T,
                              g.reshape(-1, g.shape[-1]))
            db = db.to(b.dtype)
        return da, db


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., K) @ b (K, N), or a batched (E, M, K) @ (E, K, N), summed
    in f32 and returned in f32.  On the card bf16 or f16 operands go into
    one ``mm`` / ``bmm`` with an f32 output (``out_dtype``), so no f32
    copy of the weight is made (under autograd through `_MatmulF32`,
    whose backward sums in f32), and so on meta (`core.device.card_path`);
    on the CPU both are taken to f32, the same function."""
    if card_path(a) and a.dtype == b.dtype != torch.float32:
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return _MatmulF32.apply(a, b)
        return _mm_f32(a, b)
    return torch.matmul(a.float(), b.float())


def dense_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, ...out) -> (..., *out) in f32: `dense` without
    the cast back."""
    out = w.shape[1:]
    y = matmul_f32(x, w.reshape(w.shape[0], -1))
    return y.reshape(*x.shape[:-1], *out)


def rope(x: torch.Tensor, positions: torch.Tensor, *,
         theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding. x (B, T, H, hd), positions (B, T) or (T,)."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(theta, exps)  # f32: the scalar base is cast to f32
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freq  # (B, T, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- gated / plain MLP -------------------------------------------------------

_GATED = {"swiglu", "geglu"}


def mlp_schema(d_model: int, d_ff: int, activation: str) -> dict:
    if activation in _GATED:
        wi = P((2, d_model, d_ff), (None, "fsdp", "ff"), fan_in=d_model)
    else:
        wi = P((d_model, d_ff), ("fsdp", "ff"), fan_in=d_model)
    return {
        "wi": wi,
        "wo": P((d_ff, d_model), ("ff", "fsdp"), fan_in=d_ff),
    }


def _act(h: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "relu2":  # nemotron squared-ReLU
        r = torch.relu(h)
        return r * r
    if kind == "gelu":
        return F.gelu(h, approximate="tanh")
    if kind == "relu":
        return torch.relu(h)
    raise ValueError(kind)


def mlp_apply(params: dict, x: torch.Tensor, *,
              activation: str) -> torch.Tensor:
    if shd.current() is not None:
        return _mlp_mesh(params, x, activation=activation)
    if activation in _GATED:
        gate = logical(dense(x, params["wi"][0]), ("batch", "seq", "ff"))
        up = logical(dense(x, params["wi"][1]), ("batch", "seq", "ff"))
        act = F.silu if activation == "swiglu" else (
            lambda g: F.gelu(g, approximate="tanh"))
        h = act(gate.float()).to(x.dtype) * up
    else:
        h = logical(dense(x, params["wi"]), ("batch", "seq", "ff"))
        h = _act(h.float(), activation).to(x.dtype)
    return logical(dense(h, params["wo"]), ("batch", "seq", "embed"))


def _mlp_mesh(params: dict, x: torch.Tensor, *,
              activation: str) -> torch.Tensor:
    """The MLP on each rank's shards (Megatron's TP): its batch rows of x,
    its F columns of ``wi`` and rows of ``wo`` (``fsdp`` gathered); the
    down product's share summed over the mesh dims that split F, in f32
    then rounded, as the reference's partitioned product sums (at one
    rank along them, the mesh-free products, op for op)."""
    b, t, d = x.shape
    gated = activation in _GATED
    wi_axes = (None, None, "ff") if gated else (None, "ff")
    ctx = shd.current()
    f_entry = shd.spec_for(wi_axes, mesh=ctx.mesh, rules=ctx.rules,
                           shape=tuple(params["wi"].shape))[-1]
    lp = {"wi": shd.local(params["wi"], wi_axes),
          "wo": shd.local(params["wo"], ("ff", None))}
    xl = shd.local(x, ("batch", None, None))
    with shd.use_mesh_free():
        if shd.axis_size(f_entry, ctx=ctx) == 1:
            y = mlp_apply(lp, xl, activation=activation)
        else:
            if gated:
                gate, up = dense(xl, lp["wi"][0]), dense(xl, lp["wi"][1])
                act = F.silu if activation == "swiglu" else (
                    lambda g: F.gelu(g, approximate="tanh"))
                h = act(gate.float()).to(x.dtype) * up
            else:
                h = _act(dense(xl, lp["wi"]).float(), activation).to(x.dtype)
            y = shd.all_reduce(dense_f32(h, lp["wo"]), f_entry,
                               ctx=ctx).to(x.dtype)
    return logical(shd.from_local(y, ("batch", None, None), (b, t, d)),
                   ("batch", "seq", "embed"))


# -- chunked remat scan (Mamba / RWKV recurrences) ---------------------------


def scan_chunk_size(t: int, chunk: int) -> int:
    """The largest divisor of ``t`` that is at most ``chunk`` (the
    reference's: every chunk carries the state exactly)."""
    c = max(1, min(chunk, t))
    while t % c:
        c -= 1
    return c


def chunked_remat_scan(step, carry: torch.Tensor, t: int,
                       xs: tuple, shared: tuple = (), *, chunk: int,
                       loop=scan) -> tuple[torch.Tensor, torch.Tensor]:
    """``carry, y_i = step(carry, (x[:, i] for x in xs), shared)`` for i
    in [0, t), with per-chunk rematerialization: (the last carry, the
    outputs stacked on dim 1).  ``xs`` hold time on dim 1; ``shared``
    are the tensors every trip reads whole (RWKV's bonus u, Mamba's A).

    The reference's `chunked_remat_scan` (``layers.py:231``).  ``t``
    splits into chunks of `scan_chunk_size` (``t``, ``chunk``) steps.
    When a gradient flows, the loop is one autograd Function
    (`_ChunkedScan`), as the reference rematerializes every chunk, one
    or many: its forward runs every trip without a graph
    and saves the chunks' first carries and its inputs; its backward
    recomputes one chunk at a time, last first, and takes that chunk's
    gradients.  Its saved tensors are ordinary ones, so under the layer
    group's remat (`transformer.forward_hidden`) the forward keeps none
    of them and the group's recompute makes them again: a training step
    holds T / chunk carries, the inputs and one chunk's trips of one
    layer at a time, as the reference's nested remat does.
    Without a gradient (prefill, decode) it is the plain loop.  The
    values, and the gradients bit for bit, do not depend on the chunk:
    each trip's backward runs the same ops on the same inputs, a
    time-indexed input gets each position's gradient from one trip, and
    a shared tensor's gradient is summed trip by trip, last first,
    across chunks as within one (`_ChunkedScan.backward`).

    ``loop`` runs each loop (`utils.cost.scan`: every trip on the card,
    on meta a few trips standing for all of them), so the dry run counts
    ``t`` trips and the chunked form's peak."""
    c = scan_chunk_size(t, chunk)
    grad = torch.is_grad_enabled() and any(
        a.requires_grad for a in (*xs, *shared, carry))
    if not grad:
        return _chunk(step, loop, carry, xs, shared, 0, t)
    return _ChunkedScan.apply(step, loop, c, len(xs), carry, *xs, *shared)


def _chunk(step, loop, carry: torch.Tensor, xs: tuple, shared: tuple,
           t0: int, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Trips [t0, t0 + n) of the loop: (the carry after, their outputs
    stacked on dim 1)."""
    carry, ys = loop(
        lambda s, i: step(s, tuple(x[:, t0 + i] for x in xs), shared),
        carry, n, xs[0])
    return carry, torch.stack(ys, dim=1)


class _ChunkedScan(torch.autograd.Function):
    """`chunked_remat_scan`'s loop under a gradient, ``c`` trips a
    chunk."""

    @staticmethod
    def forward(ctx, step, loop, c: int, n_x: int, carry: torch.Tensor,
                *tensors: torch.Tensor):
        xs, shared = tensors[:n_x], tensors[n_x:]
        firsts, ys = [], []
        for t0 in range(0, xs[0].shape[1], c):
            firsts.append(carry)
            carry, y = _chunk(step, loop, carry, xs, shared, t0, c)
            ys.append(y)
        ctx.step, ctx.loop, ctx.c, ctx.n_x = step, loop, c, n_x
        ctx.n_chunks = len(firsts)
        ctx.save_for_backward(*firsts, *tensors)
        return carry, torch.cat(ys, dim=1)

    @staticmethod
    def backward(ctx, g_carry: torch.Tensor | None,
                 g_ys: torch.Tensor | None):
        saved = ctx.saved_tensors
        firsts, tensors = saved[:ctx.n_chunks], saved[ctx.n_chunks:]
        xs, shared = tensors[:ctx.n_x], tensors[ctx.n_x:]
        c = ctx.c
        # contiguous, as the plain loop's select backward makes them:
        # the layers before take the gradient in that layout
        g_xs = [x.new_zeros(x.shape) if ctx.needs_input_grad[5 + i] else None
                for i, x in enumerate(xs)]
        g_shared: list = [None] * len(shared)
        for j in reversed(range(ctx.n_chunks)):
            t0 = j * c
            with torch.enable_grad():
                c_in = firsts[j].detach().requires_grad_(
                    j > 0 or ctx.needs_input_grad[4])
                x_in = [x[:, t0:t0 + c].detach().requires_grad_(g is not None)
                        for x, g in zip(xs, g_xs)]
                sh_in = [a.detach().requires_grad_(ctx.needs_input_grad[
                    5 + ctx.n_x + k]) for k, a in enumerate(shared)]
                c_out, y = _chunk(ctx.step, ctx.loop, c_in, tuple(x_in),
                                  tuple(sh_in), 0, c)
                outs, g_outs = [], []
                for o, g in ((c_out, g_carry), (y, None if g_ys is None
                                                else g_ys[:, t0:t0 + c])):
                    if g is not None:
                        outs.append(o)
                        g_outs.append(g)
                # a shared tensor's gradient so far enters its sum first
                # (this view's backward runs before any trip's), so the
                # sum goes on trip by trip, as in the plain loop
                for a, g in zip(sh_in, g_shared):
                    if g is not None:
                        outs.append(a.view_as(a))
                        g_outs.append(g)
            wrt = [a for a in (c_in, *x_in, *sh_in) if a.requires_grad]
            grads = iter(torch.autograd.grad(outs, wrt, g_outs,
                                             allow_unused=True))
            g_carry = next(grads) if c_in.requires_grad else None
            for i, a in enumerate(x_in):
                if a.requires_grad:
                    g = next(grads)
                    if g is not None:
                        g_xs[i][:, t0:t0 + c].copy_(g)
            for k, a in enumerate(sh_in):
                if a.requires_grad:
                    g = next(grads)
                    g_shared[k] = g if g is not None else g_shared[k]
        return (None, None, None, None, g_carry, *g_xs, *g_shared)
