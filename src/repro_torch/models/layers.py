"""Shared model layers (the ported part of ``repro.models.layers``).

Plain functions over explicit parameter dicts. Attention uses the grouped
layout throughout: q is (B, S, K, G, D) with K = n_kv_heads and G =
q_per_kv; k/v are (B, T, K, D), so GQA never repeats KV.

Numerics follow the JAX layers: RMSNorm scales by ``1 + scale`` in f32,
RoPE is split-half in f32, the plain attention takes its softmax in f32 and
casts the probabilities to ``q.dtype`` before the PV product, and the LM
head accumulates and returns f32.

Training differentiates the plain impls only. A kernel impl asked for a
gradient raises (``kops.require_no_grad``): its wrappers launch through raw
pointers, so autograd would see no edge through them and the gradient
would be silently wrong. ``"torch_chunked"`` takes long full-sequence
attention block by block with a recomputing backward
(``ChunkedAttention``), the counterpart of ``repro``'s ``_attention_chunked``.

On a mesh (``build_model(..., parallel=...)``) the tensors are DTensors.
The elementwise work between the products propagates op by op, the
counterpart of GSPMD: ``constrain_residual`` pins the residual stream
(``repro``'s ``with_sharding_constraint``). Every product runs in a local
region with stated placements (``local_region``), where DTensor's view
rules would otherwise flatten a sharded dim behind another (torch 2.11
refuses that; 2.13 takes it as a strided shard): each projection
(``project``, Megatron's column- and row-parallel products, the sequence
gathered first), attention over batch and heads (``attention_core``),
and the split-K decode with its explicit collectives (``repro``'s
``shard_map``). Outside a mesh the same code runs on plain tensors, the
same ops on the same shapes.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.parallel import get_activation_sharding
from repro_torch.kernels import ops as kops
from repro_torch.models import kvcache as KV
from repro_torch.models.quantize import QuantizedWeight, qeinsum

Params = Dict[str, Any]
NEG_INF = -1e30
# the impls that run plain PyTorch (and so have a backward)
PLAIN_IMPLS = ("torch", "torch_chunked")

# ---------------------------------------------------------------------------
# initializers (seeded by a torch.Generator on the target device)


def dense_init(gen: torch.Generator, shape, dtype, in_axis: int = -2,
               device=None) -> torch.Tensor:
    """LeCun-normal style init, fan-in along ``in_axis``."""
    fan_in = shape[in_axis]
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * (1.0 / fan_in ** 0.5)).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype, device=None) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms and rotary embeddings


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + scale.float())).to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, [K, [G,]] D) with positions (B, S) broadcast over heads."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)
    angles = positions[..., None].float() * freqs          # (B, S, d/2)
    for _ in range(x.ndim - angles.ndim):
        angles = angles[..., None, :]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# sharding: the residual constraint and the split-K decode region


def as_dtensor(t: torch.Tensor, mesh) -> DTensor:
    """``t`` as a DTensor on ``mesh``: a plain tensor (the same on every
    rank, as ``implicit_replication`` takes it) becomes a replicated one."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def activation_placements(ctx, spec):
    """DTensor placements of an activation spec on the context's mesh."""
    from repro_torch.distributed.sharding import P, to_placements
    return to_placements(ctx.mesh, P(*spec))


def on_mesh(*ts) -> bool:
    """Whether a mesh context is set and any of ``ts`` is a DTensor: the
    condition for a local region."""
    ctx = get_activation_sharding()
    return ctx is not None and ctx.mesh is not None and any(
        isinstance(t, DTensor) for t in ts)


def _grad_placements(in_pls):
    """The placements of each region input's local gradient: its own
    shard where it is sharded; partial over a mesh dim that shards another
    input (its rank saw part of the work); else replicated (every rank on
    that mesh dim did the same work). None for a non-tensor input."""
    out = []
    for j, pl in enumerate(in_pls):
        if pl is None:
            out.append(None)
            continue
        out.append([p if isinstance(p, Shard) else Partial() if any(
            o is not None and k != j and isinstance(o[i], Shard)
            for k, o in enumerate(in_pls)) else Replicate()
            for i, p in enumerate(pl)])
    return out


def local_region(fn, out_placements, in_placements, *args):
    """``fn`` on the local shards of ``args`` (a local_map region): each
    tensor argument is redistributed to its placements (a plain tensor
    counts as replicated), ``fn`` runs on the local tensors, and its
    output (a list of placements) or outputs (a tuple of lists) come back
    as DTensors. The backward takes ``_grad_placements``. ``None`` is the
    placement of a non-tensor argument."""
    mesh = get_activation_sharding().mesh
    region = local_map(fn, out_placements=out_placements,
                       in_placements=in_placements,
                       in_grad_placements=_grad_placements(in_placements),
                       device_mesh=mesh, redistribute_inputs=True)
    return region(*(as_dtensor(a, mesh) if torch.is_tensor(a) else a
                    for a in args))


def pointwise(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for an elementwise ``fn``; on a mesh a local region that
    keeps x's placements (a partial x summed first), for an op whose
    backward DTensor has no rule for (``logsigmoid``)."""
    if not on_mesh(x):
        return fn(x)
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    return local_region(fn, pl, (pl,), x)


def gather_seq(x: torch.Tensor) -> torch.Tensor:
    """x (B, S, ...) with its sequence whole: where ``constrain_residual``
    put S on the model axis, gather it (sequence parallelism's all-gather
    before a column-parallel product). A no-op for a plain tensor."""
    if not isinstance(x, DTensor):
        return x
    pl = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
          for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(
        x.device_mesh, pl)


def _expand_ellipsis(eq: str, ndim: int) -> str:
    """``eq`` with a leading ``...`` of its first operand spelled out in
    letters it does not use, for an operand of ``ndim`` dims."""
    if "..." not in eq:
        return eq
    first = eq.split(",")[0]
    free = [c for c in "ABCDEFGH" if c not in eq]
    dots = "".join(free[:ndim - (len(first) - 3)])
    return eq.replace("...", dots)


def project(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, x, w)`` of activations x (B, ...) and a weight w.

    On a mesh, a local region in Megatron's form: the weight keeps its
    shard over the model axis (the one dim ``param_specs`` put there) and
    is gathered over the data axes (FSDP); x takes its batch on the data
    axes where they divide it and its sequence whole (``gather_seq``).
    A weight sharded on an output dim is column-parallel (the output keeps
    that shard); one sharded on a contracted dim is row-parallel (x takes
    the same shard and the output is partial over the model axis, summed
    where the next op needs it, the residual's reduce-scatter)."""
    if not on_mesh(x, w):
        return torch.einsum(eq, x, w)
    ctx = get_activation_sharding()
    eq = _expand_ellipsis(eq, x.ndim)
    (xs, ws), out = eq.split("->")[0].split(","), eq.split("->")[1]
    m_dim = ctx.mesh.mesh_dim_names.index(ctx.model_axis)
    pl = w.placements[m_dim] if isinstance(w, DTensor) else Replicate()
    c = ws[pl.dim] if isinstance(pl, Shard) else None

    def spec(letters):
        return tuple(ctx.batch(x.shape[0]) if i == 0 and letters != ws
                     else ctx.model_axis if l == c else None
                     for i, l in enumerate(letters))

    out_pl = activation_placements(ctx, spec(out))
    if c is not None and c not in out:
        out_pl[m_dim] = Partial()
    return local_region(lambda a, b: torch.einsum(eq, a, b), out_pl,
                        (activation_placements(ctx, spec(xs)),
                         activation_placements(ctx, spec(ws))), x, w)


def constrain_residual(x: torch.Tensor) -> torch.Tensor:
    """Sequence-parallel placement of the (B, S, d) residual stream: batch
    on the data axes where they divide it, sequence on the model axis
    where it divides (``repro/models/layers.py:82-92``). A no-op outside a
    mesh context and for a plain tensor."""
    ctx = get_activation_sharding()
    if ctx is None or ctx.mesh is None or x.ndim != 3 \
            or not isinstance(x, DTensor):
        return x
    return x.redistribute(ctx.mesh, activation_placements(
        ctx, (ctx.batch(x.shape[0]), ctx.seq(x.shape[1]), None)))


def decode_attention_splitk(q, kc, vc, valid_len, ctx) -> torch.Tensor:
    """Flash-decode over a sequence-sharded KV cache, a local region
    (``repro/models/layers.py:239-282``).

    q: (B, 1, K, G, D) replicated over the model axis; kc/vc: (B, T, K, D)
    with T sharded over the model axis; ``valid_len`` one length for every
    slot (an int or a 0-d tensor). Each rank scores its T / M keys from
    the offset ``rank_in_model * T_local``, masks positions ``>=
    valid_len``, takes the local max and ``all_reduce(MAX)``; then its
    local ``p``, ``l`` and ``acc``, ``all_reduce(SUM)`` of ``l`` and
    ``acc``, and the division. A shard wholly masked adds exact zeros. No
    score or cache is gathered."""
    mesh, m_axis = ctx.mesh, ctx.model_axis
    group = mesh.get_group(m_axis)
    rank = mesh.get_local_rank(m_axis)
    B, _, K, G, D = q.shape
    dax = ctx.batch(B)
    q_pl = activation_placements(ctx, (dax, None, None, None, None))
    kv_pl = activation_placements(ctx, (dax, m_axis, None, None))
    if isinstance(valid_len, DTensor):
        valid_len = valid_len.to_local()

    def local_fn(q_l, k_l, v_l):
        T_local = k_l.shape[1]
        vlen = torch.as_tensor(valid_len, device=q_l.device)
        s = torch.einsum("bskgd,btkd->bkgst", q_l.float(), k_l.float()) \
            * (D ** -0.5)
        t_idx = rank * T_local + torch.arange(T_local, device=q_l.device)
        s = s.masked_fill(~(t_idx < vlen), NEG_INF)
        m = torch.amax(s, dim=-1, keepdim=True)               # (b,k,g,1,1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        p = torch.exp(s - m)
        l_ = torch.sum(p, dim=-1, keepdim=True)
        acc = torch.einsum("bkgst,btkd->bskgd", p.to(v_l.dtype).float(),
                           v_l.float())                       # (b,1,k,g,D)
        dist.all_reduce(l_, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
        den = torch.clamp(l_[..., 0], min=1e-30).permute(0, 3, 1, 2)
        return (acc / den[..., None]).to(q_l.dtype)

    fn = local_map(local_fn, out_placements=q_pl,
                   in_placements=(q_pl, kv_pl, kv_pl), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(as_dtensor(q, mesh), as_dtensor(kc, mesh), as_dtensor(vc, mesh))


def _splitk_ctx(q, k, kv_valid_len, impl: str):
    """The context when ``attention_core`` takes the split-K decode, under
    the reference's conditions (``repro/models/layers.py:302-311``): the
    chunked impl, a one-token query with one scalar ``kv_valid_len``, a
    mesh context, and a cache of T > 1 keys that the model axis divides
    while it does not divide the KV heads (a head-sharded cache keeps the
    propagated path). Else None."""
    if impl != "torch_chunked" or q.shape[1] != 1 or kv_valid_len is None:
        return None
    ctx = get_activation_sharding()
    if ctx is None or ctx.mesh is None:
        return None
    T, K = k.shape[1], k.shape[2]
    if T > 1 and T % ctx.model_size == 0 and K % ctx.model_size != 0:
        return ctx
    return None


# ---------------------------------------------------------------------------
# attention


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, q_offset: int = 0,
                   kv_valid_len: Optional[Any] = None,
                   impl: str = "torch") -> torch.Tensor:
    """Grouped-query attention. q (B, S, K, G, D), k/v (B, T, K, D).

    ``kv_valid_len`` masks kv positions ``>=`` it: an int, or a (B,) tensor
    of per-slot lengths. ``impl="cuda"`` runs the kernels: a one-token
    query goes to the contiguous decode kernel, which takes either form
    (per-slot lengths are read on the device: the contiguous layout's
    decode and whisper's contiguous cross-attention), a longer one to
    flash prefill, which takes only a scalar, so per-slot lengths there
    raise by name (the JAX layer sends them to XLA; the port's callers
    ask for ``impl="torch"``). The kernel impl raises when asked for a
    gradient. ``impl="torch_chunked"`` sends a long full-sequence call
    (no ``kv_valid_len``, S > 256, S % 256 == 0, T % 512 == 0) to
    ``attention_chunked`` and the rest to the plain path; under a mesh
    context a one-token query with one scalar length goes to
    ``decode_attention_splitk`` where ``_splitk_ctx`` says so, and the
    rest runs as one local region over batch and heads
    (``_attention_region``).
    """
    vec_valid = torch.is_tensor(kv_valid_len) and kv_valid_len.ndim > 0
    if not vec_valid:
        ctx = _splitk_ctx(q, k, kv_valid_len, impl)
        if ctx is not None:
            return decode_attention_splitk(q, k, v, kv_valid_len, ctx)
    if impl == "cuda":
        kops.require_no_grad("attention impl 'cuda'", q, k, v)
        if vec_valid and q.shape[1] != 1:
            raise NotImplementedError(
                "attention_core: the flash kernel takes a scalar kv_valid_len;"
                " per-slot lengths at prefill need impl='torch'")
        return kops.flash_attention_grouped(
            q, k, v, causal=causal, q_offset=q_offset,
            kv_valid_len=kv_valid_len, impl="cuda")
    if impl not in PLAIN_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}")
    if on_mesh(q, k, v, kv_valid_len):
        return _attention_region(q, k, v, causal=causal, q_offset=q_offset,
                                 kv_valid_len=kv_valid_len, impl=impl)
    return _attention_local(q, k, v, causal=causal, q_offset=q_offset,
                            kv_valid_len=kv_valid_len, impl=impl)


def _attention_region(q, k, v, *, causal, q_offset, kv_valid_len, impl):
    """``_attention_local`` as one local region: the batch on the data
    axes where they divide it; the heads on the model axis by
    ``sharding._attn_specs``' three cases (the KV heads where the axis
    divides them, for q, k and v; else q's groups, k/v replicated over
    the model axis; else no head split). S and T stay whole, so the masks
    are the unsharded ones; per-slot lengths enter placed as the batch."""
    ctx = get_activation_sharding()
    B, S, K, G, D = q.shape
    m = ctx.model_axis
    dax = ctx.batch(B)
    if K % ctx.model_size == 0:
        qh, kh = (m, None), m
    elif G % ctx.model_size == 0:
        qh, kh = (None, m), None
    else:
        qh, kh = (None, None), None
    q_pl = activation_placements(ctx, (dax, None) + qh)
    kv_pl = activation_placements(ctx, (dax, None, kh))
    if isinstance(kv_valid_len, DTensor) and kv_valid_len.ndim == 0:
        kv_valid_len = kv_valid_len.full_tensor()
    vec_valid = torch.is_tensor(kv_valid_len) and kv_valid_len.ndim > 0
    extra = (kv_valid_len,) if vec_valid else ()
    return local_region(
        lambda q_, k_, v_, *n: _attention_local(
            q_, k_, v_, causal=causal, q_offset=q_offset,
            kv_valid_len=n[0] if n else kv_valid_len, impl=impl),
        q_pl, (q_pl, kv_pl, kv_pl)
        + ((activation_placements(ctx, (dax,)),) if extra else ()),
        q, k, v, *extra)


def _attention_local(q, k, v, *, causal, q_offset, kv_valid_len, impl):
    """The plain impls on whole (or local) tensors: the chunked dispatch,
    else the plain softmax attention."""
    vec_valid = torch.is_tensor(kv_valid_len) and kv_valid_len.ndim > 0
    B, S, K, G, D = q.shape
    T = k.shape[1]
    if impl == "torch_chunked" and kv_valid_len is None and S > 256 \
            and S % 256 == 0 and T % 512 == 0:
        # repro's dispatch condition for "xla_chunked"
        # (repro/models/layers.py:317-321); anything else is plain
        return attention_chunked(q, k, v, causal=causal, q_offset=q_offset)
    scores = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) \
        * (D ** -0.5)
    if causal or kv_valid_len is not None:
        t_idx = torch.arange(T, device=q.device)
        mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
        if causal:
            s_idx = torch.arange(S, device=q.device)[:, None] + q_offset
            mask = t_idx[None, :] <= s_idx
        if kv_valid_len is not None and not vec_valid:
            mask = mask & (t_idx[None, :] < kv_valid_len)
        if vec_valid:
            per_seq = t_idx[None, :] < kv_valid_len.reshape(-1, 1)
            mask = (mask[None] & per_seq[:, None, :])[:, None, None]
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgst,btkd->bskgd", probs, v.to(q.dtype))


# ---------------------------------------------------------------------------
# chunked attention with a recomputing backward (repro's _attention_chunked)


def _chunk_mask(causal: bool, qi: int, kj: int, qb: int, kb: int,
                q_offset: int, device) -> Optional[torch.Tensor]:
    """The (qb, kb) live mask of query block ``qi`` against key block
    ``kj``; None when every pair is live (a mask would change nothing)."""
    if not causal or kj * kb + kb - 1 <= qi * qb + q_offset:
        return None
    t_idx = kj * kb + torch.arange(kb, device=device)
    s_idx = qi * qb + q_offset + torch.arange(qb, device=device)
    return t_idx[None, :] <= s_idx[:, None]


def _block_live(causal: bool, qi: int, kj: int, qb: int, kb: int,
                q_offset: int) -> bool:
    """Whether any pair of the two blocks is live. A block that is wholly
    masked adds exact zeros in both passes (its probabilities are
    exp(-1e30 - m) = 0 against a live row's max), so skipping it changes
    no bit."""
    return not causal or kj * kb <= qi * qb + q_offset + qb - 1


def _chunked_fwd(q, k, v, causal, q_offset, qb, kb):
    """Returns (out (B, S, K, G, D) in q's dtype, lse (B, K, G, S) f32)."""
    B, S, K, G, D = q.shape
    T = k.shape[1]
    scale = D ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((B, K, G, S), dtype=torch.float32, device=q.device)
    qf, kf, vf = q.float(), k.float(), v.float()
    for qi in range(S // qb):
        rows = slice(qi * qb, (qi + 1) * qb)
        qblk = qf[:, rows]
        m_run = torch.full((B, K, G, qb), NEG_INF, device=q.device)
        l_run = torch.zeros((B, K, G, qb), device=q.device)
        acc = torch.zeros((B, K, G, qb, D), device=q.device)
        for kj in range(T // kb):
            if not _block_live(causal, qi, kj, qb, kb, q_offset):
                continue
            cols = slice(kj * kb, (kj + 1) * kb)
            s = torch.einsum("bskgd,btkd->bkgst", qblk, kf[:, cols]) * scale
            mask = _chunk_mask(causal, qi, kj, qb, kb, q_offset, q.device)
            if mask is not None:
                s = s.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m_run, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m_run - m_new)
            l_run = l_run * alpha + torch.sum(p, dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgst,btkd->bkgsd", p.to(v.dtype).float(), vf[:, cols])
            m_run = m_new
        l_run = torch.clamp(l_run, min=1e-30)
        out[:, rows] = (acc / l_run[..., None]).permute(0, 3, 1, 2, 4) \
            .to(q.dtype)
        lse[..., rows] = m_run + torch.log(l_run)
    return out, lse


def _chunked_bwd(q, k, v, out, lse, dout, causal, q_offset, qb, kb):
    """FlashAttention-style recomputing backward: per (key block, query
    block) pair the probabilities are rebuilt from ``lse``; nothing S x T
    is stored. Returns (dq, dk, dv) in the inputs' dtypes."""
    B, S, K, G, D = q.shape
    T = k.shape[1]
    scale = D ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    # D_i = rowsum(dOut * Out): (B, K, G, S)
    delta = torch.einsum("bskgd,bskgd->bkgs", dof, out.float())
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for kj in range(T // kb):
        cols = slice(kj * kb, (kj + 1) * kb)
        kblk, vblk = kf[:, cols], vf[:, cols]
        for qi in range(S // qb):
            if not _block_live(causal, qi, kj, qb, kb, q_offset):
                continue
            rows = slice(qi * qb, (qi + 1) * qb)
            qblk, doblk = qf[:, rows], dof[:, rows]
            s = torch.einsum("bskgd,btkd->bkgst", qblk, kblk) * scale
            mask = _chunk_mask(causal, qi, kj, qb, kb, q_offset, q.device)
            if mask is not None:
                s = s.masked_fill(~mask, NEG_INF)
            p = torch.exp(s - lse[..., rows, None])        # (B,K,G,qb,kb)
            dp = torch.einsum("bskgd,btkd->bkgst", doblk, vblk)
            ds = p * (dp - delta[..., rows, None])
            dq[:, rows] += torch.einsum("bkgst,btkd->bskgd", ds, kblk) \
                * scale
            dk[:, cols] += torch.einsum("bkgst,bskgd->btkd", ds, qblk) \
                * scale
            dv[:, cols] += torch.einsum("bkgst,bskgd->btkd", p, doblk)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class ChunkedAttention(torch.autograd.Function):
    """Online-softmax attention over (qb, kb) blocks whose backward
    recomputes each block's probabilities: the S x T scores exist in
    neither pass. The forward saves ``(q, k, v, out, lse)``, as
    ``repro``'s custom VJP does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, qb, kb):
        out, lse = _chunked_fwd(q, k, v, causal, q_offset, qb, kb)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, qb, kb)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _chunked_bwd(q, k, v, out, lse, dout.contiguous(),
                                  *ctx.args)
        return dq, dk, dv, None, None, None, None


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_offset: int = 0, q_block: int = 256,
                      k_block: int = 512) -> torch.Tensor:
    """q (B, S, K, G, D), k/v (B, T, K, D) -> (B, S, K, G, D) through
    ``ChunkedAttention`` with blocks of min(q_block, S) queries and
    min(k_block, T) keys; S and T must be multiples of them."""
    S, T = q.shape[1], k.shape[1]
    qb, kb = min(q_block, S), min(k_block, T)
    if S % qb or T % kb:
        raise ValueError(f"attention_chunked: S {S} / T {T} are not "
                         f"multiples of the blocks {qb} / {kb}")
    return ChunkedAttention.apply(q, k, v, bool(causal), int(q_offset), qb,
                                  kb)


def window_attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          pos: torch.Tensor) -> torch.Tensor:
    """Attention of a teacher-forced decode window (the speculative
    verify). q (B, S, K, G, D); k/v (B, T, K, D), the window's rows
    already written; pos (B,) the position of each slot's first window
    token.

    Window token ``s`` of slot ``b`` sits at ``pos[b] + s`` and attends to
    positions ``<= pos[b] + s``, itself included: the decode step's
    ``kv_valid_len = pos + 1`` masked attend, batched over the window. At
    ``S == 1`` the mask is exactly the decode step's, and so are the
    operations, so a one-token window gives the decode step's bits. Plain
    PyTorch only: no kernel takes a per-row causal offset.
    """
    B, S, K, G, D = q.shape
    T = k.shape[1]
    scores = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) \
        * (D ** -0.5)
    t_idx = torch.arange(T, device=q.device)
    s_pos = pos.reshape(-1, 1, 1) + torch.arange(S, device=q.device)[:, None]
    mask = (t_idx <= s_pos)[:, None, None]            # (B, 1, 1, S, T)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgst,btkd->bskgd", probs, v.to(q.dtype))


def paged_attention_core(q, k_pool, v_pool, block_table, *, kv_valid_len,
                         impl: str = "torch") -> torch.Tensor:
    """One-token decode attention over a paged KV cache, attend only.

    q (B, 1, K, G, D); pools (n_phys, ps, K, D); block_table (B, P) int32;
    ``kv_valid_len`` per-slot lengths: a (B,) int32 tensor, or a scalar
    for every slot. ``impl="cuda"`` runs the paged decode kernel, which
    walks the block table itself; the plain path gathers each slot's
    logical view (entries clamped into the pool) and runs the masked
    ``attention_core``.
    """
    if impl == "cuda":
        kops.require_no_grad("attention impl 'cuda'", q)
        kops.require_cuda(q, "paged_attention_core")
        return kops.paged_decode_attention(
            q[:, 0].contiguous(), k_pool, v_pool, block_table,
            kv_valid_len)[:, None]
    if impl not in PLAIN_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}")
    kc = KV.gather_block_kv(k_pool, block_table)
    vc = KV.gather_block_kv(v_pool, block_table)
    return attention_core(q, kc, vc, causal=False, kv_valid_len=kv_valid_len,
                          impl="torch")


def paged_update_attend(q, k, v, k_pool, v_pool, block_table, pos, *,
                        impl: str = "torch") -> Tuple[torch.Tensor, Any, Any]:
    """One decode step's paged KV write + attend; returns (o, k_pool, v_pool).

    q (B, 1, K, G, D); k/v (B, 1, K, D); pools (n_phys, ps, K, D) updated in
    place; block_table (B, P) int32; pos (B,) int32. ``impl="cuda"`` runs
    the fused kernel, which needs the engine's kernel pool layout (a trash
    page at the sentinel index); the plain path scatters with sentinel drop
    and then runs the gathered masked attend.
    """
    if impl == "cuda":
        kops.require_no_grad("attention impl 'cuda'", q, k, v)
        kops.require_cuda(q, "paged_update_attend")
        o, k_pool, v_pool = kops.fused_paged_decode_attention(
            q[:, 0].contiguous(), k[:, 0].contiguous(), v[:, 0].contiguous(),
            k_pool, v_pool, block_table, pos)
        return o[:, None], k_pool, v_pool
    if impl not in PLAIN_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}")
    k_pool, v_pool = KV.paged_update_layer_cache(k_pool, v_pool, k, v,
                                                 block_table, pos)
    o = paged_attention_core(q, k_pool, v_pool, block_table,
                             kv_valid_len=pos + 1)
    return o, k_pool, v_pool


def attn_qkv(x: torch.Tensor, p: Params, qimpl: str = "torch"):
    """Projections of one layer: x (B, S, d) -> q (B,S,K,G,h), k/v (B,S,K,h)."""
    if isinstance(p["wq"], QuantizedWeight):
        q = qeinsum(x, p["wq"], 1, impl=qimpl)
        k = qeinsum(x, p["wk"], 1, impl=qimpl)
        v = qeinsum(x, p["wv"], 1, impl=qimpl)
        return q.to(x.dtype), k.to(x.dtype), v.to(x.dtype)
    x = gather_seq(x)
    q = project("bsd,dkgh->bskgh", x, p["wq"])
    k = project("bsd,dkh->bskh", x, p["wk"])
    v = project("bsd,dkh->bskh", x, p["wv"])
    return q, k, v


def attn_out(o: torch.Tensor, p: Params, qimpl: str = "torch") -> torch.Tensor:
    if isinstance(p["wo"], QuantizedWeight):
        return qeinsum(o, p["wo"], 3, impl=qimpl).to(o.dtype)
    return project("bskgh,kghd->bsd", o, p["wo"])


# ---------------------------------------------------------------------------
# SwiGLU MLP


def swiglu(x: torch.Tensor, p: Params, qimpl: str = "torch") -> torch.Tensor:
    if isinstance(p["w_gate"], QuantizedWeight):
        g = qeinsum(x, p["w_gate"], 1, impl=qimpl)       # f32
        u = qeinsum(x, p["w_up"], 1, impl=qimpl)
        h = torch.nn.functional.silu(g) * u
        return qeinsum(h, p["w_down"], 1, impl=qimpl).to(x.dtype)
    x = gather_seq(x)
    g = project("bsd,df->bsf", x, p["w_gate"])
    u = project("bsd,df->bsf", x, p["w_up"])
    h = torch.nn.functional.silu(g) * u
    return project("bsf,fd->bsd", h, p["w_down"])


# ---------------------------------------------------------------------------
# embeddings / lm head


def embed_tokens(tokens: torch.Tensor, table: torch.Tensor,
                 dtype) -> torch.Tensor:
    """The rows of ``table`` (V, d) at ``tokens`` in ``dtype``; on a mesh a
    local region (``_embed_region``)."""
    if on_mesh(tokens, table):
        return _embed_region(tokens, table, dtype)
    return table[tokens.long()].to(dtype)


def _vocab_axis(ctx, V: int):
    """The model axis where it splits a vocab of ``V`` evenly, else None."""
    return ctx.model_axis if ctx.model_size > 1 \
        and V % ctx.model_size == 0 else None


def _embed_region(tokens, table, dtype):
    """The lookup on a mesh, GSPMD's vocab-sharded gather: a local region
    with the tokens' batch on the data axes where they divide it and the
    table's vocab on the model axis where it divides it; each rank reads
    the rows its shard holds, zeros for the rest, so the output is partial
    over the model axis. Its backward writes each rank's own rows."""
    ctx = get_activation_sharding()
    vax = _vocab_axis(ctx, table.shape[0])
    rank = ctx.mesh.get_local_rank(vax) if vax else 0
    rows = ctx.batch(tokens.shape[0])

    def look(tok, tab):
        ids = tok.long() - rank * tab.shape[0]
        hit = (ids >= 0) & (ids < tab.shape[0])
        out = tab[torch.where(hit, ids, 0)].masked_fill(~hit[..., None], 0)
        return out.to(dtype)

    out_pl = activation_placements(ctx, (rows, None, None))
    if vax:
        out_pl[ctx.mesh.mesh_dim_names.index(vax)] = Partial()
    return local_region(look, out_pl, (
        activation_placements(ctx, (rows, None)),
        activation_placements(ctx, (vax, None))), tokens, table)


def select_last(x: torch.Tensor, length: Optional[torch.Tensor]) -> torch.Tensor:
    """The last *valid* position per sequence: x (B, S, d) -> (B, 1, d)."""
    if length is None:
        return x[:, -1:]
    idx = torch.clamp(length.long() - 1, 0, x.shape[1] - 1)
    return torch.gather(x, 1, idx[:, None, None].expand(-1, 1, x.shape[2]))


class _HeadBf16(torch.autograd.Function):
    """bf16 x (N, d) times the bf16 head (V, d) into f32 logits on CUDA,
    with a backward (``torch.mm(..., out_dtype=)`` has none). The f32
    logit grads enter the two backward products rounded to bf16, whose
    results are bf16 (the params' dtype) accumulated in f32."""

    @staticmethod
    def forward(ctx, x2, head):
        ctx.save_for_backward(x2, head)
        return torch.mm(x2, head.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, head = ctx.saved_tensors
        g = g.to(torch.bfloat16)
        return torch.mm(g, head), torch.mm(g.t(), x2)


def lm_logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """Logits in f32, accumulated in f32 (no rounding to the working dtype).

    On CUDA a bf16 head goes through ``_HeadBf16``, whose forward is
    ``torch.mm(..., out_dtype=float32)`` (on a mesh in a local region,
    ``_head_bf16_region``); elsewhere the operands are widened first.
    """
    B, S, d = x.shape
    x2 = gather_seq(x).reshape(B * S, d)
    if x.is_cuda and x.dtype == torch.bfloat16:
        if isinstance(x2, DTensor):
            out = _head_bf16_region(x2, head)
        else:
            out = _HeadBf16.apply(x2, head)
    elif on_mesh(x2, head):
        out = project("nd,vd->nv", x2.float(), head.float())
    else:
        out = x2.float() @ head.float().t()
    return out.reshape(B, S, -1)


def _head_bf16_region(x2: DTensor, head: DTensor) -> DTensor:
    """``_HeadBf16`` on a mesh, a local region (DTensor has no sharding
    rule for ``mm`` with an ``out_dtype``): rows on the data axes where
    they divide them, the vocab on the model axis where it divides it, as
    ``param_specs`` shards the head; each rank multiplies its rows by its
    vocab shard over the whole of d, so every logit is the unsharded
    product's."""
    ctx = get_activation_sharding()
    vocab = ctx.model_axis if head.shape[0] % ctx.model_size == 0 else None
    rows = ctx.batch(x2.shape[0])
    fn = local_map(_HeadBf16.apply,
                   out_placements=activation_placements(ctx, (rows, vocab)),
                   in_placements=(activation_placements(ctx, (rows, None)),
                                  activation_placements(ctx, (vocab, None))),
                   device_mesh=ctx.mesh, redistribute_inputs=True)
    return fn(x2, as_dtensor(head, ctx.mesh))


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy: logits (B, S, V) f32, targets (B, S) int.

    The mean over tokens of logsumexp minus the gold logit. The gold logit
    is gathered: each row reads one element, so its backward writes one
    element a row and gives the same bits every call on the card (``repro``
    takes it by a mask-reduce, for a vocab-sharded layout; the value is the
    same). On a mesh (DTensor logits) each token's loss is a local region
    (``_token_losses_region``) that never gathers a row."""
    if on_mesh(logits, targets):
        return torch.mean(_token_losses_region(logits, targets))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


class _SumOverGroup(torch.autograd.Function):
    """A sum over a process group that every rank holds and uses alike:
    the gradient of each rank's term is the sum's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def _token_losses_region(logits, targets):
    """Each token's loss on a mesh, the reference's vocab-sharded form: a
    local region with the rows on the data axes where they divide the
    batch and the vocab on the model axis where it divides it. Each rank
    takes its shard's max (all-reduced, a constant of the gradient), its
    sum of exponentials and its mask-reduced gold logit, summed over the
    model axis; the (B, S) losses are whole over the model axis."""
    ctx = get_activation_sharding()
    B, S, V = logits.shape
    vax = _vocab_axis(ctx, V)
    rows = ctx.batch(B)
    group = ctx.mesh.get_group(ctx.model_axis)
    rank = ctx.mesh.get_local_rank(vax) if vax else 0

    def losses(lg, tg):
        v0 = rank * lg.shape[-1]
        m = torch.amax(lg, dim=-1, keepdim=True).detach()
        if vax:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        sumexp = torch.sum(torch.exp(lg - m), dim=-1)
        ids = v0 + torch.arange(lg.shape[-1], device=lg.device)
        gold = torch.sum(lg.masked_fill(ids != tg.long()[..., None], 0.0),
                         dim=-1)
        if vax:
            sumexp = _SumOverGroup.apply(sumexp, group)
            gold = _SumOverGroup.apply(gold, group)
        return m[..., 0] + torch.log(sumexp) - gold

    tok_pl = activation_placements(ctx, (rows, None))
    return local_region(losses, tok_pl,
                        (activation_placements(ctx, (rows, None, vax)),
                         tok_pl), logits, targets)
