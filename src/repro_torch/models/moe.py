"""Mixture-of-Experts decoder (moonshot 64 experts top-6, qwen3 128 top-8;
``repro.models.moe``).

Two FFN lowerings, ``moe_ffn_ep`` on a mesh and ``moe_ffn_dense``
without one:

* ``moe_ffn_dense``, ``repro``'s single-device lowering: capacity-bounded
  top-k routing with token dropping (GShard-style), every expert run over
  its capacity buffer, so a step reads every expert's weights. The
  routing, the dispatch, the expert GEMMs (``torch.bmm``) and the combine
  are plain PyTorch, as they are XLA in the JAX package, outside any
  Pallas kernel. They give the same bits on every call: the dispatch is a
  plain indexed write (kept assignments have unique (expert, position)
  pairs; dropped ones go to a spare row that nothing reads) and the
  combine sums each token's k weighted expert outputs in one reduction of
  fixed order, where ``repro`` scatter-adds both (atomics on a GPU).
* ``moe_ffn_ep``, the expert-parallel lowering on a mesh: a local region
  in which each rank routes its own tokens, dispatches them by the same
  indexed write, sends each expert's buffer to its owner over the model
  axis (``all_to_all_single``), runs its ``E / M`` experts and sends the
  outputs back for the same fixed-order combine.

Attention reuses the dense family's self block halves
(``transformer._self_attn`` at prefill, ``transformer._decode_attn`` at
decode), so it runs under the config's impl: flash prefill (causal) and,
at decode, the fused paged kernel through ``"bt"`` or the contiguous
kernel's per-slot form. Decode routes every one of the ``max_batch``
rows, idle slots' too, as ``repro`` does: their tokens take expert
capacity.

Parameters are stacked on a leading layer axis, as in the JAX package, and
the layer loop is a Python loop over per-layer views.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.parallel import (activation_sharding_from,
                                              get_activation_sharding,
                                              using_activation_sharding)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init (seeded by a torch.Generator on the target device)


def _expert_init(gen: torch.Generator, shape, dtype, in_axis: int,
                 device) -> torch.Tensor:
    """``L.dense_init`` drawn one layer (leading index) at a time: a whole
    stack of moonshot's experts would need a 35 GB f32 draw."""
    w = torch.empty(shape, dtype=dtype, device=device)
    scale = 1.0 / shape[in_axis] ** 0.5
    for i in range(shape[0]):
        w[i] = (torch.randn(shape[1:], generator=gen, dtype=torch.float32,
                            device=device) * scale).to(dtype)
    return w


def _moe_mlp_init(cfg: ArchConfig, gen: torch.Generator, n: int, dtype,
                  device) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": L.dense_init(gen, (n, d, e), torch.float32, 1,
                               device=device),
        "w_gate": _expert_init(gen, (n, e, d, f), dtype, 2, device),
        "w_up": _expert_init(gen, (n, e, d, f), dtype, 2, device),
        "w_down": _expert_init(gen, (n, e, f, d), dtype, 2, device),
    }
    if cfg.n_shared_experts:
        fs = cfg.d_ff * cfg.n_shared_experts
        p["shared"] = {
            "w_gate": L.dense_init(gen, (n, d, fs), dtype, 1, device=device),
            "w_up": L.dense_init(gen, (n, d, fs), dtype, 1, device=device),
            "w_down": L.dense_init(gen, (n, fs, d), dtype, 1, device=device),
        }
    return p


def init_moe(cfg: ArchConfig, gen: torch.Generator, device) -> Params:
    """Embedding, the stacked attention + MoE layers, final norm, head."""
    dtype = T.DTYPES[cfg.param_dtype]
    n, d = cfg.n_layers, cfg.d_model
    return {
        "embed": L.embed_init(gen, (cfg.vocab, d), dtype, device=device),
        "layers": {
            "attn": T._attn_stack_init(cfg, gen, n, dtype, device),
            "moe": _moe_mlp_init(cfg, gen, n, dtype, device),
            "ln1": torch.zeros((n, d), dtype=dtype, device=device),
            "ln2": torch.zeros((n, d), dtype=dtype, device=device),
        },
        "ln_f": torch.zeros((d,), dtype=dtype, device=device),
        "head": L.embed_init(gen, (cfg.vocab, d), dtype, device=device),
    }


# ---------------------------------------------------------------------------
# routing


def _route(x2d: torch.Tensor, router: torch.Tensor, cfg: ArchConfig):
    """x2d: (T, d). Returns (weights (T, k) f32, experts (T, k) int64).

    The top k by a stable descending sort: on equal probabilities the
    lower expert id comes first, as ``lax.top_k`` orders them
    (``torch.topk`` leaves ties unordered)."""
    logits = x2d.float() @ router
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :cfg.top_k], idx[:, :cfg.top_k]
    return w / torch.sum(w, dim=-1, keepdim=True), idx


def _capacity(n_tokens: int, cfg: ArchConfig) -> int:
    c = int(math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts))
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def _dispatch_indices(idx: torch.Tensor, cfg: ArchConfig, capacity: int):
    """idx: (T, k) expert ids. Returns (pos (T, k), keep (T, k) bool): each
    assignment's position in its expert's capacity buffer, a running count
    in flattened (token-major) order, the GShard dispatch order."""
    T_, k = idx.shape
    onehot = F.one_hot(idx.reshape(T_ * k), cfg.n_experts)      # (T*k, E)
    pos = torch.cumsum(onehot, dim=0) - onehot                  # pre-count
    pos_of = torch.sum(pos * onehot, dim=-1).reshape(T_, k)
    return pos_of, pos_of < capacity


def _expert_gemm(buf: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    """buf: (E, C, d) tokens grouped per expert; per-expert SwiGLU."""
    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    return torch.bmm(h, wd)


def moe_ffn_dense(x: torch.Tensor, p: Params,
                  cfg: ArchConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d), capacity computed from all B * S rows.

    Kept assignments land at (expert, position) in an (E * C + 1, d)
    buffer by a plain indexed write (their pairs are unique); dropped ones
    go to its spare last row, which the expert GEMMs never read. The
    combine gathers each token's k outputs (a dropped one's weight is 0),
    weights them in x's dtype and sums them over k in one reduction (a
    fixed order; bf16 accumulates in f32 and rounds once, where
    ``repro``'s scatter-add rounds after each add). The backward is the
    same bits every call on the card too: the repeat is an expand, whose
    backward sums over k, and the gather an indexed read, whose backward
    accumulates sorted by index (``index_select`` and
    ``repeat_interleave`` would add with atomics)."""
    B, S, d = x.shape
    x2 = x.reshape(B * S, d)
    w, keep, flat, buf = _dispatch(x2, p["router"], cfg)
    E, C = cfg.n_experts, buf.shape[0] // cfg.n_experts
    out = _expert_gemm(buf.view(E, C, d), p["w_gate"], p["w_up"],
                       p["w_down"]).reshape(E * C, d)
    y = _combine(out, w, keep, flat, cfg, x.dtype).reshape(B, S, d)
    if "shared" in p:
        y = y + L.swiglu(x, p["shared"])
    return y


def _dispatch(x2: torch.Tensor, router: torch.Tensor, cfg: ArchConfig):
    """Route the n rows of x2 (n, d) and write each kept assignment at
    (expert, position) of an (E * C + 1, d) buffer, C from n; dropped ones
    go to the spare last row. Returns (weights (n, k), keep (n, k), the
    flat buffer rows (n * k,), the buffer's first E * C rows)."""
    n, d = x2.shape
    k, E = cfg.top_k, cfg.n_experts
    w, idx = _route(x2, router, cfg)
    C = _capacity(n, cfg)
    pos, keep = _dispatch_indices(idx, cfg, C)
    flat = (idx * C + pos).masked_fill(~keep, E * C).reshape(n * k)
    buf = x2.new_zeros((E * C + 1, d))
    buf.index_copy_(0, flat, x2[:, None].expand(n, k, d).reshape(n * k, d))
    return w, keep, flat, buf[:E * C]


def _combine(out: torch.Tensor, w, keep, flat, cfg: ArchConfig,
             dtype) -> torch.Tensor:
    """Each row's k expert outputs from ``out`` (E * C, d), weighted in
    ``dtype`` (a dropped one's weight is 0) and summed over k in one
    reduction: (n, d)."""
    n, k = w.shape
    gathered = out[torch.clamp(flat, max=out.shape[0] - 1)]
    w_f = (w * keep).to(dtype)
    return torch.sum(gathered.reshape(n, k, -1) * w_f[..., None], dim=1)


def moe_ffn_ep(x: torch.Tensor, p: Params, cfg: ArchConfig,
               parallel) -> torch.Tensor:
    """Expert parallelism over the model axis with explicit all-to-alls
    (``repro/models/moe.py:156-214``); x and the params are DTensors on
    ``parallel.mesh``.

    Tokens enter the local region sharded over the data axes (batch, where
    they divide it) and over the model axis (sequence, when S > 1 and M
    divides it; otherwise replicated over model), matching the
    sequence-parallel residual stream; the expert weights enter sharded on
    their expert dim over model, the router replicated. Each rank routes
    its own T rows with capacity C from T, as the reference does (so where
    local capacity drops a token the result differs from the dense
    lowering's, as the reference's does), and dispatches them by
    ``_dispatch``'s indexed write. Its (E * C, d) buffer is M blocks of
    E / M experts, block j for model rank j: ``all_to_all_single`` sends
    them, the rank runs its experts over the (E / M, M * C, d) rows it
    received, and a second ``all_to_all_single`` returns each block to its
    source for ``_combine``. Both are the autograd form, so a train step
    takes gradients through them: a rank's router and expert gradients
    sum over its own tokens and are partial over the mesh dims that split
    the tokens. A gradient needs the sequence split over the model axis
    (tokens replicated over it would count M times in each expert's
    gradient), and is refused by name otherwise. The shared experts run
    outside the region, as in the reference."""
    # the autograd all-to-all lives in a private module: imported here so
    # that the unsharded paths do not depend on it
    import torch.distributed._functional_collectives as funcol
    mesh = parallel.mesh
    ctx = activation_sharding_from(parallel)
    M = parallel.model_size
    E = cfg.n_experts
    if E % M:
        raise ValueError(f"moe_ffn_ep: {E} experts do not divide the model "
                         f"axis of size {M}")
    e_local = E // M
    group = (mesh, mesh.mesh_dim_names.index(parallel.model_axis))
    B, S, d = x.shape
    seq = parallel.model_axis if (S % M == 0 and S > 1) else None
    if seq is None and M > 1 and torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, p["router"], p["w_gate"])):
        # every model rank would route the same tokens, and each expert
        # would add their gradients M times
        raise ValueError(f"moe_ffn_ep: a gradient needs the sequence ({S}) "
                         f"split over the model axis ({M})")
    x_pl = L.activation_placements(ctx, (ctx.batch(B), seq, None))
    rep = L.activation_placements(ctx, ())
    w_pl = L.activation_placements(ctx, (parallel.model_axis,))
    # gradients: a rank's router and expert grads sum over its own tokens,
    # partial over every mesh dim that splits the tokens
    split = [isinstance(pl, Shard) for pl in x_pl]
    router_g = [Partial() if s else Replicate() for s in split]
    w_g = [pl if isinstance(pl, Shard) else Partial() if s else Replicate()
           for pl, s in zip(w_pl, split)]

    def local_fn(x_l, router, wg, wu, wd):
        Bl, Sl, _ = x_l.shape
        x2 = x_l.reshape(Bl * Sl, d)
        w, keep, flat, buf = _dispatch(x2, router, cfg)
        C = buf.shape[0] // E
        recv = funcol.all_to_all_single_autograd(buf.contiguous(), None,
                                                 None, group)
        recv = recv.view(M, e_local, C, d).transpose(0, 1) \
            .reshape(e_local, M * C, d)
        out = _expert_gemm(recv, wg, wu, wd)
        out = out.view(e_local, M, C, d).transpose(0, 1) \
            .reshape(E * C, d)
        back = funcol.all_to_all_single_autograd(out.contiguous(), None,
                                                 None, group)
        return _combine(back, w, keep, flat, cfg, x_l.dtype) \
            .reshape(Bl, Sl, d)

    fn = local_map(local_fn, out_placements=x_pl,
                   in_placements=(x_pl, rep, w_pl, w_pl, w_pl),
                   in_grad_placements=(x_pl, router_g, w_g, w_g, w_g),
                   device_mesh=mesh, redistribute_inputs=True)
    y = fn(x, L.as_dtensor(p["router"], mesh), p["w_gate"], p["w_up"],
           p["w_down"])
    if "shared" in p:
        # the shared experts' products are local regions of this mesh
        with using_activation_sharding(get_activation_sharding() or ctx):
            y = y + L.swiglu(x, p["shared"])
    return y


# ---------------------------------------------------------------------------
# full model: forward / prefill / decode


def _moe_residual(cfg: ArchConfig, x, o, blk, parallel=None):
    x = x + L.attn_out(o, blk["attn"])
    h = L.rmsnorm(x, blk["ln2"])
    x = x + (moe_ffn_dense(h, blk["moe"], cfg) if parallel is None
             else moe_ffn_ep(h, blk["moe"], cfg, parallel))
    return L.constrain_residual(x)


def forward_moe(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
                parallel=None) -> torch.Tensor:
    """The causal forward of training: tokens (B, S) -> logits (B, S, V)
    f32, each layer a remat body. Capacity comes from all B * S tokens
    (from each rank's own tokens under ``moe_ffn_ep``)."""
    positions = T._positions(tokens)
    x = L.embed_tokens(tokens, params["embed"], T.DTYPES[cfg.dtype])

    def body(x, blk):
        o, _, _ = T._self_attn(cfg, x, blk, positions)
        return _moe_residual(cfg, x, o, blk, parallel)

    for blk in T.unstack(params["layers"], cfg.n_layers):
        x = T.remat(cfg, body, x, blk)
    return T._logits(params, x)


def prefill_moe(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
                parallel=None, length: Optional[torch.Tensor] = None):
    """tokens (B, S), right-padded; ``length`` (B,) valid prefix lengths.

    Expert capacity comes from the padded token count, as in ``repro``:
    padded rows are routed too. Returns next-token logits (B, 1, V) f32,
    read at ``length - 1``, and the prompt cache ``{"k", "v"}`` (L, B, S,
    K, D)."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    x = L.embed_tokens(tokens, params["embed"], T.DTYPES[cfg.dtype])
    ks, vs = [], []
    for blk in T.unstack(params["layers"], cfg.n_layers):
        o, k, v = T._self_attn(cfg, x, blk, positions)
        x = _moe_residual(cfg, x, o, blk, parallel)
        ks.append(k)
        vs.append(v)
    return T._head(cfg, params, x, length), {"k": torch.stack(ks),
                                             "v": torch.stack(vs)}


def decode_moe(cfg: ArchConfig, params: Params, cache, token: torch.Tensor,
               pos: torch.Tensor, parallel=None) -> Tuple[torch.Tensor, Any]:
    """One new token per slot: token (B, 1), pos (B,) int32; every row is
    routed. ``cache`` holds the pools ``"k"``/``"v"`` (L, n_phys, ps, K, D)
    and the block table ``"bt"``, or, without ``"bt"``, the contiguous
    (L, B, S_max, K, D) rows; either is updated in place. Returns (logits
    (B, 1, V) f32, cache)."""
    bt = cache.get("bt")
    x = L.embed_tokens(token, params["embed"], T.DTYPES[cfg.dtype])
    for i, blk in enumerate(T.unstack(params["layers"], cfg.n_layers)):
        o = T._decode_attn(cfg, x, blk, cache["k"][i], cache["v"][i], bt,
                           pos)
        x = _moe_residual(cfg, x, o, blk, parallel)
    return T._head(cfg, params, x), cache
