"""Mamba2 (SSD) blocks and the Zamba2 hybrid backbone (``repro.models.ssm``).

The SSD layer follows the chunked algorithm of Mamba-2 [arXiv:2405.21060]:
intra-chunk contributions through a (Q, Q) decay-masked score matrix,
inter-chunk ones through a scan over per-chunk states. Decode is the O(1)
recurrence on the (B, H, N, P) state.

Zamba2 [arXiv:2411.15242]: a stack of Mamba2 layers with ONE shared
transformer block (attention + SwiGLU, the same parameters at every call)
after every ``shared_attn_every`` layers, plus a Mamba tail. The shared
block is the dense family's self block, so its attention goes through the
config's impl: flash prefill (causal) and, at decode, the fused paged
kernel through ``"bt"`` or the contiguous kernel's per-slot form. The SSD
scan, the convolutions and the gated norm are plain PyTorch, as they are
XLA in the JAX package, outside any Pallas kernel.

Parameters are stacked on a leading layer axis, as in the JAX package, and
the layer loops are Python loops over per-layer views. Decode updates the
cache in place: the shared block's k/v (pools or contiguous rows) and each
layer's ``ssm`` and ``conv`` state rows, which have no sequence axis and
stay indexed by slot.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.parallel import get_activation_sharding
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Params = Dict[str, Any]

CONV_WIDTH = 4


def mamba_dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    """(d_inner, n_heads_mamba, head_dim_mamba, conv_channels)."""
    d_inner = 2 * cfg.d_model
    p = 64 if cfg.d_model >= 512 else 16
    h = d_inner // p
    conv_ch = d_inner + 2 * cfg.ssm_state
    return d_inner, h, p, conv_ch


# ---------------------------------------------------------------------------
# init (seeded by a torch.Generator on the target device)


def _mamba_stack_init(cfg: ArchConfig, gen: torch.Generator, n: int, dtype,
                      device) -> Params:
    """``n`` stacked Mamba2 layers. The projections stay separate (w_z,
    w_x, w_bc, w_dt), as in the JAX package."""
    d = cfg.d_model
    di, h, _, _ = mamba_dims(cfg)
    n2 = 2 * cfg.ssm_state
    f32 = torch.float32
    kw = dict(device=device)
    return {
        "w_z": L.dense_init(gen, (n, d, di), dtype, 1, **kw),
        "w_x": L.dense_init(gen, (n, d, di), dtype, 1, **kw),
        "w_bc": L.dense_init(gen, (n, d, n2), dtype, 1, **kw),
        "w_dt": L.dense_init(gen, (n, d, h), f32, 1, **kw),
        "conv_x_w": L.dense_init(gen, (n, CONV_WIDTH, di), dtype, 1, **kw),
        "conv_x_b": torch.zeros((n, di), dtype=dtype, **kw),
        "conv_bc_w": L.dense_init(gen, (n, CONV_WIDTH, n2), dtype, 1, **kw),
        "conv_bc_b": torch.zeros((n, n2), dtype=dtype, **kw),
        "A_log": torch.zeros((n, h), dtype=f32, **kw),      # A = -exp(A_log)
        "D": torch.ones((n, h), dtype=f32, **kw),
        "dt_bias": torch.zeros((n, h), dtype=f32, **kw),
        "norm": torch.zeros((n, di), dtype=dtype, **kw),
        "out_proj": L.dense_init(gen, (n, di, d), dtype, 1, **kw),
    }


def init_zamba(cfg: ArchConfig, gen: torch.Generator, device) -> Params:
    """Embedding, the Mamba stack, the one shared block, final norm, head."""
    dtype = T.DTYPES[cfg.param_dtype]
    shared = T._block_stack_init(cfg, gen, 1, dtype, device)
    return {
        "embed": L.embed_init(gen, (cfg.vocab, cfg.d_model), dtype,
                              device=device),
        "mamba": _mamba_stack_init(cfg, gen, cfg.n_layers, dtype, device),
        "shared": T.unstack(shared, 1)[0],
        "ln_f": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        "head": L.embed_init(gen, (cfg.vocab, cfg.d_model), dtype,
                             device=device),
    }


# ---------------------------------------------------------------------------
# SSD core


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., Q) log-decay increments -> (..., Q, Q) masked cumulative sums
    M[i, j] = sum_{l in (j, i]} x_l for i >= j, -inf otherwise."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(xdt: torch.Tensor, dA: torch.Tensor, B_: torch.Tensor,
                C_: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    xdt: (b, l, h, p) inputs pre-scaled by dt; dA: (b, l, h) log decays
    (<= 0); B_, C_: (b, l, n), shared across heads (one group). h0: an
    optional initial state (b, h, n, p). Returns (y (b, l, h, p), the
    final state (b, h, n, p)), both in xdt's dtype; the decays and the
    C.B scores are taken in f32 and cast, as in the JAX package.
    """
    b, slen, h, p = xdt.shape
    n = B_.shape[-1]
    if slen % chunk:
        raise ValueError(f"sequence {slen} is not a multiple of the SSD "
                         f"chunk {chunk}")
    nc = slen // chunk
    dt = xdt.dtype
    x_ = xdt.reshape(b, nc, chunk, h, p)
    dA_ = dA.reshape(b, nc, chunk, h).float()
    B2 = B_.reshape(b, nc, chunk, n)
    C2 = C_.reshape(b, nc, chunk, n)

    # intra-chunk: a decay-masked attention-like contraction
    Lm = torch.exp(_segsum(dA_.permute(0, 3, 1, 2)))         # (b,h,nc,Q,Q)
    scores = torch.einsum("bcin,bcjn->bcij", C2.float(), B2.float())
    y_intra = torch.einsum("bhcij,bcij,bcjhp->bcihp", Lm.to(dt),
                           scores.to(dt), x_)

    # per-chunk end states
    cs = torch.cumsum(dA_, dim=2)                             # (b,nc,Q,h)
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)
    S_c = torch.einsum("bcjn,bcjh,bcjhp->bchnp", B2, decay_to_end.to(dt), x_)

    # inter-chunk scan
    total = torch.exp(cs[:, :, -1, :]).to(dt)                 # (b,nc,h)
    state = (torch.zeros((b, h, n, p), dtype=dt, device=xdt.device)
             if h0 is None else h0)
    prevs = []
    for c in range(nc):
        prevs.append(state)
        state = state * total[:, c, :, None, None] + S_c[:, c]
    S_prevs = torch.stack(prevs, 1)                           # (b,nc,h,n,p)

    y_inter = torch.einsum("bcin,bcih,bchnp->bcihp", C2,
                           torch.exp(cs).to(dt), S_prevs)
    y = (y_intra + y_inter).reshape(b, slen, h, p)
    return y, state


def ssd_scan(xdt: torch.Tensor, dA: torch.Tensor, B_: torch.Tensor,
             C_: torch.Tensor, chunk: int,
             h0: Optional[torch.Tensor] = None):
    """``ssd_chunked``; on a mesh, a local region over the batch (on the
    data axes where they divide it) and the heads (on the model axis where
    it divides them), the sequence whole: each head's scan is independent,
    and B, C, shared by the heads, are whole on every rank."""
    extra = () if h0 is None else (h0,)
    if not L.on_mesh(xdt, dA, B_, C_, *extra):
        return ssd_chunked(xdt, dA, B_, C_, chunk, h0)
    ctx = get_activation_sharding()
    hm = ctx.model_axis if xdt.shape[2] % ctx.model_size == 0 else None

    def pl(*rest):
        return L.activation_placements(ctx, (ctx.batch(xdt.shape[0]),)
                                       + rest)
    x_pl, st_pl, bc_pl = pl(None, hm), pl(hm), pl()
    return L.local_region(
        lambda x_, a_, b_, c_, *h: ssd_chunked(x_, a_, b_, c_, chunk,
                                               h[0] if h else None),
        (x_pl, st_pl), (x_pl, pl(None, hm), bc_pl, bc_pl)
        + ((st_pl,) if extra else ()), xdt, dA, B_, C_, *extra)


def ssd_step(x1: torch.Tensor, dA1: torch.Tensor, B1: torch.Tensor,
             C1: torch.Tensor, state: torch.Tensor):
    """One-token recurrence. x1: (b, h, p) pre-scaled by dt; dA1: (b, h);
    B1, C1: (b, n); state: (b, h, n, p). Returns (y (b, h, p), state)."""
    decay = torch.exp(dA1.float()).to(x1.dtype)
    state = state * decay[..., None, None] + torch.einsum("bn,bhp->bhnp",
                                                          B1, x1)
    y = torch.einsum("bn,bhnp->bhp", C1, state)
    return y, state


# ---------------------------------------------------------------------------
# Mamba2 block


def _silu_f32(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(x.float()).to(x.dtype)


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    return L.rmsnorm(y * torch.nn.functional.silu(z.float()).to(y.dtype),
                     scale)


def _causal_conv_full(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, L, C); w: (W, C). On a mesh, a local
    region over the batch (on the data axes where they divide it) and the
    channels as ``param_specs`` places the weight (on the model axis or
    whole), the sequence whole."""
    if L.on_mesh(x, w, b):
        ctx = get_activation_sharding()
        m_dim = ctx.mesh.mesh_dim_names.index(ctx.model_axis)
        ch = ctx.model_axis if isinstance(w, DTensor) and isinstance(
            w.placements[m_dim], Shard) else None
        x_pl = L.activation_placements(ctx, (ctx.batch(x.shape[0]), None,
                                             ch))
        return L.local_region(_causal_conv_local, x_pl, (
            x_pl, L.activation_placements(ctx, (None, ch)),
            L.activation_placements(ctx, (ch,))), x, w, b)
    return _causal_conv_local(x, w, b)


def _causal_conv_local(x: torch.Tensor, w: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    W = w.shape[0]
    pad = torch.nn.functional.pad(x, (0, 0, W - 1, 0))
    out = 0
    for i in range(W):
        out = out + pad[:, i:i + x.shape[1], :] * w[i][None, None, :]
    return out + b[None, None, :]


def _conv_step(x1: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor):
    """x1: (B, C) one token; conv_state: (B, W-1, C)."""
    window = torch.cat([conv_state, x1[:, None, :]], dim=1)   # (B, W, C)
    out = torch.einsum("bwc,wc->bc", window, w) + b
    return out, window[:, 1:, :]


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return L.project("...d,dz->...z", x, w)


def mamba_block_full(x: torch.Tensor, p: Params, cfg: ArchConfig,
                     h0: Optional[torch.Tensor] = None,
                     mask: Optional[torch.Tensor] = None):
    """x: (B, L, d). Returns (y (B, L, d), final ssm state (B, h, n, p)).

    ``mask``: optional (B, L) bool validity of right-padded prompts. Padded
    positions get dt = 0, so their decay is 1 and their input 0: the
    recurrence is the identity there and the final state is the state
    after the last valid token.
    """
    B, Lseq, _ = x.shape
    di, h, pdim, _ = mamba_dims(cfg)
    n = cfg.ssm_state
    x = L.gather_seq(x)
    z = _proj(x, p["w_z"])
    xs = _proj(x, p["w_x"])
    bc = _proj(x, p["w_bc"])
    dt = _proj(x.float(), p["w_dt"])
    xs = _silu_f32(_causal_conv_full(xs, p["conv_x_w"], p["conv_x_b"]))
    bc = _silu_f32(_causal_conv_full(bc, p["conv_bc_w"], p["conv_bc_b"]))
    Bm, Cm = bc[..., :n], bc[..., n:]
    dt = torch.nn.functional.softplus(dt + p["dt_bias"])          # (B,L,h)
    if mask is not None:
        dt = dt * mask[..., None].to(dt.dtype)
    A = -torch.exp(p["A_log"])                                    # (h,)
    dA = dt * A
    xh = xs.reshape(B, Lseq, h, pdim)
    xdt = xh * dt[..., None].to(x.dtype)
    y, state = ssd_scan(xdt, dA, Bm, Cm, min(cfg.ssm_chunk, Lseq), h0)
    y = y + xh * p["D"][None, None, :, None].to(x.dtype)
    y = _gated_rmsnorm(y.reshape(B, Lseq, di), z, p["norm"])
    return _proj(y, p["out_proj"]), state


def mamba_block_step(x1: torch.Tensor, p: Params, cfg: ArchConfig,
                     ssm_state: torch.Tensor, conv_state: torch.Tensor):
    """x1: (B, 1, d) one token. Returns (y (B, 1, d), (ssm_state,
    conv_state)); conv_state (B, W-1, di + 2n) holds the x and BC conv
    tails side by side."""
    B = x1.shape[0]
    di, h, pdim, _ = mamba_dims(cfg)
    n = cfg.ssm_state
    x0 = x1[:, 0, :]
    z = _proj(x0, p["w_z"])
    xs = _proj(x0, p["w_x"])
    bc = _proj(x0, p["w_bc"])
    dt = _proj(x0.float(), p["w_dt"])
    xs, cs_x = _conv_step(xs, conv_state[..., :di], p["conv_x_w"],
                          p["conv_x_b"])
    bc, cs_bc = _conv_step(bc, conv_state[..., di:], p["conv_bc_w"],
                           p["conv_bc_b"])
    conv_state = torch.cat([cs_x, cs_bc], dim=-1)
    xs = _silu_f32(xs)
    bc = _silu_f32(bc)
    Bm, Cm = bc[..., :n], bc[..., n:]
    dt = torch.nn.functional.softplus(dt + p["dt_bias"])          # (B,h)
    dA = dt * -torch.exp(p["A_log"])
    xh = xs.reshape(B, h, pdim)
    y, ssm_state = ssd_step(xh * dt[..., None].to(x1.dtype), dA, Bm, Cm,
                            ssm_state)
    y = y + xh * p["D"][None, :, None].to(x1.dtype)
    y = _gated_rmsnorm(y.reshape(B, 1, di), z[:, None, :], p["norm"])
    return _proj(y, p["out_proj"]), (ssm_state, conv_state)


def mamba_conv_tail(x: torch.Tensor, p: Params, cfg: ArchConfig,
                    length: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The conv state after a prefill: the last W-1 conv inputs (pre-conv
    x and BC projections) of each sequence, (B, W-1, di + 2n). With
    ``length`` (B,) they are the last W-1 *valid* inputs, at positions
    length-(W-1)..length-1, zero rows where that underflows (the causal
    conv's implicit zero padding)."""
    W1 = CONV_WIDTH - 1
    x = L.gather_seq(x)
    if length is None:
        tail = x[:, -W1:, :]
        valid = None
    else:
        idx = length.reshape(-1, 1).long() - W1 + torch.arange(
            W1, device=x.device)
        tail = torch.gather(x, 1, torch.clamp(idx, min=0)[..., None]
                            .expand(-1, -1, x.shape[2]))
        valid = (idx >= 0)[..., None]
    out = torch.cat([_proj(tail, p["w_x"]), _proj(tail, p["w_bc"])], dim=-1)
    if valid is not None:
        out = out.masked_fill(~valid, 0.0)
    return out


# ---------------------------------------------------------------------------
# Zamba2: groups of ``shared_attn_every`` Mamba layers, each followed by
# the shared block, then a Mamba tail


def _zamba_groups(cfg: ArchConfig) -> Tuple[int, int]:
    """(n_groups, n_tail): layers = n_groups * shared_attn_every + n_tail."""
    g = cfg.n_layers // cfg.shared_attn_every
    return g, cfg.n_layers - g * cfg.shared_attn_every


def _mamba_layer(params: Params, i: int) -> Params:
    """Mamba layer ``i``'s parameters as views into the stacked tree."""
    return {k: w[i] for k, w in params["mamba"].items()}


def _split_mamba_stack(cfg: ArchConfig):
    """The layer order of the stack: ``(group, [layer ids])`` for each
    group, then the tail's layer ids (group None)."""
    g, tail = _zamba_groups(cfg)
    per = cfg.shared_attn_every
    order = [(j, list(range(j * per, (j + 1) * per))) for j in range(g)]
    order.append((None, list(range(g * per, g * per + tail))))
    return order


def _shared_block(cfg: ArchConfig, x, shared: Params, positions):
    """The shared transformer block over a whole sequence (causal); returns
    (x, k, v) with its roped k/v (B, S, K, D)."""
    return T._self_block(cfg, x, shared, positions)


def forward_zamba(cfg: ArchConfig, params: Params,
                  tokens: torch.Tensor) -> torch.Tensor:
    """The causal forward of training: tokens (B, S) -> logits (B, S, V)
    f32. Remat as ``repro``'s: each group (its Mamba layers and the shared
    block) is a remat body holding one per Mamba layer, and so is each
    tail layer."""
    positions = T._positions(tokens)
    x = L.embed_tokens(tokens, params["embed"], T.DTYPES[cfg.dtype])
    layers = T.unstack(params["mamba"], cfg.n_layers)
    shared = params["shared"]

    def mamba(x, blk):
        return L.constrain_residual(x + mamba_block_full(x, blk, cfg)[0])

    def group(x, blks):
        for blk in blks:
            x = T.remat(cfg, mamba, x, blk)
        return _shared_block(cfg, x, shared, positions)[0]

    for grp, ids in _split_mamba_stack(cfg):
        if grp is not None:
            x = T.remat(cfg, group, x, [layers[i] for i in ids])
        else:
            for i in ids:
                x = T.remat(cfg, mamba, x, layers[i])
    return T._logits(params, x)


def prefill_zamba(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
                  length: Optional[torch.Tensor] = None):
    """tokens (B, S) right-padded; ``length`` (B,) valid prefix lengths.

    Mamba layers mask dt at padded positions (the identity recurrence) and
    take the conv tail at the last valid inputs; the shared block is
    causal, so its valid positions ignore the padding. Returns next-token
    logits (B, 1, V) f32 and the cache: ``"ssm"`` (L, B, h, n, p),
    ``"conv"`` (L, B, W-1, di + 2n) and the shared block's ``"k"``/``"v"``
    (g, B, S, K, D), one per call.
    """
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)[None, :]
    mask = None if length is None else \
        positions < length.reshape(-1, 1)
    x = L.embed_tokens(tokens, params["embed"], T.DTYPES[cfg.dtype])
    states, convs, ks, vs = [], [], [], []
    for grp, layers in _split_mamba_stack(cfg):
        for i in layers:
            blk = _mamba_layer(params, i)
            out, state = mamba_block_full(x, blk, cfg, mask=mask)
            states.append(state)
            convs.append(mamba_conv_tail(x, blk, cfg, length))
            x = L.constrain_residual(x + out)
        if grp is not None:
            x, k, v = _shared_block(cfg, x, params["shared"], positions)
            ks.append(k)
            vs.append(v)
    cache = {"ssm": torch.stack(states), "conv": torch.stack(convs),
             "k": torch.stack(ks), "v": torch.stack(vs)}
    return T._head(cfg, params, x, length), cache


def decode_zamba(cfg: ArchConfig, params: Params, cache, token: torch.Tensor,
                 pos: torch.Tensor) -> Tuple[torch.Tensor, Any]:
    """One token per slot: token (B, 1), pos (B,) int32.

    With a ``"bt"`` block table the shared block's ``"k"``/``"v"`` are
    shared pools (g, n_phys, ps, K, D); without one they are the
    contiguous (g, B, S_max, K, D) rows. ``"ssm"`` and ``"conv"`` stay
    indexed by slot. Every leaf is updated in place. Returns (logits
    (B, 1, V) f32, cache).
    """
    bt = cache.get("bt")
    ssm, conv = cache["ssm"], cache["conv"]
    x = L.embed_tokens(token, params["embed"], T.DTYPES[cfg.dtype])
    for grp, layers in _split_mamba_stack(cfg):
        for i in layers:
            out, (st, cv) = mamba_block_step(x, _mamba_layer(params, i), cfg,
                                             ssm[i], conv[i])
            ssm[i].copy_(st)
            conv[i].copy_(cv)
            x = x + out
        if grp is not None:
            x = T._decode_block(cfg, x, params["shared"], cache["k"][grp],
                                cache["v"][grp], bt, pos)
    return T._head(cfg, params, x), cache


def zamba_cache_shapes(cfg: ArchConfig, batch: int, max_len: int):
    """name -> (shape, dtype) of the zamba decode cache, contiguous."""
    _, h, pdim, ci = mamba_dims(cfg)
    g, _ = _zamba_groups(cfg)
    dtype = T.DTYPES[cfg.dtype]
    kv = (g, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"ssm": ((cfg.n_layers, batch, h, cfg.ssm_state, pdim), dtype),
            "conv": ((cfg.n_layers, batch, CONV_WIDTH - 1, ci), dtype),
            "k": (kv, dtype), "v": (kv, dtype)}
