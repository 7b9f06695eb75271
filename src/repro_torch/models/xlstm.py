"""xLSTM backbone [arXiv:2405.04517] (``repro.models.xlstm``):
chunkwise-parallel mLSTM blocks with one
sequential sLSTM block every ``slstm_every`` layers.

mLSTM: a matrix memory C (dk x dv per head) with exponential input gating
and a log-sigmoid forget gate. The chunkwise form stabilizes the
exponentials with a running max carried across chunks, the recurrent
stabilizer m_t of the paper; ``mlstm_recurrent`` is the one-token form,
the decode path and the chunked form's oracle. sLSTM: a scalar memory
whose gates read the previous hidden state through block-diagonal
(per-head) weights, so it is sequential over the prompt: a Python loop of
S steps per sLSTM layer, inside the prefill program.

No attention and no kernel: the cells are XLA in the JAX package, outside
any Pallas kernel, and plain PyTorch here. Both states are O(1) in the
sequence length; every state leaf is f32 and indexed by slot, with no
sequence axis, so the serving engine has nothing to page. The empty state
is not all zeros: the stabilizers ``mm``/``sm`` start at -1e30 and the
sLSTM normalizer ``sn`` at 1e-6 (``xlstm_empty_state``).

Parameters are stacked on a leading layer axis, as in the JAX package, and
the layer loops are Python loops over per-layer views. Decode updates the
state leaves in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.parallel import get_activation_sharding
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Params = Dict[str, Any]
NEG = -1e30          # the stabilizers' empty value
N_FLOOR = 1e-6       # the sLSTM normalizer's floor and empty value


def xlstm_groups(cfg: ArchConfig) -> Tuple[int, int]:
    """(n_groups, m_per_group): layers = n_groups * (m_per_group + 1)."""
    per = cfg.slstm_every
    if cfg.n_layers % per:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"slstm_every {per}")
    return cfg.n_layers // per, per - 1


def slstm_ffn_width(d: int) -> int:
    return max(128, int(d * 4 / 3) // 64 * 64)


# ---------------------------------------------------------------------------
# init (seeded by a torch.Generator on the target device)


def _mlstm_stack_init(cfg: ArchConfig, gen: torch.Generator, n: int, dtype,
                      device) -> Params:
    d, H = cfg.d_model, cfg.n_heads
    f32 = torch.float32
    kw = dict(device=device)
    return {
        "w_up": L.dense_init(gen, (n, d, 2 * d), dtype, 1, **kw),
        "wq": L.dense_init(gen, (n, d, d), dtype, 1, **kw),
        "wk": L.dense_init(gen, (n, d, d), dtype, 1, **kw),
        "wv": L.dense_init(gen, (n, d, d), dtype, 1, **kw),
        "w_gate": L.dense_init(gen, (n, d, 2 * H), f32, 1, **kw),
        # input gate bias 0, forget gate bias 3
        "gate_bias": torch.cat([torch.zeros((n, H), dtype=f32, **kw),
                                torch.full((n, H), 3.0, dtype=f32, **kw)],
                               dim=-1),
        "w_down": L.dense_init(gen, (n, d, d), dtype, 1, **kw),
        "ln": torch.zeros((n, d), dtype=dtype, **kw),
    }


def _slstm_stack_init(cfg: ArchConfig, gen: torch.Generator, n: int, dtype,
                      device) -> Params:
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    f = slstm_ffn_width(d)
    f32 = torch.float32
    kw = dict(device=device)
    return {
        "w_in": L.dense_init(gen, (n, d, 4 * d), dtype, 1, **kw),
        # recurrent block-diagonal weights, one (hd, hd) block per gate
        # and head
        "r": L.dense_init(gen, (n, 4, H, hd, hd), f32, -2, **kw),
        # z, i, f, o: the forget gate's bias 3, the others 0
        "bias": torch.cat([torch.zeros((n, 2 * d), dtype=f32, **kw),
                           torch.full((n, d), 3.0, dtype=f32, **kw),
                           torch.zeros((n, d), dtype=f32, **kw)], dim=-1),
        "ln": torch.zeros((n, d), dtype=dtype, **kw),
        "ln2": torch.zeros((n, d), dtype=dtype, **kw),
        "ffn": {
            "w_gate": L.dense_init(gen, (n, d, f), dtype, 1, **kw),
            "w_up": L.dense_init(gen, (n, d, f), dtype, 1, **kw),
            "w_down": L.dense_init(gen, (n, f, d), dtype, 1, **kw),
        },
    }


def init_xlstm(cfg: ArchConfig, gen: torch.Generator, device) -> Params:
    """Embedding, the mLSTM and sLSTM stacks, final norm, head."""
    dtype = T.DTYPES[cfg.param_dtype]
    g, m_per = xlstm_groups(cfg)
    return {
        "embed": L.embed_init(gen, (cfg.vocab, cfg.d_model), dtype,
                              device=device),
        "mlstm": _mlstm_stack_init(cfg, gen, g * m_per, dtype, device),
        "slstm": _slstm_stack_init(cfg, gen, g, dtype, device),
        "ln_f": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        "head": L.embed_init(gen, (cfg.vocab, cfg.d_model), dtype,
                             device=device),
    }


# ---------------------------------------------------------------------------
# mLSTM cell


def _mlstm_state0(B: int, H: int, D: int, device):
    f32 = torch.float32
    return (torch.zeros((B, H, D, D), dtype=f32, device=device),
            torch.zeros((B, H, D), dtype=f32, device=device),
            torch.full((B, H), NEG, dtype=f32, device=device))


def mlstm_chunked(q, k, v, log_i, log_f, chunk: int, state=None):
    """The chunkwise-parallel mLSTM. q, k, v: (B, S, H, D); log_i, log_f:
    (B, S, H) f32; ``S`` a multiple of ``chunk``.

    Returns (h (B, S, H, D) in q's dtype, state = (C_hat (B, H, D, D),
    n_hat (B, H, D), m (B, H)), all f32). Stabilized: the true C_t is
    exp(m_t) * C_hat_t. With csf_t the inclusive in-chunk cumsum of log_f
    and a_j = log_i_j - csf_j, the true state is C_t = exp(csf_t) [sum_{j
    <= t} exp(a_j) k_j v_j^T + exp(m0) C_hat0], and the stabilizer m_t =
    csf_t + max(m0, cummax_{j <= t} a_j), m0 the carried full m.
    """
    B, S, H, D = q.shape
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the mLSTM "
                         f"chunk {chunk}")
    nc = S // chunk
    f32 = torch.float32
    scale = D ** -0.5
    qc = q.reshape(B, nc, chunk, H, D)
    kc = k.reshape(B, nc, chunk, H, D) * scale
    vc = v.reshape(B, nc, chunk, H, D)
    li = log_i.reshape(B, nc, chunk, H).float()
    lf = log_f.reshape(B, nc, chunk, H).float()
    C_hat, n_hat, m_prev = (_mlstm_state0(B, H, D, q.device) if state is None
                            else state)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=q.device))[None, :, :, None]
    hs = []
    for c in range(nc):
        qj, kj, vj, lij, lfj = qc[:, c], kc[:, c], vc[:, c], li[:, c], lf[:, c]
        csf = torch.cumsum(lfj, dim=1)                       # (B,Q,H)
        a = lij - csf
        run_amax = torch.cummax(a, dim=1).values
        m_loc = torch.maximum(run_amax, m_prev[:, None, :])
        # intra-chunk decay-scaled scores
        dmat = torch.exp(a[:, None, :, :] - m_loc[:, :, None, :])
        dmat = dmat.masked_fill(~mask, 0.0)                  # (B,Qi,Qj,H)
        qf, kf, vf = qj.to(f32), kj.to(f32), vj.to(f32)
        scores = torch.einsum("bihd,bjhd->bijh", qf, kf)
        w = scores * dmat
        num_intra = torch.einsum("bijh,bjhd->bihd", w, vf)
        # the denominator uses k, not v: n.q = sum_j weight_j (k_j.q_t)
        den_intra = torch.sum(w, dim=2)                      # (B,Qi,H)
        # the carried state's contribution
        inter_w = torch.exp(m_prev[:, None, :] - m_loc)      # (B,Q,H)
        num_inter = torch.einsum("bihd,bhde->bihe", qf, C_hat) \
            * inter_w[..., None]
        den_inter = torch.einsum("bihd,bhd->bih", qf, n_hat) * inter_w
        num = num_intra + num_inter
        den = den_intra + den_inter
        # h = C q / max(|n.q|, 1) in true space
        m_full = csf + m_loc
        denom = torch.maximum(torch.abs(den), torch.exp(-m_full))
        hs.append((num / denom[..., None]).to(q.dtype))
        # end-of-chunk state, in hat space w.r.t. m_tilde; the carried m
        # is the full m_tilde + csf_total
        m_tilde = torch.maximum(run_amax[:, -1, :], m_prev)
        wght = torch.exp(a - m_tilde[:, None, :])            # (B,Q,H)
        decay = torch.exp(m_prev - m_tilde)
        C_hat = C_hat * decay[..., None, None] + torch.einsum(
            "bjh,bjhd,bjhe->bhde", wght, kf, vf)
        n_hat = n_hat * decay[..., None] + torch.einsum(
            "bjh,bjhd->bhd", wght, kf)
        m_prev = m_tilde + csf[:, -1, :]
    h = torch.stack(hs, dim=1).reshape(B, S, H, D)
    return h, (C_hat, n_hat, m_prev)


def mlstm_recurrent(q, k, v, log_i, log_f, state=None):
    """The step-by-step mLSTM, the decode path and the chunked form's
    oracle. Same shapes and returns as ``mlstm_chunked``."""
    B, S, H, D = q.shape
    f32 = torch.float32
    scale = D ** -0.5
    C, n, m = _mlstm_state0(B, H, D, q.device) if state is None else state
    hs = []
    for t in range(S):
        qt = q[:, t].to(f32)
        kt = k[:, t].to(f32) * scale
        vt = v[:, t].to(f32)
        lit, lft = log_i[:, t].float(), log_f[:, t].float()
        m_new = torch.maximum(lft + m, lit)                  # (B,H)
        fw = torch.exp(lft + m - m_new)
        iw = torch.exp(lit - m_new)
        C = C * fw[..., None, None] + iw[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = n * fw[..., None] + iw[..., None] * kt
        num = torch.einsum("bhd,bhde->bhe", qt, C)
        den = torch.einsum("bhd,bhd->bh", qt, n)
        denom = torch.maximum(torch.abs(den), torch.exp(-m_new))
        hs.append(num / denom[..., None])
        m = m_new
    return torch.stack(hs, dim=1).to(q.dtype), (C, n, m)


def _mlstm_cell(q, k, v, log_i, log_f, chunk: int, state, mode: str):
    """The mLSTM cell over heads: q, k, v (B, S, H * D), log_i, log_f (B,
    S, H); returns (h (B, S, H * D), state) by ``mlstm_chunked`` or
    ``mlstm_recurrent``. On a mesh, a local region over the batch (on the
    data axes where they divide it) and the heads (on the model axis where
    it divides them: q, k, v shard their columns a head at a time), each
    rank running its heads' chunk loop or recurrence whole; the state
    takes the same placements."""
    def cell(q, k, v, log_i, log_f, *st):
        B, S, HD = q.shape
        heads = (B, S, log_i.shape[-1], HD // log_i.shape[-1])
        fn = mlstm_chunked if mode == "chunked" else mlstm_recurrent
        args = (q.reshape(heads), k.reshape(heads), v.reshape(heads),
                log_i, log_f) + ((chunk,) if mode == "chunked" else ())
        h, new = fn(*args, st or None)
        return (h.reshape(B, S, HD),) + tuple(new)

    state = tuple(state) if state is not None else ()
    if not L.on_mesh(q, k, v, log_i, log_f, *state):
        h, *new = cell(q, k, v, log_i, log_f, *state)
        return h, tuple(new)
    ctx = get_activation_sharding()
    dax = ctx.batch(q.shape[0])
    hm = ctx.model_axis if log_i.shape[-1] % ctx.model_size == 0 else None

    def pl(*rest):
        return L.activation_placements(ctx, (dax,) + rest)
    seq = pl(None, hm)              # q, k, v, the gates and h
    st_pl = (pl(hm), pl(hm), pl(hm))
    h, *new = L.local_region(
        cell, (seq,) + st_pl, (seq,) * 5 + (st_pl if state else ()),
        q, k, v, log_i, log_f, *state)
    return h, tuple(new)


def _mlstm_gates(xm, blk):
    H = blk["gate_bias"].shape[-1] // 2
    raw = L.project("bsd,dg->bsg", xm.float(), blk["w_gate"])
    raw = raw + blk["gate_bias"][None, None, :]
    return raw[..., :H], L.pointwise(F.logsigmoid, raw[..., H:])


def mlstm_block(x, blk, cfg: ArchConfig, state=None, mode: str = "chunked",
                mask=None):
    """x: (B, S, d). Returns (y, new_state).

    ``mask``: optional (B, S) bool validity of right-padded prompts. Masked
    positions get log_i = -1e30 (no input) and log_f = 0 (keep), the
    identity on the (C, n, m) state once a valid token has been seen,
    which right padding guarantees."""
    B, S, d = x.shape
    h_in = L.gather_seq(L.rmsnorm(x, blk["ln"]))
    up = L.project("bsd,dz->bsz", h_in, blk["w_up"])
    xm, z = up[..., :d], up[..., d:]
    q = L.project("bsd,de->bse", xm, blk["wq"])
    k = L.project("bsd,de->bse", xm, blk["wk"])
    v = L.project("bsd,de->bse", xm, blk["wv"])
    log_i, log_f = _mlstm_gates(xm, blk)
    if mask is not None:
        keep = mask[..., None]
        log_i = log_i.masked_fill(~keep, NEG)
        log_f = log_f.masked_fill(~keep, 0.0)
    h, new_state = _mlstm_cell(q, k, v, log_i, log_f,
                               min(cfg.ssm_chunk, S), state, mode)
    h = h * F.silu(z.float()).to(x.dtype)
    return L.project("bsd,de->bse", h, blk["w_down"]), new_state


# ---------------------------------------------------------------------------
# sLSTM


def slstm_state0(B: int, d: int, device):
    """(h, c, n, m) of a sequence that has seen no token."""
    f32 = torch.float32
    zeros = torch.zeros((B, d), dtype=f32, device=device)
    return (zeros, zeros.clone(), torch.full((B, d), N_FLOOR, dtype=f32,
                                             device=device),
            torch.full((B, d), NEG, dtype=f32, device=device))


def slstm_scan(x_gates, r, bias, H: int, state=None, mask=None):
    """``_slstm_scan_local``; on a mesh, a local region over the batch (on
    the data axes where they divide it) with the heads whole on every
    rank: the gate-major columns interleave the heads, so no shard of the
    4d columns holds whole heads."""
    state = tuple(state) if state is not None else ()
    extra = () if mask is None else (mask,)
    if not L.on_mesh(x_gates, r, bias, *state, *extra):
        return _slstm_scan_local(x_gates, r, bias, H, state or None, mask)
    ctx = get_activation_sharding()

    def pl(n):
        return L.activation_placements(
            ctx, (ctx.batch(x_gates.shape[0]),) + (None,) * (n - 1))
    rep = L.activation_placements(ctx, ())

    def scan(xg, r_, b_, *rest):
        m_ = rest[-1] if mask is not None else None
        st = rest[:-1] if mask is not None else rest
        h, new = _slstm_scan_local(xg, r_, b_, H, st or None, m_)
        return (h,) + tuple(new)

    h, *new = L.local_region(
        scan, (pl(3),) + (pl(2),) * 4,
        (pl(3), rep, rep) + (pl(2),) * len(state) + (pl(2),) * len(extra),
        x_gates, r, bias, *state, *extra)
    return h, tuple(new)


def _slstm_scan_local(x_gates, r, bias, H: int, state=None, mask=None):
    """x_gates: (B, S, 4d) pre-activations (z, i, f, o, each d wide); r:
    (4, H, hd, hd) recurrent block-diagonal weights. Returns (h (B, S, d)
    f32, state (h, c, n, m)).

    ``mask``: optional (B, S) validity; the whole (h, c, n, m) carry is
    frozen at masked steps (h feeds the recurrence, so masking the gates
    alone would not hold it). A Python loop of S steps. The loop runs in a
    head-major layout: the carry is (H, B, hd), ``r`` is laid out once as
    (H, hd, 4 hd) and the pre-activations as (S, H, B, 4 hd), so a step's
    ``x + bias + h r`` is one ``baddbmm`` and no operand is copied a step.
    """
    B, S, G4 = x_gates.shape
    d = G4 // 4
    hd = d // H
    f32 = torch.float32
    # (B, S, 4, H, hd) -> (S, H, B, 4 hd): the gate-major columns of a head
    xb = (x_gates.float() + bias).reshape(B, S, 4, H, hd).permute(
        1, 3, 0, 2, 4).reshape(S, H, B, 4 * hd)
    R = r.to(f32).permute(1, 2, 0, 3).reshape(H, hd, 4 * hd)

    def heads(t):                                   # (B, d) -> (H, B, hd)
        return t.reshape(B, H, hd).transpose(0, 1)

    state = slstm_state0(B, d, x_gates.device) if state is None else state
    carry = torch.stack([heads(t) for t in state])  # (4, H, B, hd)
    keep = None if mask is None else mask.t()[:, None, :, None]
    hs = []
    for t in range(S):
        h_prev, c_prev, n_prev, m_prev = carry
        pre = torch.baddbmm(xb[t], h_prev, R)      # (H, B, 4 hd)
        z_ = torch.tanh(pre[..., :hd])
        i_ = pre[..., hd:2 * hd]
        log_f = F.logsigmoid(pre[..., 2 * hd:3 * hd])
        o_ = torch.sigmoid(pre[..., 3 * hd:])
        lfm = log_f + m_prev
        m_new = torch.maximum(lfm, i_)
        fw = torch.exp(lfm - m_new)
        iw = torch.exp(i_ - m_new)
        c = torch.addcmul(fw * c_prev, iw, z_)
        n = torch.addcmul(iw, fw, n_prev)
        h = o_ * c / torch.clamp(n, min=N_FLOOR)
        hs.append(h)
        new = torch.stack([h, c, n, m_new])
        carry = new if keep is None else torch.where(keep[t], new, carry)
    out = torch.stack(hs).permute(2, 0, 1, 3).reshape(B, S, d)
    final = carry.permute(0, 2, 1, 3).reshape(4, B, d)
    return out, tuple(final)


def slstm_block(x, blk, cfg: ArchConfig, state=None, mask=None):
    """x: (B, S, d). Returns (y, new_state); the caller adds the
    residual (``y`` is the block's output less ``x``, as in ``repro``)."""
    h_in = L.rmsnorm(x, blk["ln"])
    gates = L.project("bsd,dg->bsg", h_in, blk["w_in"])
    h, new_state = slstm_scan(gates, blk["r"], blk["bias"], cfg.n_heads,
                              state, mask)
    y = x + h.to(x.dtype)
    y = y + L.swiglu(L.rmsnorm(y, blk["ln2"]), blk["ffn"])
    return y - x, new_state


# ---------------------------------------------------------------------------
# full model


def forward_xlstm(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
                  mode: str = "chunked") -> torch.Tensor:
    """The forward of training: tokens (B, S) -> logits (B, S, V) f32, the
    mLSTM cells in ``mode`` (chunked by default). Remat as ``repro``'s:
    each group (its mLSTM blocks and its sLSTM block) is a remat body
    holding one per mLSTM block."""
    x = L.embed_tokens(tokens, params["embed"], T.DTYPES[cfg.dtype])
    g, m_per = xlstm_groups(cfg)
    mlstms = T.unstack(params["mlstm"], g * m_per)
    slstms = T.unstack(params["slstm"], g)

    def mlstm(x, blk):
        return L.constrain_residual(x + mlstm_block(x, blk, cfg,
                                                    mode=mode)[0])

    def group(x, m_blks, s_blk):
        for blk in m_blks:
            x = T.remat(cfg, mlstm, x, blk)
        return L.constrain_residual(x + slstm_block(x, s_blk, cfg)[0])

    for grp in range(g):
        x = T.remat(cfg, group, x, mlstms[grp * m_per:(grp + 1) * m_per],
                    slstms[grp])
    return T._logits(params, x)


def prefill_xlstm(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
                  length: Optional[torch.Tensor] = None,
                  mode: str = "chunked"):
    """tokens (B, S) right-padded; ``length`` (B,) valid prefix lengths: the
    mLSTM gates and the sLSTM carry are masked, so padded positions leave
    every state as it was. Returns next-token logits (B, 1, V) f32, read
    at position ``length - 1``, and the state cache
    (``xlstm_cache_shapes``). ``mode="recurrent"`` runs the mLSTM blocks
    step by step, the form decode takes, each cell from its own
    zero-token state."""
    S = tokens.shape[1]
    mask = None if length is None else \
        torch.arange(S, device=tokens.device)[None, :] < length.reshape(-1, 1)
    x = L.embed_tokens(tokens, params["embed"], T.DTYPES[cfg.dtype])
    g, m_per = xlstm_groups(cfg)
    mlstms = T.unstack(params["mlstm"], g * m_per)
    m_states, s_states = [], []
    for grp, s_blk in enumerate(T.unstack(params["slstm"], g)):
        for blk in mlstms[grp * m_per:(grp + 1) * m_per]:
            y, st = mlstm_block(x, blk, cfg, mask=mask, mode=mode)
            x = L.constrain_residual(x + y)
            m_states.append(st)
        y, st = slstm_block(x, s_blk, cfg, mask=mask)
        x = x + y
        s_states.append(st)
    cache = {name: torch.stack([s[i] for s in m_states])
             for i, name in enumerate(("mC", "mn", "mm"))}
    cache.update({name: torch.stack([s[i] for s in s_states])
                  for i, name in enumerate(("sh", "sc", "sn", "sm"))})
    return T._head(cfg, params, x, length), cache


def decode_xlstm(cfg: ArchConfig, params: Params, cache, token: torch.Tensor,
                 pos: torch.Tensor) -> Tuple[torch.Tensor, Any]:
    """One token per slot: token (B, 1); ``pos`` is unused (the recurrence
    has no position). Every state leaf of ``cache`` is updated in place.
    Returns (logits (B, 1, V) f32, cache)."""
    del pos
    x = L.embed_tokens(token, params["embed"], T.DTYPES[cfg.dtype])
    g, m_per = xlstm_groups(cfg)
    mlstms = T.unstack(params["mlstm"], g * m_per)
    for grp, s_blk in enumerate(T.unstack(params["slstm"], g)):
        for j in range(m_per):
            i = grp * m_per + j
            state = (cache["mC"][i], cache["mn"][i], cache["mm"][i])
            y, new = mlstm_block(x, mlstms[i], cfg, state=state,
                                 mode="recurrent")
            for leaf, t in zip(state, new):
                leaf.copy_(t)
            x = x + y
        state = tuple(cache[n][grp] for n in ("sh", "sc", "sn", "sm"))
        y, new = slstm_block(x, s_blk, cfg, state=state)
        for leaf, t in zip(state, new):
            leaf.copy_(t)
        x = x + y
    return T._head(cfg, params, x), cache


def xlstm_cache_shapes(cfg: ArchConfig, batch: int, max_len: int):
    """name -> (shape, dtype) of the state cache; no leaf has a sequence
    axis (``max_len`` is unused)."""
    del max_len
    g, m_per = xlstm_groups(cfg)
    n_m = g * m_per
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    f32 = torch.float32
    return {"mC": ((n_m, batch, H, hd, hd), f32),
            "mn": ((n_m, batch, H, hd), f32),
            "mm": ((n_m, batch, H), f32),
            "sh": ((g, batch, d), f32), "sc": ((g, batch, d), f32),
            "sn": ((g, batch, d), f32), "sm": ((g, batch, d), f32)}


def xlstm_empty_state(cfg: ArchConfig, batch: int,
                      device) -> Dict[str, torch.Tensor]:
    """The state of a sequence that has seen no token: zeros but for the
    stabilizers ``mm``/``sm`` at -1e30 and the sLSTM normalizer ``sn`` at
    1e-6, the values ``mlstm_recurrent``/``slstm_scan`` start from, so a
    decode from it equals a decode from scratch. The slot reset of chunked
    prefill, in-segment admission and recovery."""
    fill = {"mm": NEG, "sm": NEG, "sn": N_FLOOR}
    return {n: torch.full(sh, fill.get(n, 0.0), dtype=dt, device=device)
            for n, (sh, dt) in xlstm_cache_shapes(cfg, batch, 0).items()}
