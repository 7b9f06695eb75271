"""The two attention geometries of the registry that no other configuration
has, on the CPU against the JAX package: phi3-mini-3.8b's head_dim 96
and qwen3-moe-235b-a22b's G = 16 query heads per KV head.

Kernel level: each kernel's plain version (what its wrapper computes on a
CPU tensor) at D 96 and at G 16 against the Pallas kernel in interpret
mode and ``repro.kernels.ref``, on seeded numpy inputs, f32: flash causal
and not, the fused paged decode (pools and output), the contiguous
decode with a scalar length and with per-slot lengths (against the ref:
the Pallas kernel takes a scalar), and the attend-only paged decode.

Model level: a phi3-shaped model (head_dim 96, 2 layers) and a
qwen3-shaped one (16 query heads on 1 KV head, 2 layers, 4 experts top
2), the port's weights carried across from the JAX init by the weight
converter: prefill and paged decode logits within f32 tolerance, and the
engines' greedy tokens and counts equal.

The card's bodies at these geometries: ``tests/test_torch_cuda.py`` (``-k
geometr``) and ``chip_smoke.py`` phases 2-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as j_decode
from repro.kernels.decode_attention import \
    fused_paged_decode_attention as j_fused
from repro.kernels.decode_attention import \
    paged_decode_attention as j_paged
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models import build_model as j_build
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs.registry import ARCHS as T_ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.kernels.decode_attention import (
    decode_attention, fused_paged_decode_attention, paged_decode_attention)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import build_model as t_build
from repro_torch.serving.engine import Request, ServingEngine
from test_torch_kernels import _fused_inputs, _paged_decode_inputs
from test_torch_layout import assert_counts, drive, mixed_stream, requests

# six xdist workers share the cores with XLA's threads: one torch thread
# each keeps them from oversubscribing
torch.set_num_threads(1)

# f32 sums taken in another order by two frameworks
TOL = dict(rtol=2e-5, atol=2e-5)
PHI3 = "phi3-mini-3.8b"
QWEN = "qwen3-moe-235b-a22b"
# (K, G, D): phi3-mini's 32 heads of 96 (G 1) and qwen3-moe's 64 over 4 (G
# 16, D 64), narrowed to few KV heads; and both at once
GEOMETRIES = [(2, 1, 96), (1, 16, 64), (1, 16, 96)]


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# kernel level: the plain versions against the Pallas kernels


@pytest.mark.parametrize("causal,S,T,q_off,vlen", [
    (True, 64, 64, 0, None), (True, 64, 128, 64, 100),
    (False, 64, 128, 0, 90)])
@pytest.mark.parametrize("K,G,D", GEOMETRIES)
def test_flash_plain_matches_pallas_at_registry_geometry(K, G, D, causal, S,
                                                         T, q_off, vlen):
    """The plain flash attention in the model layout (B, S, K, G, D) ==
    the Pallas kernel (interpret mode) and repro's ref in (B, H, S, D)."""
    B = 2
    rng = np.random.default_rng(K * G + D + S + T)
    q, k, v = (_randn(rng, B, S, K, G, D), _randn(rng, B, T, K, D),
               _randn(rng, B, T, K, D))
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal,
                          q_offset=q_off, valid_len=vlen).numpy()
    qh = jnp.asarray(q).transpose(0, 2, 3, 1, 4).reshape(B, K * G, S, D)
    kh = jnp.asarray(k).transpose(0, 2, 1, 3)
    vh = jnp.asarray(v).transpose(0, 2, 1, 3)
    want_k = j_flash(qh, kh, vh, None if vlen is None else jnp.int32(vlen),
                     causal=causal, q_offset=q_off, interpret=True)
    want_r = jref.flash_attention_ref(qh, kh, vh, causal=causal,
                                      q_offset=q_off, kv_valid_len=vlen)
    for want in (want_k, want_r):
        want = np.asarray(want).reshape(B, K, G, S, D).transpose(0, 3, 1, 2,
                                                                 4)
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("K,G,D", GEOMETRIES)
def test_fused_paged_plain_matches_pallas_at_registry_geometry(K, G, D):
    """The plain fused paged decode == the Pallas kernel (interpret mode):
    both pools bit for bit (trash page included) and every live slot's
    output, with a first-token slot, one on a page boundary and an
    all-sentinel slot."""
    case = (3, K, G, 12, 8, 4, D)
    q, kn, vn, kp, vp, bt, pos, _ = _fused_inputs(case, K * G + D)
    out, kp2, vp2 = fused_paged_decode_attention(
        _t(q), _t(kn), _t(vn), _t(kp), _t(vp), _t(bt), _t(pos))
    jo, jkp, jvp = j_fused(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                           jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
                           jnp.asarray(pos), interpret=True)
    np.testing.assert_array_equal(kp2.numpy(), np.asarray(jkp))
    np.testing.assert_array_equal(vp2.numpy(), np.asarray(jvp))
    np.testing.assert_allclose(out.numpy()[:-1], np.asarray(jo)[:-1], **TOL)


@pytest.mark.parametrize("T,vlen", [(128, None), (128, 77)])
@pytest.mark.parametrize("K,G,D", GEOMETRIES)
def test_decode_plain_matches_pallas_at_registry_geometry(K, G, D, T, vlen):
    """The plain contiguous decode in the model layout (B, T, K, D) with a
    scalar length == the Pallas kernel (interpret mode) and repro's ref;
    with per-slot lengths (0, 1, a 64-row tile edge, T) == the ref at
    each slot's length, zeros at length 0."""
    B = 4
    rng = np.random.default_rng(K * G + D + T + (vlen or 0))
    q, k, v = (_randn(rng, B, K, G, D), _randn(rng, B, T, K, D),
               _randn(rng, B, T, K, D))
    jq = jnp.asarray(q)
    jk = jnp.asarray(k).transpose(0, 2, 1, 3)
    jv = jnp.asarray(v).transpose(0, 2, 1, 3)
    got = decode_attention(_t(q), _t(k), _t(v), vlen).numpy()
    for want in (j_decode(jq, jk, jv, vlen, interpret=True),
                 jref.decode_attention_ref(jq, jk, jv,
                                           T if vlen is None else vlen)):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
    lens = np.array([0, 1, 64, T], np.int32)
    got = decode_attention(_t(q), _t(k), _t(v), _t(lens)).numpy()
    want = jref.decode_attention_ref(jq, jk, jv,
                                     jnp.asarray(lens)[:, None, None, None])
    np.testing.assert_allclose(got[1:], np.asarray(want)[1:], **TOL)
    assert not got[0].any()


@pytest.mark.parametrize("K,G,D", GEOMETRIES)
def test_paged_decode_plain_matches_pallas_at_registry_geometry(K, G, D):
    """The plain attend-only paged decode == the Pallas kernel (interpret
    mode): valid_len 0, a page boundary, sentinel and out-of-pool
    entries."""
    q, kp, vp, bt, vlen = _paged_decode_inputs(K * G + D, K=K, G=G, D=D)
    got = paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt),
                                 _t(vlen)).numpy()
    want = j_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                   jnp.asarray(bt), jnp.asarray(vlen), interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert not got[0].any()


# ---------------------------------------------------------------------------
# model level: phi3- and qwen3-shaped models against the JAX package

# the narrowings: phi3-mini's head_dim 96 at G 1; qwen3-moe's G 16 on one
# KV head (4 experts top 2); 2 layers each, f32
SHAPES = {PHI3: dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
                     head_dim=96),
          QWEN: dict(n_layers=2, d_model=64, n_heads=16, n_kv_heads=1,
                     head_dim=16, n_experts=4, top_k=2)}
KW = dict(max_batch=3, max_len=64, decode_block=4, min_bucket=4)


@functools.lru_cache(maxsize=None)
def shaped(arch):
    """(JAX model, JAX params, port model, port params) of ``arch``'s
    reduced config at the geometry of ``SHAPES``."""
    jcfg = dataclasses.replace(J_ARCHS[arch].reduced(), **SHAPES[arch])
    tcfg = dataclasses.replace(T_ARCHS[arch].reduced(), **SHAPES[arch])
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, t_build(tcfg, device="cpu"), \
        params_from_jax(jp, device="cpu")


@pytest.mark.parametrize("arch", [PHI3, QWEN])
def test_shaped_configs_keep_the_geometry(arch):
    _, _, tm, _ = shaped(arch)
    cfg = tm.cfg
    want = (96, 1) if arch == PHI3 else (16, 16)
    assert (cfg.head_dim, cfg.q_per_kv) == want
    assert cfg.n_layers == 2


@pytest.mark.parametrize("arch", [PHI3, QWEN])
def test_shaped_prefill_and_paged_decode_match_jax(arch):
    """Prefill of right-padded prompts, then three decode steps through an
    identity block table: logits and k/v leaves equal ``repro``'s within
    f32 tolerance."""
    jm, jp, tm, tp = shaped(arch)
    B, S, Lm, ps = 2, 16, 32, 8
    lens = np.array([16, 11], np.int32)
    rng = np.random.default_rng(0)
    toks = np.zeros((B, S), np.int32)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(0, tm.cfg.vocab, size=n)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "length": jnp.asarray(lens)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long(),
                             "length": torch.from_numpy(lens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    P = Lm // ps
    bt = np.arange(B * P, dtype=np.int32).reshape(B, P)
    jcache, tcache = {"bt": jnp.asarray(bt)}, {"bt": torch.from_numpy(bt)}
    for name in ("k", "v"):
        leaf = np.asarray(jc[name])
        np.testing.assert_allclose(tc[name].numpy(), leaf, err_msg=name,
                                   **TOL)
        full = np.zeros(leaf.shape[:2] + (Lm,) + leaf.shape[3:], np.float32)
        full[:, :, :S] = leaf
        full = full.reshape((full.shape[0], B * P, ps) + full.shape[3:])
        jcache[name] = jnp.asarray(full)
        tcache[name] = torch.from_numpy(full.copy())
    pos = lens.copy()
    for _ in range(3):
        tok = rng.integers(0, tm.cfg.vocab, (B, 1)).astype(np.int32)
        jl, jcache = jm.decode(jp, jcache, jnp.asarray(tok), jnp.asarray(pos))
        tl, tcache = tm.decode(tp, tcache, torch.from_numpy(tok),
                               torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[name].numpy(),
                                       np.asarray(jcache[name]),
                                       err_msg=name, **TOL)
        pos = pos + 1


@pytest.mark.parametrize("arch", [PHI3, QWEN])
def test_shaped_engine_greedy_tokens_match_jax(arch):
    """The port's engine and the JAX engine on one mixed stream, paged
    (pages of 8): equal greedy tokens, completion order and counts."""
    jm, jp, tm, tp = shaped(arch)
    spec = mixed_stream(tm.cfg.vocab)
    kw = dict(KW, page_size=8)
    jeng = JEngine(jm, jp, **kw)
    jreqs = requests(JRequest, spec)
    jorder = drive(jeng, jreqs)
    eng = ServingEngine(tm, tp, **kw)
    reqs = requests(Request, spec)
    order = drive(eng, reqs)
    for i, (a, b) in enumerate(zip(reqs, jreqs)):
        np.testing.assert_array_equal(np.asarray(a.tokens),
                                      np.asarray(b.tokens), err_msg=f"{i}")
    assert order == jorder
    assert_counts(eng, dict(jeng.stats))
