"""The port's Mamba2 SSD math (``repro_torch.models.ssm``) on the CPU.

Mirrors the SSD cases of the reference's ``test_property_models.py`` with
hypothesis: the chunked scan equals the one-token recurrence, and the
state carried across two calls equals one call over the whole sequence.
Beside them, each function against its ``repro.models.ssm`` counterpart on
the same seeded inputs (numpy in, f32): ``_segsum``, ``ssd_chunked`` with
and without an initial state, ``ssd_step``, the causal conv and its step,
the gated norm, ``mamba_conv_tail`` with right padding, and
``mamba_block_full``/``mamba_block_step`` on converted weights, the full
block's dt mask included (a padded position leaves the state as it was).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import (HealthCheck, given, settings,  # noqa: E402
                        strategies as st)

from repro.models import ssm as JS  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from test_torch_layout import built  # noqa: E402

# six xdist workers share the cores with XLA's threads: one torch thread
# each keeps them from oversubscribing
torch.set_num_threads(1)

# the reference's tolerance for chunked against recurrent f32 sums
TOL = dict(rtol=2e-4, atol=2e-4)
# one function in two frameworks: f32 sums in another order
EXACT = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _inputs(rng, b, L, h, n, p):
    return (rng.normal(size=(b, L, h, p)).astype(np.float32),
            (-np.abs(rng.normal(size=(b, L, h))) * 0.1).astype(np.float32),
            rng.normal(size=(b, L, n)).astype(np.float32),
            rng.normal(size=(b, L, n)).astype(np.float32))


@settings(max_examples=12, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.integers(0, 2**31 - 1),
       st.sampled_from([(16, 4), (32, 8), (64, 16), (64, 64)]),
       st.integers(1, 3), st.integers(1, 3))
def test_ssd_chunked_matches_recurrence(seed, l_chunk, b, h):
    L, chunk = l_chunk
    n, p = 8, 4
    xdt, dA, B_, C_ = (_t(a) for a in _inputs(np.random.default_rng(seed),
                                              b, L, h, n, p))
    y_chunk, state_chunk = SSM.ssd_chunked(xdt, dA, B_, C_, chunk)
    state = torch.zeros((b, h, n, p))
    ys = []
    for t in range(L):
        y, state = SSM.ssd_step(xdt[:, t], dA[:, t], B_[:, t], C_[:, t],
                                state)
        ys.append(y)
    np.testing.assert_allclose(y_chunk.numpy(), torch.stack(ys, 1).numpy(),
                               **TOL)
    np.testing.assert_allclose(state_chunk.numpy(), state.numpy(), **TOL)


@settings(max_examples=8, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.integers(0, 2**31 - 1))
def test_ssd_state_carry_across_calls(seed):
    b, L, h, n, p, chunk = 1, 32, 2, 4, 4, 8
    xdt, dA, B_, C_ = (_t(a) for a in _inputs(np.random.default_rng(seed),
                                              b, L, h, n, p))
    full, _ = SSM.ssd_chunked(xdt, dA, B_, C_, chunk)
    y1, st1 = SSM.ssd_chunked(xdt[:, :16], dA[:, :16], B_[:, :16],
                              C_[:, :16], chunk)
    y2, _ = SSM.ssd_chunked(xdt[:, 16:], dA[:, 16:], B_[:, 16:], C_[:, 16:],
                            chunk, h0=st1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), full.numpy(),
                               **TOL)


def test_ssd_chunked_rejects_a_ragged_chunk():
    xdt, dA, B_, C_ = (_t(a) for a in _inputs(np.random.default_rng(0),
                                              1, 12, 1, 2, 2))
    with pytest.raises(ValueError, match="chunk"):
        SSM.ssd_chunked(xdt, dA, B_, C_, 8)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_functions_match_repro(with_h0):
    rng = np.random.default_rng(3)
    b, L, h, n, p, chunk = 2, 32, 3, 4, 5, 8
    xdt, dA, B_, C_ = _inputs(rng, b, L, h, n, p)
    h0 = rng.normal(size=(b, h, n, p)).astype(np.float32) if with_h0 \
        else None
    np.testing.assert_allclose(
        SSM._segsum(_t(dA[0, :8, 0])).numpy(),
        np.asarray(JS._segsum(jnp.asarray(dA[0, :8, 0]))), **EXACT)
    y, st_ = SSM.ssd_chunked(_t(xdt), _t(dA), _t(B_), _t(C_), chunk,
                             None if h0 is None else _t(h0))
    jy, jst = JS.ssd_chunked(jnp.asarray(xdt), jnp.asarray(dA),
                             jnp.asarray(B_), jnp.asarray(C_), chunk,
                             None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **EXACT)
    np.testing.assert_allclose(st_.numpy(), np.asarray(jst), **EXACT)
    state = rng.normal(size=(b, h, n, p)).astype(np.float32)
    y1, s1 = SSM.ssd_step(_t(xdt[:, 0]), _t(dA[:, 0]), _t(B_[:, 0]),
                          _t(C_[:, 0]), _t(state))
    jy1, js1 = JS.ssd_step(jnp.asarray(xdt[:, 0]), jnp.asarray(dA[:, 0]),
                           jnp.asarray(B_[:, 0]), jnp.asarray(C_[:, 0]),
                           jnp.asarray(state))
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy1), **EXACT)
    np.testing.assert_allclose(s1.numpy(), np.asarray(js1), **EXACT)


def test_conv_and_gated_norm_match_repro():
    rng = np.random.default_rng(4)
    B, L, C, W = 2, 9, 6, SSM.CONV_WIDTH
    x = rng.normal(size=(B, L, C)).astype(np.float32)
    w = rng.normal(size=(W, C)).astype(np.float32)
    bias = rng.normal(size=(C,)).astype(np.float32)
    np.testing.assert_allclose(
        SSM._causal_conv_full(_t(x), _t(w), _t(bias)).numpy(),
        np.asarray(JS._causal_conv_full(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(bias))), **EXACT)
    cs = rng.normal(size=(B, W - 1, C)).astype(np.float32)
    out, tail = SSM._conv_step(_t(x[:, 0]), _t(cs), _t(w), _t(bias))
    jout, jtail = JS._conv_step(jnp.asarray(x[:, 0]), jnp.asarray(cs),
                                jnp.asarray(w), jnp.asarray(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **EXACT)
    np.testing.assert_array_equal(tail.numpy(), np.asarray(jtail))
    z = rng.normal(size=(B, L, C)).astype(np.float32)
    scale = rng.normal(size=(C,)).astype(np.float32)
    np.testing.assert_allclose(
        SSM._gated_rmsnorm(_t(x), _t(z), _t(scale)).numpy(),
        np.asarray(JS._gated_rmsnorm(jnp.asarray(x), jnp.asarray(z),
                                     jnp.asarray(scale))), **EXACT)


def _layer(i=0):
    jm, jp, tm, tp = built("zamba2-1.2b")
    jblk = {k: w[i] for k, w in jp["mamba"].items()}
    return jm.cfg, jblk, tm.cfg, SSM._mamba_layer(tp, i)


def test_mamba_block_full_and_tail_match_repro_with_padding():
    """The full block over right-padded sequences (dt masked past each
    length) and the conv tail at the last valid inputs, on converted
    weights; a masked position leaves the state where the last valid one
    put it."""
    jcfg, jblk, cfg, blk = _layer(1)
    rng = np.random.default_rng(5)
    B, L = 2, 16
    x = rng.normal(size=(B, L, cfg.d_model)).astype(np.float32)
    lens = np.array([16, 9], np.int32)
    mask = np.arange(L)[None, :] < lens[:, None]
    y, st_ = SSM.mamba_block_full(_t(x), blk, cfg,
                                  mask=torch.from_numpy(mask))
    jy, jst = JS.mamba_block_full(jnp.asarray(x), jblk, jcfg,
                                  mask=jnp.asarray(mask))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(st_.numpy(), np.asarray(jst), **TOL)
    _, st_short = SSM.mamba_block_full(_t(x[1:, :9]), blk, cfg)
    np.testing.assert_allclose(st_[1:].numpy(), st_short.numpy(), **TOL)
    tail = SSM.mamba_conv_tail(_t(x), blk, cfg, torch.from_numpy(lens))
    jtail = JS.mamba_conv_tail(jnp.asarray(x), jblk, jcfg,
                               jnp.asarray(lens))
    np.testing.assert_allclose(tail.numpy(), np.asarray(jtail), **EXACT)
    short = SSM.mamba_conv_tail(_t(x[:, :2]), blk, cfg,
                                torch.tensor([2, 1]))
    assert not short[:, 0].any() and not short[1, 1].any()


def test_mamba_block_step_matches_repro_and_the_full_block():
    """One-token steps from the empty state reproduce the full block's
    outputs and final state; each step equals ``repro``'s."""
    jcfg, jblk, cfg, blk = _layer(0)
    rng = np.random.default_rng(6)
    B, L = 2, 8
    x = rng.normal(size=(B, L, cfg.d_model)).astype(np.float32)
    di, h, p, ci = SSM.mamba_dims(cfg)
    st_ = torch.zeros((B, h, cfg.ssm_state, p))
    cv = torch.zeros((B, SSM.CONV_WIDTH - 1, ci))
    jst, jcv = jnp.asarray(st_.numpy()), jnp.asarray(cv.numpy())
    ys = []
    for t in range(L):
        y, (st_, cv) = SSM.mamba_block_step(_t(x[:, t:t + 1]), blk, cfg, st_,
                                            cv)
        jy, (jst, jcv) = JS.mamba_block_step(jnp.asarray(x[:, t:t + 1]),
                                             jblk, jcfg, jst, jcv)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        ys.append(y)
    np.testing.assert_allclose(st_.numpy(), np.asarray(jst), **TOL)
    np.testing.assert_allclose(cv.numpy(), np.asarray(jcv), **TOL)
    yf, stf = SSM.mamba_block_full(_t(x), blk, cfg)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), yf.numpy(), **TOL)
    np.testing.assert_allclose(st_.numpy(), stf.numpy(), **TOL)
    np.testing.assert_allclose(
        cv.numpy(), SSM.mamba_conv_tail(_t(x), blk, cfg).numpy(), **TOL)
