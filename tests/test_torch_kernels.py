"""The port's kernel modules against the JAX kernels and their oracles.

On the CPU each wrapper computes its plain PyTorch version; these tests
hold that version to the Pallas kernel run in interpret mode and to
``repro.kernels.ref`` on the same numpy inputs, in f32 at atol/rtol 2e-5.
The CUDA kernels themselves run only on the card: ``test_torch_cuda.py``
compares each one with its plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as j_decode
from repro.kernels.decode_attention import \
    fused_paged_decode_attention as j_fused
from repro.kernels.decode_attention import \
    paged_decode_attention as j_paged
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.int8_matmul import int8_matmul as j_int8
from repro.kernels.ops import flash_attention_grouped as j_grouped
from repro_torch.kernels import build, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import (
    decode_attention, fused_paged_decode_attention, paged_decode_attention)
from repro_torch.kernels.flash_attention import flash_attention, flash_body
from repro_torch.kernels.int8_matmul import int8_body, int8_matmul

# six xdist workers share the cores with XLA's threads: one torch thread
# each keeps them from oversubscribing
torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


FLASH_CASES = [
    # (B, H, K, S, T, causal, q_offset, valid_len)
    (1, 4, 4, 128, 128, True, 0, None),
    (2, 8, 2, 128, 128, True, 0, 100),
    (1, 4, 1, 128, 256, False, 0, None),
    (1, 2, 2, 128, 256, True, 128, 200),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_pallas_and_ref(case):
    B, H, K, S, T, causal, q_off, vlen = case
    D = 16
    rng = np.random.default_rng(abs(hash(case)) % 2**31)
    q, k, v = _randn(rng, B, H, S, D), _randn(rng, B, K, T, D), \
        _randn(rng, B, K, T, D)
    got = tref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                   q_offset=q_off, kv_valid_len=vlen).numpy()
    want_ref = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal,
                                        q_offset=q_off, kv_valid_len=vlen)
    want_kernel = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          None if vlen is None else jnp.int32(vlen),
                          causal=causal, q_offset=q_off, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want_ref), **TOL)
    np.testing.assert_allclose(got, np.asarray(want_kernel), **TOL)


@pytest.mark.parametrize("S", [1, 37, 128])
def test_flash_wrapper_model_layout_matches_jax_adapter(S):
    """The wrapper (plain on CPU) in the model layout == the JAX adapter,
    including a ragged S that the Pallas kernel itself cannot take."""
    B, K, G, D = 2, 2, 2, 16
    T = S
    rng = np.random.default_rng(S)
    q, k, v = _randn(rng, B, S, K, G, D), _randn(rng, B, T, K, D), \
        _randn(rng, B, T, K, D)
    got = flash_attention(_t(q), _t(k), _t(v), causal=True).numpy()
    qh = jnp.asarray(q).transpose(0, 2, 3, 1, 4).reshape(B, K * G, S, D)
    want = jref.flash_attention_ref(qh, jnp.asarray(k).transpose(0, 2, 1, 3),
                                    jnp.asarray(v).transpose(0, 2, 1, 3),
                                    causal=True)
    want = np.asarray(want).reshape(B, K, G, S, D).transpose(0, 3, 1, 2, 4)
    np.testing.assert_allclose(got, want, **TOL)
    if S % 8 == 0:
        want_k = j_grouped(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, interpret=True)
        np.testing.assert_allclose(got, np.asarray(want_k), **TOL)


def _emulate_wgmma_body(q, k, v, *, causal, q_offset, valid_len,
                        split=True, bk=64):
    """The arithmetic of ``flash_attention.cu``'s bf16 tensor-core body in
    torch, in the model layout: 64-key tiles in order, f32 S = Q.K^T, the
    online softmax in f32 (row sum of the f32 p), P split into bf16 hi and
    lo halves (``split=False`` drops lo) and O += hi.V + lo.V in f32, the
    result rounded to bf16. Rows that see none of a tile get p = 0 and
    alpha = 1 from it, so walking every row over the last row's tiles
    equals the kernel's per-query-tile walk."""
    B, S, K, G, D = q.shape
    qh = q.permute(0, 2, 3, 1, 4)                       # (B, K, G, S, D)
    kh = k.permute(0, 2, 1, 3)[:, :, None]              # (B, K, 1, T, D)
    vh = v.permute(0, 2, 1, 3)[:, :, None]
    m = torch.full(qh.shape[:-1], tref.NEG_INF)
    l = torch.zeros(qh.shape[:-1])
    acc = torch.zeros(qh.shape)
    kv_end = min(valid_len, S + q_offset) if causal else valid_len
    rows = torch.arange(S)[:, None] + q_offset
    for k0 in range(0, kv_end, bk):
        kt, vt = kh[..., k0:k0 + bk, :], vh[..., k0:k0 + bk, :]
        t = torch.arange(k0, k0 + kt.shape[-2])[None, :]
        s = (qh @ kt.transpose(-1, -2)) * torch.tensor(D ** -0.5)
        live = (t < valid_len) & ((t <= rows) if causal else True)
        s = torch.where(live, s, torch.full_like(s, tref.NEG_INF))
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - mx)
        p = torch.exp(s - mx[..., None])
        l = l * alpha + p.sum(-1)
        hi = p.bfloat16().float()
        acc = acc * alpha[..., None] + hi @ vt
        if split:
            acc = acc + (p - hi).bfloat16().float() @ vt
        m = mx
    out = (acc / l.clamp_min(1e-30)[..., None]).bfloat16()
    return out.permute(0, 3, 1, 2, 4)


def _bf16_flash_inputs(D, causal, S=128, T=200, K=2, G=2):
    """bf16-valued f32 inputs; causal cases attend from the last S of T
    positions (q_offset = T - S), non-causal ones mask valid_len = 180."""
    rng = np.random.default_rng(D + 2 * causal)

    def bf(*shape):
        return torch.from_numpy(_randn(rng, *shape)).bfloat16().float()

    q, k, v = bf(1, S, K, G, D), bf(1, T, K, D), bf(1, T, K, D)
    kw = dict(causal=causal, q_offset=T - S if causal else 0,
              valid_len=T if causal else 180)
    return q, k, v, kw


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128, 96])
def test_flash_wgmma_arithmetic_meets_the_f32_ulp_rule(D, causal):
    """With P split into bf16 hi + lo the tensor-core body's arithmetic is
    within the f32 rule of the plain version, and of the JAX reference, in
    f32 on the same inputs. At D 96 the body's padded columns 96-127 are
    zeros: they add nothing to Q.K^T and are never stored from P.V, so its
    arithmetic is the same walk."""
    q, k, v, kw = _bf16_flash_inputs(D, causal)
    got = _emulate_wgmma_body(q, k, v, **kw)
    want = flash_attention(q, k, v, **kw)       # plain on the CPU, f32
    assert tref.bf16_ulp_ratio(got, want) <= 1.0
    B, S, K, G, _ = q.shape
    qh = jnp.asarray(q.numpy()).transpose(0, 2, 3, 1, 4).reshape(
        B, K * G, S, D)
    want_j = jref.flash_attention_ref(
        qh, jnp.asarray(k.numpy()).transpose(0, 2, 1, 3),
        jnp.asarray(v.numpy()).transpose(0, 2, 1, 3), causal=kw["causal"],
        q_offset=kw["q_offset"], kv_valid_len=kw["valid_len"])
    want_j = np.asarray(want_j).reshape(B, K, G, S, D).transpose(0, 3, 1, 2,
                                                                 4)
    assert tref.bf16_ulp_ratio(got, _t(want_j)) <= 1.0


@pytest.mark.parametrize("D", [64, 128, 96])
def test_flash_wgmma_without_p_lo_misses_the_f32_ulp_rule(D):
    """The reason for the split: rounding P to bf16 alone (the textbook
    tensor-core flash) breaks the rule by far more than its limit."""
    q, k, v, kw = _bf16_flash_inputs(D, True)
    got = _emulate_wgmma_body(q, k, v, split=False, **kw)
    assert tref.bf16_ulp_ratio(got, flash_attention(q, k, v, **kw)) > 4.0


@pytest.mark.parametrize("dtype,D,body", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.float32, 16, "simt"), (torch.float32, 128, "simt"),
    (torch.bfloat16, 16, None), (torch.bfloat16, 32, None),
    (torch.float16, 64, None), (torch.bfloat16, 96, "wgmma"),
    (torch.float32, 96, "simt"), (torch.bfloat16, 80, None),
    (torch.float32, 80, None)])
def test_flash_body_dispatch_by_dtype_and_head_dim(dtype, D, body):
    """bf16 runs the tensor-core body at D in {64, 96, 128} only, f32 the
    SIMT body at D in {16, 32, 64, 96, 128}; any other pair raises (no
    fallback between the bodies)."""
    if body is None:
        with pytest.raises((ValueError, TypeError)):
            flash_body(dtype, D)
    else:
        assert flash_body(dtype, D) == body


FUSED_CASES = [
    # (B, K, G, n_logical, page_size, pages_per_slot, D)
    (3, 2, 4, 12, 8, 4, 16),
    (4, 2, 2, 16, 16, 2, 16),
    (2, 1, 8, 16, 8, 8, 32),
]


def _fused_inputs(case, seed):
    B, K, G, n_logical, ps, P, D = case
    rng = np.random.default_rng(seed)
    n_phys = n_logical + 1             # + trash page == sentinel index
    sent = n_logical
    q = _randn(rng, B, K, G, D)
    k_pool, v_pool = _randn(rng, n_phys, ps, K, D), _randn(rng, n_phys, ps, K, D)
    k_new, v_new = _randn(rng, B, K, D), _randn(rng, B, K, D)
    perm = rng.permutation(n_logical)[: B * P].reshape(B, P)
    pos = rng.integers(0, P * ps, size=B).astype(np.int32)
    pos[0] = 0                         # first-token slot
    if B > 2:
        pos[1] = ps                    # on a page boundary
    n_alloc = pos // ps + 1
    bt = np.where(np.arange(P)[None, :] < n_alloc[:, None], perm, sent)
    bt[B - 1] = sent                   # inactive slot: all-sentinel row
    return q, k_new, v_new, k_pool, v_pool, bt.astype(np.int32), pos, sent


@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_paged_plain_matches_pallas(case):
    """Plain fused decode (scatter, then masked attend) == the Pallas kernel
    in interpret mode: output of every live slot and both updated pools,
    trash page included."""
    q, kn, vn, kp, vp, bt, pos, sent = _fused_inputs(case, sum(case))
    kp_t, vp_t = _t(kp), _t(vp)
    out, kp2, vp2 = fused_paged_decode_attention(
        _t(q), _t(kn), _t(vn), kp_t, vp_t, _t(bt), _t(pos))
    assert kp2 is kp_t and vp2 is vp_t          # updated in place
    jo, jkp, jvp = j_fused(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                           jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
                           jnp.asarray(pos), interpret=True)
    B = q.shape[0]
    np.testing.assert_array_equal(kp2.numpy(), np.asarray(jkp))
    np.testing.assert_array_equal(vp2.numpy(), np.asarray(jvp))
    np.testing.assert_allclose(out.numpy()[:B - 1], np.asarray(jo)[:B - 1],
                               **TOL)


@pytest.mark.parametrize("case", FUSED_CASES[:2])
def test_fused_paged_plain_matches_jax_ref_composition(case):
    """Plain fused decode == repro's XLA composition: paged scatter, then
    the gathered masked attend (``layers.paged_update_attend``)."""
    from repro.models.layers import paged_update_attend as j_update_attend
    q, kn, vn, kp, vp, bt, pos, sent = _fused_inputs(case, 7 + sum(case))
    out, kp2, vp2 = fused_paged_decode_attention(
        _t(q), _t(kn), _t(vn), _t(kp), _t(vp), _t(bt), _t(pos))
    jo, jkp, jvp = j_update_attend(
        jnp.asarray(q)[:, None], jnp.asarray(kn)[:, None],
        jnp.asarray(vn)[:, None], jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(bt), jnp.asarray(pos), impl="xla")
    np.testing.assert_array_equal(kp2.numpy(), np.asarray(jkp))
    np.testing.assert_allclose(out.numpy(), np.asarray(jo)[:, 0], **TOL)


DECODE_CASES = [
    # (B, K, G, T, valid_len, dtype); T ragged (the Pallas kernel takes any
    # T <= 512 as one block), valid_len < T or None (all of T)
    (2, 2, 4, 37, 30, "float32"),
    (3, 1, 1, 200, None, "float32"),
    (2, 2, 1, 200, 123, "float32"),
    (2, 2, 4, 37, None, "bfloat16"),
    (1, 2, 4, 200, 77, "bfloat16"),
]
# bf16: the plain versions (torch and repro's ref) round probabilities to
# bf16 before the PV product, the Pallas kernel keeps them in f32, and the
# frameworks round the bf16 output at other places: a few bf16 ulps of
# values of order 1
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_attention_plain_matches_pallas_and_ref(case):
    """The plain contiguous decode in the model layout (B, T, K, D) ==
    repro's Pallas decode kernel (interpret mode) and its ref, which take
    (B, K, T, D)."""
    B, K, G, T, vlen, dt = case
    D = 16
    rng = np.random.default_rng(B * 1000 + T + G)
    q, k, v = _randn(rng, B, K, G, D), _randn(rng, B, T, K, D), \
        _randn(rng, B, T, K, D)
    tdt, jdt = getattr(torch, dt), getattr(jnp, dt)
    got = decode_attention(_t(q).to(tdt), _t(k).to(tdt), _t(v).to(tdt),
                           vlen).float().numpy()
    jq, jk, jv = (jnp.asarray(a, jdt) for a in
                  (q, k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)))
    want_kernel = j_decode(jq, jk, jv, vlen, interpret=True)
    want_ref = jref.decode_attention_ref(jq, jk, jv, T if vlen is None
                                         else vlen)
    tol = TOL if dt == "float32" else BF16_TOL
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol)


def _paged_decode_inputs(seed, B=5, K=2, G=1, ps=8, P=4, n_pages=14, D=16):
    rng = np.random.default_rng(seed)
    q = _randn(rng, B, K, G, D)
    kp, vp = _randn(rng, n_pages, ps, K, D), _randn(rng, n_pages, ps, K, D)
    bt = rng.integers(0, n_pages, size=(B, P)).astype(np.int32)
    # slot 0: valid_len 0; slot 1: exactly on a page boundary (2 pages);
    # slot 2: mid page with sentinel entries after its pages; slot 3: an
    # entry far outside the pool and a negative one past its length;
    # slot 4: the whole logical span
    vlen = np.array([0, 2 * ps, ps + 3, ps - 2, P * ps], np.int32)[:B]
    bt[2, 2:] = n_pages                     # the sentinel
    bt[3, 1] = n_pages + 7
    bt[3, 2] = -3
    return q, kp, vp, bt, vlen


@pytest.mark.parametrize("G", [1, 2])
def test_paged_decode_plain_matches_pallas(G):
    """Plain attend-only paged decode == repro's Pallas paged decode kernel
    (interpret mode): valid_len 0 gives zeros, pages past a slot's length
    are skipped, sentinel and out-of-pool entries clamp into the pool."""
    q, kp, vp, bt, vlen = _paged_decode_inputs(10 + G, G=G)
    got = paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt),
                                 _t(vlen)).numpy()
    want = j_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                   jnp.asarray(bt), jnp.asarray(vlen), interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert not np.any(got[0]), "valid_len 0 must give exact zeros"
    # repro's XLA composition (gather, then masked attend) agrees on every
    # slot with something to attend
    from repro.models.layers import paged_attention_core as j_core
    want_xla = j_core(jnp.asarray(q)[:, None], jnp.asarray(kp),
                      jnp.asarray(vp), jnp.asarray(bt),
                      kv_valid_len=jnp.asarray(vlen), impl="xla")[:, 0]
    np.testing.assert_allclose(got[1:], np.asarray(want_xla)[1:], **TOL)


@pytest.mark.parametrize("form", ["none", "int", "0-d", "(1,)", "(B,)"])
def test_paged_decode_valid_len_forms_match_pallas(form):
    """valid_len as ``repro``'s wrapper takes it: None (every slot's P * ps
    rows), an int, or a 0-d, (1,) or (B,) array broadcast to the slots;
    the same form goes to both sides."""
    q, kp, vp, bt, vlen = _paged_decode_inputs(30, G=2)
    ps, P = kp.shape[1], bt.shape[1]
    bt = np.clip(bt, 0, kp.shape[0] - 1)     # every page live at P * ps
    v = {"none": None, "int": ps + 5, "0-d": np.int32(ps + 5),
         "(1,)": np.array([P * ps - 1], np.int32), "(B,)": vlen}[form]
    got = paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt),
                                 v if v is None or form == "int" else _t(v))
    want = j_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                   jnp.asarray(bt), v if v is None else jnp.asarray(v),
                   interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("form,want", [
    ("none", [40] * 3), ("int", [7] * 3), ("0-d", [7] * 3),
    ("(1,)", [7] * 3), ("(B,) int64", [0, 7, 40]), ("(B,) int32", [0, 7, 40])])
def test_slot_lengths_broadcasts_to_int32_per_slot(form, want):
    """The attend-only kernel reads an int32 (B,) tensor on q's device;
    every form ``repro`` takes becomes one, and an int32 (B,) tensor
    already there passes through as it is."""
    from repro_torch.kernels.decode_attention import slot_lengths
    given = {"none": None, "int": 7, "0-d": torch.tensor(7),
             "(1,)": torch.tensor([7], dtype=torch.int16),
             "(B,) int64": torch.tensor([0, 7, 40]),
             "(B,) int32": torch.tensor([0, 7, 40], dtype=torch.int32)}[form]
    got = slot_lengths(given, 3, 40, torch.device("cpu"))
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert got.tolist() == want
    if form == "(B,) int32":
        assert got is given


@pytest.mark.parametrize("bad", [torch.zeros((2,), dtype=torch.int32),
                                 torch.zeros((3, 1), dtype=torch.int32)])
def test_slot_lengths_refuses_other_shapes(bad):
    from repro_torch.kernels.decode_attention import slot_lengths
    with pytest.raises(ValueError, match="valid_len of shape"):
        slot_lengths(bad, 3, 40, torch.device("cpu"))


@pytest.mark.parametrize("vlen", [None, 21])
def test_grouped_adapter_at_one_query_routes_to_decode(vlen):
    """``flash_attention_grouped`` at S == 1 == repro's adapter, which sends
    that shape to the Pallas decode kernel (interpret mode), with a scalar
    ``kv_valid_len`` and with none; ``causal`` does not apply there."""
    B, K, G, T, D = 2, 2, 2, 29, 16
    rng = np.random.default_rng(T + (vlen or 0))
    q, k, v = _randn(rng, B, 1, K, G, D), _randn(rng, B, T, K, D), \
        _randn(rng, B, T, K, D)
    got = ops.flash_attention_grouped(_t(q), _t(k), _t(v), causal=True,
                                      kv_valid_len=vlen, impl="torch")
    want = j_grouped(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, kv_valid_len=vlen, interpret=True)
    assert got.shape == (B, 1, K, G, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _emulate_decode_mma(q, k, v, valid, split, *, split_p=True, tile=64):
    """The arithmetic of the bf16 tensor-core decode body
    (``csrc/decode_mma.cuh``) and its combine in torch. q: (B, K, G, D);
    k/v: (B, R, K, D), each slot's logical rows; valid: (B,) lengths.

    Rows [0, valid) are cut into spans of ``split`` rows (one block each),
    each span into 64-row tiles, and each tile's rows into 4 warps of 16;
    each warp keeps its own running (m, l) and, at G <= 8 (the body of 8
    fragment rows), two f32 accumulators, hi.V and lo.V, with p split into
    bf16 hi = bf16(p) and lo = bf16(p - hi) (``split_p=False`` drops lo);
    at G > 8 (16 rows, every row a head) hi.V and lo.V go into one
    accumulator, hi first. A block folds its warps in warp order, and the
    combine folds the spans in order, skipping empty ones (l = 0); the
    result is acc / max(l, 1e-30) rounded to bf16."""
    B, K, G, D = q.shape
    R = k.shape[1]
    qf = q.float()
    kf = k.float().permute(0, 2, 1, 3)                  # (B, K, R, D)
    vf = v.float().permute(0, 2, 1, 3)
    valid = torch.as_tensor(valid).long().reshape(B, 1, 1, 1)
    scale = torch.tensor(D ** -0.5)
    spans = []
    for t0 in range(0, max(R, 1), split):
        t1 = torch.clamp(valid, max=t0 + split)         # the span's end
        warps = []
        for w in range(4):
            m = torch.full((B, K, G, 1), tref.NEG_INF)
            l = torch.zeros((B, K, G, 1))
            o_hi = torch.zeros((B, K, G, D))
            o_lo = torch.zeros((B, K, G, D))
            for base in range(t0, t0 + split, tile):
                r0 = base + 16 * w
                if r0 >= R:
                    break
                rows = torch.arange(r0, min(r0 + 16, R))
                x = (qf @ kf[:, :, rows].transpose(-1, -2)) * scale
                live = rows.reshape(1, 1, 1, -1) < t1
                mx = torch.where(live, x, torch.full_like(x, tref.NEG_INF)
                                 ).amax(-1, keepdim=True)
                m_new = torch.maximum(m, mx)
                alpha = torch.exp(m - m_new)
                p = torch.where(live, torch.exp(x - m_new),
                                torch.zeros_like(x))
                l = l * alpha + p.sum(-1, keepdim=True)
                hi = p.bfloat16().float()
                lo = (p - hi).bfloat16().float() if split_p else \
                    torch.zeros_like(p)
                if G > 8:
                    o_hi = o_hi * alpha + hi @ vf[:, :, rows]
                    o_hi = o_hi + lo @ vf[:, :, rows]
                else:
                    o_hi = o_hi * alpha + hi @ vf[:, :, rows]
                    o_lo = o_lo * alpha + lo @ vf[:, :, rows]
                m = m_new
            warps.append((m, l, o_hi + o_lo))
        mx = torch.stack([w[0] for w in warps]).amax(0)
        e = [torch.exp(w[0] - mx) for w in warps]
        spans.append((mx, sum(w[1] * ei for w, ei in zip(warps, e)),
                      sum(w[2] * ei for w, ei in zip(warps, e)),
                      t0 < valid))
    mx = torch.stack([torch.where(live, m, torch.full_like(m, tref.NEG_INF))
                      for m, _, _, live in spans]).amax(0)
    lsum = torch.zeros((B, K, G, 1))
    acc = torch.zeros((B, K, G, D))
    for m, l, a, live in spans:
        wgt = torch.where(live, torch.exp(m - mx), torch.zeros_like(m))
        lsum = lsum + torch.where(live, l * wgt, torch.zeros_like(l))
        acc = acc + torch.where(live, a * wgt, torch.zeros_like(a))
    return (acc / lsum.clamp_min(1e-30)).bfloat16()


def _bf(rng, *shape):
    """bf16-valued f32 numpy data."""
    return torch.from_numpy(_randn(rng, *shape)).bfloat16().float().numpy()


# (B, K, G, D, page_size, pages_per_slot); positions put the write row on a
# span's last and first row, in a later span, on the table's last row, and
# an all-sentinel slot last
FUSED_MMA_CASES = [(5, 2, 4, 64, 16, 24), (5, 1, 8, 128, 16, 24),
                   (5, 2, 1, 64, 8, 48),
                   # phi3-mini's head_dim 96; qwen3-moe's G = 16
                   (5, 2, 1, 96, 16, 24), (5, 1, 16, 64, 16, 24)]


def _fused_mma_inputs(case):
    from repro_torch.kernels.decode_attention import FUSED_SPLIT_ROWS as split
    B, K, G, D, ps, P = case
    rng = np.random.default_rng(B * K * G + D + ps)
    n_logical = B * P
    n_phys = n_logical + 1                 # + trash page == sentinel index
    sent = n_logical
    q = _bf(rng, B, K, G, D)
    kn, vn = _bf(rng, B, K, D), _bf(rng, B, K, D)
    kp, vp = _bf(rng, n_phys, ps, K, D), _bf(rng, n_phys, ps, K, D)
    pos = np.array([split - 1, split, 2 * split + 2, P * ps - 1, 7],
                   np.int32)
    n_alloc = pos // ps + 1
    perm = rng.permutation(n_logical).reshape(B, P)
    bt = np.where(np.arange(P)[None, :] < n_alloc[:, None], perm, sent)
    bt[B - 1] = sent                       # inactive slot: all-sentinel row
    return q, kn, vn, kp, vp, bt.astype(np.int32), pos


def _fused_mma_rows(case):
    """One fused case through the plain version in f32: its output, and
    each slot's logical rows after the write with their valid lengths."""
    q, kn, vn, kp, vp, bt, pos = _fused_mma_inputs(case)
    B, K, G, D, ps, P = case
    want, kp2, vp2 = fused_paged_decode_attention(
        _t(q), _t(kn), _t(vn), _t(kp), _t(vp), _t(bt), _t(pos))
    pages = torch.clamp(_t(bt).long(), 0, kp.shape[0] - 1)
    rows_k = kp2[pages].reshape(B, P * ps, K, D)
    rows_v = vp2[pages].reshape(B, P * ps, K, D)
    return want, rows_k, rows_v, np.minimum(pos + 1, P * ps)


@pytest.mark.parametrize("case", FUSED_MMA_CASES)
def test_fused_decode_mma_arithmetic_meets_the_f32_ulp_rule(case):
    """The tensor-core body's arithmetic at the fused kernel's split, with
    the write row on a span's last and first row and in a later span, and an
    all-sentinel slot: within the f32 rule of the plain version in f32 and
    of the Pallas kernel (interpret mode), on every live slot."""
    from repro_torch.kernels.decode_attention import FUSED_SPLIT_ROWS as split
    q, kn, vn, kp, vp, bt, pos = _fused_mma_inputs(case)
    assert pos[2] < pos[3] < case[4] * case[5]
    want, rows_k, rows_v, valid = _fused_mma_rows(case)
    got = _emulate_decode_mma(_t(q), rows_k, rows_v, valid, split)
    live = slice(0, case[0] - 1)
    assert tref.bf16_ulp_ratio(got[live], want[live]) <= 1.0
    jo, _, _ = j_fused(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                       jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
                       jnp.asarray(pos), interpret=True)
    assert tref.bf16_ulp_ratio(got[live], _t(jo)[live]) <= 1.0


# (B, K, G, D, T, valid_len): ragged T, valid_len < T on and off a span
DECODE_MMA_CASES = [(2, 2, 8, 128, 301, None), (3, 2, 4, 64, 200, 129),
                    (2, 1, 1, 64, 37, 30), (2, 2, 1, 96, 301, 200),
                    (2, 1, 16, 64, 200, 129), (1, 1, 12, 96, 150, None)]


def _decode_mma_inputs(case):
    B, K, G, D, T, vlen = case
    rng = np.random.default_rng(B + K + G + D + T)
    return _bf(rng, B, K, G, D), _bf(rng, B, T, K, D), _bf(rng, B, T, K, D)


@pytest.mark.parametrize("split", [64, 192])
@pytest.mark.parametrize("case", DECODE_MMA_CASES)
def test_decode_mma_arithmetic_meets_the_f32_ulp_rule(case, split):
    """The tensor-core body's arithmetic with the contiguous kernel's spans
    (whole 64-row tiles; their count follows the card's SMs), ragged T and
    valid_len < T: within the f32 rule of the plain version in f32 and of
    the Pallas kernel (interpret mode)."""
    B, K, G, D, T, vlen = case
    q, k, v = _decode_mma_inputs(case)
    n = T if vlen is None else vlen
    got = _emulate_decode_mma(_t(q), _t(k), _t(v), [n] * B, split)
    want = decode_attention(_t(q), _t(k), _t(v), vlen)   # plain, f32
    assert tref.bf16_ulp_ratio(got, want) <= 1.0
    want_k = j_decode(jnp.asarray(q), jnp.asarray(k).transpose(0, 2, 1, 3),
                      jnp.asarray(v).transpose(0, 2, 1, 3), vlen,
                      interpret=True)
    assert tref.bf16_ulp_ratio(got, _t(want_k)) <= 1.0


def test_decode_mma_without_p_lo_misses_the_f32_ulp_rule():
    """The reason for the split: P rounded to bf16 alone (one mma per n
    tile) breaks the rule by far more than its limit, in both kernels'
    cases."""
    case = DECODE_MMA_CASES[0]
    q, k, v = _decode_mma_inputs(case)
    want = decode_attention(_t(q), _t(k), _t(v))
    got = _emulate_decode_mma(_t(q), _t(k), _t(v), [case[4]] * case[0], 192,
                              split_p=False)
    assert tref.bf16_ulp_ratio(got, want) > 4.0
    case = FUSED_MMA_CASES[1]
    q = _fused_mma_inputs(case)[0]
    want, rows_k, rows_v, valid = _fused_mma_rows(case)
    got = _emulate_decode_mma(_t(q), rows_k, rows_v, valid, 128,
                              split_p=False)
    assert tref.bf16_ulp_ratio(got[:-1], want[:-1]) > 4.0


@pytest.mark.parametrize("name,body,rows,pairs,plan", [
    # the vision cross-attention at 8 slots: one block per SM at most
    ("decode_attention", "mma", 1601, 64, (2, 832)),
    ("decode_attention", "mma", 1601, 8, (7, 256)),
    ("decode_attention", "mma", 256, 16, (4, 64)),
    ("decode_attention", "mma", 0, 16, (1, 64)),
    ("decode_attention", "simt", 1601, 64, (8, 201)),
    # llama / whisper / vision self-attention at max_len 512 and 4096
    ("fused_paged_decode_attention", "mma", 512, 64, (4, 128)),
    ("fused_paged_decode_attention", "mma", 4096, 64, (8, 512)),
    ("fused_paged_decode_attention", "simt", 32, 6, (1, 32)),
    # whisper-base's cross-attention: 32 pages of 16, its published 1500
    # encoder frames (96 pages), nothing to attend; the f32 body
    ("paged_decode_attention", "mma", 512, 64, (4, 128)),
    ("paged_decode_attention", "mma", 1536, 64, (8, 192)),
    ("paged_decode_attention", "mma", 0, 64, (1, 64)),
    ("paged_decode_attention", "simt", 512, 64, (4, 128))])
def test_decode_span_plan(monkeypatch, name, body, rows, pairs, plan):
    """Spans cover the rows; every decode kernel takes at most a cluster's
    8 of them, whole 64-row tiles on the tensor-core body."""
    from repro_torch.kernels import decode_attention as da
    monkeypatch.setattr(da, "_sm_count", lambda device: 132)   # an H100
    n, split = da._split(name, body, rows, torch.zeros((pairs, 1, 1, 1)))
    assert (n, split) == plan
    assert n * split >= rows and (n - 1) * split < max(rows, 1)
    assert n <= da.MAX_SPLIT
    if body == "mma":
        assert split % da.TILE_ROWS == 0


@pytest.mark.parametrize("dtype,G,D,body", [
    (torch.bfloat16, 1, 64, "mma"), (torch.bfloat16, 4, 64, "mma"),
    (torch.bfloat16, 8, 128, "mma"), (torch.float32, 1, 16, "simt"),
    (torch.float32, 8, 128, "simt"), (torch.bfloat16, 4, 16, None),
    (torch.bfloat16, 4, 32, None), (torch.bfloat16, 9, 64, "mma"),
    (torch.float32, 4, 48, None), (torch.float16, 4, 64, None),
    (torch.bfloat16, 1, 96, "mma"), (torch.bfloat16, 16, 64, "mma"),
    (torch.bfloat16, 16, 128, "mma"), (torch.float32, 1, 96, "simt"),
    (torch.float32, 16, 96, "simt"), (torch.float32, 16, 128, None),
    (torch.bfloat16, 17, 64, None), (torch.bfloat16, 32, 64, None),
    (torch.bfloat16, 4, 80, None)])
def test_decode_body_dispatch_by_dtype_heads_and_head_dim(dtype, G, D, body):
    """bf16 runs the tensor-core body at D in {64, 96, 128} only, f32 the
    SIMT body at D in {16, 32, 64, 96, 128}, G at most 16 (at most 8 for
    f32 at D 128); any other triple raises (no fallback between the
    bodies)."""
    from repro_torch.kernels.decode_attention import decode_body
    if body is None:
        with pytest.raises((ValueError, TypeError)):
            decode_body(dtype, G, D)
    else:
        assert decode_body(dtype, G, D) == body


MM_CASES = [(1, 256, 128), (8, 512, 384), (128, 256, 128)]


@pytest.mark.parametrize("case", MM_CASES)
def test_int8_plain_matches_pallas_and_ref(case):
    M, Kd, N = case
    rng = np.random.default_rng(M + Kd + N)
    x = _randn(rng, M, Kd)
    w = _randn(rng, Kd, N)
    w_q, s = tref.quantize_int8(_t(w))
    jw_q, js = jref.quantize_int8(jnp.asarray(w))
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(jw_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    got = int8_matmul(_t(x), w_q, s)
    assert got.dtype == torch.float32
    want_ref = jref.int8_matmul_ref(jnp.asarray(x), jw_q, js)
    mp = -(-M // 8) * 8                # the Pallas kernel wants M % block == 0
    xp = np.zeros((mp, Kd), np.float32)
    xp[:M] = x
    want_kernel = j_int8(jnp.asarray(xp), jw_q, js, block_m=min(128, mp),
                         interpret=True)[:M]
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,body", [(1, "gemv"), (8, "gemv"), (16, "gemv"),
                                    (17, "mma"), (2048, "mma")])
def test_int8_body_dispatch_by_m(M, body, dtype):
    """M <= 16 (decode) runs the gemv body, larger M the tensor-core body,
    at either x dtype."""
    assert int8_body(M, dtype) == body


@pytest.mark.parametrize("dtype,M,exc", [(torch.float16, 8, TypeError),
                                         (torch.int8, 2048, TypeError),
                                         (torch.bfloat16, 0, ValueError)])
def test_int8_body_refuses_other_dtypes(dtype, M, exc):
    with pytest.raises(exc):
        int8_body(M, dtype)


def _split_bf16x3(x):
    """The int8_mma body's split of f32 x: hi = x truncated to bf16, mid =
    the remainder truncated, lo = what is left."""
    mask = torch.tensor(-65536, dtype=torch.int32)          # 0xFFFF0000
    hi = (x.view(torch.int32) & mask).view(torch.float32)
    r = x - hi
    mid = (r.view(torch.int32) & mask).view(torch.float32)
    return hi, mid, r - mid


def test_int8_f32_split_into_three_bf16_terms_is_exact():
    """hi + mid + lo == x bitwise for seeded f32 x over normal, tiny (down
    to 2^-110) and huge exponents (up to f32's largest), negatives and
    zeros, and each term is a bf16 value. Below 2^-110 the bits under
    bf16's smallest subnormal (2^-133) are lost: the error stays below
    2^-133."""
    rng = np.random.default_rng(14)
    mant = rng.uniform(1.0, 2.0, 4000) * rng.choice([-1.0, 1.0], 4000)
    exps = rng.integers(-110, 128, 4000).astype(np.float64)
    x = np.concatenate([(mant * 2.0 ** exps).astype(np.float32),
                        _randn(rng, 1000), _randn(rng, 100) * 1e-30,
                        np.float32([0.0, -0.0, 3.4028235e38, -3.4028235e38,
                                    2.0 ** -110, 1.0 + 2.0 ** -23])])
    xt = _t(x)
    hi, mid, lo = _split_bf16x3(xt)
    for term in (hi, mid, lo):
        assert torch.equal(term.bfloat16().float(), term)
    back = hi + mid + lo
    nz = xt != 0
    assert torch.equal(back[nz].view(torch.int32), xt[nz].view(torch.int32))
    assert torch.equal(back[~nz], xt[~nz])
    tiny = _t((rng.uniform(1.0, 2.0, 500)
               * 2.0 ** rng.integers(-149, -110, 500)).astype(np.float32))
    hi, mid, lo = _split_bf16x3(tiny)
    lo_kept = (lo.view(torch.int32) & -65536).view(torch.float32)
    assert ((hi + mid + lo_kept) - tiny).abs().max().item() < 2.0 ** -133


def test_int8_widens_exactly_to_bf16():
    """Every int8 weight value (the quantiser's -127..127, and -128) is
    exact in bf16, and the kernels' widening (the byte, biased to unsigned,
    as the low mantissa byte of 2^23, minus 2^23 + 128) gives it exactly."""
    b = torch.arange(-128, 128, dtype=torch.int32)
    assert torch.equal(b.to(torch.int8).to(torch.bfloat16).float(),
                       b.float())
    u = (b.to(torch.int8).view(torch.uint8).int() ^ 0x80) | 0x4B000000
    widened = u.view(torch.float32) - 8388736.0
    assert torch.equal(widened, b.float())
    assert torch.equal(widened.bfloat16().float(), widened)


def _emulate_int8_mma(x, w_q, scales, *, split=True, chain=128):
    """The tensor-core bodies' arithmetic in torch: x as bf16 terms (bf16 x
    itself; f32 x as hi, mid and lo, or rounded to bf16 once when
    ``split=False``), w_q widened to bf16, exact bf16 products summed in
    f32 over k steps of 16 and x's terms into one partial per ``chain``
    rows of k (128 in the prefill body, 64 in the decode body), the
    partials added in order, the scales applied once at the end. (The
    card's mma accumulator also truncates inside a chain; the card tests
    hold that to the plain version.)"""
    if x.dtype == torch.bfloat16:
        terms = [x.float()]
    elif split:
        terms = list(_split_bf16x3(x))
    else:
        terms = [x.bfloat16().float()]
    w = w_q.to(torch.bfloat16).float()
    acc = torch.zeros((x.shape[0], w.shape[1]))
    for t0 in range(0, x.shape[1], chain):
        part = torch.zeros_like(acc)
        for k0 in range(t0, min(t0 + chain, x.shape[1]), 16):
            for t in terms:
                part = part + t[:, k0:k0 + 16] @ w[k0:k0 + 16]
        acc = acc + part
    return acc * scales


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MM_CASES)
def test_int8_mma_arithmetic_matches_ref_and_pallas(case, xdtype):
    """The tensor-core body's arithmetic (three bf16 passes for f32 x, one
    for bf16 x) equals the f32 plain version, the JAX reference and the
    Pallas kernel (interpret mode) up to the order of f32 sums."""
    M, Kd, N = case
    rng = np.random.default_rng(M * Kd + N)
    x = _randn(rng, M, Kd)
    if xdtype == "bfloat16":                    # bf16 values, held in f32
        x = _t(x).bfloat16().float().numpy()
    w_q, s = tref.quantize_int8(_t(_randn(rng, Kd, N)))
    xt = _t(x) if xdtype == "float32" else _t(x).bfloat16()
    # the chain depth of the body that this M runs
    got = _emulate_int8_mma(
        xt, w_q, s, chain=64 if int8_body(M, xt.dtype) == "gemv" else 128)
    want = tref.int8_matmul_ref(_t(x), w_q, s)
    # rtol 1e-5 of each element, and of the output's scale for elements
    # near 0: the plain versions scale w before the sum (one rounding per
    # term), the kernel after it
    tol = dict(rtol=1e-5, atol=1e-5 * want.abs().max().item())
    np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)
    jw_q, js = jnp.asarray(w_q.numpy()), jnp.asarray(s.numpy())
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.int8_matmul_ref(jnp.asarray(x), jw_q,
                                                     js)), **tol)
    mp = -(-M // 8) * 8                # the Pallas kernel wants M % block == 0
    xp = np.zeros((mp, Kd), np.float32)
    xp[:M] = x
    want_k = j_int8(jnp.asarray(xp), jw_q, js, block_m=min(128, mp),
                    interpret=True)[:M]
    np.testing.assert_allclose(got.numpy(), np.asarray(want_k), **tol)


def test_int8_mma_one_bf16_pass_of_f32_x_misses_the_plain_version():
    """The reason for the split: rounding f32 x to bf16 once (or to TF32)
    computes another function, far outside the tolerance of sum order."""
    M, Kd, N = MM_CASES[1]
    rng = np.random.default_rng(7)
    x = _t(_randn(rng, M, Kd))
    w_q, s = tref.quantize_int8(_t(_randn(rng, Kd, N)))
    want = tref.int8_matmul_ref(x, w_q, s)
    err = (_emulate_int8_mma(x, w_q, s, split=False) - want).abs().max()
    assert err.item() > 100 * 1e-5 * (1 + want.abs().max().item())


def test_wrappers_on_cpu_launch_nothing():
    """On a CPU tensor a wrapper computes its plain version and counts no
    launch; a kernel impl asked for a CPU tensor raises instead."""
    build.reset_launch_counts()
    q = torch.zeros((1, 8, 1, 2, 16))
    k = torch.zeros((1, 8, 1, 16))
    flash_attention(q, k, k)
    decode_attention(q[:, 0], k, k)
    paged_decode_attention(q[:, 0], torch.zeros((2, 4, 1, 16)),
                           torch.zeros((2, 4, 1, 16)),
                           torch.zeros((1, 2), dtype=torch.int32),
                           torch.ones((1,), dtype=torch.int32))
    int8_matmul(torch.zeros((2, 4)), torch.zeros((4, 4), dtype=torch.int8),
                torch.ones(4))
    assert all(n == 0 for n in build.launch_counts.values())
    with pytest.raises(ValueError, match="CUDA kernel impl"):
        ops.flash_attention_grouped(q, k, k, impl="cuda")
    with pytest.raises(ValueError, match="CUDA kernel impl"):
        ops.flash_attention_grouped(q[:, :1], k, k, impl="cuda")
