"""The port's CUDA kernels and kernel-path engine on the card.

These tests import no JAX, so they run on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Each test that needs a GPU carries the ``cuda`` marker and skips, with its
reason, where ``torch.cuda.is_available()`` is false; the decision is made
inside the test. TF32 is off for every f32 product compared.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import ARCHS
from repro_torch.kernels import build, ref
from repro_torch.kernels.decode_attention import (
    _split, decode_attention, decode_attention_plain,
    fused_paged_decode_attention, paged_decode_attention)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.int8_matmul import int8_body, int8_matmul, int8_plan
from repro_torch.models import build_model
from repro_torch.models.quantize import quantize_params_dense
from repro_torch.serving.engine import Request, ServingEngine

KW = dict(max_batch=3, max_len=64, decode_block=4, min_bucket=4,
          page_size=8, n_pages=12)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_kernel_pool_layout_has_a_trash_page():
    """With the CUDA attention impl the pool carries one extra page at the
    sentinel index; the plain impl keeps the exact-size pool."""
    cfg = ARCHS["llama3.2-1b"].reduced()
    eng = ServingEngine(build_model(cfg, device="cpu"), None, **KW)
    assert eng._cache["k"].shape[1] == KW["n_pages"] == eng._pool_pages
    if not torch.cuda.is_available():
        return
    kcfg = cfg.for_device("cuda")
    eng = ServingEngine(build_model(kcfg, device="cuda"), None, **KW)
    assert eng._cache["k"].shape[1] == KW["n_pages"] + 1


@pytest.mark.cuda
def test_cuda_flash_attention_matches_plain():
    dev = _need_cuda()
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((2, 37, 2, 4, 64), generator=gen, device=dev)
    k = torch.randn((2, 37, 2, 64), generator=gen, device=dev)
    v = torch.randn((2, 37, 2, 64), generator=gen, device=dev)
    for kw in (dict(causal=True), dict(causal=True, valid_len=30),
               dict(causal=False, valid_len=5)):
        np.testing.assert_allclose(
            flash_attention(q, k, v, **kw).cpu().numpy(),
            flash_attention_plain(q, k, v, **kw).cpu().numpy(),
            rtol=1e-4, atol=1e-4)


FLASH_BF16_CASES = [
    # (B, S, T, K, G, D, causal, q_offset, valid_len)
    (2, 300, 300, 8, 1, 64, True, 0, None),     # whisper self prefill
    (1, 300, 320, 8, 8, 128, True, 0, 250),     # ragged S, valid_len < T
    (1, 64, 512, 8, 8, 128, True, 448, None),   # q_offset > 0
    (2, 256, 1601, 8, 8, 128, False, 0, None),  # vision cross prefill
    # moonshot-v1-16b-a3b: K = 16 KV heads, G = 1, D = 128
    (2, 256, 256, 16, 1, 128, True, 0, None),   # grouped causal prefill
    (1, 300, 300, 16, 1, 128, True, 0, 250),    # ragged S, valid_len < T
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_BF16_CASES)
def test_cuda_flash_wgmma_bf16_within_f32_ulp_rule(case):
    """The tensor-core body on bf16 inputs against the plain version on the
    same inputs widened to f32: within one bf16 ulp + 1e-5 everywhere."""
    dev = _need_cuda()
    B, S, T, K, G, D, causal, q_off, vlen = case
    gen = torch.Generator(device=dev).manual_seed(S + D)
    q = torch.randn((B, S, K, G, D), generator=gen, device=dev).bfloat16()
    k = torch.randn((B, T, K, D), generator=gen, device=dev).bfloat16()
    v = torch.randn((B, T, K, D), generator=gen, device=dev).bfloat16()
    kw = dict(causal=causal, q_offset=q_off, valid_len=vlen)
    got = flash_attention(q, k, v, **kw)
    want32 = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert ref.bf16_ulp_ratio(got, want32) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32])
def test_cuda_flash_bf16_small_head_dim_raises(D):
    """bf16 at D in {16, 32} has no tensor-core body: the wrapper raises and
    launches nothing."""
    from repro_torch.kernels import build
    dev = _need_cuda()
    q = torch.zeros((1, 8, 1, 1, D), device=dev, dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 1, D), device=dev, dtype=torch.bfloat16)
    launches = build.launch_counts["flash_attention"]
    with pytest.raises(ValueError, match="wgmma body"):
        flash_attention(q, k, k)
    assert build.launch_counts["flash_attention"] == launches


@pytest.mark.cuda
def test_cuda_fused_paged_decode_matches_plain():
    """f32 (the SIMT body). A trash-page pool with a first-token slot, a
    page-boundary slot and an all-sentinel slot; then slots of three
    128-row spans with the write row on span boundaries and in later spans.
    Live outputs agree, every pool row but the trash page is bit-equal to
    the plain scatter's, and two calls give the same bits."""
    dev = _need_cuda()
    rng = np.random.default_rng(1)
    B, K, G, n_logical, ps, P, D = 3, 2, 4, 12, 8, 4, 64
    sent = n_logical
    q = torch.from_numpy(rng.standard_normal((B, K, G, D)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal(
        (n_logical + 1, ps, K, D)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal(kp.shape).astype(np.float32))
    kn = torch.from_numpy(rng.standard_normal((B, K, D)).astype(np.float32))
    vn = torch.from_numpy(rng.standard_normal((B, K, D)).astype(np.float32))
    pos = torch.tensor([0, ps, 5], dtype=torch.int32)
    bt = torch.full((B, P), sent, dtype=torch.int32)
    bt[0, 0] = 4
    bt[1, :2] = torch.tensor([7, 2])
    q, kp, vp, kn, vn, pos, bt = (t.to(dev) for t in (q, kp, vp, kn, vn, pos,
                                                      bt))
    kp_ref, vp_ref = kp.clone(), vp.clone()
    out, kp2, vp2 = fused_paged_decode_attention(q, kn, vn, kp, vp, bt, pos)
    o_ref, kp_ref, vp_ref = ref.fused_paged_decode_attention_ref(
        q, kn, vn, kp_ref, vp_ref, bt, pos)
    np.testing.assert_allclose(out[:2].cpu().numpy(), o_ref[:2].cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(kp2[:sent], kp_ref[:sent])
    assert torch.equal(vp2[:sent], vp_ref[:sent])

    B, ps, P = 6, 16, 24
    assert _split("fused_paged_decode_attention", "simt", P * ps,
                  q) == (3, 128)
    sent = B * P
    gen = torch.Generator(device=dev).manual_seed(2)
    kp = torch.randn((sent + 1, ps, K, D), generator=gen, device=dev)
    vp = torch.randn(kp.shape, generator=gen, device=dev)
    q = torch.randn((B, K, G, D), generator=gen, device=dev)
    kn = torch.randn((B, K, D), generator=gen, device=dev)
    vn = torch.randn((B, K, D), generator=gen, device=dev)
    pos = torch.tensor([127, 128, 255, 256, 383, 40], dtype=torch.int32,
                       device=dev)
    perm = torch.randperm(B * P, generator=gen, device=dev).reshape(B, P)
    alloc = torch.arange(P, device=dev)[None, :] <= (pos.long() // ps)[:, None]
    bt = torch.where(alloc, perm, torch.full_like(perm, sent)).to(torch.int32)
    bt[B - 1] = sent
    k0, v0 = kp.clone(), vp.clone()
    out, kp2, vp2 = fused_paged_decode_attention(q, kn, vn, kp, vp, bt, pos)
    again, _, _ = fused_paged_decode_attention(q, kn, vn, k0.clone(),
                                               v0.clone(), bt, pos)
    o_ref, kp_ref, vp_ref = ref.fused_paged_decode_attention_ref(
        q, kn, vn, k0.clone(), v0.clone(), bt, pos)
    np.testing.assert_allclose(out[:B - 1].cpu().numpy(),
                               o_ref[:B - 1].cpu().numpy(), rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(out, again)
    assert torch.equal(kp2[:sent], kp_ref[:sent])
    assert torch.equal(vp2[:sent], vp_ref[:sent])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_decode_matches_plain(dtype):
    """Attend-only paged decode: valid_len 0 (zeros), a length on a page
    boundary, a length past a stale page, sentinel and out-of-pool entries,
    G = 1 and G = 8 with D = 128, and whisper-base's published 1500 encoder
    frames (96 pages of 16: 8 spans of 192 rows) with slots at 1500, 1025
    and on a page boundary. In bf16 (the tensor-core body) also within the
    f32 rule of the plain version on the widened inputs, and two calls give
    the same bits."""
    dev = _need_cuda()
    dt = getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 3e-2   # bf16 probabilities
    gen = torch.Generator(device=dev).manual_seed(4)
    for B, K, G, D, ps, P, lens in (
            (5, 8, 1, 64, 16, 32, [0, 32, 509, 17, 300]),
            (3, 2, 8, 128, 8, 6, [0, 16, 45]),
            (4, 8, 1, 64, 16, 96, [0, 1500, 1025, 1248])):
        n_phys = B * P + 1
        kp = torch.randn((n_phys, ps, K, D), generator=gen, device=dev).to(dt)
        vp = torch.randn((n_phys, ps, K, D), generator=gen, device=dev).to(dt)
        q = torch.randn((B, K, G, D), generator=gen, device=dev).to(dt)
        bt = torch.randperm(B * P, generator=gen, device=dev).reshape(B, P)
        bt = bt.to(torch.int32)
        vlen = torch.tensor(lens, dtype=torch.int32, device=dev)
        bt[0] = n_phys - 1                      # all-sentinel slot
        bt[1, -(-lens[1] // ps):] = n_phys + 5  # past the pool, masked
        bt[2, 0] = -1                           # clamps to page 0
        out = paged_decode_attention(q, kp, vp, bt, vlen)
        again = paged_decode_attention(q, kp, vp, bt, vlen)
        want = ref.paged_decode_attention_ref(q, kp, vp, bt, vlen)
        want32 = ref.paged_decode_attention_ref(q.float(), kp.float(),
                                                vp.float(), bt, vlen)
        torch.cuda.synchronize()
        assert not out[0].any()
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   want.float().cpu().numpy(), rtol=tol,
                                   atol=tol)
        if dt == torch.bfloat16:
            assert ref.bf16_ulp_ratio(out, want32) <= 1.0
            assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_decode_attention_matches_plain(dtype):
    """Contiguous decode in the model layout: ragged T = 1601 (the vision
    config's image tokens), valid_len < T, valid_len 0, G in {1, 8}."""
    dev = _need_cuda()
    dt = getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 3e-2   # bf16 probabilities
    gen = torch.Generator(device=dev).manual_seed(5)
    for B, K, G, D, T, vlen in ((2, 8, 8, 128, 1601, None),
                                (3, 2, 1, 64, 37, 30), (2, 2, 4, 64, 200, 0)):
        q = torch.randn((B, K, G, D), generator=gen, device=dev).to(dt)
        k = torch.randn((B, T, K, D), generator=gen, device=dev).to(dt)
        v = torch.randn((B, T, K, D), generator=gen, device=dev).to(dt)
        out = decode_attention(q, k, v, vlen)
        want = decode_attention_plain(q, k, v, vlen)
        torch.cuda.synchronize()
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   want.float().cpu().numpy(), rtol=tol,
                                   atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("P", [24, 256])
def test_cuda_fused_decode_mma_bf16(P, G, D):
    """The fused kernel's tensor-core body in bf16, over 24 pages of 16
    (3 spans of 128 rows) and llama's max_len 4096 (8 spans of 512): the
    write row on a span's last and first row, in a later span's middle and
    on the table's last row, and an all-sentinel slot. Live outputs within
    the f32 rule of the plain version on the widened inputs; written rows
    bit-equal to the new rows, every other page row (trash aside) bitwise
    untouched; a second call on the same inputs gives the same bits on
    every slot, the all-sentinel one's finite."""
    from repro_torch.kernels.decode_attention import decode_body
    dev = _need_cuda()
    assert decode_body(torch.bfloat16, G, D) == "mma"
    B, K, ps = 6, 4, 16
    n_split, split = _split("fused_paged_decode_attention", "mma", P * ps,
                            torch.zeros((B, K, G, D)))
    assert (n_split, split) == ((3, 128) if P == 24 else (8, 512))
    gen = torch.Generator(device=dev).manual_seed(G * D)
    sent = B * P                                # trash page == sentinel
    kp = torch.randn((sent + 1, ps, K, D), generator=gen, device=dev)
    vp = torch.randn(kp.shape, generator=gen, device=dev)
    q = torch.randn((B, K, G, D), generator=gen, device=dev)
    kn = torch.randn((B, K, D), generator=gen, device=dev)
    vn = torch.randn((B, K, D), generator=gen, device=dev)
    kp, vp, q, kn, vn = (t.bfloat16() for t in (kp, vp, q, kn, vn))
    pos = torch.tensor([split - 1, split, 2 * split + split // 2,
                        P * ps - 1, 0, 9], dtype=torch.int32, device=dev)
    perm = torch.randperm(B * P, generator=gen, device=dev).reshape(B, P)
    alloc = torch.arange(P, device=dev)[None, :] <= (pos.long() // ps)[:, None]
    bt = torch.where(alloc, perm, torch.full_like(perm, sent)).to(torch.int32)
    bt[B - 1] = sent
    k0, v0 = kp.clone(), vp.clone()
    outs = []
    for _ in range(2):
        kp2, vp2 = k0.clone(), v0.clone()
        out, _, _ = fused_paged_decode_attention(q, kn, vn, kp2, vp2, bt, pos)
        outs.append(out)
    want32, _, _ = ref.fused_paged_decode_attention_ref(
        q.float(), kn.float(), vn.float(), k0.float(), v0.float(), bt, pos)
    torch.cuda.synchronize()
    live = slice(0, B - 1)
    assert ref.bf16_ulp_ratio(outs[0][live], want32[live]) <= 1.0
    # the all-sentinel slot's output is discarded by the pool contract
    assert torch.equal(outs[0], outs[1])
    assert outs[0][B - 1].isfinite().all()
    wpage = bt[torch.arange(B, device=dev), pos.long() // ps].long()[live]
    woff = (pos.long() % ps)[live]
    assert torch.equal(kp2[wpage, woff], kn[live])
    assert torch.equal(vp2[wpage, woff], vn[live])
    kept = torch.ones((sent + 1, ps), dtype=torch.bool, device=dev)
    kept[wpage, woff] = False
    kept[sent] = False
    assert torch.equal(kp2[kept], k0[kept]) and torch.equal(vp2[kept],
                                                            v0[kept])


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (8, 8, 8, 128, 1601, None), (2, 8, 8, 128, 1601, 777),
    (3, 2, 1, 64, 37, 30), (2, 4, 4, 64, 300, 128), (2, 2, 4, 128, 200, 0)])
def test_cuda_decode_attention_mma_bf16(case):
    """The contiguous kernel's tensor-core body in bf16: ragged T = 1601,
    valid_len < T, on a span boundary and 0 (zeros). Within the f32 rule of
    the plain version on the widened inputs; two calls give the same
    bits."""
    dev = _need_cuda()
    B, K, G, D, T, vlen = case
    gen = torch.Generator(device=dev).manual_seed(T + G)
    q = torch.randn((B, K, G, D), generator=gen, device=dev).bfloat16()
    k = torch.randn((B, T, K, D), generator=gen, device=dev).bfloat16()
    v = torch.randn((B, T, K, D), generator=gen, device=dev).bfloat16()
    out = decode_attention(q, k, v, vlen)
    again = decode_attention(q, k, v, vlen)
    want32 = decode_attention_plain(q.float(), k.float(), v.float(), vlen)
    torch.cuda.synchronize()
    assert ref.bf16_ulp_ratio(out, want32) <= 1.0
    assert torch.equal(out, again)
    if vlen == 0:
        assert not out.any()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32])
def test_cuda_decode_bf16_small_head_dim_raises(D):
    """bf16 at D in {16, 32} has no tensor-core decode body: the three
    wrappers raise and launch nothing."""
    dev = _need_cuda()
    bf = dict(device=dev, dtype=torch.bfloat16)
    q = torch.zeros((1, 1, 2, D), **bf)
    before = dict(build.launch_counts)
    with pytest.raises(ValueError, match="mma body"):
        decode_attention(q, torch.zeros((1, 8, 1, D), **bf),
                         torch.zeros((1, 8, 1, D), **bf))
    with pytest.raises(ValueError, match="mma body"):
        fused_paged_decode_attention(
            q, torch.zeros((1, 1, D), **bf), torch.zeros((1, 1, D), **bf),
            torch.zeros((2, 4, 1, D), **bf), torch.zeros((2, 4, 1, D), **bf),
            torch.zeros((1, 2), dtype=torch.int32, device=dev),
            torch.zeros((1,), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="mma body"):
        paged_decode_attention(
            q, torch.zeros((2, 4, 1, D), **bf),
            torch.zeros((2, 4, 1, D), **bf),
            torch.zeros((1, 2), dtype=torch.int32, device=dev), 5)
    assert build.launch_counts == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (5, 300, 70), (3, 1024, 70), (40, 256, 96),
    (1, 2048, 2048), (16, 2048, 512), (8, 8192, 2048),  # gemv, aligned
    (16, 301, 136), (17, 2048, 512), (17, 300, 130),    # edges of the bodies
    (2048, 2048, 512), (2048, 8192, 2048), (200, 520, 1000)])
def test_cuda_int8_matmul_matches_plain(shape):
    """Both bodies (gemv at M <= 16, mma above) at bf16 and f32 x, aligned
    shapes and ragged M, N and Kd, against the plain version."""
    dev = _need_cuda()
    M, Kd, N = shape
    gen = torch.Generator(device=dev).manual_seed(M)
    x = torch.randn((M, Kd), generator=gen, device=dev)
    w_q, s = ref.quantize_int8(torch.randn((Kd, N), generator=gen,
                                           device=dev))
    for xx in (x, x.bfloat16()):
        np.testing.assert_allclose(
            int8_matmul(xx, w_q, s).cpu().numpy(),
            ref.int8_matmul_ref(xx.float(), w_q, s).cpu().numpy(),
            rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_int8_gemv_is_one_launch_and_deterministic():
    """At decode (M = 8, 2048 x 8192) the gemv body is one launch per call,
    with no workspace, and its cluster adds the K-split partial sums in a
    fixed order: two calls agree bitwise."""
    dev = _need_cuda()
    gen = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn((8, 2048), generator=gen, device=dev).bfloat16()
    w_q, s = ref.quantize_int8(torch.randn((2048, 8192), generator=gen,
                                           device=dev))
    assert int8_body(8, x.dtype) == "gemv"
    assert int8_plan(8, 8192, 2048, x.dtype)["cluster"] > 1
    int8_matmul(x, w_q, s)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        a = int8_matmul(x, w_q, s)
        b = int8_matmul(x, w_q, s)
        torch.cuda.synchronize()
    assert build.launch_counts["int8_matmul"] == 2
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 2 and all("int8_gemv" in k for k in kernels), \
        kernels
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_engine_matches_plain_engine_on_card():
    """Kernel impls vs plain impls on the card, f32 reduced int8 config:
    same dispatch counts and the same greedy tokens on a mixed stream."""
    dev = _need_cuda()
    rng = np.random.default_rng(3)
    stream = [(rng.integers(0, 256, size=n).astype(np.int32), m)
              for n, m in ((5, 6), (6, 1), (7, 9), (29, 4), (12, 12))]
    outs = []
    for kernels in (False, True):
        cfg = dataclasses.replace(ARCHS["llama3.2-1b"].reduced(),
                                  quantize="int8")
        if kernels:
            cfg = cfg.for_device(dev)
        m = build_model(cfg, device=dev)
        eng = ServingEngine(m, quantize_params_dense(m.init(0)), **KW)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(stream)]
        eng.serve(reqs)
        outs.append(([r.tokens for r in reqs], dict(eng.stats)))
    for a, b in zip(outs[0][0], outs[1][0]):
        np.testing.assert_array_equal(a, b)
    assert outs[0][1] == outs[1][1]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-90b"])
def test_cuda_family_engine_matches_plain_engine_on_card(arch):
    """Kernel impls vs plain impls on the card, f32 reduced audio and vlm
    configs: same dispatch counts and the same greedy tokens, every page
    back at drain; the cross-attention decode kernel ran."""
    from repro_torch.kernels import build
    dev = _need_cuda()
    rng = np.random.default_rng(3)
    stream = [(rng.integers(0, 256, size=n).astype(np.int32), m)
              for n, m in ((5, 6), (6, 1), (7, 9), (29, 4), (12, 12))]
    cross = {"whisper-base": "paged_decode_attention",
             "llama-3.2-vision-90b": "decode_attention"}[arch]
    outs = []
    for kernels in (False, True):
        cfg = ARCHS[arch].reduced()
        if kernels:
            cfg = cfg.for_device(dev)
        m = build_model(cfg, device=dev)
        eng = ServingEngine(m, m.init(0), **KW)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(stream)]
        build.reset_launch_counts()
        eng.serve(reqs)
        assert (build.launch_counts[cross] > 0) == kernels
        assert eng._alloc.n_free == eng.n_pages
        outs.append(([r.tokens for r in reqs], dict(eng.stats)))
    for a, b in zip(outs[0][0], outs[1][0]):
        np.testing.assert_array_equal(a, b)
    assert outs[0][1] == outs[1][1]


@pytest.mark.cuda
def test_cuda_control_plane_payload_query_at_full_width():
    """One payload query through the model-less API on a full-width
    llama3.2-1b cluster on the card: served on h100-1, with flash prefill,
    fused decode and (for the int8 sibling that use-case selection picks)
    the int8 GEMM launched, and the tokens of a fresh engine on the served
    variant's own params."""
    from repro_torch.core.api import QueryPayload, QuerySpec
    from repro_torch.core.master import MasterConfig
    from repro_torch.serving.executor import EngineExecutorConfig
    from repro_torch.sim.cluster import make_cluster
    dev = _need_cuda()
    cfg = ARCHS["llama3.2-1b"]
    c = make_cluster(n_accel=1, archs=[cfg], autoscale=False,
                     cfg=MasterConfig(worker_autoscale=False),
                     backend="real", device=dev,
                     engine_cfg=EngineExecutorConfig(
                         max_batch=8, max_len=512, decode_block=16,
                         min_bucket=8))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist()
               for n in (17, 100, 250)]
    build.reset_launch_counts()
    res = c.api.submit(QuerySpec.usecase(
        "text-generation", "openwebtext", min_accuracy=0.5,
        latency_ms=600_000,
        payload=QueryPayload.of(prompts, max_new_tokens=8))).result(
            timeout=3600.0)
    launches = dict(build.launch_counts)
    assert res.ok, (res.failed, res.variant)
    (ex,) = c.executors
    variant = c.store.registry.variants[res.variant]
    assert variant.hardware == "h100-1"
    assert variant.framework == "torch-int8"
    assert launches["flash_attention"] > 0
    assert launches["fused_paged_decode_attention"] > 0
    assert launches["int8_matmul"] > 0
    exec_eng = ex.engines[variant.name]
    model, params = ex.served_model(variant)
    assert model.cfg.quantize == "int8_cuda"
    eng = ServingEngine(model, params, max_batch=exec_eng.max_batch,
                        max_len=exec_eng.max_len,
                        decode_block=exec_eng.decode_block,
                        min_bucket=exec_eng.min_bucket,
                        page_size=exec_eng.page_size)
    reqs = [Request(rid=i, prompt=np.asarray(p, np.int32),
                    max_new_tokens=8) for i, p in enumerate(prompts)]
    eng.serve(reqs)
    for r, out in zip(reqs, res.outputs):
        np.testing.assert_array_equal(r.tokens, out)


# ----------------------------------------------------------------------
# the decode step as one captured CUDA graph


class _Uncaptured(ServingEngine):
    """The engine with its segments run as the plain loop of the step body
    on the card: the oracle of the graph replays. Nothing is captured."""

    def _capture(self):
        pass

    def _run_steps(self, n_steps):
        with torch.no_grad():
            for _ in range(n_steps):
                self._step_body()


def _kernel_llama(dev, quant="none"):
    cfg = dataclasses.replace(ARCHS["llama3.2-1b"].reduced(),
                              quantize=quant).for_device(dev)
    m = build_model(cfg, device=dev)
    params = m.init(0)
    return m, quantize_params_dense(params) if quant == "int8" else params


@pytest.mark.cuda
def test_cuda_one_decode_graph_per_engine_across_mixed_streams():
    """One captured step graph per engine however the stream mixes prompt
    buckets (the decode half of the reference's compile-count test), and
    every decode step a replay of it."""
    dev = _need_cuda()
    m, params = _kernel_llama(dev)
    eng = ServingEngine(m, params, max_batch=4, max_len=64, decode_block=4,
                        min_bucket=4, page_size=8)
    plens = [3, 5, 8, 9, 16, 2, 11, 4]
    for base in (0, 100):
        eng.serve([Request(rid=base + i,
                           prompt=np.arange(p, dtype=np.int32) % 256,
                           max_new_tokens=3) for i, p in enumerate(plens)])
        assert eng.stats["decode_traces"] == 1, eng.stats
        assert eng.stats["graph_replays"] == eng.stats["decode_steps"] > 0


@pytest.mark.cuda
def test_cuda_warmup_captures_and_serving_never_recaptures():
    """``warmup()`` captures the step graph; serving after it captures
    nothing more (the decode half of the reference's warm-up test)."""
    dev = _need_cuda()
    m, params = _kernel_llama(dev)
    eng = ServingEngine(m, params, max_batch=2, max_len=64, decode_block=4,
                        min_bucket=4, page_size=8)
    eng.warmup(prompt_lens=[5, 12])
    assert eng.stats["decode_traces"] == 1
    graph = eng._graph
    out = eng.serve([Request(rid=i, prompt=np.arange(p, dtype=np.int32),
                             max_new_tokens=2)
                     for i, p in enumerate([4, 6, 9, 12])])
    assert all(len(r.tokens) == 2 for r in out)
    assert eng.stats["decode_traces"] == 1 and eng._graph is graph


@pytest.mark.cuda
@pytest.mark.parametrize("quant,threshold", [("none", None), ("none", 8),
                                             ("int8", 8)])
def test_cuda_graph_replays_match_uncaptured_body(quant, threshold):
    """Graph replays against the plain loop of the same step body on the
    card: the same tokens bit for bit, the same counts, and every
    wrapper's credited launches equal to the launches the loop made."""
    dev = _need_cuda()
    m, params = _kernel_llama(dev, quant)
    rng = np.random.default_rng(3)
    stream = [(rng.integers(0, 256, size=n).astype(np.int32), k)
              for n, k in ((5, 6), (6, 1), (7, 9), (29, 4), (12, 12),
                           (4, 3), (16, 5), (9, 8))]
    runs = []
    for cls in (ServingEngine, _Uncaptured):
        eng = cls(m, params, **dict(KW, chunk_threshold=threshold))
        eng.warmup()
        reqs = [Request(rid=i, prompt=p, max_new_tokens=k)
                for i, (p, k) in enumerate(stream)]
        build.reset_launch_counts()
        eng.serve(reqs)
        torch.cuda.synchronize(dev)
        runs.append(([r.tokens for r in reqs], dict(eng.stats),
                     dict(build.launch_counts)))
    (tg, sg, lg), (tu, su, lu) = runs
    for a, b in zip(tg, tu):
        np.testing.assert_array_equal(a, b)
    assert sg["decode_traces"] == 1 and su["decode_traces"] == 0
    assert sg["graph_replays"] == sg["decode_steps"] > 0
    for key in ("chunk_admits", "prefill_dispatches", "decode_dispatches",
                "decode_steps", "busy_slot_steps"):
        assert sg[key] == su[key], key
    assert (sg["chunk_admits"] > 0) == (threshold is not None)
    assert lg == lu and lg["fused_paged_decode_attention"] > 0
    assert (lg["int8_matmul"] > 0) == (quant == "int8")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-base",
                                  "llama-3.2-vision-90b"])
def test_cuda_capture_leaves_pools_and_slots_bit_identical(arch):
    """Mid-serve on the card, a capture's warm-up steps and a capture
    itself change no bit of any pool, the trash page included, or of the
    slot state."""
    dev = _need_cuda()
    cfg = ARCHS[arch].reduced().for_device(dev)
    m = build_model(cfg, device=dev)
    eng = ServingEngine(m, m.init(0), **dict(KW, chunk_threshold=12))
    rng = np.random.default_rng(4)
    for i, (n, k) in enumerate(((29, 6), (5, 10), (7, 12))):
        eng.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab, size=n).astype(np.int32), max_new_tokens=k))
    eng.step()
    assert all(r is not None for r in eng._slot_req)
    state = lambda: [t.clone() for t in (  # noqa: E731
        *eng._cache.values(), eng._tok, eng._pos, eng._rem_dev,
        eng._plen_dev, eng._pbuf, eng._out, eng._step_i, eng._bt_dev)]
    before = state()
    eng._graph = None
    eng._capture()
    torch.cuda.synchronize(dev)
    for a, b in zip(before, state()):
        assert torch.equal(a, b)
    assert eng.stats["decode_traces"] == 2
    while eng.busy:
        eng.step()
    assert eng._alloc.n_free == eng.n_pages


# ----------------------------------------------------------------------
# the staging ring and preemption inside the captured step

PRESSURE = dict(stage_slots=2, admission="optimistic", n_pages=6,
                chunk_threshold=0, stream=True)


def _pressure_stream(n=10, seed=11):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, size=int(rng.integers(3, 10))
                          ).astype(np.int32), int(rng.integers(6, 13)))
            for _ in range(n)]


def _serve(eng, stream, forced=()):
    """Serve ``stream`` on a warm engine, applying ``forced`` actions
    (step index, "preempt" | "cancel", slot) between steps; returns the
    requests and each request's streamed chunks."""
    reqs = [Request(rid=i, prompt=p, max_new_tokens=k)
            for i, (p, k) in enumerate(stream)]
    for r in reqs:
        eng.submit(r)
    chunks = {r.rid: [] for r in reqs}
    n = 0
    while eng.busy:
        eng.step()
        for at, what, slot in forced:
            if at == n and eng._slot_req[slot] is not None:
                getattr(eng, what)(slot)
        n += 1
        for r, toks, _t in eng.drain_partial_outputs():
            chunks[r.rid].extend(toks)
    eng.drain_completions()
    return reqs, chunks


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_cuda_pressure_serve_graph_matches_uncaptured_and_oracle(quant):
    """The staging ring and preemption inside the captured step: with
    every prompt teacher-forced (``chunk_threshold`` 0), an optimistic,
    staged, streaming serve on a pool of a quarter of the slots' worst
    case gives the tokens of a worst-case serve bit for bit, its counts
    show refills and preemptions, every decode step is a replay of one
    graph, and an uncaptured engine with the same knobs gives the same
    tokens, counts and launches."""
    dev = _need_cuda()
    m, params = _kernel_llama(dev, quant)
    stream = _pressure_stream()
    geo = dict(max_batch=4, max_len=64, decode_block=4, min_bucket=4,
               page_size=8)
    oracle = ServingEngine(m, params, chunk_threshold=0, **geo)
    oracle.warmup()
    want, _ = _serve(oracle, stream)
    runs = []
    for cls in (ServingEngine, _Uncaptured):
        eng = cls(m, params, **dict(geo, **PRESSURE))
        eng.warmup()
        build.reset_launch_counts()
        reqs, chunks = _serve(eng, stream)
        torch.cuda.synchronize(dev)
        runs.append((reqs, chunks, dict(eng.stats),
                     dict(build.launch_counts)))
        assert eng._alloc.n_free == eng.n_pages
        assert eng._alloc.committed == 0
    (rg, cg, sg, lg), (ru, _cu, su, lu) = runs
    for a, b, c in zip(want, rg, ru):
        np.testing.assert_array_equal(b.tokens, a.tokens, err_msg=str(a.rid))
        np.testing.assert_array_equal(c.tokens, a.tokens, err_msg=str(a.rid))
        assert cg[b.rid] == [int(x) for x in b.tokens]
    assert sg["inseg_admissions"] > 0 and sg["pressure_stalls"] > 0
    assert sg["preempt_readmits"] == sg["preemptions"] > 0
    assert sg["decode_traces"] == 1
    assert sg["graph_replays"] == sg["decode_steps"] > 0
    for key in ("staged", "inseg_admissions", "preemptions",
                "preempt_readmits", "pressure_stalls", "decode_dispatches",
                "decode_steps", "busy_slot_steps", "chunk_admits"):
        assert sg[key] == su[key], key
    assert lg == lu and lg["fused_paged_decode_attention"] > 0


@pytest.mark.cuda
def test_cuda_forced_preempt_and_cancel_on_graphed_engine():
    """A forced ``preempt`` and a ``cancel`` between replays: the preempted
    request's tokens equal the oracle's, the cancelled one's are a prefix
    of them, and the pool drains."""
    dev = _need_cuda()
    m, params = _kernel_llama(dev)
    stream = _pressure_stream(n=6)
    geo = dict(max_batch=2, max_len=64, decode_block=4, min_bucket=4,
               page_size=8, chunk_threshold=0)
    oracle = ServingEngine(m, params, **geo)
    oracle.warmup()
    want, _ = _serve(oracle, stream)
    eng = ServingEngine(m, params, stage_slots=2, stream=True, **geo)
    eng.warmup()
    got, chunks = _serve(eng, stream, forced=[(1, "preempt", 0),
                                              (2, "cancel", 1)])
    assert eng.stats["decode_traces"] == 1
    assert eng.stats["graph_replays"] == eng.stats["decode_steps"]
    cut = [r for r in got if r.cancelled]
    assert len(cut) == 1 and eng.stats["preemptions"] == 1
    for a, b in zip(want, got):
        n = len(b.tokens)
        np.testing.assert_array_equal(b.tokens, a.tokens[:n])
        assert n == len(a.tokens) or b.cancelled
        assert chunks[b.rid] == [int(x) for x in b.tokens]
    assert eng._alloc.n_free == eng.n_pages


@pytest.mark.cuda
def test_cuda_capture_mid_pressure_serve_leaves_ring_and_log_intact():
    """A capture taken while requests are staged and live changes no bit
    of any pool, the slot state, the ring or the completion log."""
    dev = _need_cuda()
    m, params = _kernel_llama(dev)
    eng = ServingEngine(m, params, max_batch=2, max_len=64, decode_block=4,
                        min_bucket=4, page_size=8, **PRESSURE)
    for i, (p, k) in enumerate(_pressure_stream(n=6)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=k))
    eng.step()
    eng._sync_ring()
    assert eng._staged and int(eng._n_stage.item()) == len(eng._staged)
    state = lambda: [t.clone() for t in (  # noqa: E731
        *eng._cache.values(), eng._tok, eng._pos, eng._rem_dev,
        eng._plen_dev, eng._pbuf, eng._ring, eng._rb, eng._step_i,
        eng._bt_dev)]
    before = state()
    eng._graph = None
    eng._capture()
    torch.cuda.synchronize(dev)
    for a, b in zip(before, state()):
        assert torch.equal(a, b)
    while eng.busy:
        eng.step()
    assert eng._alloc.n_free == eng.n_pages


# ----------------------------------------------------------------------
# the contiguous decode kernel's per-slot form; the prefix cache, host
# swap and the contiguous layout inside the captured step


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("G,D", [(1, 64), (4, 64), (8, 128)])
def test_cuda_decode_attention_per_slot_lengths(dtype, G, D):
    """The contiguous kernel with (B,) device lengths at T = 512: lengths
    0 (zeros), 1, on a 64-row tile edge, T, and mixed within the batch.
    bf16 within the f32 ulp rule of the plain version on the widened
    inputs, f32 within 1e-4 of it; two calls give the same bits."""
    dev = _need_cuda()
    dt = getattr(torch, dtype)
    B, K, T = 8, 8, 512
    gen = torch.Generator(device=dev).manual_seed(G + D)
    q = torch.randn((B, K, G, D), generator=gen, device=dev).to(dt)
    k = torch.randn((B, T, K, D), generator=gen, device=dev).to(dt)
    v = torch.randn((B, T, K, D), generator=gen, device=dev).to(dt)
    lens = torch.tensor([0, 1, 64, T, 127, 128, 300, 65], dtype=torch.int32,
                        device=dev)
    out = decode_attention(q, k, v, lens)
    again = decode_attention(q, k, v, lens)
    want32 = decode_attention_plain(q.float(), k.float(), v.float(), lens)
    torch.cuda.synchronize()
    if dt == torch.bfloat16:
        assert ref.bf16_ulp_ratio(out, want32) <= 1.0
    else:
        np.testing.assert_allclose(out.cpu().numpy(), want32.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)
    assert torch.equal(out, again)
    assert not out[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_contiguous_decode_gives_the_fused_paged_bits(dtype):
    """The per-slot form folds the fused paged kernel's spans over the same
    rows: a slot's contiguous rows and the same rows behind an identity
    block table (32 pages of 16, the fused kernel writing row ``pos`` from
    ``k_new``) give the same output bits at every length."""
    dev = _need_cuda()
    dt = getattr(torch, dtype)
    B, K, G, D, ps, P = 8, 8, 4, 64, 16, 32
    T = P * ps
    gen = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn((B, K, G, D), generator=gen, device=dev).to(dt)
    k = torch.randn((B, T, K, D), generator=gen, device=dev).to(dt)
    v = torch.randn((B, T, K, D), generator=gen, device=dev).to(dt)
    pos = torch.tensor([0, 1, 63, 64, 127, 128, 300, T - 1],
                       dtype=torch.int32, device=dev)
    kp = torch.zeros((B * P + 1, ps, K, D), dtype=dt, device=dev)
    vp = torch.zeros_like(kp)
    kp[:B * P] = k.reshape(B * P, ps, K, D)
    vp[:B * P] = v.reshape(B * P, ps, K, D)
    bt = torch.arange(B * P, dtype=torch.int32, device=dev).reshape(B, P)
    rows = torch.arange(B, device=dev)
    paged, _, _ = fused_paged_decode_attention(
        q, k[rows, pos.long()].contiguous(), v[rows, pos.long()].contiguous(),
        kp, vp, bt, pos)
    contiguous = decode_attention(q, k, v, pos + 1)
    torch.cuda.synchronize()
    assert torch.equal(paged, contiguous)


@pytest.mark.cuda
def test_cuda_page_copies_never_touch_the_trash_page():
    """On the kernel pool layout (a trash page at ``n_pages``), a copy or a
    scatter aimed at the sentinel is dropped and a gather refuses it; the
    copies land bit for bit."""
    from repro_torch.models import kvcache as KV
    dev = _need_cuda()
    n_pages = 6
    gen = torch.Generator(device=dev).manual_seed(1)
    pool = torch.randn((2, n_pages + 1, 4, 2, 8), generator=gen, device=dev)
    trash = pool[:, n_pages].clone()
    KV.copy_pool_page(pool, 2, n_pages, 2, n_pages=n_pages)
    KV.copy_pool_page(pool, 2, 5, 2, n_pages=n_pages)
    assert torch.equal(pool[:, 5], pool[:, 2])
    host = KV.gather_pool_pages(pool, [1, 3], 2, n_pages=n_pages)
    assert host.device.type == "cpu"
    with pytest.raises(ValueError, match="allocatable"):
        KV.gather_pool_pages(pool, [n_pages], 2, n_pages=n_pages)
    KV.scatter_pool_pages(pool, torch.cat([host, host]), [0, n_pages, 4,
                                                          n_pages], 2,
                          n_pages=n_pages)
    torch.cuda.synchronize()
    assert torch.equal(pool[:, 0].cpu(), host[0].movedim(1, 0))
    assert torch.equal(pool[:, 4].cpu(), host[0].movedim(1, 0))
    assert torch.equal(pool[:, n_pages], trash)


def _prefix_stream():
    """Templated prompts on one two-page template: three long requests
    keep its pages live while a short one frees its slot for a request
    whose prompt is exactly the template (a full-page hit that must copy
    on write), then three more hits."""
    rng = np.random.default_rng(5)
    tpl = rng.integers(0, 256, size=16).astype(np.int32)

    def sfx():
        return rng.integers(0, 256, size=int(rng.integers(2, 9))).astype(
            np.int32)

    out = [(np.concatenate([tpl, sfx()]), k) for k in (20, 18, 16, 2)]
    out.append((tpl.copy(), 4))
    out += [(np.concatenate([tpl, sfx()]), int(rng.integers(3, 9)))
            for _ in range(3)]
    return out


def _serve_forcing_swap(eng, stream):
    """Serve ``stream`` and preempt, once, the first slot past its prompt
    feed that still owes tokens (a swap that the gates take)."""
    reqs = [Request(rid=i, prompt=p, max_new_tokens=k)
            for i, (p, k) in enumerate(stream)]
    for r in reqs:
        eng.submit(r)
    forced = False
    while eng.busy:
        eng.step()
        live = [s for s, r in enumerate(eng._slot_req) if r is not None
                and 0 < len(eng._gen[s]) < r.max_new_tokens]
        if not forced and live:
            eng.preempt(live[0])
            forced = True
        eng.drain_partial_outputs()
    eng.drain_completions()
    return reqs


CASES = {
    "prefix": (dict(max_batch=4, max_len=64, decode_block=4, min_bucket=4,
                    page_size=8, n_pages=24, chunk_threshold=0),
               dict(prefix_cache=True), _prefix_stream),
    "swap": (dict(max_batch=4, max_len=64, decode_block=4, min_bucket=4,
                  page_size=8, chunk_threshold=0),
             dict(PRESSURE, swap="host"), _pressure_stream),
    "contiguous": (dict(max_batch=3, max_len=64, decode_block=4,
                        min_bucket=4, page_size=8, chunk_threshold=8),
                   dict(page_size=None), None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_prefix_swap_and_contiguous_graph_match_uncaptured(case):
    """On the card, each of the prefix cache with a copy-on-write hit, a
    host swap round trip under pressure, and the contiguous layout: the
    graphed engine and an uncaptured one give the same tokens, counts and
    launches per wrapper, every decode step a replay of one graph; the
    tokens equal the plain worst-case paged serve's (prefix off, no swap,
    the paged layout), bit for bit."""
    dev = _need_cuda()
    m, params = _kernel_llama(dev)
    geo, knobs, make = CASES[case]
    if make is None:
        rng = np.random.default_rng(3)
        stream = [(rng.integers(0, 256, size=n).astype(np.int32), k)
                  for n, k in ((5, 6), (6, 1), (7, 9), (29, 4), (12, 12),
                               (4, 3), (16, 5), (9, 8))]
    else:
        stream = make()
    oracle = ServingEngine(m, params, **geo)
    oracle.warmup()
    want = oracle.serve([Request(rid=i, prompt=p, max_new_tokens=k)
                         for i, (p, k) in enumerate(stream)])
    runs = []
    for cls in (ServingEngine, _Uncaptured):
        eng = cls(m, params, **dict(geo, **knobs))
        eng.warmup()
        build.reset_launch_counts()
        if case == "swap":
            reqs = _serve_forcing_swap(eng, stream)
        else:
            reqs = eng.serve([Request(rid=i, prompt=p, max_new_tokens=k)
                              for i, (p, k) in enumerate(stream)])
        torch.cuda.synchronize(dev)
        runs.append((reqs, dict(eng.stats), dict(build.launch_counts)))
        if eng._alloc is not None:
            assert eng._alloc.n_free + eng._alloc.n_cached == eng.n_pages
            assert eng._alloc.committed == 0
        assert eng._swap_live_bytes == 0
    (rg, sg, lg), (ru, su, lu) = runs
    for a, b, c in zip(want, rg, ru):
        np.testing.assert_array_equal(b.tokens, a.tokens, err_msg=str(a.rid))
        np.testing.assert_array_equal(c.tokens, a.tokens, err_msg=str(a.rid))
    assert sg["decode_traces"] == 1 and su["decode_traces"] == 0
    assert sg["graph_replays"] == sg["decode_steps"] > 0
    for key in ("prefix_hits", "prefix_pages_reused", "prefix_tokens_skipped",
                "cow_copies", "swap_out", "swap_in", "swap_fallbacks",
                "swap_bytes", "preemptions", "decode_dispatches",
                "decode_steps", "busy_slot_steps", "chunk_admits"):
        assert sg[key] == su[key], key
    assert lg == lu
    if case == "prefix":
        assert sg["prefix_hits"] > 0 and sg["cow_copies"] >= 1
        assert lg["fused_paged_decode_attention"] > 0
    if case == "swap":
        assert sg["swap_out"] == sg["swap_in"] >= 1
    if case == "contiguous":
        n_layers = m.cfg.n_layers
        assert lg["fused_paged_decode_attention"] == 0
        assert lg["decode_attention"] == sg["decode_steps"] * n_layers
        assert sg["chunk_admits"] > 0


# ----------------------------------------------------------------------
# prefill as one captured graph per (nbatch, bucket) key


class _EagerPrefill(ServingEngine):
    """The engine with every prefill dispatch run as its body, op by op,
    on the card: the oracle of the prefill graphs. Nothing of prefill is
    captured (the decode step still is)."""

    def _capture_prefill(self, prog):
        pass

    def _run_prefill(self, prog):
        with torch.no_grad():
            self._prefill_body(prog)


def _family(dev, arch, quant="none"):
    cfg = dataclasses.replace(ARCHS[arch].reduced(), quantize=quant)
    m = build_model(cfg.for_device(dev), device=dev)
    params = m.init(0)
    return m, quantize_params_dense(params) if quant == "int8" else params


@pytest.mark.cuda
@pytest.mark.parametrize("arch,quant", [
    ("llama3.2-1b", "none"), ("llama3.2-1b", "int8"),
    ("whisper-base", "none"), ("llama-3.2-vision-90b", "none")])
def test_cuda_prefill_graphs_give_the_eager_body_bits(arch, quant):
    """Per family, admission rounds of one- and many-row dispatches over
    several buckets: after each round every leaf (trash page included),
    ``tok``, ``pos``, ``rem`` and ``plen`` of the graphed engine equal the
    eager-prefill engine's bit for bit, and so do the first tokens; the
    serves then give the same tokens, one program (one graph) a key,
    replayed once a dispatch, with the same credited launches."""
    dev = _need_cuda()
    m, params = _family(dev, arch, quant)
    geo = dict(KW, n_pages=None)
    lens = [(3, 5), (9, 4), (17, 6), (5, 3), (12, 7), (30, 2), (7, 8),
            (2, 5), (20, 3)]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, m.cfg.vocab, size=n).astype(np.int32)
               for n, _ in lens]
    engs = [cls(m, params, **geo) for cls in (ServingEngine, _EagerPrefill)]
    for eng in engs:
        eng.warmup(prompt_lens=[n for n, _ in lens])
    assert len(engs[0]._prefill_fns) == engs[0].stats["prefill_traces"]
    assert all(p.graph is not None for p in engs[0]._prefill_fns.values())
    assert all(p.graph is None for p in engs[1]._prefill_fns.values())
    reqs = [[Request(rid=i, prompt=p, max_new_tokens=k)
             for i, (p, (_, k)) in enumerate(zip(prompts, lens))]
            for _ in engs]
    for eng, rs in zip(engs, reqs):
        for r in rs:
            eng.submit(r)
    build.reset_launch_counts()
    counts = []
    while any(e.busy for e in engs):
        for eng in engs:
            eng._admit_pending()
        torch.cuda.synchronize(dev)
        a, b = engs
        for name in a._cache:
            assert torch.equal(a._cache[name], b._cache[name]), name
        for t in ("_tok", "_pos", "_rem_dev", "_plen_dev"):
            assert torch.equal(getattr(a, t), getattr(b, t)), t
        assert a._gen == b._gen
        for eng in engs:
            before = dict(build.launch_counts)
            eng.step()
            counts.append({k: build.launch_counts[k] - before[k]
                           for k in before})
    for x, y in zip(*reqs):
        np.testing.assert_array_equal(x.tokens, y.tokens)
    sg, se = engs[0].stats, engs[1].stats
    assert sg["prefill_replays"] == sg["prefill_dispatches"] > 1
    assert se["prefill_replays"] == 0
    assert sg["prefill_traces"] == se["prefill_traces"]
    # the admissions above launched the same kernels on both engines
    assert counts[0::2] == counts[1::2]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-base",
                                  "llama-3.2-vision-90b"])
def test_cuda_prefill_capture_mid_serve_leaves_pools_and_slots(arch):
    """Mid-serve on the card, capturing a new prefill key (its warm-up
    runs and the capture) changes no bit of any pool, the trash page
    included, or of the slot state; the serve then completes."""
    dev = _need_cuda()
    m, params = _family(dev, arch)
    eng = ServingEngine(m, params, **KW)
    rng = np.random.default_rng(4)
    for i, (n, k) in enumerate(((9, 12), (5, 10), (7, 11))):
        eng.submit(Request(rid=i, prompt=rng.integers(
            0, m.cfg.vocab, size=n).astype(np.int32), max_new_tokens=k))
    eng.step()
    assert all(r is not None for r in eng._slot_req)
    traces = eng.stats["prefill_traces"]

    def state():
        return [t.clone() for t in (*eng._cache.values(), eng._tok,
                                    eng._pos, eng._rem_dev, eng._plen_dev,
                                    eng._pbuf, eng._bt_dev)]

    before = state()
    eng._get_prefill(32, KW["max_batch"])
    torch.cuda.synchronize(dev)
    for a, b in zip(before, state()):
        assert torch.equal(a, b)
    assert eng.stats["prefill_traces"] == traces + 1
    while eng.busy:
        eng.step()
    assert eng._alloc.n_free == eng.n_pages


def _wall_cuda_cluster(dev, n_accel):
    from repro_torch.serving.executor import EngineExecutorConfig
    from repro_torch.sim.cluster import make_cluster
    return make_cluster(n_accel=n_accel, archs=[ARCHS["llama3.2-1b"]],
                        autoscale=False, backend="real", clock="wall",
                        device=dev, reduced=True,
                        engine_cfg=EngineExecutorConfig(
                            max_batch=4, max_len=48, decode_block=4))


@pytest.mark.cuda
def test_cuda_wall_serve_two_steppers_exact_and_no_capture_after_warmup():
    """Two workers' stepper threads on one card under the wall clock, both
    variants' engines warmed for the stream's buckets first: every query
    returns a direct engine's tokens on the served variant's params, its
    streamed concat equals its outputs, no graph is captured during the
    serve, and shutdown drains with every stepper joined."""
    from repro_torch.core.api import QueryPayload, QuerySpec
    from repro_torch.serving.runtime import ServingRuntime
    dev = _need_cuda()
    c = _wall_cuda_cluster(dev, 2)
    cfg = ARCHS["llama3.2-1b"]
    rng = np.random.default_rng(9)
    payloads = [[rng.integers(0, 256, size=int(n)).astype(np.int32)
                 for n in rng.integers(3, 30, size=2)] for _ in range(8)]
    names = [f"{cfg.name}/h100-1/{d}-b8" for d in ("bf16", "int8")]
    lens = [len(p) for ps in payloads for p in ps]
    for ex in c.executors:
        for name in names:
            ex._engine(c.store.registry.variants[name]).warmup(lens)
    traces = {(id(ex), n): (e.stats["prefill_traces"],
                            e.stats["decode_traces"])
              for ex in c.executors for n, e in ex.engines.items()}
    rt = ServingRuntime(c)
    try:
        hs = [rt.submit(QuerySpec.variant(
            names[i % 2], latency_ms=600_000,
            payload=QueryPayload.of(ps, max_new_tokens=10)))
            for i, ps in enumerate(payloads)]
        results = [h.result(timeout=600.0) for h in hs]
    finally:
        assert rt.shutdown(drain=True, timeout=120.0)
    assert all(ex._thread is None or not ex._thread.is_alive()
               for ex in c.executors)
    assert {(id(ex), n): (e.stats["prefill_traces"],
                          e.stats["decode_traces"])
            for ex in c.executors for n, e in ex.engines.items()} == traces
    ex0 = c.executors[0]
    for ps, h, res in zip(payloads, hs, results):
        assert res.ok, (res.failed, res.variant)
        for idx, out in enumerate(res.outputs):
            assert [t for ch in h.chunks if ch.input_idx == idx
                    for t in ch.tokens] == [int(x) for x in out]
        variant = c.store.registry.variants[res.variant]
        model, params = ex0.served_model(variant)
        eng = ServingEngine(model, params, max_batch=4, max_len=48,
                            decode_block=4, min_bucket=4, page_size=16)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=10)
                for i, p in enumerate(ps)]
        eng.serve(reqs)
        for r, out in zip(reqs, res.outputs):
            np.testing.assert_array_equal(r.tokens, out)


# ----------------------------------------------------------------------
# speculative decoding and the hybrid family on the card


class _UncapturedSpec(_Uncaptured):
    """The uncaptured oracle of a speculating engine: its propose, verify
    and resync programs run their bodies too."""

    def _capture_prefill(self, prog):
        pass

    def _run_prefill(self, prog):
        with torch.no_grad():
            self._prefill_body(prog)

    def _capture_spec(self, prog):
        pass

    def _run_spec(self, prog):
        with torch.no_grad():
            prog.body()


@pytest.mark.cuda
def test_cuda_paged_update_window_captured_in_a_graph():
    """The window write (B x S rows through the block table, sentinel rows
    dropped by the spare-row rewrite) captured in a CUDA graph: a replay
    writes the eager call's bits, and the dropped rows touch nothing."""
    from repro_torch.models import kvcache as KV
    from repro_torch.serving.engine import capture_graph
    dev = _need_cuda()
    gen = torch.Generator(device=dev).manual_seed(3)
    B, S, ps, K, D, P, n_pages = 3, 5, 8, 4, 16, 4, 12
    pool = torch.randn((n_pages, ps, K, D), generator=gen, device=dev)
    k_new = torch.randn((B, S, K, D), generator=gen, device=dev)
    v_new = torch.randn((B, S, K, D), generator=gen, device=dev)
    bt = torch.full((B, P), n_pages, dtype=torch.int32, device=dev)
    bt[0, :2] = torch.tensor([5, 2], device=dev)
    bt[1, :1] = torch.tensor([9], device=dev)        # slot 2: all sentinel
    pos = torch.tensor([6, 2, 0], dtype=torch.int32, device=dev)
    want_k, want_v = pool.clone(), pool.clone()
    KV.paged_update_window(want_k, want_v, k_new, v_new, bt, pos)
    gk, gv = pool.clone(), pool.clone()
    KV.paged_update_window(gk.clone(), gv.clone(), k_new, v_new, bt, pos)
    graph, _ = capture_graph(dev, lambda: KV.paged_update_window(
        gk, gv, k_new, v_new, bt, pos))
    graph.replay()
    torch.cuda.synchronize(dev)
    assert torch.equal(gk, want_k) and torch.equal(gv, want_v)
    touched = torch.zeros((n_pages, ps), dtype=torch.bool, device=dev)
    touched[5, 6:], touched[2, :3], touched[9, 2:7] = True, True, True
    assert torch.equal(gk[~touched], pool[~touched])


def _spec_models(dev, quant="none"):
    base = dataclasses.replace(ARCHS["llama3.2-1b"].reduced(),
                               quantize=quant)
    target = build_model(base.for_device(dev, speculate=True), device=dev)
    assert target.cfg.attention_impl == "torch"
    params = target.init(0)
    if quant == "int8":
        params = quantize_params_dense(params)
    draft = build_model(dataclasses.replace(
        ARCHS["llama3.2-1b"].reduced(), quantize="int8").for_device(dev),
        device=dev)
    dparams = quantize_params_dense(target.init(0)) if quant == "none" \
        else params
    return target, params, draft, dparams


@pytest.mark.cuda
@pytest.mark.parametrize("page_size", [8, None])
def test_cuda_spec_graphs_match_their_bodies(page_size):
    """A speculating engine's propose, verify and resync graphs (captured
    at warmup) against their bodies on the same inputs, bit for bit, and
    its serve against an uncaptured oracle's: the same tokens, spec
    counts and credited launches. The target attends in plain PyTorch,
    so its tokens are also a plain graphed engine's."""
    dev = _need_cuda()
    target, params, draft, dparams = _spec_models(dev)
    rng = np.random.default_rng(5)
    stream = [(rng.integers(0, 256, size=int(n)).astype(np.int32), int(m))
              for n, m in zip(rng.integers(3, 20, 8), rng.integers(6, 14, 8))]
    kw = dict(max_batch=3, max_len=48, decode_block=4, min_bucket=4,
              page_size=page_size)
    runs = []
    for cls, spec in ((ServingEngine, True), (_UncapturedSpec, True),
                      (ServingEngine, False)):
        eng = cls(target, params, **kw, **(dict(
            speculate=(draft, dparams), spec_k=3) if spec else {}))
        eng.warmup(prompt_lens=[len(p) for p, _ in stream])
        reqs = [Request(rid=i, prompt=p, max_new_tokens=m)
                for i, (p, m) in enumerate(stream)]
        build.reset_launch_counts()
        eng.serve(reqs)
        torch.cuda.synchronize(dev)
        runs.append(([r.tokens for r in reqs], dict(eng.stats),
                     dict(build.launch_counts), eng))
    (tg, sg, lg, eng), (tu, su, lu, _), (tp, _, _, _) = runs
    for a, b, c in zip(tg, tu, tp):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert sg["spec_rounds"] > 0
    for key in ("spec_rounds", "spec_proposed", "spec_accepted",
                "decode_steps"):
        assert sg[key] == su[key], key
    assert lg == lu
    assert lg["flash_attention"] > 0 and lg["decode_attention"] > 0
    assert lg["int8_matmul"] > 0 and lg["fused_paged_decode_attention"] == 0
    progs = [eng._spec.propose_program(), eng._get_verify()] + [
        p for p, _ in eng._spec._resync.values()][:2]
    state = (list(eng._cache.values()) + list(eng._spec.cache.values())
             + [eng._spec_out])
    for prog in progs:
        assert prog.graph is not None, prog.name
        snap = [t.clone() for t in state]
        prog.graph.replay()
        torch.cuda.synchronize(dev)
        graphed = [t.clone() for t in state]
        for t, v in zip(state, snap):
            t.copy_(v)
        with torch.no_grad():
            prog.body()
        torch.cuda.synchronize(dev)
        assert all(torch.equal(a, b) for a, b in zip(graphed, state)), \
            prog.name


@pytest.mark.cuda
def test_cuda_speculation_refuses_the_kernel_attention():
    dev = _need_cuda()
    cfg = ARCHS["llama3.2-1b"].reduced().for_device(dev)
    m = build_model(cfg, device=dev)
    with pytest.raises(ValueError, match="attention_impl='torch'"):
        ServingEngine(m, m.init(0), max_batch=2, speculate=(m, None))


@pytest.mark.cuda
@pytest.mark.parametrize("page_size", [8, None])
def test_cuda_zamba_ring_refill_resets_state_rows_in_the_graph(page_size):
    """zamba2 (reduced) on the kernel impls, every prompt fed
    (``chunk_threshold=0``): with the staging ring the captured step
    refills freed slots, resetting their ssm and conv rows in the graph;
    the tokens equal boundary-only admission's and an uncaptured engine's
    with the ring, and the shared block ran the fused paged or the
    contiguous decode kernel."""
    dev = _need_cuda()
    cfg = ARCHS["zamba2-1.2b"].reduced().for_device(dev)
    m = build_model(cfg, device=dev)
    params = m.init(0)
    rng = np.random.default_rng(8)
    stream = [(rng.integers(0, 256, size=int(n)).astype(np.int32), int(k))
              for n, k in zip(rng.integers(3, 12, 8), rng.integers(1, 6, 8))]
    kw = dict(max_batch=2, max_len=64, decode_block=8, min_bucket=4,
              page_size=page_size, chunk_threshold=0)
    runs = []
    for cls, stage in ((ServingEngine, 0), (ServingEngine, 4),
                       (_Uncaptured, 4)):
        eng = cls(m, params, stage_slots=stage, **kw)
        eng.warmup()
        reqs = [Request(rid=i, prompt=p, max_new_tokens=k)
                for i, (p, k) in enumerate(stream)]
        build.reset_launch_counts()
        eng.serve(reqs)
        torch.cuda.synchronize(dev)
        runs.append(([r.tokens for r in reqs], dict(eng.stats),
                     dict(build.launch_counts)))
    (t0, s0, _), (tr, sr, lr), (tu, su, lu) = runs
    for a, b, c in zip(t0, tr, tu):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert sr["inseg_admissions"] > 0 and s0["inseg_admissions"] == 0
    assert sr["graph_replays"] == sr["decode_steps"] and lr == lu
    kernel = ("fused_paged_decode_attention" if page_size
              else "decode_attention")
    assert lr[kernel] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_decode_kernels_at_zamba_k32(dtype):
    """zamba2's shared block: K = 32 KV heads, G = 1, D = 64. The fused
    paged kernel (B1) and the contiguous kernel's per-slot form (B5)
    against their plain versions (bf16: the f32 ulp rule; f32: 1e-4), and
    B5 giving B1's bits on the same rows."""
    dev = _need_cuda()
    dt = getattr(torch, dtype)
    B, K, G, D, ps, P = 8, 32, 1, 64, 16, 32
    T = P * ps
    gen = torch.Generator(device=dev).manual_seed(32)
    q = torch.randn((B, K, G, D), generator=gen, device=dev).to(dt)
    k = torch.randn((B, T, K, D), generator=gen, device=dev).to(dt)
    v = torch.randn((B, T, K, D), generator=gen, device=dev).to(dt)
    pos = torch.tensor([0, 1, 63, 64, 127, 128, 300, T - 1],
                       dtype=torch.int32, device=dev)
    kp = torch.zeros((B * P + 1, ps, K, D), dtype=dt, device=dev)
    vp = torch.zeros_like(kp)
    kp[:B * P] = k.reshape(B * P, ps, K, D)
    vp[:B * P] = v.reshape(B * P, ps, K, D)
    bt = torch.arange(B * P, dtype=torch.int32, device=dev).reshape(B, P)
    rows = torch.arange(B, device=dev)
    kn = k[rows, pos.long()].contiguous()
    vn = v[rows, pos.long()].contiguous()
    paged, _, _ = fused_paged_decode_attention(q, kn, vn, kp.clone(),
                                               vp.clone(), bt, pos)
    contiguous = decode_attention(q, k, v, pos + 1)
    want32 = decode_attention_plain(q.float(), k.float(), v.float(), pos + 1)
    torch.cuda.synchronize()
    assert torch.equal(paged, contiguous)
    if dt == torch.bfloat16:
        assert ref.bf16_ulp_ratio(contiguous, want32) <= 1.0
    else:
        np.testing.assert_allclose(contiguous.cpu().numpy(),
                                   want32.cpu().numpy(), rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# the moe (moonshot-v1-16b-a3b) and ssm (xlstm-1.3b) families


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_decode_kernels_at_moonshot_k16(dtype):
    """moonshot's attention: K = 16 KV heads, G = 1, D = 128. The fused
    paged kernel (B1, the write row on a span edge) and the contiguous
    kernel's per-slot form (B5) against their plain versions (bf16: the
    f32 ulp rule; f32: 1e-4), and B5 giving B1's bits on the same rows."""
    dev = _need_cuda()
    dt = getattr(torch, dtype)
    B, K, G, D, ps, P = 8, 16, 1, 128, 16, 32
    T = P * ps
    gen = torch.Generator(device=dev).manual_seed(16)
    q = torch.randn((B, K, G, D), generator=gen, device=dev).to(dt)
    k = torch.randn((B, T, K, D), generator=gen, device=dev).to(dt)
    v = torch.randn((B, T, K, D), generator=gen, device=dev).to(dt)
    pos = torch.tensor([0, 1, 63, 64, 127, 128, 300, T - 1],
                       dtype=torch.int32, device=dev)
    kp = torch.zeros((B * P + 1, ps, K, D), dtype=dt, device=dev)
    vp = torch.zeros_like(kp)
    kp[:B * P] = k.reshape(B * P, ps, K, D)
    vp[:B * P] = v.reshape(B * P, ps, K, D)
    bt = torch.arange(B * P, dtype=torch.int32, device=dev).reshape(B, P)
    rows = torch.arange(B, device=dev)
    kn = k[rows, pos.long()].contiguous()
    vn = v[rows, pos.long()].contiguous()
    paged, _, _ = fused_paged_decode_attention(q, kn, vn, kp.clone(),
                                               vp.clone(), bt, pos)
    contiguous = decode_attention(q, k, v, pos + 1)
    want32 = decode_attention_plain(q.float(), k.float(), v.float(), pos + 1)
    torch.cuda.synchronize()
    assert torch.equal(paged, contiguous)
    if dt == torch.bfloat16:
        assert ref.bf16_ulp_ratio(contiguous, want32) <= 1.0
    else:
        np.testing.assert_allclose(contiguous.cpu().numpy(),
                                   want32.cpu().numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.cuda
def test_cuda_moe_ffn_same_bits_on_every_call_and_in_a_graph():
    """The MoE FFN at moonshot's width (64 experts, top 6, 2 shared, d
    2048, d_ff 1408; one layer, bf16) on a decode batch of 8 rows and a
    prefill of 512: two calls give the same bits, and so does a replay of
    the captured call (the dispatch is a plain indexed write, the combine
    a fixed-order sum: no atomics)."""
    from repro_torch.models import moe as M
    from repro_torch.serving.engine import capture_graph
    dev = _need_cuda()
    cfg = dataclasses.replace(ARCHS["moonshot-v1-16b-a3b"], n_layers=1)
    gen = torch.Generator(device=dev).manual_seed(3)
    from repro_torch.models.transformer import stack_layer
    p = stack_layer(M._moe_mlp_init(cfg, gen, 1, torch.bfloat16, dev), 0)
    for rows in (8, 512):
        x = torch.randn((1, rows, cfg.d_model), generator=gen,
                        device=dev).bfloat16()
        a = M.moe_ffn_dense(x, p, cfg)
        b = M.moe_ffn_dense(x, p, cfg)
        out = torch.empty_like(a)

        def body():
            out.copy_(M.moe_ffn_dense(x, p, cfg))

        body()
        graph, _ = capture_graph(dev, body)
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(a, b) and torch.equal(out, a), rows
        assert a.isfinite().all()


@pytest.mark.cuda
def test_cuda_moe_engine_graphs_match_uncaptured_one_prompt_a_dispatch():
    """moonshot (reduced) on the kernel impls: the graphed serve's tokens
    equal the uncaptured body's, paged and contiguous alike; one prefill
    dispatch per request, every key of ``nbatch`` 1."""
    dev = _need_cuda()
    cfg = ARCHS["moonshot-v1-16b-a3b"].reduced().for_device(dev)
    m = build_model(cfg, device=dev)
    params = m.init(0)
    rng = np.random.default_rng(9)
    stream = [(rng.integers(0, 256, size=int(n)).astype(np.int32), int(k))
              for n, k in zip(rng.integers(3, 30, 8), rng.integers(1, 8, 8))]
    toks = []
    for ps in (8, None):
        for cls in (ServingEngine, _Uncaptured):
            eng = cls(m, params, **dict(KW, page_size=ps, n_pages=None))
            eng.warmup(prompt_lens=[len(p) for p, _ in stream])
            reqs = [Request(rid=i, prompt=p, max_new_tokens=k)
                    for i, (p, k) in enumerate(stream)]
            eng.serve(reqs)
            torch.cuda.synchronize(dev)
            assert eng.stats["prefill_dispatches"] == len(stream)
            assert {nb for nb, _ in eng._prefill_fns} == {1}
            toks.append([r.tokens for r in reqs])
    for run in toks[1:]:
        for a, b in zip(toks[0], run):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_cuda_xlstm_ring_refill_writes_the_empty_rows_in_the_graph():
    """xlstm (reduced) on the card, every prompt fed (``chunk_threshold=0``)
    and a page size that must stay inert: with the staging ring the
    captured step refills freed slots, resetting their state rows to the
    -1e30 empty state inside the graph; the tokens equal boundary-only
    admission's and an uncaptured engine's with the ring. A slot the
    graph refilled holds the empty rows after the refilling step."""
    dev = _need_cuda()
    cfg = ARCHS["xlstm-1.3b"].reduced().for_device(dev)
    m = build_model(cfg, device=dev)
    params = m.init(0)
    rng = np.random.default_rng(8)
    stream = [(rng.integers(0, 256, size=int(n)).astype(np.int32), int(k))
              for n, k in zip(rng.integers(3, 12, 8), rng.integers(1, 6, 8))]
    kw = dict(max_batch=2, max_len=64, decode_block=8, min_bucket=4,
              page_size=8, chunk_threshold=0)
    runs = []
    for cls, stage in ((ServingEngine, 0), (ServingEngine, 4),
                       (_Uncaptured, 4)):
        eng = cls(m, params, stage_slots=stage, **kw)
        assert not eng._paged
        eng.warmup()
        reqs = [Request(rid=i, prompt=p, max_new_tokens=k)
                for i, (p, k) in enumerate(stream)]
        eng.serve(reqs)
        torch.cuda.synchronize(dev)
        runs.append(([r.tokens for r in reqs], dict(eng.stats)))
    (t0, s0), (tr, sr), (tu, _) = runs
    for a, b, c in zip(t0, tr, tu):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert sr["inseg_admissions"] > 0 and s0["inseg_admissions"] == 0
    assert sr["graph_replays"] == sr["decode_steps"]
    # one replay whose step refills slot 0 from the ring
    eng = ServingEngine(m, params, stage_slots=2, **kw)
    eng.warmup()
    eng._seat_prefix(0, np.array([4], np.int32), 1)
    eng._staged.append((Request(rid=9, prompt=np.array([9, 8], np.int32),
                                max_new_tokens=2), ("stage", 0), None))
    eng._ring_stale = True
    eng._sync_ring()
    for name in eng._reset_rows:
        eng._cache[name].normal_()
    eng._step_i.zero_()
    eng._graph.replay()
    torch.cuda.synchronize(dev)
    assert int(eng._comp_adm[0]) == 1
    for name, row in eng._reset_rows.items():
        assert torch.equal(eng._cache[name][:, 0], row[0]), name
