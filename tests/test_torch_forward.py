"""The port's full-sequence forwards, loss and gradients, the chunked
attention and the kernel-impl gradient guard, against the JAX package on
the CPU at reduced f32 sizes, on the same weights (carried across by
``repro_torch.convert``) and the same numpy batches; plus mirrors of
``test_models_smoke.py``'s forward, loss/grad and decode-vs-forward tests.

Tolerances: logits within 5e-5 (rtol and atol; the f32 sums of a few
layers taken in another order by two frameworks, measured up to 7e-6);
each grad leaf within 1e-4 of that leaf's scale, its largest reference
magnitude (measured up to 3.3e-5, in the xLSTM and Mamba recurrences);
the chunked attention's output and grads within 1e-5 (measured 6e-7).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.models import build_model as j_build
from repro.models import layers as JL
from repro.training import data as j_data
from repro_torch.configs.registry import ARCHS as T_ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model as t_build
from repro_torch.models import layers as TL
from repro_torch.models import make_batch
from repro_torch.models.quantize import qeinsum, quantize_weight
from repro_torch.training.train_loop import loss_and_grads
from repro_torch.tree import leaves

# six xdist workers share the cores with XLA's threads: one torch thread
# each keeps them from oversubscribing
torch.set_num_threads(1)

FAMILIES = ["llama3.2-1b", "moonshot-v1-16b-a3b", "zamba2-1.2b",
            "xlstm-1.3b", "whisper-base", "llama-3.2-vision-90b"]
LOGIT_TOL = dict(rtol=5e-5, atol=5e-5)
GRAD_SCALE_TOL = 1e-4
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
BATCH, SEQ = 2, 32

_REF = {}


def _batch(arch):
    return j_data.batch_at_step(J_ARCHS[arch].reduced(),
                                j_data.DataConfig(batch=BATCH, seq=SEQ), 3)


def _reference(arch):
    """The JAX model's params, logits, loss and grads on ``_batch``, once
    per family per module."""
    if arch not in _REF:
        jm = j_build(J_ARCHS[arch].reduced())
        jp = jm.init(jax.random.PRNGKey(0))
        jb = {k: jnp.asarray(v) for k, v in _batch(arch).items()}
        # one program: a second compile of the forward costs seconds
        logits, (loss, grads) = jax.jit(lambda p, b: (
            jm.forward(p, b), jax.value_and_grad(jm.loss)(p, b)))(jp, jb)
        _REF[arch] = dict(params=jp, logits=np.asarray(logits),
                          loss=float(loss),
                          grads={k: np.asarray(v) for k, v in leaves(grads)})
    return _REF[arch]


def _torch_batch(arch):
    return {k: torch.from_numpy(v) for k, v in _batch(arch).items()}


def _grads(model, params, batch):
    loss, grads = loss_and_grads(model, params, batch)
    return loss, dict(leaves(grads))


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_logits_match_jax(arch):
    ref = _reference(arch)
    tm = t_build(T_ARCHS[arch].reduced(), device="cpu")
    tp = params_from_jax(ref["params"], "cpu")
    with torch.no_grad():
        logits = tm.forward(tp, _torch_batch(arch))
    assert logits.dtype == torch.float32
    assert logits.shape == (BATCH, SEQ, tm.cfg.vocab)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], **LOGIT_TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch):
    """``loss`` and every grad leaf against ``jax.value_and_grad`` of the
    reference loss. The port runs with ``remat`` on (the reference's
    reduced config has it off): recomputing in backward changes nothing."""
    ref = _reference(arch)
    cfg = dataclasses.replace(T_ARCHS[arch].reduced(), remat=True)
    tm = t_build(cfg, device="cpu")
    loss, grads = _grads(tm, params_from_jax(ref["params"], "cpu"),
                         _torch_batch(arch))
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-6)
    assert grads.keys() == ref["grads"].keys()
    for k, g in grads.items():
        want = ref["grads"][k]
        err = float(np.max(np.abs(g.numpy() - want)))
        assert err <= GRAD_SCALE_TOL * float(np.max(np.abs(want))), (k, err)


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_gives_the_same_bits(arch):
    """``cfg.remat`` recomputes each block in backward through
    ``torch.utils.checkpoint``: loss and grads equal the plain run's bit
    for bit (nothing in a remat body writes into a saved tensor)."""
    cfg = T_ARCHS[arch].reduced()
    batch = make_batch(cfg, torch.Generator().manual_seed(1), BATCH, SEQ)
    out = []
    for remat in (False, True):
        tm = t_build(dataclasses.replace(cfg, remat=remat), device="cpu")
        out.append(_grads(tm, tm.init(0), batch))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    targets = rng.integers(0, 50, (3, 7)).astype(np.int32)
    got = TL.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(targets))
    want = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(targets))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# chunked attention with a recomputing backward


CHUNK_CASES = {
    # name: (S, T, causal, q_offset)
    "causal": (512, 512, True, 0),
    "full": (512, 512, False, 0),
    "causal_offset": (512, 512, True, 100),
    "two_key_blocks": (512, 1024, True, 512),
}


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_torch_chunked_matches_jax_chunked(case):
    S, T, causal, off = CHUNK_CASES[case]
    rng = np.random.default_rng(len(case))
    q = rng.standard_normal((1, S, 2, 2, 16)).astype(np.float32)
    k = rng.standard_normal((1, T, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, T, 2, 16)).astype(np.float32)
    dout = rng.standard_normal((1, S, 2, 2, 16)).astype(np.float32)

    def ref(q, k, v):
        return JL._attention_chunked(q, k, v, causal=causal, q_offset=off,
                                     kv_valid_len=None)
    j_out, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k),
                         jnp.asarray(v))
    j_grads = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = TL.attention_core(tq, tk, tv, causal=causal, q_offset=off,
                            impl="torch_chunked")
    assert type(out.grad_fn).__name__ == "ChunkedAttentionBackward"
    # the forward saves (q, k, v, out, lse): nothing S x T
    saved = [tuple(t.shape) for t in out.grad_fn.saved_tensors]
    assert saved == [q.shape, k.shape, v.shape, q.shape, (1, 2, 2, S)]
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               **ATTN_TOL)
    for g, want in zip(grads, j_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **ATTN_TOL)


@pytest.mark.parametrize("shape,valid,chunked", [
    ((512, 512), None, True),
    ((256, 512), None, False),     # S must exceed 256
    ((384, 512), None, False),     # S % 256 != 0
    ((512, 768), None, False),     # T % 512 != 0
    ((512, 512), 300, False),      # kv_valid_len takes the plain path
])
def test_torch_chunked_dispatch_is_the_references(shape, valid, chunked):
    """``impl="torch_chunked"`` takes the chunked path exactly where
    ``repro``'s ``"xla_chunked"`` does, and otherwise gives the plain
    path's bits."""
    S, T = shape
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((1, S, 1, 2, 16), generator=gen).requires_grad_(True)
    k = torch.randn((1, T, 1, 16), generator=gen)
    out = TL.attention_core(q, k, k, causal=False, kv_valid_len=valid,
                            impl="torch_chunked")
    assert (type(out.grad_fn).__name__
            == "ChunkedAttentionBackward") == chunked
    if not chunked:
        plain = TL.attention_core(q, k, k, causal=False, kv_valid_len=valid,
                                  impl="torch")
        assert torch.equal(out, plain)


def test_dense_model_on_torch_chunked_matches_plain():
    """llama3.2-1b reduced at S = 512 (two query blocks): loss and every
    grad leaf on ``torch_chunked`` against the plain impl."""
    cfg = T_ARCHS["llama3.2-1b"].reduced()
    batch = make_batch(cfg, torch.Generator().manual_seed(2), 1, 512)
    out = []
    for impl in ("torch", "torch_chunked"):
        tm = t_build(dataclasses.replace(cfg, attention_impl=impl),
                     device="cpu")
        out.append(_grads(tm, tm.init(0), batch))
    (l0, g0), (l1, g1) = out
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(),
                                   rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# the kernel impls refuse a gradient


def test_kernel_impls_refuse_a_gradient():
    """Asked for a gradient, the CUDA attention impl and the int8 GEMM
    impl raise, naming the impl, before any device check; without one
    (``no_grad``, or no input that requires grad) they go on to their
    usual CPU refusal."""
    q = torch.zeros((2, 3, 1, 2, 16), requires_grad=True)
    k = torch.zeros((2, 4, 1, 16))
    with pytest.raises(RuntimeError, match="attention impl 'cuda'"):
        TL.attention_core(q, k, k, causal=True, impl="cuda")
    with pytest.raises(RuntimeError, match="attention impl 'cuda'"):
        TL.paged_attention_core(q[:, :1], k, k, torch.zeros((2, 1)),
                                kv_valid_len=torch.tensor([1, 2]),
                                impl="cuda")
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA kernel"):
        TL.attention_core(q, k, k, causal=True, impl="cuda")
    with pytest.raises(ValueError, match="CUDA kernel"):
        TL.attention_core(q.detach(), k, k, causal=True, impl="cuda")
    qw = quantize_weight(torch.randn((1, 64, 32)), (1,)).layer(0)
    x = torch.randn((3, 64), requires_grad=True)
    with pytest.raises(RuntimeError, match="int8_cuda"):
        qeinsum(x, qw, 1, impl="cuda")
    with torch.inference_mode(), pytest.raises(ValueError, match="CUDA"):
        qeinsum(x, qw, 1, impl="cuda")


# ---------------------------------------------------------------------------
# mirrors of test_models_smoke.py


@pytest.mark.parametrize("arch", sorted(T_ARCHS))
def test_forward_smoke(arch):
    cfg = T_ARCHS[arch].reduced()
    model = t_build(cfg, device="cpu")
    params = model.init(0)
    batch = make_batch(cfg, torch.Generator().manual_seed(0), BATCH, SEQ)
    with torch.no_grad():
        logits = model.forward(params, batch)
    assert logits.shape == (BATCH, SEQ, cfg.vocab)
    assert bool(torch.isfinite(logits).all()), f"NaN/Inf in {arch} logits"


@pytest.mark.parametrize("arch", sorted(T_ARCHS))
def test_loss_and_grad_smoke(arch):
    cfg = T_ARCHS[arch].reduced()
    model = t_build(cfg, device="cpu")
    batch = make_batch(cfg, torch.Generator().manual_seed(0), BATCH, SEQ)
    loss, grads = _grads(model, model.init(0), batch)
    assert np.isfinite(float(loss))
    assert grads, "no grads"
    assert all(bool(torch.isfinite(g).all()) for g in grads.values()), \
        f"non-finite grad in {arch}"


def test_decode_matches_forward_dense():
    """Greedy consistency: prefill on 7 tokens, then one decode step,
    against the forward's logits at positions 6 and 7."""
    cfg = T_ARCHS["llama3.2-1b"].reduced()
    model = t_build(cfg, device="cpu")
    params = model.init(0)
    batch = make_batch(cfg, torch.Generator().manual_seed(0), 1, 8,
                       with_targets=False)
    with torch.no_grad():
        full = model.forward(params, batch)
        logits, cache = model.prefill(params,
                                      {"tokens": batch["tokens"][:, :7]})
        np.testing.assert_allclose(logits[0, 0].numpy(), full[0, 6].numpy(),
                                   rtol=2e-4, atol=2e-4)
        padded = {n: torch.nn.functional.pad(
            c, (0, 0, 0, 0, 0, 16 - c.shape[2])) for n, c in cache.items()}
        logits2, _ = model.decode(params, padded, batch["tokens"][:, 7:8],
                                  torch.tensor([7], dtype=torch.int32))
    np.testing.assert_allclose(logits2[0, 0].numpy(), full[0, 7].numpy(),
                               rtol=2e-4, atol=2e-4)


def test_make_batch_shapes_and_seed():
    for arch in FAMILIES:
        cfg = T_ARCHS[arch].reduced()
        a = make_batch(cfg, torch.Generator().manual_seed(5), 2, 8)
        b = make_batch(cfg, torch.Generator().manual_seed(5), 2, 8)
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (arch, k)
        assert a["tokens"].dtype == a["targets"].dtype == torch.int32
        assert a["tokens"].shape == (2, 8)
        assert int(a["tokens"].max()) < cfg.vocab
        if cfg.family == "audio":
            assert a["frames"].shape == (2, 8, cfg.d_model)
        if cfg.family == "vlm":
            assert a["image_embeds"].shape == (2, cfg.n_image_tokens,
                                               cfg.d_model)
