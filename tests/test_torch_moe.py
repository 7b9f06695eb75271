"""The moe family (moonshot-v1-16b-a3b, qwen3-moe-235b-a22b) in the port
against the JAX package, reduced size, f32, on the CPU; and the control
plane's and launcher's view of the two families this slice adds (moe and
ssm).

FFN level: ``moe_ffn_dense`` against ``repro``'s on the same inputs and
converted weights, balanced and with a biased router that overflows one
expert's capacity: the keep mask equal exactly, the outputs within f32
tolerance; the routing's tie rule (``lax.top_k``'s lower index first) and
the dispatch positions; the same bits on a second call. Model level:
``prefill_moe``/``decode_moe`` logits and KV leaves against ``repro``'s,
paged (through a block table) and contiguous; the moe cases of the
reference's ``test_models_smoke.py``; configs field for field and
``param_count``/``active_param_count`` equal to ``repro``'s.

Engine level: tokens and counts equal to the JAX engine's, one prefill
dispatch per admitted prompt and the prefill key set ``{1}``; mirrors of
``test_paged_engine.py::test_moe_never_chunks_and_stays_exact``,
``test_inseg_admission.py::test_stage_slots_clamped_for_ineligible_families``
and the moe half of ``test_preemption.py::test_admission_knob_validation``;
the prefix cache and speculation refused. Above it: an executor payload
query on an xlstm and a moonshot variant returns a direct engine's tokens,
the launcher serves both with ``--device cpu --reduced``, and qwen3 is
refused on one card by its weight bytes, without CUDA (its G = 16 takes
the decode kernels' 16-row bodies).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.models import moe as JM
from repro_torch.configs.registry import ARCHS as T_ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.core.api import QueryPayload, QuerySpec
from repro_torch.core.master import MasterConfig
from repro_torch.launch.serve import check_weights_fit
from repro_torch.launch.serve import main as launch_main
from repro_torch.models import build_model as t_build
from repro_torch.models import moe as M
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.sim.cluster import make_cluster
from test_torch_layout import (assert_counts, assert_tokens, built,
                               jax_run, mixed_stream, port_run, requests)

# six xdist workers share the cores with XLA's threads: one torch thread
# each keeps them from oversubscribing
torch.set_num_threads(1)

ARCH = "moonshot-v1-16b-a3b"
QWEN = "qwen3-moe-235b-a22b"
# f32 sums taken in another order by two frameworks
TOL = dict(rtol=2e-5, atol=2e-5)
KW = dict(max_batch=3, max_len=64, decode_block=4, min_bucket=4)


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _ffn_case(biased: bool):
    """(JAX params of layer 0's FFN, the port's, x (B, S, d)) of the
    reduced moonshot; ``biased`` adds a router column that every token
    prefers (x is shifted positive), so expert 0 takes all of them."""
    jm, jp, _, _ = built(ARCH)
    cfg = jm.cfg
    jmoe = _layer0(jp["layers"]["moe"])
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    if biased:
        x = np.abs(x) + 0.5
        router = np.array(jmoe["router"])
        router[:, 0] = 0.15
        jmoe = dict(jmoe, router=jnp.asarray(router))
    return cfg, jmoe, params_from_jax(jmoe, device="cpu"), x


@pytest.mark.parametrize("biased", [False, True])
def test_moe_ffn_dense_matches_repro(biased):
    """The FFN against ``repro``'s: the keep mask exactly (the biased
    router overflows expert 0: its capacity holds 20 of 32 tokens), the
    outputs within f32 tolerance, and the same bits on a second call."""
    cfg, jmoe, tmoe, x = _ffn_case(biased)
    T_ = x.shape[0] * x.shape[1]
    C = JM._capacity(T_, cfg)
    assert C == M._capacity(T_, T_ARCHS[ARCH].reduced()) == 20
    _, jidx = JM._route(jnp.asarray(x.reshape(T_, -1)), jmoe["router"], cfg)
    _, jkeep = JM._dispatch_indices(jidx, cfg, C)
    want = JM.moe_ffn_dense(jnp.asarray(x), jmoe, cfg)
    tcfg = T_ARCHS[ARCH].reduced()
    got = M.moe_ffn_dense(torch.from_numpy(x), tmoe, tcfg)
    _, tidx = M._route(torch.from_numpy(x.reshape(T_, -1)), tmoe["router"],
                       tcfg)
    _, keep = M._dispatch_indices(tidx, tcfg, C)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    if biased:
        assert (np.asarray(jidx)[:, 0] == 0).all()
        # expert 0 is every token's first choice and keeps C of them
        assert int((~keep[:, 0]).sum()) == T_ - C
    else:
        assert keep.all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    again = M.moe_ffn_dense(torch.from_numpy(x), tmoe, tcfg)
    assert torch.equal(again, got)


def test_route_ties_and_dispatch_positions_match_repro():
    """On equal probabilities (a zero input row) the top k are the lowest
    expert ids, as ``lax.top_k`` returns them; weights, experts and the
    dispatch positions equal ``repro``'s on a random batch."""
    cfg, jmoe, tmoe, x = _ffn_case(False)
    tcfg = T_ARCHS[ARCH].reduced()
    x2 = x.reshape(-1, x.shape[-1])
    x2[3] = 0.0
    jw, jidx = JM._route(jnp.asarray(x2), jmoe["router"], cfg)
    tw, tidx = M._route(torch.from_numpy(x2), tmoe["router"], tcfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert tidx[3].tolist() == list(range(tcfg.top_k))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    for C in (4, 8, 20):
        jpos, jkeep = JM._dispatch_indices(jidx, cfg, C)
        tpos, tkeep = M._dispatch_indices(tidx, tcfg, C)
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))


# ---------------------------------------------------------------------------
# model level


def _prompts(vocab, lens, S, seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), S), np.int32)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(0, vocab, size=n)
    return toks


@pytest.mark.parametrize("arch,paged", [(ARCH, False), (ARCH, True),
                                        (QWEN, True)])
def test_prefill_decode_logits_and_cache_match_repro(arch, paged):
    """Prefill of right-padded prompts, then three decode steps, paged
    through an identity block table or contiguous: logits and the k/v
    leaves equal ``repro``'s within f32 tolerance."""
    jm, jp, tm, tp = built(arch)
    cfg = tm.cfg
    B, S, Lm, ps = 2, 16, 32, 8
    lens = np.array([16, 11], np.int32)
    toks = _prompts(cfg.vocab, lens, S)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "length": jnp.asarray(lens)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long(),
                             "length": torch.from_numpy(lens)})
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), np.asarray(jc[name]),
                                   err_msg=name, **TOL)
    jcache, tcache = {}, {}
    P = Lm // ps
    for name in ("k", "v"):
        full = np.zeros(np.asarray(jc[name]).shape[:2] + (Lm,)
                        + np.asarray(jc[name]).shape[3:], np.float32)
        full[:, :, :S] = np.asarray(jc[name])
        if paged:
            full = full.reshape((full.shape[0], B * P, ps) + full.shape[3:])
        jcache[name] = jnp.asarray(full)
        tcache[name] = torch.from_numpy(full.copy())
    if paged:
        bt = np.arange(B * P, dtype=np.int32).reshape(B, P)
        jcache["bt"] = jnp.asarray(bt)
        tcache["bt"] = torch.from_numpy(bt)
    rng = np.random.default_rng(1)
    pos = lens.copy()
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        jl, jcache = jm.decode(jp, jcache, jnp.asarray(tok),
                               jnp.asarray(pos))
        tl, tcache = tm.decode(tp, tcache, torch.from_numpy(tok),
                               torch.from_numpy(pos))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(tcache[name]),
                                       np.asarray(jcache[name]),
                                       err_msg=name, **TOL)
        pos = pos + 1


@pytest.mark.parametrize("arch", [ARCH, QWEN])
def test_prefill_decode_smoke(arch):
    """The moe cases of the reference's ``test_prefill_decode_smoke``
    (batch 2, 32 tokens): finite logits of the vocabulary's width, then a
    decode step against the cache padded to 40 positions."""
    _, _, tm, tp = built(arch)
    cfg = tm.cfg
    toks = torch.from_numpy(_prompts(cfg.vocab, [32, 32], 32)).long()
    logits, cache = tm.prefill(tp, {"tokens": toks})
    assert logits.shape == (2, 1, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    big = {n: torch.zeros(sh, dtype=dt)
           for n, (sh, dt) in tm.cache_shapes(2, 40).items()}
    for n in ("k", "v"):
        assert cache[n].shape[2] == 32
        big[n][:, :, :32] = cache[n]
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    logits2, cache2 = tm.decode(tp, big, tok,
                                torch.full((2,), 32, dtype=torch.int32))
    assert logits2.shape == (2, 1, cfg.vocab)
    assert bool(torch.isfinite(logits2).all())
    assert set(cache2) == {"k", "v"}
    assert tm.decode_window is None
    assert all(not bool(t.any()) for t in tm.empty_state(2, 8).values())


@pytest.mark.parametrize("arch", [ARCH, QWEN])
def test_configs_and_counts_equal_repro(arch):
    """Field for field (reduced too), and ``param_count`` and
    ``active_param_count`` equal to ``repro``'s, which count the tree:
    moonshot's 28.9 B parameters, 4.8 B of them active a token."""
    mine, ref = T_ARCHS[arch], J_ARCHS[arch]
    for m, r in ((mine, ref), (mine.reduced(), ref.reduced())):
        for f in dataclasses.fields(m):
            if f.name not in ("attention_impl", "quantize"):
                assert getattr(m, f.name) == getattr(r, f.name), f.name
        assert m.param_count() == r.param_count()
        assert m.active_param_count() == r.active_param_count()
        assert m.n_experts > 0
    _, _, tm, tp = built(arch)

    def weights(node, name=""):
        if isinstance(node, dict):
            return sum(weights(v, k) for k, v in node.items())
        return 0 if name.startswith("ln") else node.numel()

    assert weights(tp) == tm.cfg.param_count()
    assert weights(t_build(tm.cfg, "cpu").init(0)) == tm.cfg.param_count()
    if arch == ARCH:
        assert mine.param_count() == 28_888_268_800
        assert mine.active_param_count() == 4_804_575_232


def test_qwen3_refused_on_one_card_without_cuda():
    """qwen3-moe-235b-a22b's 463.5 GB of bf16 weights exceed one 80 GB
    card (the launcher's check, by bytes); moonshot's 57.8 GB fit. Its G
    = 16 takes the decode kernels' 16-row bodies, so ``build_model``
    under the CUDA impls passes the body checks (here it then stops at
    the missing device), and qwen3 at a depth that fits passes the
    weight check; G = 32 (2 KV heads) has no body and is refused by
    name."""
    from repro_torch.kernels.decode_attention import decode_body
    with pytest.raises(ValueError, match=r"463\.5 GB .* 80\.0 GB"):
        check_weights_fit(T_ARCHS[QWEN], 80 * 10**9, "an 80 GB card")
    check_weights_fit(T_ARCHS[ARCH], 80 * 10**9, "an 80 GB card")
    check_weights_fit(dataclasses.replace(T_ARCHS[QWEN], n_layers=4),
                      80 * 10**9, "an 80 GB card")
    assert decode_body(torch.bfloat16, T_ARCHS[QWEN].q_per_kv, 64) == "mma"
    if not torch.cuda.is_available():
        with pytest.raises(Exception) as info:
            t_build(T_ARCHS[QWEN].for_device("cuda"), device="cuda")
        assert "no CUDA attention body" not in str(info.value)
    with pytest.raises(ValueError, match="G=32"):
        t_build(dataclasses.replace(T_ARCHS[QWEN], n_kv_heads=2).for_device(
            "cuda"), device="cuda")


# ---------------------------------------------------------------------------
# engine level


@pytest.mark.parametrize("page_size", [None, 8])
def test_engine_matches_jax_one_prompt_per_dispatch(page_size):
    """Tokens, completion order and counts equal to the JAX engine's; one
    prefill dispatch per admitted prompt, and only ``nbatch`` 1 programs
    (the JAX engine's key set)."""
    _, _, tm, _ = built(ARCH)
    spec = mixed_stream(tm.cfg.vocab)
    kw = dict(KW, page_size=page_size)
    want, worder, stats, jeng = jax_run(ARCH, f"moe-{page_size}", spec,
                                        **kw)
    got, order, eng, _ = port_run(ARCH, spec, **kw)
    assert_tokens(got, want)
    assert order == worder
    assert_counts(eng, stats)
    assert eng.stats["prefill_dispatches"] == eng.stats["admitted"] \
        == len(spec)
    assert {nb for nb, _ in eng._prefill_fns} == {1}
    assert eng.stats["prefill_traces"] == stats["prefill_traces"]
    assert eng._paged == (page_size is not None)
    eng.warmup(prompt_lens=[len(p) for p, _ in spec])
    assert {nb for nb, _ in eng._prefill_fns} == {1}


def test_moe_never_chunks_and_stays_exact():
    """The reference's test: the chunk knob is inert for moe and the
    tokens equal the non-chunked engine's (and the JAX engine's)."""
    _, _, tm, _ = built(ARCH)
    spec = mixed_stream(tm.cfg.vocab)
    kw = dict(KW, page_size=8)
    base, _, _, _ = port_run(ARCH, spec, **kw)
    got, _, eng, _ = port_run(ARCH, spec, chunk_threshold=12, **kw)
    assert eng.chunk_threshold is None
    assert eng.stats["chunk_admits"] == 0
    assert_tokens(got, base)
    want, _, _, _ = jax_run(ARCH, "moe-8", spec, **kw)
    assert_tokens(got, want)


def test_stage_slots_clamped_for_ineligible_families():
    """The reference's test: moe cannot teacher-force staged prompts, so
    the ring clamps to boundary-only admission and outputs stay exact."""
    _, _, tm, tp = built(ARCH)
    rng = np.random.default_rng(0)
    spec = [(rng.integers(0, tm.cfg.vocab, size=int(rng.integers(3, 10))
                          ).astype(np.int32), int(rng.integers(1, 6)))
            for _ in range(4)]
    kw = dict(max_batch=2, max_len=64, decode_block=8, min_bucket=4)
    eng = ServingEngine(tm, tp, stage_slots=4, **kw)
    assert eng.stage_slots == 0
    r0 = requests(Request, spec)
    eng.serve(r0)
    assert eng.stats["inseg_admissions"] == 0
    base, _, _, _ = port_run(ARCH, spec, **kw)
    assert_tokens([r.tokens for r in r0], base)


def test_admission_knob_validation_moe_half():
    """The moe half of the reference's ``test_admission_knob_validation``:
    optimistic admission clamps to worst case (no teacher-forcing seam)
    and ``preempt`` raises (no replay path); the prefix cache clamps off
    and speculation is refused by family."""
    _, _, tm, tp = built(ARCH)
    eng = ServingEngine(tm, tp, page_size=8, admission="optimistic",
                        prefix_cache=True)
    assert eng.admission == "worstcase"
    assert eng._prefix is None
    with pytest.raises(ValueError):
        eng.preempt(0)
    _, _, dm, dp = built("llama3.2-1b")
    with pytest.raises(ValueError, match="family"):
        ServingEngine(tm, tp, max_batch=2, speculate=(dm, dp))


# ---------------------------------------------------------------------------
# the control plane and the launcher on the two families of this slice


@pytest.mark.parametrize("arch", ["xlstm-1.3b", ARCH])
def test_executor_payload_query_returns_a_direct_engines_tokens(arch):
    """A payload query for the family's bf16 h100-1 variant on a
    one-accel-worker real cluster (reduced, on the CPU) returns the tokens
    of a fresh engine on the served variant's params, with the executor
    engine's geometry (xlstm under the default page size 16: inert)."""
    cfg = T_ARCHS[arch]
    c = make_cluster(n_accel=1, archs=[cfg], autoscale=False,
                     cfg=MasterConfig(worker_autoscale=False),
                     backend="real", device="cpu", reduced=True)
    name = next(v.name for v in c.store.registry.variants.values()
                if v.arch == arch and v.hardware == "h100-1"
                and v.framework == "torch-bf16")
    prompts = ((3, 1, 4, 1, 5, 9), (2, 7, 1, 8))
    h = c.api.submit(QuerySpec.variant(
        name, slo=600.0, payload=QueryPayload.of(prompts,
                                                 max_new_tokens=4)))
    res = h.result(timeout=120.0)
    assert res.ok, (res.failed, res.variant)
    (ex,) = c.executors
    variant = c.store.registry.variants[res.variant]
    exec_eng = ex.engines[variant.name]
    assert exec_eng._paged == (cfg.family == "moe")
    model, params = ex.served_model(variant)
    eng = ServingEngine(model, params, max_batch=exec_eng.max_batch,
                        max_len=exec_eng.max_len,
                        decode_block=exec_eng.decode_block,
                        min_bucket=exec_eng.min_bucket,
                        page_size=exec_eng.page_size,
                        n_pages=exec_eng.n_pages or None)
    reqs = requests(Request, [(p, 4) for p in prompts])
    eng.serve(reqs)
    assert len(res.outputs) == len(prompts)
    for r, out in zip(reqs, res.outputs):
        np.testing.assert_array_equal(r.tokens, out)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", ARCH])
def test_launcher_serves_the_family_reduced_on_cpu(arch, capsys):
    launch_main(["--real-engine", "--arch", arch, "--device", "cpu",
                 "--reduced", "--real-reqs", "4"])
    out = capsys.readouterr().out
    assert f"{arch}-smoke" in out
    assert ("(contiguous)" in out) == (arch == "xlstm-1.3b")
