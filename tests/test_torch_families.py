"""The port's audio (whisper-base) and vlm (llama-3.2-vision-90b) families
against the JAX package, reduced size, f32, on the CPU.

The JAX serving engine feeds these families all-zero stub encoder inputs,
and with no biases a zero encoder input makes every cross-attention output
exactly zero. So the model tests here feed seeded non-zero ``frames`` /
``image_embeds`` through ``prefill`` and paged ``decode`` directly, and
check that those inputs reach the logits; the engine tests then pin greedy
tokens and counts on the engine's own (zero) stub inputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.models import build_model as j_build
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs.registry import ARCHS as T_ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import check_weights_fit
from repro_torch.launch.serve import main as launch_main
from repro_torch.models import build_model as t_build
from repro_torch.serving.engine import Request, ServingEngine

# six xdist workers share the cores with XLA's threads: one torch thread
# each keeps them from oversubscribing
torch.set_num_threads(1)

FAMILIES = ["whisper-base", "llama-3.2-vision-90b"]
# f32 sums taken in another order by two frameworks, over a few layers
TOL = dict(rtol=1e-4, atol=1e-4)
KW = dict(max_batch=3, max_len=64, decode_block=4, min_bucket=4,
          page_size=8, n_pages=12)
COUNTS = ("prefill_dispatches", "decode_dispatches", "decode_steps",
          "tokens_generated", "admitted", "peak_concurrency",
          "busy_slot_steps", "bubble_slot_steps")

_BUILT = {}


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_model(arch):
    if arch not in _BUILT:
        jm = j_build(J_ARCHS[arch].reduced())
        _BUILT[arch] = (jm, jm.init(jax.random.PRNGKey(0)))
    return _BUILT[arch]


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_configs_match_jax(arch):
    fields = {f.name for f in dataclasses.fields(T_ARCHS[arch])} - {
        "attention_impl", "quantize"}
    for t_cfg, j_cfg in ((T_ARCHS[arch], J_ARCHS[arch]),
                         (T_ARCHS[arch].reduced(), J_ARCHS[arch].reduced())):
        for f in fields:
            assert getattr(t_cfg, f) == getattr(j_cfg, f), f


@pytest.mark.parametrize("arch", ["llama3.2-1b"] + FAMILIES)
def test_param_count_is_the_initialised_tree(arch):
    """``param_count`` counts the weights ``init`` makes (norm scales
    aside): what the launcher turns into weight bytes."""
    cfg = T_ARCHS[arch].reduced()

    def weights(node, name=""):
        if isinstance(node, dict):
            return sum(weights(v, k) for k, v in node.items())
        return 0 if name.startswith("ln") else node.numel()

    assert cfg.param_count() == weights(t_build(cfg, "cpu").init(0))


def test_published_sizes_and_the_launcher_refusal():
    """whisper-base at its published size; vision at 20 and 100 layers.
    The published vision model cannot fit one 80 GB card, and the launcher
    refuses it by weight bytes before allocating anything."""
    vis = T_ARCHS["llama-3.2-vision-90b"]
    assert T_ARCHS["whisper-base"].param_count() == 128_607_232
    assert dataclasses.replace(vis, n_layers=20).param_count() \
        == 19_214_106_624
    check_weights_fit(dataclasses.replace(vis, n_layers=20), 80 * 10**9,
                      "an 80 GB card")
    with pytest.raises(ValueError, match=r"175\.3 GB .* 80\.0 GB"):
        check_weights_fit(vis, 80 * 10**9, "an 80 GB card")
    with pytest.raises(ValueError, match="dense-only"):
        launch_main(["--real-engine", "--arch", "whisper-base", "--device",
                     "cpu", "--reduced", "--quantize", "int8"])


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_from_jax_carries_the_family_tree(arch):
    _jm, jp = _jax_model(arch)
    got = params_from_jax(jp, device="cpu")
    mine = t_build(T_ARCHS[arch].reduced(), "cpu").init(0)

    def walk(g, m, j, path):
        if isinstance(m, dict):
            assert sorted(g) == sorted(m) == sorted(j), path
            for k in m:
                walk(g[k], m[k], j[k], f"{path}/{k}")
            return
        assert g.shape == m.shape, path
        np.testing.assert_array_equal(g.numpy(), np.asarray(j), err_msg=path)

    walk(got, mine, jp, "")


def _stub_batch(cfg, rng, B, S):
    """Seeded non-zero stub encoder input of the family."""
    if cfg.family == "audio":
        return {"frames": rng.standard_normal((B, S, cfg.d_model))
                .astype(np.float32)}
    return {"image_embeds": rng.standard_normal(
        (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)}


def _to_pools(leaf, bt, n_pages, ps, bax, sax):
    """A prefill leaf (batch at bax, sequence at sax) -> its page pool."""
    a = np.moveaxis(np.asarray(leaf), (bax, sax), (0, 1))   # (B, S, ...)
    B, S = a.shape[:2]
    pool = np.zeros((n_pages, ps) + a.shape[2:], np.float32)
    for b in range(B):
        for s in range(S):
            pool[bt[b, s // ps], s % ps] = a[b, s]
    return np.moveaxis(pool, (0, 1), (sax - 1, sax))


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_prefill_and_paged_decode_match_jax(arch):
    """Prefill and 8 paged decode steps on non-zero frames / image
    embeddings and a right-padded length vector: logits, greedy tokens and
    every cache leaf agree with the JAX model in f32."""
    jm, jp = _jax_model(arch)
    cfg = T_ARCHS[arch].reduced()
    tm = t_build(cfg, device="cpu")
    tp = params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(6)
    B, S, ps, P = 2, 16, 8, 8
    toks = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    lens = np.array([16, 9], np.int32)
    stub = _stub_batch(cfg, rng, B, S)
    jl, jc = jax.jit(jm.prefill)(jp, dict(
        {k: jnp.asarray(v) for k, v in stub.items()},
        tokens=jnp.asarray(toks), length=jnp.asarray(lens)))
    tl, tc = tm.prefill(tp, dict({k: _t(v) for k, v in stub.items()},
                                 tokens=_t(toks), length=_t(lens)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert sorted(tc) == sorted(jc)
    for name in tc:
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   err_msg=name, **TOL)
    # the stub input reaches the logits: zeros give other logits
    zl, _ = tm.prefill(tp, dict({k: torch.zeros(v.shape)
                                 for k, v in stub.items()},
                                tokens=_t(toks), length=_t(lens)))
    assert (zl - tl).abs().max() > 1e-3
    # paged decode cache: every leaf with a sequence axis becomes a pool
    n_pages = B * P
    bt = np.arange(n_pages, dtype=np.int32).reshape(B, P)
    shapes = tm.cache_shapes(B, P * ps, enc_len=P * ps)
    longer = tm.cache_shapes(B, P * ps + ps, enc_len=P * ps + ps)
    wider = tm.cache_shapes(B + 1, P * ps, enc_len=P * ps)
    cache = {}
    for name, (sh, _dt) in shapes.items():
        sax = next((i for i, (x, y) in enumerate(zip(sh, longer[name][0]))
                    if x != y), -1)
        bax = next(i for i, (x, y) in enumerate(zip(sh, wider[name][0]))
                   if x != y)
        cache[name] = (np.asarray(jc[name]) if sax == -1 else
                       _to_pools(jc[name], bt, n_pages, ps, bax, sax))
    jcache = dict({k: jnp.asarray(v) for k, v in cache.items()},
                  bt=jnp.asarray(bt))
    tcache = dict({k: _t(v) for k, v in cache.items()}, bt=_t(bt))
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tl[:, -1], -1).to(torch.int32)[:, None]
    pos = lens.copy()
    j_decode = jax.jit(jm.decode)
    for _ in range(8):
        jlog, jcache = j_decode(jp, jcache, jtok, jnp.asarray(pos))
        tlog, tcache = tm.decode(tp, tcache, ttok, _t(pos))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        jtok = jnp.argmax(jlog[:, -1], -1).astype(jnp.int32)[:, None]
        ttok = torch.argmax(tlog[:, -1], -1).to(torch.int32)[:, None]
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        pos = pos + 1
    for name in cache:
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), err_msg=name,
                                   **TOL)


def _stream(vocab, seed=3):
    rng = np.random.default_rng(seed)
    spec = [(5, 6), (6, 1), (7, 9), (29, 4), (12, 12), (4, 3), (16, 5),
            (9, 8)]
    return [(rng.integers(0, vocab, size=n).astype(np.int32), m)
            for n, m in spec]


@pytest.mark.parametrize("arch", FAMILIES)
def test_port_engine_matches_jax_paged_engine(arch):
    """Grouped admits with padding rows, a max_new == 1 request, prompts
    over several pages, admission gated on pages: the same greedy tokens
    and counts as the JAX paged engine, and every page back at drain."""
    jm, jp = _jax_model(arch)
    jeng = JEngine(jm, jp, **KW)
    teng = ServingEngine(t_build(T_ARCHS[arch].reduced(), device="cpu"),
                         params_from_jax(jp, device="cpu"), **KW)
    stream = _stream(256)
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=m)
             for i, (p, m) in enumerate(stream)]
    treqs = [Request(rid=i, prompt=p, max_new_tokens=m)
             for i, (p, m) in enumerate(stream)]
    jeng.serve(jreqs)
    teng.serve(treqs)
    for jr, tr in zip(jreqs, treqs):
        np.testing.assert_array_equal(tr.tokens, jr.tokens,
                                      err_msg=str(tr.rid))
    for key in COUNTS:
        assert teng.stats[key] == jeng.stats[key], key
    assert teng._alloc.n_free == teng.n_pages
    assert (teng._bt == teng.n_pages).all()


def test_engine_pages_sequence_leaves_and_keeps_state_by_slot():
    """audio: self and encoder k/v are pools, enc_len is per slot (0 for a
    slot never admitted); vlm: self k/v are grouped pools, image k/v per
    slot."""
    audio = ServingEngine(t_build(T_ARCHS["whisper-base"].reduced(), "cpu"),
                          None, **KW)
    L, K, D = 4, 4, 16
    for name in ("k", "v", "xk", "xv"):
        assert audio._cache[name].shape == (L, 12, 8, K, D), name
    assert audio._cache["enc_len"].shape == (3,)
    vlm_cfg = T_ARCHS["llama-3.2-vision-90b"].reduced()
    vlm = ServingEngine(t_build(vlm_cfg, "cpu"), None, **KW)
    assert vlm._cache["k"].shape == (2, 1, 12, 8, 2, D)
    assert vlm._cache["xk"].shape == (2, 3, vlm_cfg.n_image_tokens, 2, D)
    assert vlm._axes["xk"] == (1, -1) and vlm._axes["k"] == (2, 3)

    _jm, jp = _jax_model("whisper-base")
    eng = ServingEngine(t_build(T_ARCHS["whisper-base"].reduced(), "cpu"),
                        params_from_jax(jp, device="cpu"), **KW)
    prompt = np.arange(11, dtype=np.int32)
    eng.serve([Request(rid=0, prompt=prompt, max_new_tokens=3)])
    # FIFO slot order hands out slot 0 first; the others were never used
    assert eng._cache["enc_len"].tolist() == [11, 0, 0]


@pytest.mark.parametrize("arch", FAMILIES)
def test_launcher_serves_the_family_reduced_on_cpu(arch, capsys):
    launch_main(["--real-engine", "--arch", arch, "--device", "cpu",
                 "--reduced", "--real-reqs", "4"])
    assert f"{arch}-smoke" in capsys.readouterr().out
