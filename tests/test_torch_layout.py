"""The contiguous KV layout (``page_size=None``) in the port against the
JAX package, reduced size, f32, on the CPU.

Mirrors the reference's ``test_paged_engine.py``: paged == contiguous for
the dense, audio and vlm families, admission beyond max-shape capacity,
FIFO gating on free pages, a bad page size, chunked prefill on the
contiguous layout and a request larger than the pool. Each stream is
served once by the JAX engine (memoized per module), and every port
variant is held to it: tokens, completion order and counts.

Below the engine: ``kvcache.update_layer_cache`` (the contiguous decode
write) and the page copies of copy-on-write and host swap against
``repro.models.kvcache``, with the kernel layout's trash page never
written; the contiguous decode wrapper with per-slot lengths against the
JAX reference and its span plan, which for per-slot lengths is the fused
paged kernel's. Port-only: the capture's warm-up steps on the contiguous
layout leave every row a slot has written as it was.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.kernels import ref as jref
from repro.models import build_model as j_build
from repro.models import kvcache as JKV
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs.registry import ARCHS as T_ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.kernels import decode_attention as da
from repro_torch.models import build_model as t_build
from repro_torch.models import kvcache as KV
from repro_torch.serving.engine import Request, ServingEngine

# six xdist workers share the cores with XLA's threads: one torch thread
# each keeps them from oversubscribing
torch.set_num_threads(1)

# f32 sums taken in another order by two frameworks
TOL = dict(rtol=2e-5, atol=2e-5)
# the counts the port must share with the JAX engine on one stream
COUNTS = ("prefill_dispatches", "decode_dispatches", "decode_steps",
          "tokens_generated", "admitted", "chunk_admits",
          "peak_concurrency", "busy_slot_steps", "bubble_slot_steps",
          "staged", "inseg_admissions", "preemptions", "preempt_readmits",
          "pressure_stalls", "prefix_hits", "prefix_pages_reused",
          "prefix_tokens_skipped", "cow_copies", "evictions", "swap_out",
          "swap_in", "swap_fallbacks", "swap_bytes")


@functools.lru_cache(maxsize=None)
def built(arch="llama3.2-1b"):
    """(JAX model, JAX params, port model, port params) of a reduced
    config, the port's weights carried across from the JAX init."""
    jm = j_build(J_ARCHS[arch].reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, t_build(T_ARCHS[arch].reduced(), device="cpu"), \
        params_from_jax(jp, device="cpu")


def requests(cls, spec, **kw):
    return [cls(rid=i, prompt=np.array(p, np.int32), max_new_tokens=m, **kw)
            for i, (p, m) in enumerate(spec)]


def drive(eng, reqs, hook=None):
    """Submit all, step until idle; ``hook(eng, n)`` runs after step n.
    Returns the rids in completion order."""
    for r in reqs:
        eng.submit(r)
    order, n = [], 0
    while eng.busy:
        eng.step()
        if hook is not None:
            hook(eng, n)
        n += 1
        order += [r.rid for r in eng.drain_completions()]
    return order


_JAX = {}


def jax_run(arch, label, spec, hook=None, **kw):
    """The JAX engine's (tokens, completion order, stats, engine) on a
    stream, served once per module and knob set."""
    key = (arch, label, tuple(sorted(kw.items())))
    if key not in _JAX:
        jm, jp, _, _ = built(arch)
        eng = JEngine(jm, jp, **kw)
        reqs = requests(JRequest, spec)
        order = drive(eng, reqs, hook)
        _JAX[key] = ([np.asarray(r.tokens) for r in reqs], order,
                     dict(eng.stats), eng)
    return _JAX[key]


def port_run(arch, spec, hook=None, **kw):
    """The port engine's (tokens, completion order, engine, requests)."""
    _, _, tm, tp = built(arch)
    eng = ServingEngine(tm, tp, **kw)
    reqs = requests(Request, spec)
    order = drive(eng, reqs, hook)
    return [np.asarray(r.tokens) for r in reqs], order, eng, reqs


def assert_tokens(got, want, msg=""):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} rid={i}")


def assert_counts(eng, stats, keys=COUNTS):
    for key in keys:
        if key in stats:
            assert eng.stats[key] == stats[key], (key, eng.stats[key],
                                                  stats[key])


def mixed_stream(vocab, seed=3, n=6):
    """Mixed lengths including one prompt spanning several 8-wide pages
    (the reference's ``_mixed_stream``)."""
    rng = np.random.default_rng(seed)
    out = [(rng.integers(0, vocab, size=int(rng.integers(3, 12))
                         ).astype(np.int32), int(rng.integers(1, 6)))
           for _ in range(n - 1)]
    out.append((rng.integers(0, vocab, size=29).astype(np.int32), 4))
    return out


# ---------------------------------------------------------------------------
# kvcache: the contiguous write, page copies, the trash page


@pytest.mark.parametrize("pos,S_new", [(5, 1), ([0, 7, 15], 1),
                                        ([3, 14, 0], 2), ([20, 16, 2], 1)])
def test_update_layer_cache_matches_jax(pos, S_new):
    """Scalar and per-slot positions, one and two rows, and starts that
    the JAX write clamps so the rows fit (20 and 16 of 16 rows)."""
    rng = np.random.default_rng(S_new)
    kc, vc = (rng.standard_normal((3, 16, 2, 4)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((3, S_new, 2, 4)).astype(np.float32)
              for _ in range(2))
    jpos = jnp.asarray(pos, jnp.int32)
    wk, wv = JKV.update_layer_cache(jnp.asarray(kc), jnp.asarray(vc),
                                    jnp.asarray(kn), jnp.asarray(vn), jpos)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = KV.update_layer_cache(tk, tv, torch.from_numpy(kn),
                                torch.from_numpy(vn),
                                torch.as_tensor(pos, dtype=torch.int32))
    assert got[0] is tk and got[1] is tv                    # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))


def test_pool_page_copies_match_jax_and_spare_the_trash_page():
    """``copy_pool_page``, ``gather_pool_pages`` and ``scatter_pool_pages``
    on a (L, n_phys, ps, K, D) pool (sequence axis 2) equal the JAX
    helpers; with ``n_pages`` one below the pool (the kernel layout's
    trash page at ``n_pages``) a copy or scatter aimed there is dropped
    and a gather listing it raises."""
    rng = np.random.default_rng(0)
    n_pages = 5
    pool = rng.standard_normal((2, n_pages + 1, 4, 2, 3)).astype(np.float32)
    want = JKV.copy_pool_page(jnp.asarray(pool), jnp.int32(3), jnp.int32(1),
                              2)
    t = torch.from_numpy(pool.copy())
    KV.copy_pool_page(t, 3, 1, 2, n_pages=n_pages)
    np.testing.assert_array_equal(t.numpy(), np.asarray(want))
    before = t.clone()
    KV.copy_pool_page(t, 3, n_pages, 2, n_pages=n_pages)   # the trash page
    assert torch.equal(t, before)
    ids = [4, 0, 2]
    host = KV.gather_pool_pages(t, ids, 2, n_pages=n_pages)
    np.testing.assert_array_equal(
        host.numpy(), JKV.gather_pool_pages(jnp.asarray(t.numpy()), ids, 2))
    assert host.device.type == "cpu" and host.shape == (3, 4, 2, 2, 3)
    with pytest.raises(ValueError, match="allocatable"):
        KV.gather_pool_pages(t, [1, n_pages], 2, n_pages=n_pages)
    fresh = rng.standard_normal(tuple(host.shape)).astype(np.float32)
    dst = [1, n_pages, 3]                      # the middle one is the trash
    want = JKV.scatter_pool_pages(jnp.asarray(t.numpy()), fresh,
                                  [1, n_pages + 1, 3], 2)  # JAX: dropped
    KV.scatter_pool_pages(t, torch.from_numpy(fresh), dst, 2,
                          n_pages=n_pages)
    np.testing.assert_array_equal(t.numpy(), np.asarray(want))
    assert torch.equal(t[:, n_pages], before[:, n_pages])


# ---------------------------------------------------------------------------
# the contiguous decode kernel's per-slot form


def test_contiguous_decode_per_slot_lengths_match_jax():
    """The wrapper's per-slot form on a CPU tensor (its plain version)
    against the JAX reference at each slot's length: lengths 0, 1, on a
    64-row tile edge, T, and mixed within one batch; a slot of length 0
    gets zeros."""
    B, K, G, T, D = 5, 2, 4, 130, 16
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, K, G, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, K, D)).astype(np.float32)
            for _ in range(2))
    lens = np.array([0, 1, 64, T, 97], np.int32)
    got = da.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(lens))
    want = jref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k).transpose(0, 2, 1, 3),
        jnp.asarray(v).transpose(0, 2, 1, 3),
        jnp.asarray(lens)[:, None, None, None])
    live = lens > 0
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               **TOL)
    assert not got[0].any()


@pytest.mark.parametrize("body", ["mma", "simt"])
@pytest.mark.parametrize("T", [64, 300, 512, 1601, 4096])
def test_contiguous_per_slot_plan_is_the_fused_plan(monkeypatch, body, T):
    """Per-slot lengths: the lengths stay on the device, and the spans come
    from T alone, as the fused paged kernel cuts its P * ps rows, so a
    contiguous slot folds the same spans as a paged one. A scalar length
    keeps its own plan."""
    monkeypatch.setattr(da, "_sm_count", lambda device: 132)   # an H100
    q = torch.zeros((8, 8, 4, 64))
    lens = torch.tensor([0, 1, 63, 64, T, 5, 128, T - 1], dtype=torch.int32)
    got = da.contiguous_plan(q, T, lens, body)
    assert got[0].dtype == torch.int32 and torch.equal(got[0], lens)
    assert got[1:] == (T,) + da._split("fused_paged_decode_attention", body,
                                       T, q)
    assert got[2] <= da.MAX_SPLIT and got[2] * got[3] >= T
    scalar = da.contiguous_plan(q, T, T // 2, body)
    assert scalar == (None, T // 2) + da._split("decode_attention", body,
                                                T // 2, q)


# ---------------------------------------------------------------------------
# the engine: paged == contiguous == the JAX engine

GEOM = dict(max_batch=3, max_len=64, decode_block=4, min_bucket=4)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-base",
                                  "llama-3.2-vision-90b"])
def test_paged_matches_contiguous_bit_identical(arch):
    """The same stream through the contiguous and the paged layout gives
    the JAX contiguous engine's tokens, completion order and counts; the
    paged engine drains every page."""
    spec = mixed_stream(J_ARCHS[arch].reduced().vocab)
    want, order, stats, _ = jax_run(arch, "mixed", spec, page_size=None,
                                    **GEOM)
    for page_size in (None, 8):
        got, torder, eng, _ = port_run(arch, spec, page_size=page_size,
                                       **GEOM)
        assert_tokens(got, want, f"{arch} page_size={page_size}")
        assert torder == order
        assert_counts(eng, stats)
        assert eng._paged == (page_size is not None)
        if eng._paged:
            assert eng._alloc.n_free == eng.n_pages
        else:
            assert eng._alloc is None and eng._bt is None \
                and "bt" not in eng._dcache and eng.n_pages == 0


def test_contiguous_clamps_optimism_and_serves_the_staging_ring():
    """Optimistic admission is a page-pool discipline: the contiguous
    layout clamps it to worst case, as the reference does; its staging
    ring and chunked prefill still run, with the JAX engine's tokens and
    counts."""
    spec = mixed_stream(256, seed=5, n=8)
    kw = dict(GEOM, page_size=None, stage_slots=2, chunk_threshold=6,
              admission="optimistic")
    want, order, stats, jeng = jax_run("llama3.2-1b", "mixed5", spec, **kw)
    got, torder, eng, _ = port_run("llama3.2-1b", spec, **kw)
    assert eng.admission == jeng.admission == "worstcase"
    assert_tokens(got, want)
    assert torder == order
    assert_counts(eng, stats)
    assert eng.stats["inseg_admissions"] > 0 and eng.stats["chunk_admits"] > 0


def test_contiguous_forced_preempt_recovers_bit_identical():
    """A preempted slot of the contiguous layout replays its prefix into
    its own rows: the uninterrupted run's tokens."""
    rng = np.random.default_rng(11)
    spec = [(rng.integers(0, 256, size=int(rng.integers(3, 10))
                          ).astype(np.int32), int(rng.integers(6, 13)))
            for _ in range(6)]
    want, _, _, _ = jax_run("llama3.2-1b", "long6", spec, page_size=None,
                            **GEOM)

    def hook(eng, n):
        if n == 0:
            eng.preempt(next(s for s, r in enumerate(eng._slot_req)
                             if r is not None
                             and 0 < len(eng._gen[s]) < r.max_new_tokens))

    got, _, eng, _ = port_run("llama3.2-1b", spec, hook=hook,
                              page_size=None, **GEOM)
    assert_tokens(got, want)
    assert eng.stats["preemptions"] == eng.stats["preempt_readmits"] == 1


def test_paged_admits_beyond_max_shape_capacity():
    """With the pool sized for 2 max-shape slots, the paged engine admits
    more than 2 concurrent short requests, as the JAX engine does."""
    max_len, page = 64, 8
    rng = np.random.default_rng(0)
    spec = [(rng.integers(0, 256, size=6).astype(np.int32), 8)
            for _ in range(8)]
    kw = dict(max_batch=8, max_len=max_len, decode_block=4, min_bucket=4,
              page_size=page, n_pages=2 * max_len // page)
    want, order, stats, _ = jax_run("llama3.2-1b", "short8", spec, **kw)
    got, torder, eng, _ = port_run("llama3.2-1b", spec, **kw)
    assert eng.stats["peak_concurrency"] > 2
    assert eng.stats["peak_concurrency"] >= 6   # 16 pages / 2-page requests
    assert_tokens(got, want)
    assert torder == order
    assert_counts(eng, stats)
    assert eng._alloc.n_free == eng.n_pages


def test_admission_gated_on_free_pages_fifo():
    """The head that cannot reserve its worst case blocks everything
    behind it; the stream drains FIFO as pages free."""
    prompt = np.arange(20, dtype=np.int32) % 256
    spec = [(prompt, 4)] * 3
    kw = dict(max_batch=4, max_len=32, decode_block=4, min_bucket=4,
              page_size=8, n_pages=4)
    _, _, tm, tp = built()
    eng = ServingEngine(tm, tp, **kw)
    reqs = requests(Request, spec)
    for r in reqs:
        eng.submit(r)
    eng.step()
    assert eng.stats["peak_concurrency"] == 1   # 3 of 4 pages: one fits
    while eng.busy:
        eng.step()
    assert [r.rid for r in eng.drain_completions()] == [0, 1, 2]
    want, order, stats, _ = jax_run("llama3.2-1b", "fifo", spec, **kw)
    assert_tokens([r.tokens for r in reqs], want)
    assert order == [0, 1, 2]
    assert_counts(eng, stats)
    assert eng._alloc.n_free == eng.n_pages


def test_paged_rejects_bad_page_size():
    _, _, tm, tp = built()
    with pytest.raises(ValueError, match="multiple of"):
        ServingEngine(tm, tp, max_len=64, page_size=7)


def test_chunked_prefill_works_on_contiguous_layout():
    """Chunked prefill with ``page_size=None``: the prompts past the
    threshold are fed through the decode step into the slot's own rows,
    with the JAX engine's tokens."""
    rng = np.random.default_rng(7)
    spec = [(rng.integers(0, 256, size=p).astype(np.int32), 3)
            for p in (5, 20, 31, 6)]
    kw = dict(max_batch=2, max_len=64, decode_block=4, min_bucket=4,
              page_size=None, chunk_threshold=8)
    want, order, stats, _ = jax_run("llama3.2-1b", "chunk4", spec, **kw)
    got, torder, eng, _ = port_run("llama3.2-1b", spec, **kw)
    assert eng.stats["chunk_admits"] == 2
    assert_tokens(got, want)
    assert torder == order
    assert_counts(eng, stats)


def test_request_larger_than_pool_rejected_at_submit():
    _, _, tm, tp = built()
    eng = ServingEngine(tm, tp, max_batch=4, max_len=32, decode_block=4,
                        min_bucket=4, page_size=8, n_pages=2)
    with pytest.raises(ValueError, match="pool"):
        eng.submit(Request(rid=0, prompt=np.arange(20, dtype=np.int32),
                           max_new_tokens=4))


def test_contiguous_warm_steps_leave_written_rows_and_state():
    """The warm-up a capture runs on the contiguous layout (no block table
    to point at a sentinel): mid-stream, every row a slot has written,
    [0, pos), keeps its bytes, only the row at ``pos`` (the slot's next
    write) may change, and the loop state comes back as it was."""
    _, _, tm, tp = built()
    eng = ServingEngine(tm, tp, page_size=None, **GEOM)
    for r in requests(Request, mixed_stream(256)):
        eng.submit(r)
    eng.step()
    pos = eng._pos.clone()
    k, v = eng._cache["k"].clone(), eng._cache["v"].clone()
    state = [t.clone() for t in (eng._tok, eng._pos, eng._rem_dev,
                                 eng._plen_dev, eng._pbuf, eng._ring,
                                 eng._rb, eng._step_i)]
    eng._warm_steps()
    for t, w in zip((eng._tok, eng._pos, eng._rem_dev, eng._plen_dev,
                     eng._pbuf, eng._ring, eng._rb, eng._step_i), state):
        assert torch.equal(t, w)
    for s in range(eng.max_batch):
        p = int(pos[s])
        assert torch.equal(eng._cache["k"][:, s, :p], k[:, s, :p])
        assert torch.equal(eng._cache["v"][:, s, :p], v[:, s, :p])
        assert torch.equal(eng._cache["k"][:, s, p + 1:], k[:, s, p + 1:])
    while eng.busy:
        eng.step()


@pytest.mark.parametrize("flags,lines", [
    (["--page-size", "0"], ["(contiguous)"]),
    (["--prefix-cache", "--n-pages", "12", "--admission", "optimistic",
      "--swap", "host", "--swap-budget-mb", "64"],
     ["prefix cache:", "host swap:"])])
def test_launcher_layout_prefix_and_swap_flags(flags, lines, capsys):
    """``--page-size 0`` serves the contiguous layout; ``--prefix-cache``,
    ``--swap`` and ``--swap-budget-mb`` reach the engine and print their
    counts, as the reference's launcher does."""
    from repro_torch.launch.serve import main as launch_main
    launch_main(["--real-engine", "--device", "cpu", "--reduced",
                 "--real-reqs", "8", *flags])
    out = capsys.readouterr().out
    for line in lines:
        assert line in out
    with pytest.raises(SystemExit):
        launch_main(["--real-engine", "--device", "cpu", "--reduced",
                     "--swap-budget-mb", "1"])
