"""The port's layers, paged KV cache, quantization and dense model against
the JAX package, on the same numpy inputs and the same weights (carried
across by ``repro_torch.convert``), reduced size, f32, on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.models import build_model as j_build
from repro.models import kvcache as JKV
from repro.models import layers as JL
from repro.models import quantize as JQ
from repro_torch.configs.registry import ARCHS as T_ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model as t_build
from repro_torch.models import kvcache as TKV
from repro_torch.models import layers as TL
from repro_torch.models import quantize as TQ

TOL = dict(rtol=2e-5, atol=2e-5)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_rmsnorm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x, scale = _randn(rng, 2, 5, 64), _randn(rng, 64)
    np.testing.assert_allclose(TL.rmsnorm(_t(x), _t(scale)).numpy(),
                               np.asarray(JL.rmsnorm(jnp.asarray(x),
                                                     jnp.asarray(scale))),
                               **TOL)
    q = _randn(rng, 2, 5, 2, 2, 16)
    pos = np.array([[3, 4, 5, 6, 7], [0, 1, 2, 3, 60]], np.int32)
    np.testing.assert_allclose(
        TL.apply_rope(_t(q), _t(pos), 500_000.0).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(q), jnp.asarray(pos), 500_000.0)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["causal", "valid", "per_slot"])
def test_attention_core_matches_jax(kind):
    rng = np.random.default_rng(1)
    q, k, v = _randn(rng, 3, 6, 2, 2, 16), _randn(rng, 3, 6, 2, 16), \
        _randn(rng, 3, 6, 2, 16)
    kw = {"causal": dict(causal=True),
          "valid": dict(causal=False, kv_valid_len=4),
          "per_slot": dict(causal=False,
                           kv_valid_len=np.array([1, 6, 3], np.int32))}[kind]
    tkw = dict(kw)
    if kind == "per_slot":
        tkw["kv_valid_len"] = _t(kw["kv_valid_len"])
    got = TL.attention_core(_t(q), _t(k), _t(v), **tkw).numpy()
    want = JL.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             impl="xla", **kw)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_attention_core_kernel_impl_refuses_per_slot_lengths():
    """The flash kernel takes one scalar length: the kernel impl with
    per-slot lengths raises instead of running the plain path."""
    q, k = torch.zeros((2, 1, 1, 2, 16)), torch.zeros((2, 4, 1, 16))
    with pytest.raises(NotImplementedError, match="per-slot"):
        TL.attention_core(q, k, k, causal=False, impl="cuda",
                          kv_valid_len=torch.tensor([1, 3]))


def _paged_case(rng, B=3, P=4, ps=8, n_pages=12, K=2, D=16):
    pool_k, pool_v = _randn(rng, n_pages, ps, K, D), _randn(rng, n_pages, ps, K, D)
    bt = np.full((B, P), n_pages, np.int32)          # sentinel everywhere
    bt[0, :2] = [3, 7]
    bt[1, :1] = [5]
    pos = np.array([15, 8, 4], np.int32)   # slot 0 mid page, slot 1 on a
    # page boundary whose page is unallocated, slot 2 all-sentinel
    return pool_k, pool_v, bt, pos


def test_paged_update_drops_sentinel_and_out_of_pool_writes():
    rng = np.random.default_rng(2)
    pk, pv, bt, pos = _paged_case(rng)
    kn, vn = _randn(rng, 3, 1, 2, 16), _randn(rng, 3, 1, 2, 16)
    page, off = TKV.page_coords(_t(bt), _t(pos), 8)
    jpage, joff = JKV.page_coords(jnp.asarray(bt), jnp.asarray(pos), 8)
    np.testing.assert_array_equal(page.numpy(), np.asarray(jpage))
    np.testing.assert_array_equal(off.numpy(), np.asarray(joff))
    tk, tv = TKV.paged_update_layer_cache(_t(pk), _t(pv), _t(kn), _t(vn),
                                          _t(bt), _t(pos))
    jk, jv = JKV.paged_update_layer_cache(jnp.asarray(pk), jnp.asarray(pv),
                                          jnp.asarray(kn), jnp.asarray(vn),
                                          jnp.asarray(bt), jnp.asarray(pos))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # only slot 0's write landed: page 7, offset 7
    changed = np.argwhere((tk.numpy() != pk).any(axis=(2, 3)))
    np.testing.assert_array_equal(changed, [[7, 7]])


@pytest.mark.parametrize("case", ["spare_taken", "spare_after_kept",
                                  "pool_of_b_rows"])
def test_paged_update_drop_without_mask_matches_jax(case):
    """The sync-free drop (a dropped row rewrites a row no kept slot
    writes) against JAX's ``mode="drop"``: kept slots that take rows 0 and
    1, so the spare row moves past them; kept slots on rows 0..B-2 beside
    a dropped one, so it is row B - 1; and a pool of no more than B rows,
    which takes the mask."""
    rng = np.random.default_rng(7)
    B, ps = 4, 2
    n_pages = 2 if case == "pool_of_b_rows" else 6
    pk, pv = _randn(rng, n_pages, ps, 2, 16), _randn(rng, n_pages, ps, 2, 16)
    bt = np.full((B, 3), n_pages, np.int32)
    bt[:, 0] = [0, 0, 1, 1] if case != "spare_taken" else [0, 0, 5, 4]
    pos = {"spare_taken": [0, 1, 3, 5],
           "spare_after_kept": [0, 1, 0, 3],
           "pool_of_b_rows": [0, 1, 2, 1]}[case]
    pos = np.asarray(pos, np.int32)
    kn, vn = _randn(rng, B, 1, 2, 16), _randn(rng, B, 1, 2, 16)
    tk, tv = TKV.paged_update_layer_cache(_t(pk), _t(pv), _t(kn), _t(vn),
                                          _t(bt), _t(pos))
    jk, jv = JKV.paged_update_layer_cache(jnp.asarray(pk), jnp.asarray(pv),
                                          jnp.asarray(kn), jnp.asarray(vn),
                                          jnp.asarray(bt), jnp.asarray(pos))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert (tk.numpy() != pk).any()


def test_gather_block_kv_clamps_like_jax():
    rng = np.random.default_rng(3)
    pk, _pv, bt, _pos = _paged_case(rng)
    np.testing.assert_array_equal(
        TKV.gather_block_kv(_t(pk), _t(bt)).numpy(),
        np.asarray(JKV.gather_block_kv(jnp.asarray(pk), jnp.asarray(bt))))
    np.testing.assert_array_equal(TKV.sentinel_block_table(2, 3, 9),
                                  JKV.sentinel_block_table(2, 3, 9))


def test_paged_update_attend_plain_matches_jax():
    rng = np.random.default_rng(4)
    pk, pv, bt, pos = _paged_case(rng)
    q = _randn(rng, 3, 1, 2, 2, 16)
    kn, vn = _randn(rng, 3, 1, 2, 16), _randn(rng, 3, 1, 2, 16)
    o, tk, _tv = TL.paged_update_attend(_t(q), _t(kn), _t(vn), _t(pk), _t(pv),
                                        _t(bt), _t(pos), impl="torch")
    jo, jk, _jv = JL.paged_update_attend(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pk),
        jnp.asarray(pv), jnp.asarray(bt), jnp.asarray(pos), impl="xla")
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)


@pytest.mark.parametrize("name", sorted(TQ.STACKED_AXES))
def test_quantize_weight_and_qeinsum_match_jax(name):
    rng = np.random.default_rng(5)
    shapes = {"wq": (2, 64, 2, 2, 16), "wk": (2, 64, 2, 16),
              "wv": (2, 64, 2, 16), "wo": (2, 2, 2, 16, 64),
              "w_gate": (2, 64, 128), "w_up": (2, 64, 128),
              "w_down": (2, 128, 64)}
    axes = TQ.STACKED_AXES[name]
    w = _randn(rng, *shapes[name])
    w[:, :, 0] = 0.0                                 # an all-zero channel
    jqw = JQ.quantize_weight(jnp.asarray(w), axes)
    tqw = TQ.quantize_weight(_t(w), axes)
    want = params_from_jax({name: jqw}, device="cpu")[name]
    assert torch.equal(tqw.w_q, want.w_q)
    assert torch.equal(tqw.scales, want.scales)
    assert tqw.out_dims == want.out_dims
    n_c = len(axes)
    x = _randn(rng, 2, 3, *[shapes[name][i] for i in axes])
    jl = JQ.QuantizedWeight(jqw.w_q[1], jqw.scales[1])
    spec_in = "abcde"[:n_c]
    spec_w = "".join(spec_in[axes.index(i)] if i in axes else "vwxyz"[i]
                     for i in range(1, len(shapes[name])))
    spec_out = "".join("vwxyz"[i] for i in range(1, len(shapes[name]))
                       if i not in axes)
    spec = f"st{spec_in},{spec_w}->st{spec_out}"
    want_y = JQ.qeinsum(spec, jnp.asarray(x), jl,
                        tuple(i - 1 for i in axes), impl="xla")
    got_y = TQ.qeinsum(_t(x), tqw.layer(1), n_c, impl="torch")
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               rtol=1e-5, atol=1e-5)


def _fill_pools(kc, vc, bt, n_phys, ps):
    """(L, B, S, K, D) prompt caches -> pools through the block table."""
    L, B, S, K, D = kc.shape
    pk = np.zeros((L, n_phys, ps, K, D), np.float32)
    pv = np.zeros_like(pk)
    for b in range(B):
        for s in range(S):
            pk[:, bt[b, s // ps], s % ps] = kc[:, b, s]
            pv[:, bt[b, s // ps], s % ps] = vc[:, b, s]
    return pk, pv


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_dense_model_prefill_and_32_decode_steps_match_jax(quant):
    jcfg = dataclasses.replace(J_ARCHS["llama3.2-1b"].reduced(),
                               quantize=quant)
    tcfg = dataclasses.replace(T_ARCHS["llama3.2-1b"].reduced(),
                               quantize=quant)
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    if quant == "int8":
        jp = JQ.quantize_params_dense(jp)
    tm = t_build(tcfg, device="cpu")
    tp = params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(6)
    B, S, ps, P = 2, 16, 8, 8
    toks = rng.integers(0, tcfg.vocab, size=(B, S)).astype(np.int32)
    lens = np.array([16, 9], np.int32)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks),
                                      "length": jnp.asarray(lens)})
    tl, tc = tm.prefill(tp, {"tokens": _t(toks), "length": _t(lens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               rtol=1e-4, atol=1e-4)
    n_pages = B * P
    bt = np.arange(n_pages, dtype=np.int32).reshape(B, P)
    pk, pv = _fill_pools(np.asarray(jc["k"]), np.asarray(jc["v"]), bt,
                         n_pages, ps)
    jcache = {"k": jnp.asarray(pk), "v": jnp.asarray(pv),
              "bt": jnp.asarray(bt)}
    tcache = {"k": _t(pk), "v": _t(pv), "bt": _t(bt)}
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tl[:, -1], -1).to(torch.int32)[:, None]
    pos = lens.copy()
    j_decode = jax.jit(jm.decode)
    for _ in range(32):
        jlog, jcache = j_decode(jp, jcache, jtok, jnp.asarray(pos))
        tlog, tcache = tm.decode(tp, tcache, ttok, _t(pos))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=1e-4, atol=1e-4)
        jtok = jnp.argmax(jlog[:, -1], -1).astype(jnp.int32)[:, None]
        ttok = torch.argmax(tlog[:, -1], -1).to(torch.int32)[:, None]
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        pos = pos + 1


def test_quantize_params_dense_matches_converted_jax_tree():
    jcfg = J_ARCHS["llama3.2-1b"].reduced()
    jp = j_build(jcfg).init(jax.random.PRNGKey(1))
    want = params_from_jax(JQ.quantize_params_dense(jp), device="cpu")
    got = TQ.quantize_params_dense(params_from_jax(jp, device="cpu"))
    for grp in ("attn", "mlp"):
        for name, w in want["layers"][grp].items():
            assert torch.equal(got["layers"][grp][name].w_q, w.w_q), name
            assert torch.equal(got["layers"][grp][name].scales, w.scales)


def test_default_device_entry_points_raise_without_cuda():
    from repro_torch.convert import params_from_jax as convert
    from repro_torch.launch.serve import main as launch_main
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    cfg = T_ARCHS["llama3.2-1b"].reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        t_build(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        convert({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="cuda"):
        launch_main(["--real-engine", "--reduced"])


def test_unported_families_and_kernel_impl_on_cpu_raise():
    cfg = T_ARCHS["llama3.2-1b"].reduced()
    with pytest.raises(NotImplementedError):
        t_build(dataclasses.replace(cfg, family="moe"), device="cpu")
    with pytest.raises(ValueError, match="CUDA kernels"):
        t_build(cfg.for_device("cuda"), device="cpu")
    assert cfg.for_device("cpu") is cfg
    tm = t_build(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="contiguous"):
        tm.decode(tm.init(0), {"k": None, "v": None},
                  torch.zeros((1, 1), dtype=torch.int32),
                  torch.zeros((1,), dtype=torch.int32))
