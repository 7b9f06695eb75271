"""The port's training path (``repro_torch.training``, ``launch.train``)
against the JAX package on the CPU at reduced f32 sizes, and mirrors of
``test_training.py``.

Tolerances: the data batches bit for bit; the schedule within 1 f32 ulp
(rtol 1e-6); one AdamW update within rtol 1e-6 / atol 1e-7 in f32 and
within one bf16 ulp in bf16; five train steps' losses within 1e-5. After
five steps the params cannot be held element by element to a rounding
tolerance: Adam's first steps move an element by about sign(g) * lr, so an
element whose gradient is a rounding error away from 0 may move the other
way in the other framework. Each leaf is held to 1e-6 on 99.9 % of its
elements (measured: at most 4.7e-7, on ``layers/ln2``) and every element
to 2e-4, about four times the largest difference measured (5.5e-5, one
element of ``layers/mlp/w_down``; 19 of llama3.2-1b's 180,800 reduced
elements lie above 1e-6).
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.models import build_model as j_build
from repro.training import data as j_data
from repro.training import optimizer as j_opt
from repro.training import train_loop as j_loop
from repro_torch.configs.registry import ARCHS as T_ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.launch.train import main as train_main
from repro_torch.models import build_model
from repro_torch.training import data as data_lib
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import (TrainConfig,
                                             _compress_grads_int8,
                                             make_train_step, train)
from repro_torch.tree import leaves

# six xdist workers share the cores with XLA's threads: one torch thread
# each keeps them from oversubscribing
torch.set_num_threads(1)

FAMILIES = ["llama3.2-1b", "moonshot-v1-16b-a3b", "zamba2-1.2b",
            "xlstm-1.3b", "whisper-base", "llama-3.2-vision-90b"]


def _cfg():
    return T_ARCHS["llama3.2-1b"].reduced()


def _dcfg():
    return data_lib.DataConfig(batch=4, seq=32, seed=0)


def _rand_tree(rng, dtype=np.float32):
    return {"layers": {"w": rng.standard_normal((4, 8)).astype(dtype),
                       "b": rng.standard_normal((8,)).astype(dtype)},
            "head": rng.standard_normal((8, 3)).astype(dtype)}


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(v.copy())
            for k, v in tree.items()}


def _flat(tree):
    return {k: np.asarray(v, np.float32) for k, v in leaves(tree)}


@pytest.mark.parametrize("arch", FAMILIES)
def test_batch_at_step_matches_jax_bit_for_bit(arch):
    dcfg = data_lib.DataConfig(batch=3, seq=16, seed=4, shard=1)
    jd = j_data.DataConfig(batch=3, seq=16, seed=4, shard=1)
    for step in (0, 7, 123):
        mine = data_lib.batch_at_step(T_ARCHS[arch].reduced(), dcfg, step)
        ref = j_data.batch_at_step(J_ARCHS[arch].reduced(), jd, step)
        assert mine.keys() == ref.keys()
        for k in ref:
            assert mine[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(mine[k], ref[k])


def test_lr_schedule_matches_jax():
    cfg = opt.AdamWConfig(lr=2e-3, warmup_steps=10, total_steps=60)
    jcfg = j_opt.AdamWConfig(lr=2e-3, warmup_steps=10, total_steps=60)
    for step in [0, 1, 5, 9, 10, 11, 30, 59, 60, 75]:
        got = opt.lr_schedule(cfg, step)
        want = j_opt.lr_schedule(jcfg, jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_clip_by_global_norm_matches_jax():
    tree = _rand_tree(np.random.default_rng(0))
    for max_norm in (0.5, 100.0):
        got, norm = opt.clip_by_global_norm(_t(tree), max_norm)
        want, jnorm = j_opt.clip_by_global_norm(
            jax.tree.map(jnp.asarray, tree), max_norm)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
        for k, v in _flat(want).items():
            np.testing.assert_allclose(_flat(got)[k], v, rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype):
    """One update from a state three steps in (moments not zero), params,
    moments, lr and the grad norm against ``repro``'s; the gradient is
    clipped (grad_clip 1.0 under its norm). Moments are f32 for bf16
    params too."""
    rng = np.random.default_rng(1)
    params, grads = _rand_tree(rng), _rand_tree(rng)
    mu = _rand_tree(rng)
    nu = jax.tree.map(lambda a: np.abs(a) * 0.1, _rand_tree(rng))
    cfg = opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20)
    jcfg = j_opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)
    jg = jax.tree.map(lambda a: jnp.asarray(a, jdt), grads)
    jstate = j_opt.AdamWState(step=jnp.asarray(3, jnp.int32),
                              mu=jax.tree.map(jnp.asarray, mu),
                              nu=jax.tree.map(jnp.asarray, nu))
    j_new, j_state, j_info = j_opt.adamw_update(jcfg, jg, jstate, jp)
    tp = params_from_jax(jp, "cpu")
    tg = params_from_jax(jg, "cpu")
    state = opt.AdamWState(step=torch.tensor(3, dtype=torch.int32),
                           mu=_t(mu), nu=_t(nu))
    new, state, info = opt.adamw_update(cfg, tg, state, tp)
    assert int(state.step) == 4
    np.testing.assert_allclose(float(info["lr"]), float(j_info["lr"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(info["grad_norm"]),
                               float(j_info["grad_norm"]), rtol=1e-6)
    for name, mine, ref in (("mu", state.mu, j_state.mu),
                            ("nu", state.nu, j_state.nu)):
        for k, v in _flat(ref).items():
            got = dict(leaves(mine))[k]
            assert got.dtype == torch.float32, (name, k)
            np.testing.assert_allclose(got.numpy(), v, rtol=1e-6, atol=1e-7)
    for k, v in _flat(j_new).items():
        got = dict(leaves(new))[k]
        assert got.dtype == tdt
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), v, rtol=1e-6, atol=1e-7)
        else:   # one bf16 ulp of the value
            np.testing.assert_allclose(got.float().numpy(), v, rtol=2 ** -8)


def test_five_train_steps_match_jax():
    """Five ``make_train_step`` steps of llama3.2-1b (reduced, f32) against
    the reference's jitted step from the same params and batches."""
    jc = J_ARCHS["llama3.2-1b"].reduced()
    jm = j_build(jc)
    jtc = j_loop.TrainConfig(opt=j_opt.AdamWConfig(lr=1e-3, warmup_steps=2,
                                                   total_steps=30))
    js = j_loop.init_train_state(jm, jax.random.PRNGKey(0))
    j_step = jax.jit(j_loop.make_train_step(jm, jtc))
    model = build_model(_cfg(), device="cpu")
    step = make_train_step(model, TrainConfig(opt=opt.AdamWConfig(
        lr=1e-3, warmup_steps=2, total_steps=30)))
    tp = params_from_jax(js["params"], "cpu")
    state = {"params": tp, "opt": opt.adamw_init(tp),
             "gen": torch.Generator().manual_seed(0)}
    dcfg = j_data.DataConfig(batch=2, seq=32)
    for s in range(5):
        b = j_data.batch_at_step(jc, dcfg, s)
        js, jmet = j_step(js, {k: jnp.asarray(v) for k, v in b.items()})
        state, met = step(state, {k: torch.from_numpy(v)
                                  for k, v in b.items()})
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   atol=1e-5)
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4)
    ref = _flat(js["params"])
    for k, v in leaves(state["params"]):
        diff = np.abs(v.numpy() - ref[k])
        assert np.quantile(diff, 0.999) <= 1e-6, (k, np.quantile(diff, 0.999))
        assert diff.max() <= 2e-4, (k, diff.max())


def test_compress_grads_int8():
    """Each leaf is quantized to at most 127 steps of its own scale (max
    |g| / 127) and dequantized: within one step of the gradient, in its
    dtype, the same for the same generator state."""
    rng = np.random.default_rng(2)
    grads = _t(_rand_tree(rng))
    grads["layers"]["b"] *= 1e-3                      # a leaf of its own scale
    out = _compress_grads_int8(grads, torch.Generator().manual_seed(3))
    again = _compress_grads_int8(grads, torch.Generator().manual_seed(3))
    other = _compress_grads_int8(grads, torch.Generator().manual_seed(4))
    moved = False
    for k, g in leaves(grads):
        c = dict(leaves(out))[k]
        assert c.dtype == g.dtype and c.shape == g.shape
        scale = float(g.abs().max()) / 127.0
        q = c / scale
        assert float(q.abs().max()) <= 127.0 + 1e-4, k
        np.testing.assert_allclose(q.numpy(), np.round(q.numpy()),
                                   atol=1e-3)             # integer steps
        assert float((c - g).abs().max()) <= scale * (1 + 1e-5), k
        assert torch.equal(c, dict(leaves(again))[k])
        moved |= not torch.equal(c, dict(leaves(other))[k])
    assert moved


@pytest.mark.parametrize("impl", [dict(attention_impl="cuda"),
                                  dict(quantize="int8_cuda")])
def test_make_train_step_refuses_a_kernel_config(impl):
    """The kernels have no backward: a model whose config asks for one is
    refused by name (training builds its model without ``for_device``)."""
    model = build_model(_cfg(), device="cpu")
    kernel = dataclasses.replace(model,
                                 cfg=dataclasses.replace(_cfg(), **impl))
    with pytest.raises(ValueError, match=list(impl.values())[0]):
        make_train_step(kernel)


def test_train_launcher_cpu_reduced():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_main(["--device", "cpu", "--reduced", "--steps", "3"])
    text = out.getvalue()
    assert "step 0: loss=" in text and "final loss" in text
    assert np.isfinite(float(text.split("final loss")[1]))
    if not torch.cuda.is_available():      # the default device is CUDA
        with pytest.raises(RuntimeError, match="device='cuda'"):
            train_main(["--reduced", "--steps", "1"])


# ---------------------------------------------------------------------------
# mirrors of test_training.py


def test_loss_decreases():
    model = build_model(_cfg(), device="cpu")
    tcfg = TrainConfig(opt=opt.AdamWConfig(lr=2e-3, warmup_steps=5,
                                           total_steps=60))
    out = train(model, _dcfg(), steps=60, tcfg=tcfg)
    first = np.mean(out["losses"][:5])
    last = np.mean(out["losses"][-5:])
    assert last < first - 0.3, (first, last)


def test_checkpoint_restart_exact(tmp_path):
    model = build_model(_cfg(), device="cpu")
    tcfg = TrainConfig(opt=opt.AdamWConfig(lr=1e-3, warmup_steps=2,
                                           total_steps=30), ckpt_every=10)
    ckpt = str(tmp_path / "run")
    # crash at step 17 (after the step-10 checkpoint)
    with pytest.raises(RuntimeError, match="injected failure"):
        train(model, _dcfg(), steps=30, tcfg=tcfg, ckpt_dir=ckpt,
              fail_at_step=17)
    out = train(model, _dcfg(), steps=30, tcfg=tcfg, ckpt_dir=ckpt)
    assert out["resumed_from"] == 10
    # a run with no failure must produce identical final params
    clean = train(model, _dcfg(), steps=30, tcfg=tcfg)
    a = dict(leaves(out["state"]["params"]))
    for k, y in leaves(clean["state"]["params"]):
        np.testing.assert_allclose(a[k].numpy(), y.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_grad_compression_trains():
    model = build_model(_cfg(), device="cpu")
    tcfg = TrainConfig(opt=opt.AdamWConfig(lr=2e-3, warmup_steps=5,
                                           total_steps=40),
                       grad_compression=True)
    out = train(model, _dcfg(), steps=40, tcfg=tcfg)
    assert np.mean(out["losses"][-5:]) < np.mean(out["losses"][:5])


def test_data_restart_determinism():
    cfg, dcfg = _cfg(), _dcfg()
    b1 = data_lib.batch_at_step(cfg, dcfg, 123)
    b2 = data_lib.batch_at_step(cfg, dcfg, 123)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    b3 = data_lib.batch_at_step(cfg, dcfg, 124)
    assert not np.array_equal(b1["tokens"], b3["tokens"])
