"""The port's baselines against the JAX package, reduced size, on the CPU.

* ``WaveEngine``, the run-to-completion baseline: on the same seeded waves
  (ragged prompts, ``max_batch`` 2, three requests, so two waves of other
  shapes, served twice) every family at ``.reduced()`` in f32 and llama's
  int8 variant, on weights carried across by ``convert.params_from_jax``,
  gives the JAX ``WaveEngine``'s greedy tokens and its
  ``prefill_traces``/``decode_traces``. The engine feeds audio and vlm
  all-zero stub encoder inputs, as the reference does.
* The mirror of ``tests/test_serving_engine.py``'s
  ``test_wave_engine_baseline_still_serves``, held to the port's serial
  greedy rollout.
* ``TorchExecutor``, the counterpart of ``JaxExecutor``: the mirror of
  ``tests/test_executor_real.py``'s
  ``test_jax_executor_measured_keyed_by_prompt_len`` on the CPU; it asks
  for CUDA unless told otherwise.
* ``repro_torch.serving`` exports the reference's names, with
  ``TorchExecutor`` for ``JaxExecutor``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.serving as j_serving
import repro_torch.serving as t_serving
from repro.configs.registry import ARCHS as J_ARCHS
from repro.models import build_model as j_build
from repro.models.quantize import quantize_params_dense as j_quantize
from repro.serving.engine import Request as JRequest
from repro.serving.engine import WaveEngine as JWave
from repro_torch.configs.registry import ARCHS as T_ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model as t_build
from repro_torch.serving import Request, TorchExecutor, WaveEngine

# six xdist workers share the cores with XLA's threads: one torch thread
# each keeps them from oversubscribing
torch.set_num_threads(1)

LLAMA = "llama3.2-1b"
# (arch, quantize): the six families and llama's int8 variant
CASES = [(LLAMA, "none"), (LLAMA, "int8"), ("moonshot-v1-16b-a3b", "none"),
         ("zamba2-1.2b", "none"), ("xlstm-1.3b", "none"),
         ("whisper-base", "none"), ("llama-3.2-vision-90b", "none")]
# (prompt length, max_new): waves of (B, plen) (2, 9) and (1, 7), all
# prompts within the audio cross cache's pad_to (32)
WAVES = [(5, 3), (9, 4), (7, 2)]


def _stream(vocab, seed=4):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=n).astype(np.int32), m)
            for n, m in WAVES]


def _pair(arch, quant):
    """The JAX model and params, and the port's model on the same
    weights, at ``arch``'s reduced size with ``quant``."""
    jcfg = dataclasses.replace(J_ARCHS[arch].reduced(), quantize=quant)
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    if quant == "int8":
        jp = j_quantize(jp)
    tcfg = dataclasses.replace(T_ARCHS[arch].reduced(), quantize=quant)
    return jm, jp, t_build(tcfg, device="cpu"), params_from_jax(jp, "cpu")


@pytest.mark.parametrize("arch,quant", CASES)
def test_wave_engine_matches_jax_wave_engine(arch, quant):
    jm, jp, tm, tp = _pair(arch, quant)
    jeng = JWave(jm, jp, max_batch=2)
    teng = WaveEngine(tm, tp, max_batch=2)
    stream = _stream(tm.cfg.vocab)
    for _ in range(2):          # the second serve traces nothing new
        jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=m)
                 for i, (p, m) in enumerate(stream)]
        treqs = [Request(rid=i, prompt=p, max_new_tokens=m)
                 for i, (p, m) in enumerate(stream)]
        jeng.serve(jreqs)
        teng.serve(treqs)
        for jr, tr in zip(jreqs, treqs):
            assert len(tr.tokens) == tr.max_new_tokens
            np.testing.assert_array_equal(tr.tokens, np.asarray(jr.tokens),
                                          err_msg=f"{arch} {quant} {tr.rid}")
            assert tr.latency > 0
    assert teng.stats == jeng.stats == {"prefill_traces": 2,
                                        "decode_traces": 2}


def _serial_greedy(model, params, prompt, max_new):
    """Oracle: greedy rollout with the full forward per step, one
    request."""
    toks = [int(t) for t in prompt]
    with torch.no_grad():
        for _ in range(max_new):
            logits = model.forward(params, {"tokens": torch.tensor(
                [toks], dtype=torch.int32)})
            toks.append(int(logits[0, -1].argmax()))
    return toks[len(prompt):]


def test_wave_engine_baseline_still_serves():
    """The seed-style baseline stays importable and correct (benchmarks)."""
    cfg = T_ARCHS[LLAMA].reduced()
    model = t_build(cfg, device="cpu")
    params = model.init(0)
    eng = WaveEngine(model, params, max_batch=4)
    prompt = np.arange(6, dtype=np.int32) % cfg.vocab
    out = eng.serve([Request(rid=0, prompt=prompt, max_new_tokens=4)])
    want = _serial_greedy(model, params, prompt, 4)
    np.testing.assert_array_equal(np.asarray(out[0].tokens),
                                  np.asarray(want, np.int32))


def test_wave_engine_refuses_a_prompt_past_the_cross_cache():
    """The audio cross cache is padded to ``pad_to`` rows; a longer prompt
    cannot pad down to it (the reference's ``jnp.pad`` raises too)."""
    model = t_build(T_ARCHS["whisper-base"].reduced(), device="cpu")
    eng = WaveEngine(model, model.init(0), max_batch=2, pad_to=4)
    req = Request(rid=0, prompt=np.arange(6, dtype=np.int32),
                  max_new_tokens=2)
    with pytest.raises(ValueError, match="does not pad"):
        eng.serve([req])


def test_torch_executor_measured_keyed_by_prompt_len():
    """Mixed-length calibration runs must not overwrite each other."""
    cfg = T_ARCHS[LLAMA]
    ex = TorchExecutor({cfg.name: cfg.reduced()}, device="cpu",
                       max_batch=2, max_len=32, decode_block=4, min_bucket=4)
    ex.execute(cfg.name, batch=2, prompt_len=4, max_new=2)
    ex.execute(cfg.name, batch=2, prompt_len=8, max_new=2)
    assert set(ex.measured) == {(cfg.name, 2, 4), (cfg.name, 2, 8)}
    assert all(t > 0 for t in ex.measured.values())


def test_torch_executor_asks_for_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is served")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        TorchExecutor({LLAMA: T_ARCHS[LLAMA].reduced()})


def test_serving_exports_the_reference_names():
    """``repro_torch.serving`` exports what ``repro.serving`` does, with
    ``TorchExecutor`` in place of ``JaxExecutor``."""
    want = {n for n in dir(j_serving) if not n.startswith("_")} - {
        "engine", "executor", "JaxExecutor"} | {"TorchExecutor"}
    have = {n for n in dir(t_serving) if not n.startswith("_")}
    assert want <= have, want - have
    assert t_serving.ContinuousEngine is t_serving.ServingEngine
    assert t_serving.bucket_len(9) == 16
