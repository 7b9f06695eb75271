"""The plain reference against the port at a reduced float32 size on the
CPU (this test imports both; the reference imports neither), and the
control one precision lower coming out apart from it."""
import dataclasses

import bench_tiny
import numpy as np
import pytest
import torch

from bench import harness
from bench.reference import dense

torch.set_num_threads(1)


def _port(cfg, params, quantize="none"):
    from repro_torch.models.model import build_model
    from repro_torch.models.quantize import quantize_params_dense
    arch = dataclasses.replace(harness.arch_config(cfg), quantize=quantize)
    model = build_model(arch, "cpu")
    return model, (quantize_params_dense(params) if quantize == "int8"
                   else params)


@pytest.mark.parametrize("quantize,bits", [("none", None), ("int8", 8)])
def test_reference_logits_match_the_port(quantize, bits):
    from repro_torch.models.transformer import forward_dense
    cfg = dict(bench_tiny.TINY)
    params = dense.make_params(cfg, 3, "cpu", torch.float32)
    model, served = _port(cfg, params, quantize)
    tokens = torch.randint(0, cfg["vocab_size"], (2, 20),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = forward_dense(model.cfg, served, tokens)
    (got,) = dense.served_logits(params, cfg, list(tokens), [0, 0], [bits])
    for g, w in zip(got, want):
        assert torch.allclose(g, w, atol=2e-5, rtol=1e-4)


def test_served_tokens_of_the_port_engine_have_no_gap():
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = dict(bench_tiny.TINY)
    params = dense.make_params(cfg, 4, "cpu", torch.float32)
    model, _ = _port(cfg, params)
    eng = ServingEngine(model, params, **cfg["engine"])
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, 256, n).astype(np.int32),
                    max_new_tokens=12) for i, n in enumerate((5, 17, 30))]
    eng.serve(reqs)
    seqs = [torch.as_tensor(np.concatenate([r.prompt, r.tokens[:-1]]))
            for r in reqs]
    (logits,) = dense.served_logits(params, cfg, seqs,
                                    [len(r.prompt) - 1 for r in reqs], [None])
    for lg, r in zip(logits, reqs):
        assert float(dense.gaps(lg, torch.as_tensor(r.tokens)).max()) < 1e-5


def test_quantize_rule_hand_worked():
    w = torch.tensor([[1.0, 0.0], [-2.0, 0.0], [0.5, 0.0]])
    got = dense.quantize(w, (0,), bits=8)
    scale = 2.0 / 127
    want = torch.tensor([[round(1.0 / scale) * scale, 0.0],
                         [-2.0, 0.0],
                         [round(0.5 / scale) * scale, 0.0]])
    assert torch.allclose(got, want)
    assert torch.equal(dense.quantize(w, (0,), bits=4)[:, 1],
                       torch.zeros(3))


def _control_answer(params, cfg, prompt, n, bits):
    """``n`` tokens decoded greedily by the reference with its weights
    rounded to ``bits``: the control served in the program's place."""
    seq = torch.as_tensor(prompt, dtype=torch.long)
    for _ in range(n):
        (lg,), = dense.served_logits(params, cfg, [seq], [len(seq) - 1],
                                     [bits])
        seq = torch.cat([seq, lg[-1].argmax().reshape(1)])
    return seq[len(prompt):].numpy().astype(np.int32)


def test_control_fails_the_check_on_a_run(tmp_path, monkeypatch):
    """A tiny open-loop run on the CPU: the program's served tokens lie on
    the reference's best logits and the harness's check passes them; the
    control (the reference with int8 weights) decoding the same prompts in
    the program's place lies below them by more than the tiny cell's
    limit, and the same check comes out not correct."""
    monkeypatch.setattr(harness, "SAMPLE", 16)
    root = bench_tiny.make_root(tmp_path)
    cell = harness.load_cell("tiny-open", root)
    seed = 2 ** 31 + 9
    dev = torch.device("cpu")
    reqs = harness.workload.draw(cell.mix, 2.0, seed, 256)
    ctx = harness.setup(cell, seed, dev, [len(r.prompt) for r in reqs])
    try:
        run = harness.window(ctx, reqs, 2.0, False, 0.0, log=lambda m: None)
    finally:
        harness.teardown(ctx)
    read = harness.gap_readings(run, ctx.params, dev, seed)
    assert read["program"]["max"] < 1e-5
    sound = harness.check(run, ctx.params, dev, seed)
    assert all(v["value"] <= v["limit"] for v in sound.values()), sound
    for q in harness.sample(run, seed):
        q.outputs = _control_answer(ctx.params, cell.config, q.prompt,
                                    q.max_new, 8)
    control = harness.check(run, ctx.params, dev, seed)
    assert control["mean_gap"]["value"] > control["mean_gap"]["limit"], \
        control
