"""The ``examples/torch_*.py`` twins, each run in process through its
``main``, whose returned counts are asserted (not its printout).

The three sim twins (quickstart, autoscale, multi-tenant) run the control
plane on the simulator: no model, no device. The serve and train twins run
the registry's ``.reduced()`` llama3.2-1b on ``--device``: here on the
CPU; the ``cuda``-marked cases run each twin on the card and skip without
one. This file imports no JAX, so the card cases run on a machine with
only the port's dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_examples.py
"""
import importlib.util
import math
from pathlib import Path

import pytest
import torch

# six xdist workers share the cores with XLA's threads: one torch thread
# each keeps them from oversubscribing
torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
SIM_TWINS = ["torch_quickstart", "torch_autoscale_demo",
             "torch_multi_tenant"]


def _twin(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False


def test_twins_import_only_the_port():
    """Each twin imports ``repro_torch`` and never ``jax`` or ``repro``."""
    import ast
    for path in sorted(EXAMPLES.glob("torch_*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "repro"), (path, n)


def check_quickstart(out):
    assert out["archs"] == 2        # the text-generation archs
    assert out["ok"] == {"use-case": True, "arch": True, "variant": True}
    assert 0 < out["processed"] <= out["total_inputs"] == 200
    assert out["decisions"] >= 3


def check_autoscale(out):
    assert out["served"] > 0
    assert 0 <= out["violations"] <= out["served"]
    assert 1 <= out["workers_alive"] <= out["workers"]


def check_multi_tenant(out):
    assert out["victim"] in out["dead"]
    assert out["alive"]
    assert 0 < out["completed"] == out["online"]
    assert sum(out["served_by_arch"].values()) == out["completed"]
    assert out["offline_processed"] > 0
    # accuracy isolation: every tenant-B online query went to yi-9b
    assert out["tenant_b"] > 0
    assert out["tenant_b_on_yi9b"] == out["tenant_b"]


CHECKS = {"torch_quickstart": check_quickstart,
          "torch_autoscale_demo": check_autoscale,
          "torch_multi_tenant": check_multi_tenant}


@pytest.mark.parametrize("name", SIM_TWINS)
def test_sim_twin(name):
    CHECKS[name](_twin(name).main())


@pytest.mark.cuda
@pytest.mark.parametrize("name", SIM_TWINS)
def test_sim_twin_leaves_the_card_alone(name):
    """The sim twins run no model: with a card present they put nothing
    on it."""
    _need_cuda()
    before = torch.cuda.memory_allocated()
    CHECKS[name](_twin(name).main())
    assert torch.cuda.memory_allocated() == before


def check_serve(out):
    assert out["served"] == out["at_budget"] == 20
    s = out["stats"]
    assert s["prefill_dispatches"] > 0 and s["decode_steps"] > 0
    assert math.isfinite(out["m"]) and math.isfinite(out["c"])
    assert all(t > 0 for t in out["latencies"])


def check_train(out, steps):
    assert out["steps"] == steps
    assert out["final_loss"] < out["first_loss"]
    # the restart resumes from the last checkpoint (saved at the end)
    assert out["resumed_from"] == steps
    assert out["steps_after_restart"] == 0


def test_serve_e2e_twin_on_cpu():
    out = _twin("torch_serve_e2e").main(["--device", "cpu"])
    check_serve(out)
    assert out["stats"]["decode_traces"] == 0       # nothing captured


def test_train_e2e_twin_on_cpu():
    check_train(_twin("torch_train_e2e").main(
        ["--device", "cpu", "--steps", "60"]), 60)


@pytest.mark.parametrize("name,argv", [("torch_serve_e2e", []),
                                       ("torch_train_e2e", ["--steps", "1"])])
def test_device_twins_ask_for_cuda_by_default(name, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is served")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        _twin(name).main(argv)


@pytest.mark.cuda
def test_serve_e2e_twin_on_cuda():
    _need_cuda()
    from repro_torch.kernels import build
    build.reset_launch_counts()
    out = _twin("torch_serve_e2e").main(["--device", "cuda"])
    check_serve(out)
    assert out["c"] > 0
    s = out["stats"]
    assert s["decode_traces"] == 1 and s["graph_replays"] >= s["decode_steps"]
    assert build.launch_counts.get("flash_attention", 0) > 0
    assert build.launch_counts.get("fused_paged_decode_attention", 0) > 0


@pytest.mark.cuda
def test_train_e2e_twin_on_cuda():
    _need_cuda()
    check_train(_twin("torch_train_e2e").main(
        ["--device", "cuda", "--steps", "60"]), 60)
