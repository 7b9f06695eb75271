"""The port's cluster serving launcher (``repro_torch.launch.serve``) on
the CPU: mirrors of the reference's ``test_launch_serve.py``.

The simulated path, the real-backend path (``--device cpu --reduced``),
the standalone engine demo and the wall-clock streaming server run end to
end at tiny sizes, and the flag checks refuse what the reference refuses,
with its messages. The paged layout is the port's default, so where the
reference leaves ``--page-size`` out to ask for the contiguous layout,
these pass ``--page-size 0``. ``--speculate DRAFT[:K]`` reaches the
engine demo (an int8 draft for the dense target, a dense draft for the
hybrid zamba2-1.2b) and is refused, as in the reference, when malformed
or on the sim backend.
"""
import os
import queue
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

from repro_torch.launch import serve

# six xdist workers share the cores with XLA's threads: one torch thread
# each keeps them from oversubscribing
torch.set_num_threads(1)

CPU = ["--device", "cpu", "--reduced"]


def test_launch_sim_path_smoke(capsys):
    serve.main(["--arch", "llama3.2-1b", "--workers", "1",
                "--cpu-workers", "0", "--rate", "5", "--duration", "6",
                "--slo-ms", "5000", "--no-autoscale"])
    out = capsys.readouterr().out
    assert "served=" in out
    assert "workers alive at end: 1" in out


def test_launch_real_backend_smoke(capsys):
    serve.main(["--arch", "llama3.2-1b", "--backend", "real",
                "--workers", "1", "--cpu-workers", "0", "--rate", "3",
                "--duration", "6", "--slo-ms", "600000", "--no-autoscale",
                *CPU])
    out = capsys.readouterr().out
    assert "served=" in out
    # at least one profile was re-fit from real measurements
    assert "variants re-fit from real measurements:" in out
    n = int(out.rsplit("variants re-fit from real measurements:", 1)[1])
    assert n >= 1


def test_launch_real_backend_rejects_all_archs():
    with pytest.raises(SystemExit):
        serve.main(["--arch", "all", "--backend", "real", *CPU])


def test_launch_real_engine_demo_smoke(capsys):
    serve.main(["--real-engine", "--arch", "llama3.2-1b",
                "--real-reqs", "4", "--real-slots", "2", *CPU])
    out = capsys.readouterr().out
    assert "real engine" in out and "tok/s" in out


def test_launch_real_engine_demo_paged_smoke(capsys):
    """The paged/chunked knobs reach the standalone engine demo."""
    serve.main(["--real-engine", "--arch", "llama3.2-1b",
                "--real-reqs", "4", "--real-slots", "2",
                "--page-size", "8", "--chunk-threshold", "16", *CPU])
    out = capsys.readouterr().out
    assert "paged 16x8" in out and "tok/s" in out


def test_launch_sim_backend_rejects_paged_flags():
    """The paged/chunk knobs configure the real data plane; the sim
    backend refuses them rather than ignore them."""
    with pytest.raises(SystemExit, match="real"):
        serve.main(["--arch", "llama3.2-1b", "--page-size", "8"])
    with pytest.raises(SystemExit, match="real"):
        serve.main(["--arch", "llama3.2-1b", "--chunk-threshold", "16"])


def test_launch_optimistic_requires_page_size():
    """Optimistic admission over-commits the paged pool: the contiguous
    layout has no pool to over-commit."""
    with pytest.raises(SystemExit, match="page-size"):
        serve.main(["--arch", "llama3.2-1b", "--real-engine",
                    "--admission", "optimistic", "--page-size", "0", *CPU])


def test_launch_wall_clock_requires_real_backend():
    """--clock wall runs the control plane in real time; the sim executor
    has nothing to execute, so the combination is refused up front."""
    with pytest.raises(SystemExit, match="--backend real"):
        serve.main(["--arch", "llama3.2-1b", "--clock", "wall"])
    with pytest.raises(SystemExit, match="--backend real"):
        serve.main(["--arch", "llama3.2-1b", "--clock", "wall",
                    "--real-engine", *CPU])


def test_launch_wall_clock_sigint_drains_clean():
    """A live wall-clock server absorbs seeded Poisson traffic, streams at
    least one token, and a SIGINT mid-run drains in-flight work before a
    clean (exit 0) shutdown. Every wait is bounded."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.path.join(root, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    p = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve",
         "--arch", "llama3.2-1b", "--backend", "real", "--clock", "wall",
         "--workers", "1", "--cpu-workers", "0", "--rate", "2",
         "--duration", "60", "--slo-ms", "600000", "--no-autoscale", *CPU],
        cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines: "queue.Queue[str]" = queue.Queue()

    def pump():
        for line in p.stdout:
            lines.put(line)
        lines.put("")

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    out = []
    try:
        deadline = time.monotonic() + 120.0
        while not any("wall-clock server up" in x for x in out):
            out.append(lines.get(timeout=max(deadline - time.monotonic(),
                                              0.1)))
            assert out[-1], "".join(out)
        # a few seconds of live traffic (the seeded first arrival comes
        # well inside them)
        time.sleep(5.0)
        p.send_signal(signal.SIGINT)
        p.wait(timeout=120.0)
        reader.join(timeout=10.0)
    finally:
        if p.poll() is None:
            p.kill()
    while not lines.empty():
        out.append(lines.get())
    text = "".join(out)
    assert p.returncode == 0, text
    assert "SIGINT: draining in-flight work" in text, text
    assert "clean shutdown: drained in-flight work" in text, text
    tokens = int(text.split("streamed: ", 1)[1].split(" tokens", 1)[0])
    assert tokens >= 1, text


def test_launch_real_engine_demo_optimistic_smoke(capsys):
    """The admission/preempt-policy knobs reach the standalone engine
    demo: a starved pool forces preemptions and the stream completes."""
    serve.main(["--real-engine", "--arch", "llama3.2-1b",
                "--real-reqs", "8", "--real-slots", "4",
                "--page-size", "8", "--n-pages", "12",
                "--admission", "optimistic", "--preempt-policy", "slack",
                *CPU])
    out = capsys.readouterr().out
    assert "paged 12x8" in out and "preemptions" in out


def test_launch_sim_backend_rejects_spec_and_quantize():
    """--speculate/--quantize reshape the real decode loop; the sim backend
    refuses them rather than ignore them, with the reference's message."""
    with pytest.raises(SystemExit, match="real"):
        serve.main(["--arch", "llama3.2-1b", "--speculate", "int8:4"])
    with pytest.raises(SystemExit, match="real"):
        serve.main(["--arch", "llama3.2-1b", "--quantize", "int8"])


def test_launch_speculate_rejects_malformed_spec():
    with pytest.raises(SystemExit, match="DRAFT"):
        serve.main(["--arch", "llama3.2-1b", "--real-engine",
                    "--speculate", "int8:notanint", *CPU])
    with pytest.raises(SystemExit, match="DRAFT"):
        serve.main(["--arch", "llama3.2-1b", "--real-engine",
                    "--speculate", ":4", *CPU])


@pytest.mark.parametrize("arch,spec", [("llama3.2-1b", "int8:3"),
                                       ("zamba2-1.2b", "llama3.2-1b:4")])
def test_launch_real_engine_demo_speculative_smoke(capsys, arch, spec):
    """--speculate reaches the standalone engine demo: an int8 draft for
    the dense target, a dense draft for the hybrid one; the rounds and the
    acceptance rate are printed, and the target's attention impl."""
    serve.main(["--real-engine", "--arch", arch, "--real-reqs", "6",
                "--real-slots", "4", "--speculate", spec, *CPU])
    out = capsys.readouterr().out
    k = spec.split(":")[1]
    assert f"speculative decode (k={k}" in out and "rounds" in out
    assert "attn=torch" in out


def test_launch_sim_backend_rejects_fault_tolerance_flags():
    """--swap/--breaker/--deadline-enforce wire the control plane to the
    real data plane; the sim backend has none of it, and --real-engine
    bypasses the control plane. (The port's engine demo takes --swap, so
    where the reference refuses ``--real-engine --swap host`` the port
    refuses ``--real-engine --breaker``.)"""
    with pytest.raises(SystemExit, match="real"):
        serve.main(["--arch", "llama3.2-1b", "--swap", "host"])
    with pytest.raises(SystemExit, match="real"):
        serve.main(["--arch", "llama3.2-1b", "--breaker"])
    with pytest.raises(SystemExit, match="real"):
        serve.main(["--arch", "llama3.2-1b", "--deadline-enforce"])
    with pytest.raises(SystemExit, match="real"):
        serve.main(["--arch", "llama3.2-1b", "--real-engine",
                    "--breaker", *CPU])


def test_launch_swap_budget_requires_swap():
    with pytest.raises(SystemExit, match="--swap host"):
        serve.main(["--arch", "llama3.2-1b", "--backend", "real",
                    "--swap-budget-mb", "64", *CPU])


def test_launch_deadline_enforce_requires_wall_clock():
    """Deadline cancellation runs from the threaded stepper; under the
    virtual clock the flag would be silently inert."""
    with pytest.raises(SystemExit, match="wall"):
        serve.main(["--arch", "llama3.2-1b", "--backend", "real",
                    "--deadline-enforce", *CPU])


def test_launch_real_engine_demo_quantized_smoke(capsys):
    serve.main(["--real-engine", "--arch", "llama3.2-1b",
                "--real-reqs", "4", "--real-slots", "2",
                "--quantize", "int8", *CPU])
    out = capsys.readouterr().out
    assert "real engine" in out and "tok/s" in out
