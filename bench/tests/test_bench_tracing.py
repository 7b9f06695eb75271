"""The readers of the program's queue-wait and padding counters and of its
``stepper.wait`` spans: traced CPU runs of both tiny cells report all six
metrics, and on a program without those counters and spans each reader
returns None instead of raising."""
import types

import bench_tiny
import pytest
import torch

from bench import harness

torch.set_num_threads(1)
SEED = 2 ** 31 + 77
NEW = ("queue_wait_ms", "prefill_pad_share", "stepper_wait_share")


@pytest.mark.parametrize("loop", ["open", "closed"])
def test_traced_run_reports_the_program_metrics(tmp_path, monkeypatch, loop):
    # a short window: the span opens at a prefill past its first 1.5 s, so
    # the counters (read up to the span) cover that much of it
    monkeypatch.setattr(harness, "ARM_S", 1.5)
    monkeypatch.setattr(harness, "SAMPLE", 4)
    root = bench_tiny.make_root(tmp_path)
    cell = harness.load_cell(f"tiny-{loop}", root)
    out = harness.run_cell(cell, SEED, 3.0, True, device="cpu")
    assert out["correct"], out["check"]
    got = out["metrics"]
    for name in NEW:
        m = got.get(f"{name}.{loop}")
        assert m is not None and m["value"] is not None, (name, got)
    assert got[f"queue_wait_ms.{loop}"]["value"] > 0.0
    assert 0.0 <= got[f"prefill_pad_share.{loop}"]["value"] < 100.0
    assert 0.0 <= got[f"stepper_wait_share.{loop}"]["value"] <= 100.0


@pytest.mark.parametrize("name", NEW)
def test_reader_without_the_program_counters_reads_none(name):
    keys = {"stats.prefill_dispatches": 3, "timing.prefill_s": 0.5}
    run = types.SimpleNamespace(
        counters={"t0": dict(keys), "read": dict(keys)}, span=None,
        t0=0.0, t_read=1.0)
    assert harness.reader(name)(run) is None
