"""Whole runs of a tiny cell on the CPU (the look for a chip skipped):
``correct`` is true on a sound run and false with the timed path broken
underneath: a token altered where the engine produces it, and a decode
step that leaves the KV cache as it was."""
import bench_tiny
import numpy as np
import pytest
import torch

from bench import harness

torch.set_num_threads(1)
SEED = 2 ** 31 + 21


@pytest.fixture(autouse=True)
def _sample(monkeypatch):
    monkeypatch.setattr(harness, "SAMPLE", 8)


def _run(tmp_path, name="tiny-open"):
    root = bench_tiny.make_root(tmp_path)
    return harness.run_cell(harness.load_cell(name, root), SEED, 2.0, False,
                            device="cpu")


@pytest.mark.parametrize("name", ["tiny-open", "tiny-closed"])
def test_sound_run_is_correct(tmp_path, name):
    out = _run(tmp_path, name)
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "check"


def test_altered_token_is_not_correct(tmp_path, monkeypatch):
    from repro_torch.serving.engine import ServingEngine
    seg = ServingEngine._decode_segment

    def altered(self, plan):
        out, log = seg(self, plan)
        out = np.where(out >= 0, (out + 1) % self.model.cfg.vocab, out)
        return out, log
    monkeypatch.setattr(ServingEngine, "_decode_segment", altered)
    out = _run(tmp_path)
    assert not out["correct"]
    assert out["check"]["mean_gap"]["value"] > 1e-4


def test_kv_left_unchanged_is_not_correct(tmp_path, monkeypatch):
    from repro_torch.models import kvcache

    def unchanged(k_pool, v_pool, k, v, block_table, pos):
        return k_pool, v_pool
    monkeypatch.setattr(kvcache, "paged_update_layer_cache", unchanged)
    out = _run(tmp_path)
    assert not out["correct"]
    assert out["check"]["mean_gap"]["value"] > 1e-4
