"""The port's dry-run (``repro_torch.launch.{specs,roofline,dryrun}`` and
``launch.train --dryrun``) on the CPU.

The roofline terms against hand-computed values; ``model_flops`` and
``analytic_compute_s`` against the reference's ``repro.launch.roofline``
(imported alone: ``repro.launch.dryrun`` sets ``XLA_FLAGS`` at import);
the skip rule; what ``DeviceCost`` counts for one rank on a fake (1, 4)
world; one reduced-width llama3.2-1b cell at ``train_4k`` and at
``decode_32k`` on the fake 16x16 world. Fake worlds run in subprocesses
(one default process group a process), every wait bounded at 120 s.
"""
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro.launch import roofline as ref_roofline
from repro.configs.registry import ARCHS as REF_ARCHS
from repro.configs.shapes import shape_applicable as ref_applicable
from repro_torch.configs.registry import ARCHS
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun as DR
from repro_torch.launch import roofline as RF
from repro_torch.sim.hardware import (H100_HBM_BW, H100_NVLINK_BW,
                                      H100_PEAK_FLOPS_BF16)

torch.set_num_threads(1)

WAIT_S = 120
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
# the reference's record of an ok cell (repro/launch/dryrun.py:120-157);
# lower_s/compile_s are one trace_s in the port, which adds the torch
# version and the constants it divides by
REF_OK_KEYS = {"arch", "shape", "mesh", "entry_point", "status", "lower_s",
               "compile_s", "devices", "bytes_per_device", "cost_per_device",
               "collective_bytes_per_device", "roofline", "wall_s"}
REF_ROOFLINE_KEYS = {"compute_s", "compute_s_analytic", "memory_s",
                     "collective_s", "dominant", "step_time_s", "model_flops",
                     "hlo_flops_global", "useful_flops_ratio"}


def _run(script, *args):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", script, *args], env=env,
                          capture_output=True, text=True, timeout=WAIT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# the roofline arithmetic


def test_roofline_terms_hand_computed():
    t = RF.roofline_terms({"flops": 2 * H100_PEAK_FLOPS_BF16,
                           "bytes accessed": 0.5 * H100_HBM_BW},
                          3 * H100_NVLINK_BW, chips=4)
    assert t.compute_s == pytest.approx(2.0, rel=1e-12)
    assert t.memory_s == pytest.approx(0.5, rel=1e-12)
    assert t.collective_s == pytest.approx(3.0, rel=1e-12)
    assert t.dominant == "collective" and t.step_time_s == t.collective_s
    assert t.flops_global == pytest.approx(8 * H100_PEAK_FLOPS_BF16)
    assert t.bytes_global == pytest.approx(2 * H100_HBM_BW)
    assert RF.CONSTANTS["peak_flops_bf16"] == 989e12
    assert RF.CONSTANTS["hbm_bytes_per_s"] == 3.35e12
    assert RF.CONSTANTS["nvlink_bytes_per_s"] == 900e9


@pytest.mark.parametrize("arch", ["llama3.2-1b", "yi-9b",
                                  "moonshot-v1-16b-a3b",
                                  "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_model_flops_match_reference(arch, shape):
    """The same formulas on the same dense and moe configs; the analytic
    compute term differs from the reference's by the peak it divides by
    (989 TFLOP/s here, the TPU v5e's 197 there)."""
    s = SHAPES[shape]
    want = ref_roofline.model_flops(REF_ARCHS[arch], s)
    assert RF.model_flops(ARCHS[arch], s) == want
    for chips in (256, 512):
        ref_s = ref_roofline.analytic_compute_s(REF_ARCHS[arch], s, chips)
        got = RF.analytic_compute_s(ARCHS[arch], s, chips)
        assert got * H100_PEAK_FLOPS_BF16 == pytest.approx(
            ref_s * ref_roofline.V5E_PEAK_FLOPS_BF16, rel=1e-12)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-base",
                                  "zamba2-1.2b", "xlstm-1.3b"])
def test_skip_rule_gives_reference_reason_without_tracing(arch):
    rec = DR.run_cell(arch, "long_500k", multi_pod=False)
    ok, reason = ref_applicable(REF_ARCHS[arch], SHAPES["long_500k"])
    if ok:
        # a sub-quadratic arch runs: checked on the fake world below
        assert ARCHS[arch].subquadratic
        return
    assert rec == {"arch": arch, "shape": "long_500k", "mesh": "16x16",
                   "entry_point": "serve_step", "status": "skipped",
                   "reason": reason}
    assert not dist.is_initialized()        # no world was set up


def test_train_dryrun_routes_to_run_cell(monkeypatch, capsys):
    from repro_torch.launch import train
    calls = []

    def fake_run_cell(arch, shape, multi_pod):
        calls.append((arch, shape, multi_pod))
        return {"arch": arch, "shape": shape, "status": "ok"}
    monkeypatch.setattr(DR, "run_cell", fake_run_cell)
    train.main(["--arch", "qwen3-moe-235b-a22b", "--dryrun", "--multi-pod"])
    assert calls == [("qwen3-moe-235b-a22b", "train_4k", True)]
    assert json.loads(capsys.readouterr().out)["shape"] == "train_4k"


# ---------------------------------------------------------------------------
# what one rank executes, on a fake (1, 4) world

_COUNTS = r"""
import json
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import local_map
from repro_torch.launch.roofline import DeviceCost
torch.set_num_threads(1)
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
# typed as the dry-run types its meshes (launch.mesh._device_type)
mesh = init_device_mesh("cuda", (1, 4), mesh_dim_names=("data", "model"))
R, S = Replicate(), Shard

def place(shape, pl):
    return distribute_tensor(torch.empty(shape, device="meta"), mesh, pl,
                             src_data_rank=None)

x = place((8, 16), [R, R])
w_col = place((16, 32), [R, S(1)])
w_rep = place((16, 32), [R, R])
x_rows = place((8, 16), [R, S(0)])
region = local_map(torch.mm, out_placements=[R, S(0)],
                   in_placements=([R, S(0)], [R, R]), device_mesh=mesh)
cases = {"column_parallel": lambda: x @ w_col,
         "replicated": lambda: x @ w_rep,
         "local_region": lambda: region(x_rows, w_rep),
         "redistribute": lambda: x_rows.redistribute(mesh, [R, R]),
         "shard_to_shard": lambda: x_rows.redistribute(mesh, [R, S(1)])}
out = {}
for name, fn in cases.items():
    with DeviceCost() as c:
        fn()
    out[name] = {"flops": c.flops, "bytes": c.bytes_accessed,
                 "coll": c.collective}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def counts():
    return _run(_COUNTS)


def test_column_parallel_matmul_counts_a_quarter(counts):
    assert counts["column_parallel"]["flops"] == 2 * 8 * 16 * 32 // 4
    # x (8, 16) and w's shard (16, 8) read, (8, 8) written, f32
    assert counts["column_parallel"]["bytes"] == 4 * (8 * 16 + 16 * 8
                                                      + 8 * 8)
    assert sum(counts["column_parallel"]["coll"].values()) == 0


def test_replicated_matmul_counts_global(counts):
    assert counts["replicated"]["flops"] == 2 * 8 * 16 * 32


def test_local_region_counts_its_local_shape(counts):
    # rows (2, 16) of x times the whole w (16, 32)
    assert counts["local_region"]["flops"] == 2 * 2 * 16 * 32
    assert sum(counts["local_region"]["coll"].values()) == 0


def test_redistribute_counts_its_bytes(counts):
    # gathering (8, 16) f32 over 4 ranks: the result, 512 bytes
    assert counts["redistribute"]["coll"]["all-gather"] == 8 * 16 * 4
    assert counts["redistribute"]["flops"] == 0


def test_shard_to_shard_counts_an_all_to_all(counts):
    # rows (2, 16) to columns (8, 4) of x, f32: one all-to-all of the
    # result's 128 bytes, as on a mesh of cards, and no gather
    coll = counts["shard_to_shard"]["coll"]
    assert coll["all-to-all"] == 8 * 4 * 4
    assert sum(coll.values()) == coll["all-to-all"]


# ---------------------------------------------------------------------------
# one reduced-width cell on the fake 16x16 world

_CELL = r"""
import dataclasses, json, sys
import torch
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import dryrun as DR
torch.set_num_threads(1)
cfg = dataclasses.replace(ARCHS["llama3.2-1b"].reduced(), n_layers=2)
recs = [DR.run_cell("llama3.2-1b", shape, False, cfg=cfg)
        for shape in sys.argv[1:]]
print(json.dumps(recs))
"""


@pytest.fixture(scope="module")
def cells():
    recs = _run(_CELL, "train_4k", "decode_32k")
    return {r["shape"]: r for r in recs}


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_reduced_llama_cell_runs_with_reference_record(cells, shape):
    rec = cells[shape]
    assert rec["status"] == "ok", rec.get("error", "") + rec.get(
        "traceback", "")
    want = (REF_OK_KEYS - {"lower_s", "compile_s"}) | {"trace_s", "torch",
                                                        "constants"}
    assert set(rec) == want
    assert set(rec["roofline"]) == (REF_ROOFLINE_KEYS
                                    - {"hlo_flops_global"}) | {
        "flops_global"}
    assert set(rec["bytes_per_device"]) == {"arguments", "outputs", "temps",
                                            "peak"}
    assert set(rec["cost_per_device"]) == {"flops", "bytes accessed"}
    assert set(rec["collective_bytes_per_device"]) == set(RF.COLLECTIVES)
    assert rec["devices"] == 256 and rec["mesh"] == "16x16"
    assert rec["constants"] == RF.CONSTANTS
    b = rec["bytes_per_device"]
    assert 0 < b["arguments"] <= b["peak"]
    assert b["temps"] == b["peak"] - b["arguments"]
    assert rec["cost_per_device"]["flops"] > 0
    r = rec["roofline"]
    assert r["step_time_s"] == max(r["compute_s"], r["memory_s"],
                                   r["collective_s"]) > 0
    # 256 ranks split the batch 16 ways: each executes a fraction of the
    # global FLOPs, never the global count
    assert r["flops_global"] > r["model_flops"] > 0
    assert rec["cost_per_device"]["flops"] < r["model_flops"]
