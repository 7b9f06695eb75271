"""The traffic generator: one seed gives one draw, every seed the same
multiset of lengths and gaps, and each mix holds its parameters."""
import json

import bench_tiny
import numpy as np
import pytest
import torch

from bench import workload

torch.set_num_threads(1)

MIXES = sorted((bench_tiny.ROOT / "bench" / "traffic").glob("*.json"))


def _mix(path):
    return json.loads(path.read_text())


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_same_seed_same_draw(path):
    mix = _mix(path)
    a = workload.draw(mix, 10.0, 2 ** 31 + 11, 32064)
    b = workload.draw(mix, 10.0, 2 ** 31 + 11, 32064)
    assert len(a) == len(b) == workload.count(mix, 10.0)
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt)
        assert (x.max_new, x.due) == (y.max_new, y.due)


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_seeds_share_the_work_in_another_order(path):
    mix = _mix(path)
    a = workload.draw(mix, 10.0, 1, 32064)
    b = workload.draw(mix, 10.0, 2, 32064)
    la, lb = [len(r.prompt) for r in a], [len(r.prompt) for r in b]
    assert sorted(la) == sorted(lb) and la != lb
    assert sorted(r.max_new for r in a) == sorted(r.max_new for r in b)
    assert not np.array_equal(a[0].prompt[:4], b[0].prompt[:4])


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_mix_holds_its_parameters(path):
    mix = _mix(path)
    reqs = workload.draw(mix, 40.0, 3, 32064)
    p, o = mix["prompt"], mix["output"]
    plens = np.array([len(r.prompt) for r in reqs])
    outs = np.array([r.max_new for r in reqs])
    assert plens.min() >= p["min"] and plens.max() <= p["max"]
    assert outs.min() >= o["min"] and outs.max() <= o["max"]
    assert all(0 <= r.prompt.min() and r.prompt.max() < 32064 for r in reqs)
    for d, v in ((p, plens), (o, outs)):
        if d["dist"] == "lognormal":
            assert np.median(v) == pytest.approx(d["median"], rel=0.05)
        elif d["dist"] == "uniform":
            assert v.mean() == pytest.approx((d["min"] + d["max"]) / 2,
                                             rel=0.02)
        else:
            assert np.median(v) == pytest.approx(
                np.sqrt(d["min"] * d["max"]), rel=0.05)
    if mix["loop"] == "open":
        due = np.array([r.due for r in reqs])
        assert len(reqs) == round(mix["rate_qps"] * 40.0)
        assert due[0] == 0.0 and np.all(np.diff(due) >= 0)
        assert due[-1] < 40.0
        assert np.diff(due).mean() == pytest.approx(
            1 / mix["rate_qps"], rel=0.05)
    else:
        assert len(reqs) == mix["clients"] * 32


def test_lognormal_quantiles_hand_worked():
    q = workload.quantiles({"dist": "lognormal", "median": 100, "sigma": 1.0,
                            "min": 1, "max": 10 ** 6}, 3)
    # quantiles at 1/6, 1/2, 5/6: exp(ln 100 -+ 0.9674)
    assert q.tolist() == [38, 100, 263]
    q = workload.quantiles({"dist": "uniform", "min": 10, "max": 20}, 2)
    assert q.tolist() == [12, 18]


@pytest.mark.parametrize("path", [p for p in MIXES if "block" in _mix(p)],
                         ids=lambda p: p.stem)
def test_every_block_holds_the_same_lengths(path):
    mix = _mix(path)
    b = mix["block"]
    for seed in (1, 2):
        reqs = workload.draw(mix, 50.0, seed, 32064)
        first = sorted((len(r.prompt), r.max_new) for r in reqs[:b])
        for k in range(1, 4):
            blk = reqs[k * b:(k + 1) * b]
            assert sorted(len(r.prompt) for r in blk) == sorted(
                p for p, _ in first)
            assert sorted(r.max_new for r in blk) == sorted(
                m for _, m in first)
