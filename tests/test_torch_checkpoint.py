"""The port's checkpoints (``repro_torch.distributed.checkpoint``) and the
on-disk model repository: mirrors of ``test_checkpoint.py``, and params
trees written by one package and read by the other, at f32 and bf16, with
equal SHA-256 hashes and equal bits (no tolerance: a checkpoint is bytes).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.distributed import checkpoint as j_ckpt
from repro.models import build_model as j_build
from repro_torch.convert import params_from_jax
from repro_torch.core.repository import ModelRepository
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.tree import leaves

# six xdist workers share the cores with XLA's threads: one torch thread
# each keeps them from oversubscribing
torch.set_num_threads(1)


def _tree(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {
        "layers": {"w": torch.randn((4, 8), generator=gen),
                   "b": torch.randn((8,), generator=gen)},
        "head": torch.randn((8, 2), generator=gen),
        "step_count": torch.tensor(7, dtype=torch.int32),
    }


def _assert_trees_equal(a, b):
    fa, fb = dict(leaves(a)), dict(leaves(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k], fb[k]), k


def _raw(t: torch.Tensor) -> bytes:
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


# ---------------------------------------------------------------------------
# mirrors of test_checkpoint.py


def test_roundtrip(tmp_path):
    t = _tree()
    p = str(tmp_path / "c0")
    ckpt.save_pytree(p, t)
    _assert_trees_equal(ckpt.load_pytree(p, like=t), t)


def test_corruption_detected(tmp_path):
    t = _tree()
    p = str(tmp_path / "c1")
    ckpt.save_pytree(p, t)
    # flip bytes in the array file
    npz = os.path.join(p, "arrays.npz")
    data = dict(np.load(npz))
    key = sorted(data)[0]
    data[key] = data[key] + 1.0
    np.savez(npz, **data)
    with pytest.raises(IOError, match="corruption"):
        ckpt.load_pytree(p, like=t)


def test_manager_retention_and_restore(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path / "run"), keep=2)
    for step in (10, 20, 30, 40):
        mgr.save(step, _tree(step))
    assert mgr.all_steps() == [30, 40]
    step, tree = mgr.restore(like=_tree())
    assert step == 40
    _assert_trees_equal(tree, _tree(40))


def test_manager_restart_after_partial_write(tmp_path):
    """A torn write (no manifest) must be invisible to restore."""
    mgr = ckpt.CheckpointManager(str(tmp_path / "run"), keep=3)
    mgr.save(1, _tree(1))
    torn = os.path.join(str(tmp_path / "run"), "step_000000002")
    os.makedirs(torn)           # directory exists, but no manifest.json
    assert mgr.latest_step() == 1
    step, _ = mgr.restore(like=_tree())
    assert step == 1


# ---------------------------------------------------------------------------
# across packages


@pytest.fixture(scope="module")
def jax_params():
    jm = j_build(J_ARCHS["llama3.2-1b"].reduced())
    return jm.init(jax.random.PRNGKey(0))


def _manifest_hashes(path):
    import json
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    return {e["key"]: (e["sha256"], e["dtype"], e["shape"])
            for e in m["leaves"]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_cross_packages_with_equal_hashes(tmp_path, jax_params,
                                                 dtype):
    """A params tree saved by ``repro`` loads in the port with the same
    bits, and the port's save of it gives the same manifest (keys, order,
    dtypes, shapes, SHA-256); the port's save loads in ``repro`` with the
    same bits. ``repro`` reads a bf16 leaf back as its raw 2-byte values
    (numpy's form of an ``ml_dtypes.bfloat16`` array in an ``.npz``)."""
    jp = jax.tree.map(lambda a: a.astype(jnp.dtype(dtype)), jax_params)
    j_path, t_path = str(tmp_path / "from_jax"), str(tmp_path / "from_torch")
    j_hashes = j_ckpt.save_pytree(j_path, jp)
    loaded = ckpt.load_pytree(j_path)
    _assert_trees_equal(loaded, params_from_jax(jp, "cpu"))
    t_hashes = ckpt.save_pytree(t_path, loaded)
    assert t_hashes == j_hashes
    assert list(_manifest_hashes(t_path).items()) == \
        list(_manifest_hashes(j_path).items())
    back = j_ckpt.load_pytree(t_path, like=jp)
    flat = dict(leaves(loaded))
    for k, v in leaves(back):
        assert np.asarray(v).tobytes() == _raw(flat[k]), k


def test_model_repository_root_roundtrip(tmp_path):
    """``ModelRepository(root=)`` persists through the checkpoint module:
    a second repository on the same root (nothing in memory) gets the
    tree back as host tensors, bf16 and f32 leaves alike."""
    tree = _tree(3)
    tree["bf16"] = torch.randn((5, 3)).to(torch.bfloat16)
    repo = ModelRepository(root=str(tmp_path / "repo"))
    repo.put_params("llama/bf16", tree)
    assert repo.get_params("llama/bf16") is tree
    assert os.path.isdir(str(tmp_path / "repo" / "llama_bf16"))
    fresh = ModelRepository(root=str(tmp_path / "repo"))
    got = fresh.get_params("llama/bf16")
    _assert_trees_equal(got, tree)
    assert all(t.device.type == "cpu" for _, t in leaves(got))
    with pytest.raises(FileNotFoundError):
        fresh.get_params("absent")
    with pytest.raises(KeyError):
        ModelRepository().get_params("llama/bf16")
