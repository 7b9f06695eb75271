"""The port's partition specs (``repro_torch.distributed.sharding``):
mirrors of ``test_sharding.py`` (spec trees mirror the init and cache
structures, every sharded dim divides the production mesh), leafwise
parity with the reference's spec trees for every architecture, both
production meshes and both ``fsdp`` settings, and ``to_placements``.

No process group is set up: the production meshes are described by
``MeshAxes`` alone, the init structure comes from the port's ``init``
under ``FakeTensorMode`` (nothing is allocated), and ``to_placements``
takes a stand-in with the names and sizes it reads of a ``DeviceMesh``.
"""
from typing import Any, Iterator, Tuple

import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard

from repro.configs.registry import ARCHS as J_ARCHS
from repro.distributed import sharding as JS
from repro_torch.configs.registry import ARCHS
from repro_torch.configs.shapes import SHAPES, shape_applicable
from repro_torch.distributed import sharding as S
from repro_torch.distributed.sharding import MeshAxes, P
from repro_torch.models.model import build_model

# six xdist workers share the cores with XLA's threads: one torch thread
# each keeps them from oversubscribing
torch.set_num_threads(1)

POD = MeshAxes(data=("data",), model="model", data_size=16, model_size=16)
MULTIPOD = MeshAxes(data=("pod", "data"), model="model", data_size=32,
                    model_size=16)
J_POD = JS.MeshAxes(data=("data",), model="model", data_size=16,
                    model_size=16)
J_MULTIPOD = JS.MeshAxes(data=("pod", "data"), model="model", data_size=32,
                         model_size=16)
MESHES = {"pod": (POD, J_POD), "multipod": (MULTIPOD, J_MULTIPOD)}
AXIS_SIZE = {"data": 16, "pod": 2, "model": 16}


def _flat(tree, path=()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) in ``jax.tree``'s order: dict keys sorted, a
    NamedTuple's fields in order; a spec (either package's) is a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _flat(getattr(tree, f), path + (f,))
    else:
        yield path, tree


def _fake_init(cfg):
    model = build_model(cfg, "cpu")
    with FakeTensorMode():
        return model.init(0)


def _check_divides(shape, spec, where):
    assert len(spec) <= len(shape), (where, shape, spec)
    for dim, names in enumerate(spec):
        if names is None:
            continue
        names = names if isinstance(names, tuple) else (names,)
        total = 1
        for n in names:
            total *= AXIS_SIZE[n]
        assert shape[dim] % total == 0, (where, shape, spec)


# ---------------------------------------------------------------------------
# mirrors of test_sharding.py


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_init_structure(arch, mesh):
    cfg = ARCHS[arch]
    ax = MESHES[mesh][0]
    params = dict(_flat(_fake_init(cfg)))
    specs = dict(_flat(S.param_specs(cfg, ax)))
    assert params.keys() == specs.keys(), arch
    for path, leaf in params.items():
        assert isinstance(specs[path], P), path
        _check_divides(tuple(leaf.shape), specs[path], (arch, path))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_match_cache_structure(arch):
    cfg = ARCHS[arch]
    shape = SHAPES["decode_32k"]
    assert shape_applicable(cfg, shape)[0]
    cache = build_model(cfg, "cpu").cache_shapes(
        shape.global_batch, shape.seq_len, enc_len=shape.seq_len)
    specs = S.cache_specs(cfg, shape.global_batch, POD)
    assert cache.keys() == specs.keys(), arch
    for name, (leaf_shape, _) in cache.items():
        _check_divides(leaf_shape, specs[name], (arch, name))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_specs_structure(arch):
    cfg = ARCHS[arch]
    specs = S.batch_specs(cfg, 256, MULTIPOD)
    assert "tokens" in specs and "targets" in specs
    if cfg.family == "audio":
        assert "frames" in specs
    if cfg.family == "vlm":
        assert "image_embeds" in specs
    # batch 1 (long_500k) must not be sharded over data
    s1 = S.batch_specs(cfg, 1, MULTIPOD)
    assert s1["tokens"][0] is None


# ---------------------------------------------------------------------------
# leafwise parity with the reference's spec trees


def _assert_same_tree(port, ref, what):
    ours = list(_flat(port))
    theirs = list(_flat(ref))
    assert [p for p, _ in ours] == [p for p, _ in theirs], what
    for (path, a), (_, b) in zip(ours, theirs):
        assert isinstance(a, P) and isinstance(b, JP), (what, path)
        assert tuple(a) == tuple(b), (what, path, a, b)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_spec_trees_equal_reference(arch):
    cfg, jcfg = ARCHS[arch], J_ARCHS[arch]
    decode = SHAPES["decode_32k"]
    for mesh, (ax, jax_) in MESHES.items():
        for fsdp in (False, True, None):
            _assert_same_tree(S.param_specs(cfg, ax, fsdp=fsdp),
                              JS.param_specs(jcfg, jax_, fsdp=fsdp),
                              (arch, mesh, "params", fsdp))
        _assert_same_tree(
            S.cache_specs(cfg, decode.global_batch, ax),
            JS.cache_specs(jcfg, decode.global_batch, jax_),
            (arch, mesh, "cache"))
        for batch in (256, 1):
            _assert_same_tree(S.batch_specs(cfg, batch, ax),
                              JS.batch_specs(jcfg, batch, jax_),
                              (arch, mesh, "batch", batch))
        _assert_same_tree(S.train_state_specs(cfg, ax),
                          JS.train_state_specs(jcfg, jax_),
                          (arch, mesh, "train_state"))
        assert S.needs_fsdp(cfg, ax) == JS.needs_fsdp(jcfg, jax_)


def test_spec_normalizes_like_partition_spec():
    for entries in [(("data",), None, "model"), (("pod", "data"), None),
                    (), (None, None)]:
        assert tuple(P(*entries)) == tuple(JP(*entries)), entries


# ---------------------------------------------------------------------------
# to_placements


class _Mesh:
    """What ``to_placements`` reads of a ``DeviceMesh``: its dim names and
    sizes (2 each unless given)."""

    def __init__(self, names, sizes=None):
        self.mesh_dim_names = tuple(names)
        self.ndim = len(names)
        self._sizes = sizes or (2,) * len(names)

    def size(self, i):
        return self._sizes[i]


@pytest.mark.parametrize("case", [
    # (mesh dim names, spec, expected placements)
    (("data", "model"), P(None, ("data", "model")), [Shard(1), Shard(1)]),
    (("data", "model"), P(None, None), [Replicate(), Replicate()]),
    (("data", "model"), P("model", None), [Replicate(), Shard(0)]),
    (("pod", "data", "model"), P(("pod", "data"), None, "model"),
     [Shard(0), Shard(0), Shard(2)]),
], ids=["tuple_axis", "none", "unnamed_mesh_dim", "leading_pod"])
def test_to_placements(case):
    names, spec, want = case
    assert S.to_placements(_Mesh(names), spec) == want


def test_to_placements_leaves_a_size_one_mesh_dim_replicated():
    mesh = _Mesh(("data", "model"), sizes=(1, 4))
    assert S.to_placements(mesh, P("data", "model")) == [Replicate(),
                                                          Shard(1)]
    assert S.to_placements(_Mesh(("data", "model"), sizes=(1, 1)),
                           P("data", "model")) == [Replicate(), Replicate()]


def test_to_placements_refuses_a_reversed_tuple():
    with pytest.raises(ValueError, match="order"):
        S.to_placements(_Mesh(("pod", "data", "model")),
                        P(("data", "pod"), None))
