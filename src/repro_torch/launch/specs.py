"""Shape-only, placed inputs for every (arch x shape) dry-run cell
(``repro.launch.specs`` on ``torch.distributed``).

The reference builds ``jax.ShapeDtypeStruct`` stand-ins and lets ``jit``'s
``in_shardings`` place them. Here every leaf is a tensor on the ``meta``
device (a shape and a dtype, no storage, so qwen3-moe-235b's 463.5 GB of
weights cost nothing) placed on the mesh by ``sharding.shard_tree`` with
the port's spec trees: params by ``param_specs``, the AdamW moments by
``opt_state_specs``, batches by ``batch_specs``, caches by
``cache_specs``. The params come from the model's own ``init`` with its
``torch.Generator``, run under a ``FakeTensorMode`` (no storage either)
and taken to ``meta`` leaf by leaf. The run itself takes meta tensors, not
fake ones: under an active ``FakeTensorMode`` DTensor treats every op as
traced and propagates its sharding afresh, and a fake op costs about a
millisecond, where a meta op costs tens of microseconds.

The train state is the port's ``{"params", "opt", "gen"}``
(``sharding.train_state_specs`` mirrors the reference's ``"rng"`` tree,
not this one); its step is a host scalar, which AdamW reads on the host,
and ``gen`` is None (no gradient compression).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.distributed import sharding as SH
from repro_torch.models.model import Model
from repro_torch.models.transformer import DTYPES
from repro_torch.training.optimizer import AdamWState
from repro_torch.tree import tree_map

META = torch.device("meta")


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device=META)


def meta_params(model: Model) -> Any:
    """``model.init(0)``'s tree as meta tensors: init runs under a
    ``FakeTensorMode`` with the model's generator."""
    with FakeTensorMode():
        fake = model.init(0)
    return tree_map(_meta, fake)


def batch_structs(cfg: ArchConfig, batch: int, seq: int, mesh: DeviceMesh,
                  with_targets: bool = True) -> Dict[str, Any]:
    """int32 ``tokens`` (and ``targets``) (batch, seq) and the family's
    encoder input in ``cfg.dtype``, placed by ``batch_specs``."""
    dtype = DTYPES[cfg.dtype]
    i32 = dict(dtype=torch.int32, device=META)
    out = {"tokens": torch.zeros((batch, seq), **i32)}
    if with_targets:
        out["targets"] = torch.zeros((batch, seq), **i32)
    if cfg.family == "audio":
        out["frames"] = torch.zeros((batch, seq, cfg.d_model), dtype=dtype,
                                    device=META)
    if cfg.family == "vlm":
        out["image_embeds"] = torch.zeros(
            (batch, cfg.n_image_tokens, cfg.d_model), dtype=dtype,
            device=META)
    ax = SH.MeshAxes.from_mesh(mesh)
    return SH.shard_tree(mesh, out, SH.batch_specs(cfg, batch, ax,
                                                   with_targets))


def param_structs(model: Model, mesh: DeviceMesh) -> Any:
    """``meta_params`` placed by ``param_specs``."""
    ax = SH.MeshAxes.from_mesh(mesh)
    return SH.shard_tree(mesh, meta_params(model),
                         SH.param_specs(model.cfg, ax))


def train_state_structs(model: Model, mesh: DeviceMesh) -> Dict[str, Any]:
    """``{"params", "opt", "gen"}``: the params placed by ``param_specs``,
    the AdamW moments (f32 zeros) by ``opt_state_specs``, step 0."""
    ax = SH.MeshAxes.from_mesh(mesh)
    pspecs = SH.param_specs(model.cfg, ax)
    params = meta_params(model)
    ospecs = SH.opt_state_specs(pspecs)

    def moments(specs):
        zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
        return SH.shard_tree(mesh, zeros, specs)
    opt = AdamWState(step=torch.tensor(0, dtype=torch.int32),
                     mu=moments(ospecs.mu), nu=moments(ospecs.nu))
    return {"params": SH.shard_tree(mesh, params, pspecs), "opt": opt,
            "gen": None}


def decode_structs(model: Model, shape: ShapeConfig,
                   mesh: DeviceMesh) -> Tuple[Any, Any, Any]:
    """(cache, token, pos) of one serve step: one new token a slot against
    a contiguous cache of ``shape.seq_len`` (the last slot receives it),
    placed by ``cache_specs``; ``pos`` one position for every slot, as
    the reference's scalar."""
    B, S = shape.global_batch, shape.seq_len
    ax = SH.MeshAxes.from_mesh(mesh)
    cache = {name: torch.zeros(sh, dtype=dt, device=META) for name, (sh, dt)
             in model.cache_shapes(B, S, enc_len=S).items()}
    cache = SH.shard_tree(mesh, cache, SH.cache_specs(model.cfg, B, ax))
    placed = SH.shard_tree(
        mesh, {"token": torch.zeros((B, 1), dtype=torch.int32, device=META),
               "pos": torch.full((), S - 1, dtype=torch.int32, device=META)},
        {"token": SH.P(SH._dax(ax, B), None), "pos": SH.P()})
    return cache, placed["token"], placed["pos"]


def input_specs(model: Model, shape: ShapeConfig,
                mesh: DeviceMesh) -> Dict[str, Any]:
    """All entry-point inputs of one cell, keyed by argument name."""
    cfg = model.cfg
    if shape.kind == "train":
        return {"state": train_state_structs(model, mesh),
                "batch": batch_structs(cfg, shape.global_batch,
                                       shape.seq_len, mesh)}
    if shape.kind == "prefill":
        return {"params": param_structs(model, mesh),
                "batch": batch_structs(cfg, shape.global_batch,
                                       shape.seq_len, mesh,
                                       with_targets=False)}
    cache, token, pos = decode_structs(model, shape, mesh)
    return {"params": param_structs(model, mesh), "cache": cache,
            "token": token, "pos": pos}
