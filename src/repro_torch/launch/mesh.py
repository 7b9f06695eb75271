"""Mesh construction (``repro.launch.mesh`` on ``torch.distributed``).

Functions, not module constants, so importing this module touches no
process group. The production meshes are 16x16 = 256 ranks (data, model)
and, multi-pod, 2x16x16 = 512 (pod, data, model); the host mesh is 1x1
over the world already set up (one rank, one device). Each needs the
caller to have called ``torch.distributed.init_process_group`` with the
world size it takes; none falls back to another size.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type() -> str:
    """``cuda`` under NCCL and under the ``"fake"`` backend, whose world
    stands for one of cards (DTensor then moves a shard to another dim by
    an all-to-all, where a ``cpu`` mesh gathers it whole); else ``cpu``."""
    backend = dist.get_backend()
    return "cuda" if backend in ("nccl", "fake") else "cpu"


def _mesh(shape, names) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError(f"mesh {dict(zip(names, shape))}: no "
                           "torch.distributed world is set up")
    want = math.prod(shape)
    have = dist.get_world_size()
    if have != want:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs a world of "
                         f"{want} ranks; this world has {have}")
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_host_mesh() -> DeviceMesh:
    """1x1 ("data", "model") mesh over the one rank of the world, on its
    device (``cuda`` under NCCL, the CPU under gloo)."""
    if _device_type() == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return _mesh((1, 1), ("data", "model"))
