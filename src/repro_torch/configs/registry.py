"""Registry of the ported architectures, selectable by ``--arch <id>``.

Only llama3.2-1b is ported so far; the other families join with their
model code.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import llama3_2_1b
from repro_torch.configs.base import ArchConfig

ARCHS: Dict[str, ArchConfig] = {c.name: c for c in (llama3_2_1b.CONFIG,)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choices: {sorted(ARCHS)}")
    return ARCHS[name]
