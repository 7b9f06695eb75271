"""Registry of the ported architectures, selectable by ``--arch <id>``.

The dense (llama3.2-1b, minitron-8b, yi-9b, phi3-mini-3.8b), audio
(whisper-base) and vlm (llama-3.2-vision-90b) families are ported; the
others join with their model code.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (llama3_2_1b, llama3_2_vision_90b,
                                 minitron_8b, phi3_mini, whisper_base, yi_9b)
from repro_torch.configs.base import ArchConfig

ARCHS: Dict[str, ArchConfig] = {
    c.name: c for c in (llama3_2_1b.CONFIG, minitron_8b.CONFIG,
                        yi_9b.CONFIG, phi3_mini.CONFIG, whisper_base.CONFIG,
                        llama3_2_vision_90b.CONFIG)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choices: {sorted(ARCHS)}")
    return ARCHS[name]
