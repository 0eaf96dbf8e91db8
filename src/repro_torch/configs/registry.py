"""Architecture registry: --arch <id> resolves here.

Each config module defines CONFIG (full, exact published numbers), SMOKE
(same family, tiny), and SHAPES (which assigned input shapes apply).
"""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = (
    "mixtral_8x7b",
    "deepseek_v3_671b",
    "deepseek_coder_33b",
    "gemma_7b",
    "minitron_8b",
    "llama3_8b",
    "zamba2_7b",
    "rwkv6_1b6",
    "llama32_vision_90b",
    "whisper_base",
)

# canonical ids as given in the assignment (hyphenated) -> module name
ALIASES = {
    "mixtral-8x7b": "mixtral_8x7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "gemma-7b": "gemma_7b",
    "minitron-8b": "minitron_8b",
    "llama3-8b": "llama3_8b",
    "zamba2-7b": "zamba2_7b",
    "rwkv6-1.6b": "rwkv6_1b6",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "whisper-base": "whisper_base",
}

# assigned LM shapes: name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def get(arch_id: str):
    mod_name = ALIASES.get(arch_id, arch_id)
    if mod_name not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; known: "
                         f"{sorted(ALIASES) + list(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def config(arch_id: str, **overrides):
    cfg = get(arch_id).CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def smoke_config(arch_id: str, **overrides):
    cfg = get(arch_id).SMOKE
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def shapes_for(arch_id: str) -> tuple[str, ...]:
    return get(arch_id).SHAPES
