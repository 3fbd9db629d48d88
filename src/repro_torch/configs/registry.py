"""Architecture registry: resolve --arch <id> strings."""
from __future__ import annotations

import importlib

_ARCH_MODULES = {
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "minitron-8b": "minitron_8b",
    "qwen2-0.5b": "qwen2_0_5b",
    "glm4-9b": "glm4_9b",
    "qwen3-0.6b": "qwen3_0_6b",
    "chameleon-34b": "chameleon_34b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "xlstm-1.3b": "xlstm_1_3b",
}


def list_archs() -> list:
    return sorted(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str, reduced: bool = False):
    mod = _module(arch)
    return mod.reduced() if reduced else mod.CONFIG
