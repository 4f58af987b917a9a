"""Architecture registry: one module per assigned architecture.

The port of `repro.configs`: the same names and aliases.  Each ported
module exports get_config() (the full assigned spec) and
reduced_config() (the CPU smoke-test variant).  All ten architectures
are ported (`PORTED`); an unknown name raises ValueError.
"""
from __future__ import annotations

import importlib

ARCHITECTURES = (
    "starcoder2_15b",
    "recurrentgemma_9b",
    "llama3_2_vision_90b",
    "xlstm_125m",
    "seamless_m4t_medium",
    "qwen3_4b",
    "arctic_480b",
    "deepseek_v2_236b",
    "qwen2_72b",
    "qwen3_8b",
)
PORTED = ("qwen3_4b", "qwen3_8b", "qwen2_72b", "xlstm_125m",
          "recurrentgemma_9b", "starcoder2_15b", "llama3_2_vision_90b",
          "seamless_m4t_medium", "arctic_480b", "deepseek_v2_236b")

# CLI ids (dashes) -> module names
_ALIASES = {a.replace("_", "-"): a for a in ARCHITECTURES}
_ALIASES.update({
    "starcoder2-15b": "starcoder2_15b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "llama-3.2-vision-90b": "llama3_2_vision_90b",
    "xlstm-125m": "xlstm_125m",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "qwen3-4b": "qwen3_4b",
    "arctic-480b": "arctic_480b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "qwen2-72b": "qwen2_72b",
    "qwen3-8b": "qwen3_8b",
})


def _module(name: str):
    key = _ALIASES.get(name, name)
    if key not in ARCHITECTURES:
        raise ValueError(f"unknown architecture {name!r}")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(name: str):
    return _module(name).get_config()


def reduced_config(name: str):
    return _module(name).reduced_config()


def list_architectures() -> tuple:
    return tuple(sorted(set(_ALIASES) - set(ARCHITECTURES)))
