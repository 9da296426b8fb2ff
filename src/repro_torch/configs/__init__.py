"""Architecture registry (port of `repro.configs`): ``get_config(name)``.

Each module defines ``config: ArchConfig`` with the published dimensions,
as the JAX package's does; the paper's own models (``mnist-mlp``,
``cifar-cnn``) are plain dicts, kept out of ``ARCH_NAMES`` as in JAX.
All ten of the JAX package's architectures are registered.
"""
from __future__ import annotations

import importlib

_ARCH_MODULES = {
    "gemma2-9b": "gemma2_9b",
    "qwen2.5-3b": "qwen2_5_3b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "internvl2-2b": "internvl2_2b",
    "whisper-tiny": "whisper_tiny",
    "xlstm-125m": "xlstm_125m",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "llama3-405b": "llama3_405b",
    # the paper's own models
    "mnist-mlp": "mnist_mlp",
    "cifar-cnn": "cifar_cnn",
}

ARCH_NAMES = [n for n in _ARCH_MODULES if n not in ("mnist-mlp", "cifar-cnn")]


def get_config(name: str, reduced: bool = False):
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; available: "
                       f"{sorted(_ARCH_MODULES)}")
    cfg = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}").config
    return cfg.reduced() if reduced and hasattr(cfg, "reduced") else cfg
