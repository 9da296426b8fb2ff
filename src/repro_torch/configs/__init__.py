"""Architecture registry (port of `repro.configs`): ``get_config(name)``.

Each module defines ``config: ArchConfig`` with the published dimensions,
as the JAX package's does.  Only the configurations a path of the port
runs are registered; asking for another raises ``NotImplementedError``
naming the ROADMAP item that ports it.
"""
from __future__ import annotations

import importlib

_ARCH_MODULES = {
    "gemma2-9b": "gemma2_9b",
    "qwen2.5-3b": "qwen2_5_3b",
}

# The JAX package's other configurations, and why each is not here.
_LATER = "(ROADMAP §1, the other mixers and front ends)"
_NOT_PORTED = {
    "phi4-mini-3.8b": "a dense decoder, registered when a path or cell "
                      "needs it (ROADMAP §1 item 8)",
    "llama3-405b": "a dense decoder, registered when a path or cell needs "
                   "it (ROADMAP §1 item 8)",
    "qwen3-moe-235b-a22b": f"it waits for MoE and qk_norm {_LATER}",
    "kimi-k2-1t-a32b": f"it waits for MoE {_LATER}",
    "jamba-v0.1-52b": f"it waits for mamba and MoE {_LATER}",
    "xlstm-125m": f"it waits for the xLSTM mixers {_LATER}",
    "internvl2-2b": f"it waits for the vision front end {_LATER}",
    "whisper-tiny": f"it waits for the audio front end and cross-attention "
                    f"{_LATER}",
    "mnist-mlp": "the FL path builds it: repro_torch.models.make_mnist_mlp",
    "cifar-cnn": "it waits for the CIFAR CNN (ROADMAP §1)",
}

ARCH_NAMES = list(_ARCH_MODULES)


def get_config(name: str, reduced: bool = False):
    if name in _NOT_PORTED:
        raise NotImplementedError(f"{name!r} is not in the port's registry: "
                                  f"{_NOT_PORTED[name]}")
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; available: "
                       f"{sorted(_ARCH_MODULES)}")
    cfg = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}").config
    return cfg.reduced() if reduced else cfg
