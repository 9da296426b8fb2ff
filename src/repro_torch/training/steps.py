"""Single-model serve step builders (port of `repro.training.steps`).
Cross-entropy and the train step come with the LM training slice
(ROADMAP §1)."""
from __future__ import annotations

from typing import Callable

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ArchConfig


def make_prefill_step(cfg: ArchConfig) -> Callable:
    """(params, batch) -> (last_logits (B, 1, V), caches)."""
    def step(params, batch):
        return tfm.prefill(params, batch, cfg)
    return step


def make_decode_step(cfg: ArchConfig) -> Callable:
    """(params, token (B, 1), caches, pos) -> (logits (B, 1, V), deltas)."""
    def step(params, token, caches, pos):
        return tfm.decode_step(params, token, caches, pos, cfg)
    return step
