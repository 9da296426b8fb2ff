"""Model input construction (port of `repro.models.inputs`).

A *batch* is a dict: ``tokens`` (B, S_text) int64, and ``labels`` (B,
S_text) int64 for training.  The front ends' inputs (``patch_embeds``,
``frames``) wait for their slice (ROADMAP §1).
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.utils.device import resolve_device


def text_len(cfg: ArchConfig, seq_len: int) -> int:
    """Text tokens in a sequence of ``seq_len``: all of them, until the
    vision front end (whose patch embeddings take ``prefix_tokens`` of the
    sequence) is ported."""
    return seq_len


def make_batch(seed: int, cfg: ArchConfig, seq_len: int, batch: int,
               kind: str = "train", *, device=None) -> dict:
    """A random batch: uniform tokens (and labels for ``kind="train"``)
    drawn on ``device`` from a generator seeded with ``seed``."""
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend} front "
                                  f"end's inputs are not ported yet "
                                  f"(ROADMAP §1, other mixers and front "
                                  f"ends)")
    device = resolve_device(device)
    gen = torch.Generator(device).manual_seed(seed)
    shape = (batch, text_len(cfg, seq_len))
    out = {"tokens": torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                   device=device)}
    if kind == "train":
        out["labels"] = torch.randint(0, cfg.vocab_size, shape,
                                      generator=gen, device=device)
    return out
