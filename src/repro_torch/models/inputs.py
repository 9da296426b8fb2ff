"""Model input construction (port of `repro.models.inputs`).

A *batch* is a dict:
  tokens        (B, S_text) int64              — always present
  labels        (B, S_text) int64              — train only
  patch_embeds  (B, prefix, frontend_dim)      — vision_stub only
  frames        (B, encoder_seq, frontend_dim) — audio_stub only

For the VLM the model prepends ``prefix_tokens`` projected patches, so
S_text = seq_len − prefix_tokens keeps the whole sequence at seq_len.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.utils.device import resolve_device


def text_len(cfg: ArchConfig, seq_len: int) -> int:
    """Text tokens in a sequence of ``seq_len``: the VLM's patch
    embeddings take ``prefix_tokens`` of it."""
    if cfg.frontend == "vision_stub":
        return max(seq_len - cfg.prefix_tokens, 1)
    return seq_len


def make_batch(seed: int, cfg: ArchConfig, seq_len: int, batch: int,
               kind: str = "train", *, device=None) -> dict:
    """A random batch drawn on ``device`` from a generator seeded with
    ``seed``: uniform tokens (and labels for ``kind="train"``), and the
    front end's stub inputs, unit normals in ``cfg.cdtype``."""
    device = resolve_device(device)
    gen = torch.Generator(device).manual_seed(seed)
    shape = (batch, text_len(cfg, seq_len))
    out = {"tokens": torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                   device=device)}
    if kind == "train":
        out["labels"] = torch.randint(0, cfg.vocab_size, shape,
                                      generator=gen, device=device)
    stub = {"vision_stub": ("patch_embeds", cfg.prefix_tokens),
            "audio_stub": ("frames", cfg.encoder_seq)}.get(cfg.frontend)
    if stub is not None:
        name, length = stub
        out[name] = torch.randn(batch, length, cfg.frontend_dim,
                                generator=gen, device=device,
                                dtype=cfg.cdtype)
    return out
