"""Synthetic LM token streams (port of `repro.data.tokens`).

A fixed random first-order Markov chain over the vocabulary gives
sequences with learnable structure: per-token cross-entropy drops well
below uniform as the model learns the transition table.  The draws are
torch's (Philox on the card), not JAX's (threefry), so the streams agree
in law, not token for token; a test hands JAX's tokens across where it
compares the two packages.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.utils.device import resolve_device


def make_token_dataset(seed: Union[int, torch.Generator], vocab_size: int,
                       num_sequences: int, seq_len: int, branching: int = 8,
                       device=None) -> torch.Tensor:
    """int32 tokens (num_sequences, seq_len + 1); use [:, :-1] / [:, 1:] as
    inputs / targets.  Each token moves to one of ``branching`` successors
    under a fixed random table, drawn uniformly, or with probability 0.02
    to a uniform random token (a reset); starts are uniform.  ``seed``:
    an int or a ``torch.Generator`` on ``device`` (``None``: the GPU)."""
    device = resolve_device(device)
    gen = (seed if isinstance(seed, torch.Generator)
           else torch.Generator(device).manual_seed(seed))

    def randint(high, shape):
        return torch.randint(0, high, shape, generator=gen, device=device)

    table = randint(vocab_size, (vocab_size, branching))
    starts = randint(vocab_size, (num_sequences,))
    choices = randint(branching, (num_sequences, seq_len))
    resets = torch.rand((num_sequences, seq_len), generator=gen,
                        device=device) < 0.02
    reset_vals = randint(vocab_size, (num_sequences, seq_len))

    out = torch.empty((num_sequences, seq_len + 1), dtype=torch.int64,
                      device=device)
    out[:, 0] = tok = starts
    for t in range(seq_len):
        tok = torch.where(resets[:, t], reset_vals[:, t],
                          table[tok, choices[:, t]])
        out[:, t + 1] = tok
    return out.to(torch.int32)
