"""repro_torch — the PyTorch/CUDA port of the CWFL reproduction.

A twin of the JAX package ``repro`` (which stays the reference): the same
sub-package layout, the same parameter layout and names, plain functions
on tensors and small dataclasses.  Every random draw comes from an
explicit ``torch.Generator``; every entry point takes ``device=None``,
which means the GPU.  The fused CWFL round, the phase-1 OTA MAC and the
LM's prefill attention run as hand-written Hopper kernels
(`repro_torch.kernels.cwfl_round`, `repro_torch.kernels.ota_aggregate`,
`repro_torch.kernels.flash_attention`); the collectives of
`repro_torch.dist` run over ``torch.distributed``, one client a rank.

This package imports ``torch`` and never ``jax`` or ``repro``;
`repro_torch.convert` carries arrays across from the reference as numpy.
"""
