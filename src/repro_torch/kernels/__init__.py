# The port's hand-written Hopper kernels, one wrapper module each, with
# their plain PyTorch versions in ref.py.  Import a kernel as
# ``from repro_torch.kernels.cwfl_round import cwfl_round``: no package-level
# re-exports (the function would shadow its submodule of the same name).
