"""The card in place of JAX's production mesh (port of `repro.launch.mesh`).

JAX's dry run lowers every (arch × input shape) onto a 256- or 512-chip
mesh of fake devices.  The port runs on one card, so there is no mesh:
the dry run's counterpart plans each row on the ``meta`` device and runs
it on the card (`repro_torch.launch.dryrun`), and this module only
describes the card (`device_record`).

JAX's other mesh builders have counterparts elsewhere in the port:
``make_local_mesh`` (a small ``(data, model)`` mesh for tests) and
``make_client_mesh`` (the client-sharded round) are a ``torch.distributed``
process group of one client a rank (`repro_torch.dist`,
`repro_torch.sim.sharded.run_rounds_client_sharded`); ``make_mc_mesh``
(the Monte-Carlo trajectories) is `repro_torch.sim.sharded.
monte_carlo_sharded` over a process group.  ``fsdp_axes`` and
``batch_axes`` name mesh axes and have none to name.
"""
from __future__ import annotations


def device_record() -> dict:
    """The card: its name, count, memory and power limit
    (`repro_torch.obs.manifest.device_info`, which reads ``nvidia-smi``),
    ``{"platform": "cpu"}`` without one."""
    import torch

    from repro_torch.obs.manifest import device_info

    info = device_info()
    if info["platform"] == "gpu":
        info["total_memory_bytes"] = \
            torch.cuda.get_device_properties(0).total_memory
    return info


def make_production_mesh(*, multi_pod: bool = False):
    """JAX's 256- or 512-chip production mesh has no counterpart on one
    card: plan and run each row with the one-card dry run
    (`repro_torch.launch.dryrun.plan` and `run_one`)."""
    raise NotImplementedError(
        f"the {'512' if multi_pod else '256'}-chip production mesh has no "
        "counterpart on one card; the one-card dry run "
        "(repro_torch.launch.dryrun: plan on the meta device, run_one on "
        "the card) takes its place")
