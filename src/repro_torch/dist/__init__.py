"""``repro_torch.dist`` — the OTA collective substrate (port of
`repro.dist`).

* :mod:`repro_torch.dist.fl_integration` — the offline FL plan
  (clustering, water-filled β, channel-noise budget) and the
  paper-faithful hierarchical OTA all-reduce over a ``torch.distributed``
  process group, one client a rank.
* :mod:`repro_torch.dist.ota_collectives` — flat-vector lowerings of the
  CWFL aggregation: phase 1 through the ``ota_aggregate`` kernel, the full
  round through ``cwfl_round``; the tree collectives.

JAX's ``sharding_rules`` (PartitionSpec inference over a device mesh) has
no counterpart on one card; ROADMAP §1 item 8.4 lists it (``launch/``,
its one-card counterpart, is `repro_torch.launch`).
"""
from repro_torch.dist import fl_integration, ota_collectives  # noqa: F401
from repro_torch.dist.fl_integration import (FLPlan,  # noqa: F401
                                             hierarchical_ota_allreduce,
                                             make_fl_plan)
