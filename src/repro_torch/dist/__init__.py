"""``repro_torch.dist`` — the OTA collective substrate (port of
`repro.dist`).

* :mod:`repro_torch.dist.fl_integration` — the offline FL plan
  (clustering, water-filled β, channel-noise budget) and the
  paper-faithful hierarchical OTA all-reduce over a ``torch.distributed``
  process group, one client a rank.
* :mod:`repro_torch.dist.ota_collectives` — flat-vector lowerings of the
  CWFL aggregation: phase 1 through the ``ota_aggregate`` kernel, the full
  round through ``cwfl_round``; the tree collectives.
* :mod:`repro_torch.dist.sharding_rules` — the mesh-shape-aware sharding
  specs of JAX's ``sharding_rules``, and their `torch.distributed.tensor`
  placements on a `DeviceMesh`.
"""
from repro_torch.dist import (fl_integration, ota_collectives,  # noqa: F401
                              sharding_rules)
from repro_torch.dist.fl_integration import (FLPlan,  # noqa: F401
                                             hierarchical_ota_allreduce,
                                             make_fl_plan)
