"""CWFL core: the paper's contribution (channel, clustering, aggregation)."""
from repro_torch.core.topology import Topology, TopologyConfig, make_topology
from repro_torch.core import channel
from repro_torch.core import clustering
from repro_torch.core import cwfl
