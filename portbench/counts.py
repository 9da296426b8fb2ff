"""The yardstick's arithmetic: model FLOPs, the kernels' least bytes, and
the H100's peaks (NVIDIA's data sheet, SXM part, dense, 700 W).

Model FLOPs follow the usual convention: a training sample costs three
forward passes (the forward, the gradients of the activations and of the
weights), an evaluated sample one.  The forward's FLOPs are counted by
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference
model on the meta device, one client and one sample.
"""
from __future__ import annotations

import functools
import json
import math

import torch

#: f32 outside the tensor cores: the port runs with TF32 off.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12


@functools.lru_cache(maxsize=None)
def _forward_flops(model: str, input_hw: tuple, layers_json: str) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference.models import APPLY

    layers = json.loads(layers_json)
    dev = torch.device("meta")
    params = {name: {"w": torch.empty((1,) + tuple(l["w"]), device=dev),
                     "b": torch.empty((1, l["w"][-1]), device=dev)}
              for name, l in layers.items()}
    x = torch.empty((1, 1) + tuple(input_hw), device=dev)
    with FlopCounterMode(display=False) as counter:
        APPLY[model](params, x)
    return int(counter.get_total_flops())


def forward_flops_per_sample(cfg: dict) -> int:
    return _forward_flops(cfg["model"], tuple(cfg["input_hw"]),
                           json.dumps(cfg["layers"], sort_keys=True))


def local_steps(cfg: dict) -> int:
    """Minibatch steps a client takes in one round (E epochs of its
    shard of ``num_train // num_shards · shards_per_client`` samples)."""
    n_sh = cfg["num_shards"]
    n_k = (cfg["num_train"] // n_sh) * cfg["shards_per_client"]
    return max(cfg["local_epochs"] * (n_k // cfg["batch_size"]), 1)


def flops_per_round(cfg: dict) -> float:
    """Model FLOPs of one trajectory's round: every client's local steps
    (3× forward a sample) and the evaluation forward."""
    fwd = forward_flops_per_sample(cfg)
    train = 3 * fwd * cfg["clients"] * local_steps(cfg) * cfg["batch_size"]
    return float(train + fwd * cfg["eval_samples"])


def cwfl_round_bytes(B: int, K: int, C: int, d: int) -> int:
    """Kernel 1's least traffic: the signals S (K·d) and the two noise
    fields (2·C·d) read once, the new signals (K·d) and the consensus (d)
    written once, f32, for each of the B trajectories; the O(K·C) weights
    are left out."""
    return 4 * B * d * (2 * K + 2 * C + 1)


def channel_view_bytes(B: int, K: int, arrived: int) -> int:
    """The channel kernel's least traffic in a stepping round: the state
    read once, the draws the step uses read once (each link draw
    matrix's upper triangle with its diagonal, the lower being its
    mirror; the waypoint uniforms of the ``arrived`` clients only), the
    stepped state and the view written once."""
    links, clients = B * K * K, B * K
    read = links * (8 + 4) + clients * 8             # h, shadowing; pos
    write = links * (8 + 4 + 1)                      # gains, SNRs, graph
    drawn = B * K * (K + 1) // 2
    read += drawn * 12 + clients * 8 + arrived * 8   # 3 draws, way, way_u
    write += links * 12 + clients * 16               # h, s; pos, way
    return read + write


def params_count(cfg: dict) -> int:
    return sum(math.prod(l["w"]) + l["w"][-1] for l in cfg["layers"].values())
