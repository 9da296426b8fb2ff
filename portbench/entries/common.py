"""What every entry shares: the run's inputs from the seed, and the
program's objects built from them.

`Setting` makes the data, the partition and the geometry on the device
(`portbench.inputs`), and hands the program what its front door takes:
the stacked client shards, the test set, a `Topology` that the
program's own offline code derives from the drawn positions and fading,
the model's ``apply`` and loss, an `FLConfig`.  The weights and every
draw come in through the draws seam (`portbench.inputs.Draws`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from portbench import inputs


@dataclasses.dataclass
class Record:
    """What one call of the timed path produced: per trajectory (B of
    them) the per-round loss and accuracy (B, T), the final consensus
    (a list of B trees) where the entry returns it, and the heads
    (B, T, C) under a re-clustering scenario; ``work`` the rounds (or
    trajectory-rounds) it ran; ``key`` its draws' key."""

    key: tuple
    work: int
    loss: torch.Tensor
    acc: torch.Tensor
    final: Optional[list] = None
    heads: Optional[torch.Tensor] = None

    def outputs(self) -> dict:
        return {"loss": self.loss, "acc": self.acc, "final": self.final,
                "heads": self.heads}


class Setting:
    """One run's inputs (from ``seed``) and the program's view of them, on
    ``device``."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from repro_torch.core.topology import (Topology, TopologyConfig,
                                               link_stats,
                                               pathloss_amplitude)
        from repro_torch.models import make_cifar_cnn, make_mnist_mlp

        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        x, y, x_test, y_test = inputs.make_images(cfg, seed, self.device)
        xs, ys = inputs.partition_noniid(cfg, seed, x, y)
        del x, y
        self.data = {"xs": xs, "ys": ys, "x_test": x_test, "y_test": y_test}
        self.geometry = inputs.make_geometry(cfg, seed, self.device)
        tc = cfg["topology"]
        K = cfg["clients"]
        self.topo_cfg = TopologyConfig(
            num_clients=K, area_size=tc["area_size"], d0=tc["d0"],
            pathloss_exp=tc["pathloss_exp"], noise_var=tc["noise_var"],
            total_power=tc["total_power"], outage_snr_db=tc["outage_snr_db"],
            num_hotspots=tc["num_hotspots"], hotspot_std=tc["hotspot_std"])
        g = self.geometry
        amp = pathloss_amplitude(g.positions, self.topo_cfg)
        # The gains as the program's `make_topology` forms them from its
        # own draws: eager complex products, their zero terms kept.
        off = 1.0 - torch.eye(K, device=self.device)
        g_re = amp * g.h_re - 0.0 * g.h_im
        g_im = amp * g.h_im + 0.0 * g.h_re
        gain = torch.complex(off * g_re - g_im * 0.0, off * g_im + g_re * 0.0)
        snr, adjacency = link_stats(gain, self.topo_cfg)
        self.topology = Topology(positions=g.positions, link_gain=gain,
                                 link_snr=snr, adjacency=adjacency,
                                 noise_var=tc["noise_var"],
                                 total_power=tc["total_power"])
        if cfg["model"] == "mlp":
            hidden = [cfg["layers"][f"fc{i}"]["w"][1]
                      for i in range(len(cfg["layers"]) - 1)]
            self.init_fn, self.apply_fn = make_mnist_mlp(
                tuple(cfg["input_hw"]), hidden, cfg["num_classes"])
        else:
            self.init_fn, self.apply_fn = make_cifar_cnn(
                tuple(cfg["input_hw"]), cfg["num_classes"])

    def loss_fn(self, params, x, y):
        from repro_torch.models import small

        return small.nll_loss(self.apply_fn(params, x), y)

    def fl_config(self, k: int, rounds: int, snr_db=None):
        from repro_torch.training import FLConfig

        cfg = self.cfg
        return FLConfig(strategy=self.traffic["strategy"], rounds=rounds,
                        local_epochs=cfg["local_epochs"],
                        batch_size=cfg["batch_size"], lr=cfg["lr"],
                        num_clusters=cfg["clusters"],
                        snr_db=cfg["snr_db"] if snr_db is None else snr_db,
                        eval_samples=cfg["eval_samples"],
                        seed=self.seed * 1000 + k)

    def draws(self, *key) -> inputs.Draws:
        return inputs.Draws(self.cfg, key, self.device)

    def program_args(self) -> tuple:
        d = self.data
        return (self.init_fn, self.apply_fn, self.loss_fn, self.topology,
                d["xs"], d["ys"], d["x_test"], d["y_test"])
