"""Entry ``scan``: one trajectory a call through the paper-protocol front
door, ``repro_torch.training.run_federated(mode="scan")``: an eager
first round, the round captured into a CUDA graph and replayed for the
rest.  Trajectory k of a run draws from key ``("traj", seed, k)`` and
runs as ``FLConfig.seed = seed·1000 + k``: new draws and weights over the
same data and topology, as a researcher repeats a setting over seeds.
The work is the rounds run."""
from __future__ import annotations

import torch

from portbench.entries.common import Record, Setting
from portbench.reference.fl import Reference

UNIT = "rounds"


class Entry(Setting):
    def run(self, k: int, rounds: int = 0, timers=None,
            key: tuple = ()) -> Record:
        from repro_torch.training import run_federated

        T = rounds or self.cfg["rounds"]
        key = key or ("traj", self.seed, k)
        h = run_federated(*self.program_args(), self.fl_config(k, T),
                          scenario=self.traffic["scenario"],
                          topo_cfg=self.topo_cfg, draws=self.draws(*key),
                          device=self.device, mode="scan", timers=timers)
        return Record(key=key, work=T,
                      loss=torch.tensor(h["train_loss"])[None],
                      acc=torch.tensor(h["test_acc"])[None],
                      final=[h["final_params"]])

    def reference(self, key: tuple, rounds: int, tf32: bool = False) -> dict:
        """The plain reference's run of the call with draws ``key`` (with
        ``tf32``, the lower-precision control's)."""
        return Reference(self.cfg, self.traffic, self.data, self.geometry,
                         [self.draws(*key)], [self.cfg["snr_db"]],
                         self.device, sweep=False, tf32=tf32).run(rounds)

    def rounds_of(self, record: Record) -> int:
        """Rounds of the round loop the record ran."""
        return record.work
