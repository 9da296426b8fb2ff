"""Entry ``sweep``: one Monte-Carlo sweep a call,
``repro_torch.sim.run_monte_carlo``: the traffic's ``seeds`` × its SNR
grid (none: the configuration's SNR) run as one batch, every round one
set of launches for all the trajectories, captured and replayed as a
trajectory is.  Sweep k of a run draws seed i's stream from key
``("traj", seed, k, i)`` (its SNR points share it) and runs as
``FLConfig.seed = seed·1000 + k``.  The work is the trajectory-rounds
run."""
from __future__ import annotations

from portbench.entries.common import Record, Setting
from portbench.reference.fl import Reference

UNIT = "trajectory-rounds"


class Entry(Setting):
    def _grid(self) -> list:
        return self.traffic.get("snr_grid") or [self.cfg["snr_db"]]

    def run(self, k: int, rounds: int = 0, timers=None,
            key: tuple = ()) -> Record:
        from repro_torch.sim import run_monte_carlo

        T = rounds or self.cfg["rounds"]
        S = self.traffic["seeds"]
        key = key or ("traj", self.seed, k)
        grid = self.traffic.get("snr_grid")
        h = run_monte_carlo(*self.program_args(), self.fl_config(k, T),
                            scenario=self.traffic["scenario"],
                            topo_cfg=self.topo_cfg, seeds=S, snr_grid=grid,
                            draws=[self.draws(*key, i) for i in range(S)],
                            device=self.device, timers=timers)
        B = S * len(self._grid())
        heads = None
        if "scenario" in h and "heads" in h["scenario"]:
            heads = h["scenario"]["heads"].reshape(B, T, -1)
        return Record(key=key, work=B * T,
                      loss=h["train_loss"].reshape(B, T),
                      acc=h["test_acc"].reshape(B, T), heads=heads)

    def trajectory_draws(self, key: tuple) -> list:
        """Each trajectory's draws, seed-major as the sweep orders them."""
        G = len(self._grid())
        return [self.draws(*key, i) for i in range(self.traffic["seeds"])
                for _ in range(G)]

    def reference(self, key: tuple, rounds: int, tf32: bool = False) -> dict:
        """The plain reference's run of the call with draws ``key`` (with
        ``tf32``, the lower-precision control's)."""
        draws = self.trajectory_draws(key)
        snrs = self._grid() * self.traffic["seeds"]
        return Reference(self.cfg, self.traffic, self.data, self.geometry,
                         draws, snrs, self.device,
                         sweep=True, tf32=tf32).run(rounds)

    def rounds_of(self, record: Record) -> int:
        """Batched rounds of the round loop the record ran."""
        return record.loss.shape[1]
