"""Time the cluster-churn run at the paper's MNIST width (K = 50, C = 3,
6 rounds, re-clustering every 5) in two checkouts, in turns, and in this
checkout variants of the round's XLA arithmetic
(`repro_torch.core.xla_math`).  ``--modes`` picks the runs:

- ``scan``: `run_federated` scanned, steady rounds/s: rounds 2..T over
  the ``execute`` phase of `PhaseTimers`, as ``chip_smoke.py``'s
  trajectory phase reads it;
- ``loop``: `run_federated` round by round, rounds 2..T by the progress
  callback's stamps, as the trajectory phase reads it;
- ``sweep``: `run_monte_carlo` of 8 seeds, one batch, trajectory-rounds/s
  over ``execute``, as ``chip_smoke.py``'s dynamic-sweep phase reads it;
- ``mc``: the same of the paper-static ``snr-sweep`` grid (8 seeds x 5
  SNRs, 5 rounds), as its Monte-Carlo phase reads it: a path without a
  channel process, for a control.

The variants, run in ``scan`` mode only (the other modes run ``base``):

- ``base``: the checkout as it is: the channel step and view in XLA's
  arithmetic, one launch of ``kernels/csrc/channel_view.cu`` a round;
- ``plain_features``: the election's features (`clustering.snr_features`)
  under ``jit`` take torch's own ``log10`` in place of XLA's;
- ``torch_view``: the channel step and view this checkout retired, in
  torch ops (an f64 ``pow`` rounded to f32, torch's complex ``abs`` and
  ``log10``), a few ulp from JAX's.

Each process builds the workload once, then runs each mode's variants
in turns (a warm-up run, then ``--reps`` timed runs each).  Order:
parent, this checkout, this checkout, parent.

    python3 scripts/churn_ab.py --parent build/parent [--reps 3] \
        [--modes scan loop sweep mc]

Run from the checkout's root; needs one CUDA device.  One JSON line a
variant and process goes to standard output.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

VARIANTS = ("base", "plain_features", "torch_view")


def torch_op_round(state, cfg, tcfg, u):
    """The channel step and view in torch ops, as the port computed them
    before it took XLA's arithmetic (its draws N(0, ½), so the fading
    innovation is taken as it is and the shadowing's scaled by √2)."""
    import math

    import torch

    from repro_torch.sim.processes import ChannelState, ChannelView

    def mirror(m, conj):
        iu = torch.triu(torch.ones(m.shape[-2:], dtype=torch.bool,
                                   device=m.device), diagonal=1)
        mt = m.transpose(-1, -2)
        return torch.where(iu, m, mt.conj() if conj else mt)

    def ar1(rho):
        return rho, math.sqrt(max(1.0 - rho * rho, 0.0))

    t = state.waypoints - state.positions
    dist = torch.sqrt(torch.sum(t ** 2, dim=-1, keepdim=True) + 1e-12)
    arrived = dist[..., 0] <= cfg.speed
    positions = state.positions + torch.clamp(cfg.speed / dist,
                                              max=1.0) * t
    waypoints = torch.where(arrived[..., None],
                            u.waypoints * tcfg.area_size, state.waypoints)
    rho, std = ar1(cfg.fading_rho)
    h = rho * state.h_tilde + std * mirror(torch.complex(u.fade_re,
                                                         u.fade_im), True)
    rho_s, std_s = ar1(cfg.shadowing_rho)
    n = mirror(cfg.shadowing_std_db * math.sqrt(2.0) * u.shadow, False)
    shadow = rho_s * state.shadow_db + std_s * n
    K = positions.shape[-2]
    eye = torch.eye(K, dtype=torch.bool, device=positions.device)
    off = (~eye).float()
    diff = positions[..., :, None, :] - positions[..., None, :, :]
    d = torch.clamp(torch.sqrt(torch.sum(diff ** 2, dim=-1) + 1e-9),
                    min=tcfg.d0)
    amp = ((d / tcfg.d0).double() ** (-tcfg.pathloss_exp / 2.0)).float() * (
        10.0 ** (shadow.double() / 20.0)).float()
    gain = amp * h * off
    snr = torch.abs(gain) ** 2 * (tcfg.total_power / K) / tcfg.noise_var
    snr = snr * off
    adj = (10.0 * torch.log10(torch.clamp(snr, min=1e-12))
           >= tcfg.outage_snr_db) & ~eye
    return (ChannelState(positions, waypoints, h, shadow),
            ChannelView(gain, snr, adj))


MODES = ("scan", "loop", "sweep", "mc")


def worker(tree: Path, modes, variants, reps: int, rounds: int,
           device: str) -> None:
    sys.path[:0] = [str(tree / "src"), str(tree)]
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from repro_torch.core import TopologyConfig
    from repro_torch.core import clustering
    from repro_torch.obs import PhaseTimers
    from repro_torch.sim import engine, run_monte_carlo
    from repro_torch.training import FLConfig, run_federated

    def plain_db10(x, mode):
        return 10.0 * torch.log10(torch.clamp(x.float(), min=1e-12))

    saved = {(mod, name): getattr(mod, name, None)
             for mod, name in ((clustering, "db10"),
                               (engine, "step_and_view"))}
    patches = {
        "base": {},
        "plain_features": {(clustering, "db10"): plain_db10},
        "torch_view": {(engine, "step_and_view"): torch_op_round},
    }
    cs.DEVICE = device

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    workload = cs.full_width_workload()
    topo_cfg = TopologyConfig(num_clients=50)
    cfg = FLConfig(rounds=rounds, num_clusters=3, snr_db=40.0, seed=0)
    mc_cfg = FLConfig(rounds=5, num_clusters=3, snr_db=40.0, seed=0)

    def once(mode):
        """One run of ``mode``: (its rate, the final loss)."""
        timers, stamps = PhaseTimers(), []
        sync()
        if mode in ("scan", "loop"):
            h = run_federated(
                *workload, cfg, scenario="cluster-churn", topo_cfg=topo_cfg,
                device=device, mode=mode, timers=timers,
                progress=(None if mode == "scan" else
                          lambda *_: stamps.append(time.perf_counter())))
        else:
            h = run_monte_carlo(
                *workload, cfg if mode == "sweep" else mc_cfg,
                scenario="cluster-churn" if mode == "sweep" else "snr-sweep",
                topo_cfg=topo_cfg, seeds=8, timers=timers, device=device)
        sync()
        loss = torch.as_tensor(h["train_loss"])
        T = loss.shape[-1]
        if mode == "loop":
            rate = (T - 1) / (stamps[-1] - stamps[0])
        else:
            rate = loss[..., 0].numel() * (T - 1) / timers.seconds["execute"]
        return rate, float(loss[..., -1].mean())

    for mode in modes:
        vs = list(variants) if mode == "scan" else ["base"]
        for variant in vs + list(reversed(vs)) if len(vs) > 1 else vs:
            for (mod, name), fn in patches[variant].items():
                setattr(mod, name, fn)
            out = []
            for i in range(reps + 1):
                rate, loss = once(mode)
                if i:
                    out.append({"rate": rate, "final_loss": loss})
            for (mod, name), value in saved.items():
                if value is not None:
                    setattr(mod, name, value)
            print(json.dumps({"tree": str(tree), "mode": mode,
                              "variant": variant, "unit":
                              "rounds/s" if mode in ("scan", "loop")
                              else "trajectory-rounds/s", "runs": out}),
                  flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=False)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--worker", default=None)
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS),
                    choices=VARIANTS)
    ap.add_argument("--modes", nargs="*", default=["scan"], choices=MODES)
    ap.add_argument("--device", default="cuda",
                    help="cpu: a check of the script itself, not a timing")
    args = ap.parse_args()
    if args.worker:
        worker(Path(args.worker).resolve(), args.modes, args.variants,
               args.reps, args.rounds, args.device)
        return
    here = Path(".").resolve()
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
           if args.device == "cuda" else "cpu")
    print(smi, flush=True)
    order = [(here, list(args.variants))]
    if args.parent:
        parent = (Path(args.parent).resolve(), ["base"])
        order = [parent, order[0], order[0], parent]
    for tree, variants in order:
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, str(here / "scripts" / "churn_ab.py"),
             "--worker", str(tree), "--reps", str(args.reps),
             "--rounds", str(args.rounds), "--device", args.device,
             "--modes", *args.modes, "--variants", *variants],
            capture_output=True, text=True)
        print(res.stderr[-3000:], file=sys.stderr, flush=True)
        if res.returncode:
            raise SystemExit(f"the worker in {tree} failed")
        for line in res.stdout.splitlines():
            if line.startswith("{"):
                rec = json.loads(line)
                rec["tree"] = ("parent" if args.parent and tree
                               == Path(args.parent).resolve() else "change")
                print(json.dumps(rec), flush=True)
        print(f"[{tree}] {time.perf_counter() - t0:.1f} s", flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
