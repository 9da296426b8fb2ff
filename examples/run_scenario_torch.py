"""Run a named scenario on the PyTorch port: dynamic channels, scheduling,
faults, Monte-Carlo sweeps, telemetry, checkpoints and the live stream —
the twin of ``examples/run_scenario.py``, with its flags and ``--device``.

    PYTHONPATH=src python examples/run_scenario_torch.py --device cpu \\
        --scenario mobile-fading --seeds 8
    PYTHONPATH=src python examples/run_scenario_torch.py --device cpu \\
        --telemetry run.jsonl
    PYTHONPATH=src python examples/run_scenario_torch.py --device cpu \\
        --scenario head-failure --telemetry run.jsonl \\
        --checkpoint-dir ckpt --checkpoint-every 4 --stop-after 4   # "crash"
    PYTHONPATH=src python examples/run_scenario_torch.py --device cpu \\
        --scenario head-failure --telemetry run.jsonl \\
        --checkpoint-dir ckpt --checkpoint-every 4 --resume         # bitwise
    PYTHONPATH=src python examples/run_scenario_torch.py --list

Without ``--device`` the run needs the card.  One seed runs a single
scanned trajectory; ``--seeds N`` (N > 1) runs the N-seed (× SNR-grid,
for sweep scenarios) Monte-Carlo batch through `repro_torch.sim.
run_monte_carlo` and reports mean ± std across seeds.

``--shard mc`` splits the flattened trajectory grid over the ranks of a
``torch.distributed`` process group, ``--shard clients`` the K clients of
one trajectory; launched by ``torchrun`` the script joins its group (NCCL
on the card, gloo on the CPU), otherwise it runs a group of one rank.
``--assert-match-vmap`` re-runs an ``--shard mc`` sweep unsharded and
asserts the metrics match.

``--telemetry OUT.jsonl`` records each round's `RoundTelemetry`
(per-cluster loss, participation, consensus drift, the OTA channel-use
ledger, strategy internals) and writes the run — manifest, per-round
records, summary — as a JSONL stream ``examples/obs_report_torch.py``
renders to markdown.  ``--profile-dir DIR`` captures a ``torch.profiler``
trace.  ``--stream OUT.jsonl`` goes live instead: each round's record is
appended while the run goes on (`repro_torch.obs.stream`); tail it with
``examples/watch_run.py --follow``.  ``--alerts`` attaches the
`repro_torch.obs.monitor` rules; ``--abort-on-alert`` escalates an alert
to a checkpoint-then-stop (needs ``--checkpoint-dir``; ``--resume``
continues it, its stream appending where it stopped).  ``--prom OUT.prom``
also exports the latest round's gauges as a Prometheus textfile.

    PYTHONPATH=src python examples/run_scenario_torch.py --device cpu \\
        --stream live.jsonl --alerts &
    PYTHONPATH=src python examples/watch_run.py live.jsonl --follow
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch


def _join_group(device: torch.device) -> None:
    """Join the process group ``torchrun`` describes, or make one of a
    single rank."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        return
    store = os.path.join(tempfile.mkdtemp(), "store")
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=1, rank=0)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenario", default="paper-static")
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios and exit")
    ap.add_argument("--device", default=None,
                    help="where the run happens (default: the card)")
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--clients", type=int, default=12)
    ap.add_argument("--clusters", type=int, default=3)
    ap.add_argument("--strategy", default=None,
                    help="aggregation strategy (repro_torch.strategies "
                         "registry). Default: the scenario's pinned "
                         "strategy, else cwfl")
    ap.add_argument("--snr-db", type=float, default=40.0,
                    help="overall SNR (ignored by snr-sweep's grid)")
    ap.add_argument("--hidden", type=int, default=64,
                    help="MLP hidden width (small default for the CPU)")
    ap.add_argument("--train", type=int, default=4800)
    ap.add_argument("--test", type=int, default=1024)
    ap.add_argument("--out", default=None, help="optional JSON output path")
    ap.add_argument("--shard", choices=["mc", "clients"], default=None,
                    help="mc: split the Monte-Carlo trajectory grid over "
                         "the process group's ranks; clients: split the K "
                         "clients of one trajectory")
    ap.add_argument("--assert-match-vmap", action="store_true",
                    help="with --shard mc: also run the unsharded sweep "
                         "and assert the metrics match")
    ap.add_argument("--telemetry", default=None, metavar="OUT.jsonl",
                    help="record each round's telemetry and write the run "
                         "as a JSONL stream (render with "
                         "examples/obs_report_torch.py)")
    ap.add_argument("--stream", default=None, metavar="OUT.jsonl",
                    help="live telemetry: append every round to this JSONL "
                         "while the run goes on; implies telemetry")
    ap.add_argument("--alerts", action="store_true",
                    help="attach the monitor's rules to the stream")
    ap.add_argument("--abort-on-alert", action="store_true",
                    help="escalate any alert to checkpoint-then-stop "
                         "(needs --stream and --checkpoint-dir). Implies "
                         "--alerts")
    ap.add_argument("--prom", default=None, metavar="OUT.prom",
                    help="also export the latest round's gauges as a "
                         "Prometheus textfile (needs --stream)")
    ap.add_argument("--alert-max-drift", type=float, default=100.0,
                    help="ConsensusDriftRule's ceiling (tiny, e.g. 1e-9, "
                         "forces an alert)")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace into this "
                         "directory")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save the run's carry, outputs and draws' state "
                         "for a bitwise resume (one trajectory)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="rounds a checkpoint segment (0 = one final "
                         "checkpoint)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in "
                         "--checkpoint-dir, bitwise an uninterrupted run")
    ap.add_argument("--resume-step", type=int, default=None,
                    help="resume from this checkpoint step instead")
    ap.add_argument("--stop-after", type=int, default=None,
                    help="stop at the first checkpoint boundary >= this "
                         "round (a crash, for resume drills)")
    args = ap.parse_args()

    from repro_torch.core import TopologyConfig, make_topology
    from repro_torch.data import (SyntheticImageConfig,
                                  make_synthetic_images, partition_iid)
    from repro_torch.models import make_mnist_mlp, nll_loss
    from repro_torch.obs import (PhaseTimers, build_manifest,
                                 profiler_trace, write_history)
    from repro_torch.sim import (SCENARIOS, get_scenario, run_monte_carlo,
                                 run_rounds)
    from repro_torch.strategies import available_strategies, get_strategy
    from repro_torch.training import FLConfig
    from repro_torch.utils.device import resolve_device

    if args.list:
        for name, sc in sorted(SCENARIOS.items()):
            dyn = "dynamic" if not sc.is_static else "static"
            grid = f" snr_grid={list(sc.snr_grid)}" if sc.snr_grid else ""
            pin = f" strategy={sc.strategy}" if sc.strategy else ""
            print(f"{name:16s} [{dyn}]{grid}{pin}")
        print(f"strategies: {', '.join(available_strategies())}")
        return

    scenario = get_scenario(args.scenario)
    strategy = get_strategy(args.strategy or scenario.strategy or "cwfl")
    is_sweep = args.seeds > 1 or bool(scenario.snr_grid)
    if args.shard == "mc" and not is_sweep:
        ap.error("--shard mc splits a Monte-Carlo sweep; pass --seeds N > 1 "
                 "or a grid scenario (e.g. snr-sweep), or use --shard "
                 "clients for a single trajectory")
    if args.shard == "clients" and is_sweep:
        ap.error("--shard clients runs ONE trajectory; drop --seeds / pick "
                 "a grid-free scenario, or use --shard mc for sweeps")
    if args.assert_match_vmap and args.shard != "mc":
        ap.error("--assert-match-vmap compares a --shard mc sweep against "
                 "the unsharded one; nothing to compare here")
    if args.checkpoint_dir is not None and is_sweep:
        ap.error("--checkpoint-dir checkpoints ONE trajectory; drop --seeds "
                 "/ the grid scenario")
    if args.checkpoint_dir is None and (args.resume
                                        or args.stop_after is not None):
        ap.error("--resume/--stop-after need --checkpoint-dir")
    if (args.alerts or args.abort_on_alert or args.prom) and not args.stream:
        ap.error("--alerts/--abort-on-alert/--prom ride the live stream; "
                 "add --stream OUT.jsonl")
    if args.abort_on_alert and args.checkpoint_dir is None:
        ap.error("--abort-on-alert stops at a checkpoint boundary so the "
                 "run stays resumable; add --checkpoint-dir")

    device = resolve_device(args.device)
    rank = 0
    if args.shard is not None:
        import torch.distributed as dist

        _join_group(device)
        rank = dist.get_rank()
        print(f"shard={args.shard} ranks={dist.get_world_size()}")

    tcfg = TopologyConfig(num_clients=args.clients, num_hotspots=3)
    topo = make_topology(7, tcfg, device=device)
    (xtr, ytr), (xte, yte) = make_synthetic_images(
        1, SyntheticImageConfig.mnist_like(args.train, args.test),
        device=device)
    xs, ys = partition_iid(2, xtr, ytr, args.clients)
    init, apply = make_mnist_mlp(hidden=(args.hidden,))

    def loss(p, x, y):
        return nll_loss(apply(p, x), y)

    cfg = FLConfig(strategy=strategy.name, rounds=args.rounds,
                   num_clusters=args.clusters, snr_db=args.snr_db,
                   eval_samples=args.test)
    telemetry = args.telemetry is not None or args.stream is not None
    # Checkpointed runs are multi-segment: phase timers mean nothing there
    # (run_rounds refuses the combination).
    timers = (PhaseTimers()
              if args.telemetry is not None and args.checkpoint_dir is None
              else None)
    extra = {"shard": args.shard, "seeds": args.seeds,
             "clients": args.clients, "device": str(device)}
    manifest = None
    stream = None
    if args.stream is not None:
        from repro_torch.obs import (JsonlStreamSink, Monitor,
                                     PrometheusSink, RoundStream,
                                     default_rules)
        monitor = None
        if args.alerts or args.abort_on_alert:
            monitor = Monitor(default_rules(max_drift=args.alert_max_drift),
                              abort_on_alert=args.abort_on_alert)
        # Manifest first: a tailer picking up the file mid-run knows the
        # config before the first round lands; --resume appends.
        sinks = []
        manifest = build_manifest(cfg=cfg, scenario=scenario,
                                  strategy=strategy, extra=extra)
        if rank == 0:
            jsonl = JsonlStreamSink(args.stream, append=args.resume)
            jsonl.write({"type": "manifest", **manifest})
            sinks.append(jsonl)
            if args.prom:
                sinks.append(PrometheusSink(args.prom))
        stream = RoundStream(sinks, monitor=monitor)

    print(f"scenario={args.scenario} strategy={strategy.name} "
          f"K={args.clients} rounds={args.rounds} seeds={args.seeds} "
          f"device={device}"
          + (f" telemetry={args.telemetry}" if args.telemetry else "")
          + (f" stream={args.stream}" if args.stream else ""))
    common = dict(scenario=scenario, topo_cfg=tcfg, device=device,
                  telemetry=telemetry, timers=timers, stream=stream)
    t0 = time.perf_counter()
    with profiler_trace(args.profile_dir):
        if is_sweep:
            h = run_monte_carlo(init, apply, loss, topo, xs, ys, xte, yte,
                                cfg, seeds=args.seeds, shard=args.shard,
                                **common)
        else:
            h = run_rounds(init, apply, loss, topo, xs, ys, xte, yte, cfg,
                           shard=args.shard,
                           checkpoint_dir=args.checkpoint_dir,
                           checkpoint_every=args.checkpoint_every,
                           resume=args.resume, resume_step=args.resume_step,
                           stop_after=args.stop_after, **common)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    acc = h["test_acc"].cpu().numpy()
    train_loss = h["train_loss"].cpu().numpy()
    if args.assert_match_vmap:
        ref = run_monte_carlo(init, apply, loss, topo, xs, ys, xte, yte, cfg,
                              seeds=args.seeds, scenario=scenario,
                              topo_cfg=tcfg, device=device)
        for key, got in (("train_loss", train_loss), ("test_acc", acc)):
            want = ref[key].cpu().numpy()
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)
            print(f"  sharded == unsharded [{key}]: "
                  f"{'bitwise' if np.array_equal(got, want) else 'allclose'}"
                  f" OK")
    n_traj = int(np.prod(acc.shape[:-1], dtype=int))
    if is_sweep:
        if h["snr_grid"] is not None:
            for gi, snr in enumerate(h["snr_grid"].tolist()):
                fin = acc[:, gi, -1]
                print(f"  SNR {snr:5.1f} dB: final acc {fin.mean():.3f} ± "
                      f"{fin.std():.3f}  (over {acc.shape[0]} seeds)")
        else:
            fin = acc[:, -1]
            print(f"  final acc {fin.mean():.3f} ± {fin.std():.3f} "
                  f"(over {acc.shape[0]} seeds)")
    else:
        for r, (lo, a) in enumerate(zip(train_loss, acc)):
            print(f"  round {r + 1:2d}  loss={lo:.3f}  acc={a:.3f}")
    total_rounds = n_traj * int(acc.shape[-1])   # < --rounds after a stop
    print(f"  {total_rounds} rounds total in {wall:.1f}s "
          f"({total_rounds / wall:.2f} rounds/s incl. the first round)")
    if stream is not None:
        print(f"  stream: {stream.emitted} records -> {args.stream}"
              + (f" ({stream.dropped} off-rank/off-scope dropped)"
                 if stream.dropped else "")
              + (f" [{len(stream.errors)} sink errors]"
                 if stream.errors else ""))
        if stream.monitor is not None:
            s = stream.monitor.summary()
            if s["alerts"]:
                by = ", ".join(f"{k}×{v}" for k, v in s["by_rule"].items())
                print(f"  ALERTS: {s['alerts']} ({by})"
                      + ("; run aborted at a checkpoint boundary — resume "
                         "with --resume" if stream.should_abort else ""))
            else:
                print("  alerts: none")
        stream.close()
    if manifest is None and (telemetry or args.out):
        manifest = build_manifest(cfg=cfg, scenario=scenario,
                                  strategy=strategy, extra=extra)
    if args.telemetry is not None and rank == 0:
        if timers is not None:
            for name, secs in timers.as_dict().items():
                print(f"  phase {name:14s} {secs:8.3f}s")
        n_rec = write_history(args.telemetry, h, manifest=manifest,
                              timings=timers.as_dict() if timers else None)
        print(f"  wrote {args.telemetry} ({n_rec} records); render with "
              f"examples/obs_report_torch.py")
    if args.out and rank == 0:
        payload = {"scenario": args.scenario, "strategy": strategy.name,
                   "shard": args.shard, "seeds": args.seeds,
                   "test_acc": acc.tolist(),
                   "train_loss": train_loss.tolist(), "wall_seconds": wall,
                   "trajectories": n_traj, "run_manifest": manifest}
        if "checkpoint" in h:
            payload["checkpoint"] = h["checkpoint"]
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"  wrote {args.out}")
    if args.shard is not None:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()
