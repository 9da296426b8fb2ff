"""Time the cluster-churn run's scan at the paper's MNIST width (K = 50,
C = 3, 6 rounds, re-clustering every 5) in two checkouts, in turns, and
in this checkout two variants of where the clustering's dB takes XLA's
CPU ``log`` (`repro_torch.core.xla_math.db10`):

- ``base``: the checkout as it is;
- ``plain_features``: the election's features (`clustering.snr_features`)
  under ``jit`` take torch's own ``log10`` in place of XLA's;
- ``jit_view``: the round's channel view takes its outage threshold with
  XLA's ``log`` (``db_mode="jit"``) in place of torch's.

Each process builds the workload once, then runs its variants in turns
(a warm-up run, then ``--reps`` timed runs each): steady rounds/s is
rounds 2..T over the ``execute`` phase of `PhaseTimers`, as
``chip_smoke.py``'s trajectory phase reads it.  Order: parent, this
checkout, this checkout, parent.

    python3 scripts/churn_ab.py --parent build/parent [--reps 3]

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

VARIANTS = ("base", "plain_features", "jit_view")


def worker(tree: Path, variants, reps: int, rounds: int,
           device: str) -> None:
    sys.path[:0] = [str(tree / "src"), str(tree)]
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from repro_torch.core import TopologyConfig
    from repro_torch.core import clustering, topology
    from repro_torch.obs import PhaseTimers
    from repro_torch.sim import processes
    from repro_torch.training import FLConfig, run_federated

    def plain_db10(x, mode):
        return 10.0 * torch.log10(torch.clamp(x.float(), min=1e-12))

    saved = {"db10": getattr(clustering, "db10", None),
             "link_stats": processes.link_stats}
    patches = {
        "base": {},
        "plain_features": {(clustering, "db10"): plain_db10},
        "jit_view": {(processes, "link_stats"):
                     lambda g, c, db_mode=None: topology.link_stats(
                         g, c, db_mode="jit")},
    }
    cs.DEVICE = device

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    workload = cs.full_width_workload()
    cfg = FLConfig(rounds=rounds, num_clusters=3, snr_db=40.0, seed=0)
    for variant in list(variants) + list(reversed(variants)):
        for (mod, name), fn in patches[variant].items():
            setattr(mod, name, fn)
        out = []
        for i in range(reps + 1):
            timers = PhaseTimers()
            sync()
            h = run_federated(*workload, cfg, scenario="cluster-churn",
                              topo_cfg=TopologyConfig(num_clients=50),
                              device=device, mode="scan", timers=timers)
            sync()
            if i:
                out.append({"rounds_per_s": (rounds - 1)
                            / timers.seconds["execute"],
                            "trace_compile_s":
                            timers.seconds["trace_compile"],
                            "final_loss": float(h["train_loss"][-1])})
        if saved["db10"] is not None:
            clustering.db10 = saved["db10"]
        processes.link_stats = saved["link_stats"]
        print(json.dumps({"tree": str(tree), "variant": variant,
                          "runs": out}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=False)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--worker", default=None)
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--device", default="cuda",
                    help="cpu: a check of the script itself, not a timing")
    args = ap.parse_args()
    if args.worker:
        worker(Path(args.worker).resolve(), args.variants, args.reps,
               args.rounds, args.device)
        return
    here = Path(".").resolve()
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
           if args.device == "cuda" else "cpu")
    print(smi, flush=True)
    order = [(here, list(VARIANTS))]
    if args.parent:
        parent = (Path(args.parent).resolve(), ["base"])
        order = [parent, order[0], order[0], parent]
    for tree, variants in order:
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, str(here / "scripts" / "churn_ab.py"),
             "--worker", str(tree), "--reps", str(args.reps),
             "--rounds", str(args.rounds), "--device", args.device,
             "--variants", *variants],
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
