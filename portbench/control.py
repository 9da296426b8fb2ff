"""Readings that set the limits of ``correct``: sound runs, the
lower-precision control and planted faults, at a cell's own size.

    python3 portbench/control.py --workload <name> --seeds 11 12 13 \
        [--kinds sound tf32 state_unchanged half_batch no_exchange \
        answer_altered] [--out control.jsonl]

For each seed: the cell's inputs, one call of its entry as the window
makes it (``sound``, or with a fault planted in the program), and the
plain reference on the same draws; the numbers of
`portbench.reference.check` for each kind go to standard output and
``--out`` as JSON lines.  ``tf32`` is the control: the reference itself
put in the program's place in TF32, the nearest precision below the
configuration's float32 with TF32 off: TF32 on, and the operands of
every matmul and convolution rounded to TF32 (cuDNN computes the grouped
convolutions in f32 whatever the flag says).  The faults:

* ``state_unchanged``: local training returns the parameters it got;
* ``half_batch``: the loss is the mean over the first half of each
  minibatch, the rest left out;
* ``no_exchange``: the sync round leaves every client's parameters as
  they are (no aggregation between clients);
* ``answer_altered``: each round's test accuracy is reported 0.01 high
  where it is computed.

The benchmark's own runs never run this.  The CPU tests drive the same
faults through a whole run at a small size (``portbench/tests``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

FAULTS = ("state_unchanged", "half_batch", "no_exchange", "answer_altered")


@contextlib.contextmanager
def planted(kind: str):
    """The program with fault ``kind`` planted, for the block."""
    from repro_torch.core import cwfl
    from repro_torch.models import small
    from repro_torch.sim import engine

    if kind == "state_unchanged":
        target, name = engine, "make_local_runner"
        orig = engine.make_local_runner

        def fake(*a, **k):
            run = orig(*a, **k)

            def unchanged(params, opt_state, *args, **kw):
                _, opt_state, loss = run(params, opt_state, *args, **kw)
                return params, opt_state, loss
            return unchanged
    elif kind == "half_batch":
        target, name = small, "nll_loss"
        orig = small.nll_loss

        def fake(log_probs, labels):
            half = labels.shape[-1] // 2
            return orig(log_probs[..., :half, :], labels[..., :half])
    elif kind == "no_exchange":
        target, name = cwfl, "cwfl_round"
        orig = cwfl.cwfl_round

        def fake(signals, *args, **kw):
            return signals.clone(), signals.mean(dim=-2)
    elif kind == "answer_altered":
        target, name = engine, "accuracy"
        orig = engine.accuracy

        def fake(log_probs, labels):
            return orig(log_probs, labels) + 0.01
    else:
        raise ValueError(f"unknown fault {kind!r}; choose from {FAULTS}")
    setattr(target, name, fake)
    try:
        yield
    finally:
        setattr(target, name, orig)


def readings(cell, seed: int, kinds, device) -> list:
    """``[{"seed", "kind", <numbers>}]`` of one seed: each kind's call
    against the plain reference (f32, TF32 off) on the same draws."""
    from portbench import harness
    from portbench.harness import reference_numerics
    from portbench.reference.check import numbers

    entry = cell.entry().Entry(cell.config, cell.traffic, seed, device)
    key = ("traj", seed, 0)
    rounds = harness.check_rounds(cell.traffic, cell.config["rounds"])
    with reference_numerics():
        ref = entry.reference(key, rounds)
    out = []
    for kind in kinds:
        t0 = time.perf_counter()
        if kind == "tf32":
            with reference_numerics(tf32=True):
                got = entry.reference(key, rounds, tf32=True)
        else:
            with (planted(kind) if kind != "sound"
                  else contextlib.nullcontext()):
                got = entry.run(0).outputs()
        out.append({"seed": seed, "kind": kind,
                    "seconds": time.perf_counter() - t0,
                    **numbers(got, ref)})
    return out


def open_out(path):
    """``--out`` opened for appending, its directory made."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    return open(path, "a")


def main(argv=None) -> int:
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--kinds", nargs="+",
                   default=["sound", "tf32", *FAULTS])
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    from portbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds:
        for row in readings(cell, seed, args.kinds, device):
            line = json.dumps({"workload": args.workload, **row})
            print(line, flush=True)
            if args.out:
                with open_out(args.out) as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
