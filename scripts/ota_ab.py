#!/usr/bin/env python3
"""Parent/change comparison of the ``ota_aggregate`` kernel (or, with
``--kernel cwfl_round``, of the round kernel) on one GPU.

    python3 scripts/ota_ab.py [--parent DIR] [--kernel NAME]
        [--shapes LABEL ...] [--reps N]

Runs the kernel of this checkout's ``src/repro_torch`` (and, with
``--parent``, that of another checkout, such as the parent commit unpacked
with ``git archive`` into a git-ignored directory) at ``chip_smoke.py``'s
``OTA_SHAPES``, on the same inputs (``chip_smoke.ota_inputs``): each call's
launches, its largest error against the checkout's own plain version (its
output poisoned with NaN before the launch), and, at ``OTA_TIMED`` shapes,
the median event time of a call and its mean device time with the L2
flushed before each, beside ``torch.addmm``'s, and the kernel's launch
plan where the checkout has one.  Each checkout runs in a process of its
own (both name their package ``repro_torch``), in the order
parent, change, change, parent, so that both are timed on one card in
turns; each keeps its first outputs under ``build/ota_ab/``, and the last
lines give, for each shape, the largest |Δ| between the two checkouts'
outputs.  Prints the card's ``nvidia-smi`` line, then one JSON object a
line: each library's compiler report (registers, spills), each shape, each
comparison.  With ``--kernel cwfl_round`` the same at ``chip_smoke.py``'s
``CWFL_SHAPES`` (``chip_smoke.round_inputs``), unguarded and guarded (on
``chip_smoke.poison``'s inputs), both outputs compared; every shape is
timed (device time, L2 flushed).  Needs a CUDA device; exits 1 without
one.
"""
import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ota_ab"


def round_worker(src: str, label: str, shapes, reps: int) -> None:
    """One checkout's ``cwfl_round`` at ``shapes`` (labels of
    CWFL_SHAPES), unguarded and guarded."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    sys.path.insert(0, src)
    from repro_torch.kernels import cwfl_round as kmod
    from repro_torch.kernels._build import build, library_path
    from repro_torch.kernels.ref import cwfl_round_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    build([kmod.SOURCE])
    log = library_path(kmod.SOURCE).with_suffix(".log").read_text()
    print(json.dumps({"tree": label, "library": kmod.SOURCE.name, "ptxas": [
        ln.strip() for ln in log.splitlines()
        if any(w in ln for w in ("entry function", "registers", "spill",
                                  "arning"))]}),
        flush=True)
    (OUT / label).mkdir(parents=True, exist_ok=True)
    for label_s, K, C, d, dtype in cs.CWFL_SHAPES:
        if shapes and label_s not in shapes:
            continue
        for guard in (False, True):
            args = cs.round_inputs(K, C, d, dtype, seed=K + C + d)
            if guard:
                args = cs.poison(args, seed=K + C + d)
            before = kmod.launches + kmod.launches_guard
            new, cons = kmod.cwfl_round(*args, guard=guard)
            torch.cuda.synchronize()
            ref_new, ref_cons = cwfl_round_ref(*args, guard=guard)
            name = f"{label_s}{'_guard' if guard else ''}"
            call = lambda: kmod.cwfl_round(*args, guard=guard)   # noqa: E731
            line = {"tree": label, "shape": name, "K": K, "C": C, "d": d,
                    "dtype": str(dtype),
                    "launches_a_call": (kmod.launches + kmod.launches_guard
                                        - before),
                    "max_abs_err": max(
                        float((new.float() - ref_new.float()).abs().max()),
                        float((cons - ref_cons).abs().max())),
                    "device_ms": cs.device_ms(call, reps)}
            saved = OUT / label / f"{name}.pt"
            if not saved.exists():
                torch.save(torch.cat([new.float().flatten().cpu(),
                                      cons.cpu()]), saved)
            print(json.dumps(line), flush=True)


def worker(src: str, label: str, shapes, reps: int) -> None:
    """One checkout's kernel at ``shapes`` (labels of OTA_SHAPES)."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    sys.path.insert(0, src)
    from repro_torch.kernels import ota_aggregate as omod
    from repro_torch.kernels._build import build, library_path
    from repro_torch.kernels.ref import ota_aggregate_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    build([omod.SOURCE])
    log = library_path(omod.SOURCE).with_suffix(".log").read_text()
    print(json.dumps({"tree": label, "library": omod.SOURCE.name, "ptxas": [
        ln.strip() for ln in log.splitlines()
        if any(w in ln for w in ("entry function", "registers", "spill",
                                  "arning"))]}),
        flush=True)
    (OUT / label).mkdir(parents=True, exist_ok=True)
    for label_s, K, C, d, dtype, wdtype in cs.OTA_SHAPES:
        if shapes and label_s not in shapes:
            continue
        s, w, n = cs.ota_inputs(K, C, d, dtype, wdtype)
        before = omod.launches
        out = cs.poisoned_launch(lambda: omod.ota_aggregate(s, w, n),
                                 (C, d), dtype)
        torch.cuda.synchronize()
        ref = ota_aggregate_ref(s, w, n)
        line = {"tree": label, "shape": label_s, "K": K, "C": C, "d": d,
                "dtype": str(dtype),
                "plan": (dataclasses.asdict(omod.launch_plan(
                    K, C, d, s.dtype, n.dtype))
                    if hasattr(omod, "read_plan") else None),
                "launches_a_call": omod.launches - before,
                "max_abs_err": float((out.float() - ref.float()).abs().max()),
                "finite": bool(torch.isfinite(out.float()).all())}
        saved = OUT / label / f"{label_s}.pt"
        if not saved.exists():
            torch.save(out.cpu(), saved)
        del out, ref
        if label_s in cs.OTA_TIMED:
            call = lambda: omod.ota_aggregate(s, w, n)   # noqa: E731
            wl, nl = w.to(dtype), n.to(dtype)
            lib = lambda: torch.addmm(nl, wl, s)         # noqa: E731
            bound_bytes, bound_ops = cs.ota_bounds(s, n, C)[2:]
            line.update(ms=cs.time_cold(call, reps),
                        device_ms=cs.device_ms(call, reps),
                        addmm_ms=cs.time_cold(lib, reps),
                        addmm_device_ms=cs.device_ms(lib, reps),
                        bound_ms_bytes=bound_bytes,
                        bound_ms_operations=bound_ops)
        print(json.dumps(line), flush=True)


def compare(labels) -> None:
    """The largest |Δ| between the trees' outputs at each shape."""
    import torch

    for saved in sorted((OUT / labels[0]).glob("*.pt")):
        a = torch.load(saved).float()
        b = torch.load(OUT / labels[1] / saved.name).float()
        print(json.dumps({"compare": list(labels), "shape": saved.stem,
                          "max_abs_delta": float((a - b).abs().max()),
                          "bitwise_equal": bool(torch.equal(a, b))}),
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of the checkout to compare with")
    ap.add_argument("--kernel", default="ota_aggregate",
                    choices=("ota_aggregate", "cwfl_round"))
    ap.add_argument("--shapes", nargs="*", default=[],
                    help="OTA_SHAPES (CWFL_SHAPES) labels (default: all)")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--worker", nargs=2, metavar=("SRC", "LABEL"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        (round_worker if args.kernel == "cwfl_round" else worker)(
            args.worker[0], args.worker[1], args.shapes, args.reps)
        return
    import shutil

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ota_ab.py needs a CUDA device; none found")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    shutil.rmtree(OUT, ignore_errors=True)
    change = ("change", str(ROOT / "src"))
    runs = [change]
    if args.parent:
        parent = ("parent", str(Path(args.parent).resolve() / "src"))
        runs = [parent, change, change, parent]
    for label, src in runs:
        subprocess.run([sys.executable, __file__, "--worker", src, label,
                        "--kernel", args.kernel, "--reps", str(args.reps),
                        "--shapes", *args.shapes], check=True)
    if args.parent:
        compare(("parent", "change"))


if __name__ == "__main__":
    main()
