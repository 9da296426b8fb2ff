#!/usr/bin/env python3
"""Parent/change comparison of the ``flash_attention`` kernels on one GPU.

    python3 scripts/fa_ab.py [--parent DIR] [--shapes LABEL ...] [--reps N]

Runs the kernels of this checkout's ``src/repro_torch`` (and, with
``--parent``, those of another checkout, such as the parent commit
unpacked with ``git archive`` into a git-ignored directory) at
``chip_smoke.py``'s ``FA_SHAPES``: each launch's largest error against
the checkout's own plain version (its output poisoned with NaN before the
launch) and, at the full-width shapes, the median time of a launch with
the L2 flushed before it.  Each checkout runs in a process of its own
(both name their package ``repro_torch``), in the order parent, change,
change, parent, so that both are timed on one card in turns.  Prints the
card's ``nvidia-smi`` line, then one JSON object a line: each library's
compiler report (registers, spills, warnings), then each shape.  Needs a
CUDA device; exits 1 without one.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def worker(src: str, label: str, shapes, reps: int) -> None:
    """One checkout's kernels at ``shapes`` (labels of FA_SHAPES)."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    sys.path.insert(0, src)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels._build import build, library_path
    from repro_torch.kernels.ref import flash_attention_ref

    build(fa.SOURCES)
    for source in fa.SOURCES:
        log = library_path(source).with_suffix(".log").read_text()
        print(json.dumps({"tree": label, "library": source.name, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if any(w in ln for w in ("registers", "spill", "arning"))]}),
            flush=True)
    for label_s, B, H, KV, S, D, dtype, window, cap in cs.FA_SHAPES:
        if shapes and label_s not in shapes:
            continue
        g = torch.Generator(cs.DEVICE).manual_seed(S + D + window)
        q = (4 * torch.randn(B, H, S, D, generator=g, device=cs.DEVICE)).to(
            dtype)
        k = torch.randn(B, KV, S, D, generator=g, device=cs.DEVICE).to(dtype)
        v = torch.randn(B, KV, S, D, generator=g, device=cs.DEVICE).to(dtype)
        mode = {"causal": True, "window": window, "cap": cap}
        out = cs.poisoned_launch(lambda: fa.flash_attention(q, k, v, **mode),
                                 q.shape, dtype)
        ref = flash_attention_ref(q, k, v, **mode)
        torch.cuda.synchronize()
        line = {"tree": label, "shape": label_s, "dtype": str(dtype),
                "max_abs_err": float((out.float() - ref.float()).abs().max()),
                "finite": bool(torch.isfinite(out.float()).all())}
        del out, ref
        if not label_s.startswith("small"):
            line["ms"] = cs.time_cold(
                lambda: fa.flash_attention(q, k, v, **mode), reps)
        print(json.dumps(line), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of the checkout to compare with")
    ap.add_argument("--shapes", nargs="*", default=[],
                    help="FA_SHAPES labels (default: all)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--worker", nargs=2, metavar=("SRC", "LABEL"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker[0], args.worker[1], args.shapes, args.reps)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("fa_ab.py needs a CUDA device; none found")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    change = ("change", str(ROOT / "src"))
    runs = [change]
    if args.parent:
        parent = ("parent", str(Path(args.parent).resolve() / "src"))
        runs = [parent, change, change, parent]
    for label, src in runs:
        subprocess.run([sys.executable, __file__, "--worker", src, label,
                        "--reps", str(args.reps), "--shapes", *args.shapes],
                       check=True)


if __name__ == "__main__":
    main()
