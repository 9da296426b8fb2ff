#!/usr/bin/env python3
"""Parent/change comparison of the ``flash_attention`` kernels on one GPU.

    python3 scripts/fa_ab.py [--parent DIR] [--parts fwd bwd]
                             [--shapes LABEL ...] [--bwd-shapes LABEL ...]
                             [--reps N]

Runs the kernels of this checkout's ``src/repro_torch`` (and, with
``--parent``, those of another checkout, such as the parent commit
unpacked with ``git archive`` into a git-ignored directory) at
``chip_smoke.py``'s ``FA_SHAPES``: each launch's largest error against
the checkout's own plain version (its output poisoned with NaN before the
launch) and, at the full-width shapes, the median time of a launch with
the L2 flushed before it, and a digest of the output's bytes; with
``--parent`` a last line says, shape by shape, whether the two
checkouts' outputs are bitwise the same.  ``bwd`` does the same for the
backward (``flash_attention_bwd``) at ``BWD_SHAPES`` (default: the
full-width ones), on the checkout's own forward's o and lse: each
gradient's error relative to its largest magnitude against the plain
backward, whether a second launch is bitwise the first, and the median
device time (``chip_smoke.device_ms``).  Each checkout runs in a process
of its own
(both name their package ``repro_torch``), in the order parent, change,
change, parent, so that both are timed on one card in turns.  Prints the
card's ``nvidia-smi`` line, then one JSON object a line: each library's
compiler report (registers, spills, warnings), then each shape.  Needs a
CUDA device; exits 1 without one.
"""
import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def worker(src: str, label: str, parts, shapes, bwd_shapes,
           reps: int) -> None:
    """One checkout's kernels at ``shapes`` (labels of FA_SHAPES) and
    ``bwd_shapes`` (labels of BWD_SHAPES)."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    sys.path.insert(0, src)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels._build import build, library_path
    from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                         flash_attention_ref)

    sources = [*fa.SOURCES, *([fa.SOURCE_BWD] if "bwd" in parts else [])]
    build(sources)
    for source in sources:
        log = library_path(source).with_suffix(".log").read_text()
        print(json.dumps({"tree": label, "library": source.name, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if any(w in ln for w in ("registers", "spill", "arning"))]}),
            flush=True)
    for label_s, B, H, KV, S, D, dtype, window, cap, *opts in cs.FA_SHAPES:
        # Rows with options (no causal mask, Skv ≠ S) or a head dim the
        # kernels run padded are held to their plain version by
        # chip_smoke.py alone.
        if ("fwd" not in parts or opts or D not in fa.HEAD_DIMS
                or (shapes and label_s not in shapes)):
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
                "finite": bool(torch.isfinite(out.float()).all()),
                "digest": hashlib.sha256(
                    out.view(torch.uint8).cpu().numpy().tobytes()
                ).hexdigest()[:16]}
        del out, ref
        if not label_s.startswith("small"):
            line["ms"] = cs.time_cold(
                lambda: fa.flash_attention(q, k, v, **mode), reps)
        print(json.dumps(line), flush=True)
    for label_s, B, H, KV, S, D, dtype, window, cap in cs.BWD_SHAPES:
        if "bwd" not in parts or label_s not in bwd_shapes:
            continue
        g = torch.Generator(cs.DEVICE).manual_seed(S + D + window + 1)
        q = (4 * torch.randn(B, H, S, D, generator=g, device=cs.DEVICE)).to(
            dtype)
        k = torch.randn(B, KV, S, D, generator=g, device=cs.DEVICE).to(dtype)
        v = torch.randn(B, KV, S, D, generator=g, device=cs.DEVICE).to(dtype)
        do = torch.randn(B, H, S, D, generator=g, device=cs.DEVICE).to(dtype)
        mode = {"causal": True, "window": window, "cap": cap,
                "scale": D ** -0.5}
        o, lse = fa._forward(q, k, v, True, window, cap, D ** -0.5, True)
        grads = cs.poisoned_outputs(fa, lambda: fa.flash_attention_bwd(
            q, k, v, o, lse, do, **mode))
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, **mode)
        want = flash_attention_bwd_ref(q, k, v, o, lse, do, **mode)
        torch.cuda.synchronize()
        line = {"tree": label, "bwd_shape": label_s, "dtype": str(dtype),
                "rel_err": {n: cs.rel_err(a, b) for n, a, b in
                            zip(("dq", "dk", "dv"), grads, want)},
                "bitwise_rerun": all(torch.equal(a, b)
                                     for a, b in zip(grads, again)),
                "finite": all(bool(torch.isfinite(x.float()).all())
                              for x in grads),
                "digest": hashlib.sha256(b"".join(
                    x.view(torch.uint8).cpu().numpy().tobytes()
                    for x in grads)).hexdigest()[:16]}
        del grads, again, want
        line["ms"] = cs.device_ms(lambda: fa.flash_attention_bwd(
            q, k, v, o, lse, do, **mode), reps)
        print(json.dumps(line), flush=True)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of the checkout to compare with")
    ap.add_argument("--parts", nargs="*", default=["fwd", "bwd"],
                    choices=["fwd", "bwd"])
    ap.add_argument("--shapes", nargs="*", default=[],
                    help="FA_SHAPES labels (default: all)")
    ap.add_argument("--bwd-shapes", nargs="*", default=None,
                    help="BWD_SHAPES labels (default: the full-width ones)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--worker", nargs=2, metavar=("SRC", "LABEL"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.bwd_shapes is None:
        sys.path.insert(0, str(ROOT))
        import chip_smoke as cs

        args.bwd_shapes = [s[0] for s in cs.BWD_SHAPES
                           if not s[0].startswith("small")]
    if args.worker:
        worker(args.worker[0], args.worker[1], args.parts, args.shapes,
               args.bwd_shapes, args.reps)
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
    digests = {}
    for label, src in runs:
        out = subprocess.run([sys.executable, __file__, "--worker", src,
                              label, "--reps", str(args.reps), "--parts",
                              *args.parts, "--shapes", *args.shapes,
                              "--bwd-shapes", *args.bwd_shapes], check=True,
                             text=True, stdout=subprocess.PIPE).stdout
        print(out, end="", flush=True)
        for ln in out.splitlines():
            line = json.loads(ln)
            if "digest" in line:
                shape = line.get("shape") or "bwd:" + line["bwd_shape"]
                digests.setdefault(shape, set()).add(line["digest"])
    if args.parent:
        print(json.dumps({"bitwise_parent_change": {
            shape: len(d) == 1 for shape, d in digests.items()}}),
            flush=True)


if __name__ == "__main__":
    main()
