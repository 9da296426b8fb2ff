"""Tables of the dry run and the roofline (port of `repro.launch.report`).

    PYTHONPATH=src python -m repro_torch.launch.report \
        [--dryrun-json PATH] [--roofline-json PATH] [--card-json PATH]

`dryrun_table` and `roofline_table` render JAX's record format as JAX's
do; `card_table` renders the one-card dry run's rows
(`repro_torch.launch.dryrun`): the cut, the predicted and measured peak,
the seconds a step, the bounding term, MFU and the roofline share.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

GIB = 2 ** 30
GB = 1e9


def dryrun_table(path="results/dryrun.json") -> str:
    if not Path(path).exists():
        return "_dry-run results not yet generated_"
    rows = json.loads(Path(path).read_text())
    rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    out = ["| arch | shape | mesh | status | peak GiB/dev | compile s | M | top collectives (per scan iter) |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        mem = r.get("mem", {}).get("peak_per_device", 0) / GIB
        colls = r.get("collectives", {})
        top = ", ".join(
            f"{k}×{v['count']} ({v['bytes']/GIB:.2f}G)"
            for k, v in sorted(colls.items(),
                               key=lambda kv: -kv[1]["bytes"])[:2])
        status = r["status"]
        if status == "skip":
            top = r.get("reason", "")
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {status} | "
            f"{mem:.2f} | {r.get('compile_s', '')} | "
            f"{r.get('microbatches', '')} | {top} |")
    n_ok = sum(r["status"] == "ok" for r in rows)
    n_fail = sum(r["status"] == "fail" for r in rows)
    n_skip = sum(r["status"] == "skip" for r in rows)
    out.append(f"\n**{n_ok} ok / {n_skip} skip / {n_fail} fail** "
               f"out of {len(rows)} (arch × shape × mesh) combinations.")
    return "\n".join(out)


def roofline_table(path="results/roofline.json") -> str:
    if not Path(path).exists():
        return "_roofline results not yet generated_"
    rows = json.loads(Path(path).read_text())
    rows.sort(key=lambda r: (r["arch"], r["shape"],
                             r.get("variant", "base") != "base",
                             r.get("variant", "base")))
    out = ["| arch | shape | variant | compute s | memory s | collective s | dominant | MODEL_FLOPS | useful ratio | M |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        v = r.get("variant", "base")
        if r["status"] == "skip":
            out.append(f"| {r['arch']} | {r['shape']} | {v} | — | — | — | "
                       f"skip: {r.get('reason','')[:40]} | — | — | — |")
            continue
        if r["status"] == "fail":
            out.append(f"| {r['arch']} | {r['shape']} | {v} | — | — | — | "
                       f"FAIL | — | — | — |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {v} | "
            f"{r['t_compute_s']*1e3:.1f}ms | "
            f"{r['t_memory_s']*1e3:.1f}ms | {r['t_collective_s']*1e3:.1f}ms | "
            f"**{r['dominant']}** | {r['model_flops']:.2e} | "
            f"{r['useful_ratio']:.2f} | {r.get('microbatches','')} |")
    return "\n".join(out)


def _cut(reduced: dict) -> str:
    return ", ".join(f"{k} {v}" for k, v in reduced.items()) or "none"


def card_table(path="results_torch/dryrun.json") -> str:
    """The one-card rows: status, cut, the plan's predicted peak and the
    measured one (GB), s a step, the bounding term, MFU and the roofline
    share (the larger term over the measured time)."""
    if not Path(path).exists():
        return "_one-card dry-run results not yet generated_"
    rows = json.loads(Path(path).read_text())
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    out = ["| arch | shape | status | cut | predicted GB | measured GB | s a step | bound | MFU | roofline share |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        status = r["status"]
        if status == "skip":
            out.append(f"| {r['arch']} | {r['shape']} | skip: "
                       f"{r.get('reason', '')[:40]} | — | — | — | — | — | "
                       f"— | — |")
            continue
        pred = r.get("bytes", {}).get("total")
        pred_s = f"{pred / GB:.2f}" if pred is not None else "—"
        if status != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {status} | "
                       f"{_cut(r.get('reduced', {}))} | {pred_s} | — | — "
                       f"| — | — | — |")
            continue
        run = r.get("run")
        if run is None:
            out.append(f"| {r['arch']} | {r['shape']} | planned | "
                       f"{_cut(r['reduced'])} | {pred_s} | not run | — | "
                       f"— | — | — |")
            continue
        roof = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | ok | {_cut(r['reduced'])} | "
            f"{pred_s} | {run['peak_bytes'] / GB:.2f} | "
            f"{run['step_s']:.4g} | {roof['bound']} | {roof['mfu']:.3f} | "
            f"{100 * roof['share']:.1f} % |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dryrun-json", default="results/dryrun.json",
                    help="JAX's dry-run results JSON (repro.launch.dryrun)")
    ap.add_argument("--roofline-json", default="results/roofline.json",
                    help="JAX's roofline results JSON "
                         "(repro.launch.roofline)")
    ap.add_argument("--card-json", default="results_torch/dryrun.json",
                    help="the one-card rows (repro_torch.launch.dryrun)")
    args = ap.parse_args(argv)
    print("## §Dry-run\n")
    print(dryrun_table(args.dryrun_json))
    print("\n## §Roofline\n")
    print(roofline_table(args.roofline_json))
    print("\n## §One card\n")
    print(card_table(args.card_json))


if __name__ == "__main__":
    main()
