"""Render a `repro_torch.obs` telemetry JSONL run into a markdown report
(the PyTorch port's twin of ``examples/obs_report.py``; the port's JSONL
has the JAX package's schema).

    PYTHONPATH=src python examples/run_scenario_torch.py --device cpu \
        --telemetry run.jsonl
    PYTHONPATH=src python examples/obs_report_torch.py run.jsonl [--out REPORT.md]

Sections: run provenance (the `repro_torch.obs.manifest` record), per-cluster
convergence (mean cluster loss + consensus drift ‖θ_c − θ̄‖ per round),
the OTA communication-cost ledger (channel uses / scalar symbols, with
the paper's §IV CWFL-vs-decentralized savings row), participation and
injected-noise telemetry, and the phase wall timings
(trace+compile / execute / gather).  The paper's §IV row resolves
through `repro_torch.obs.ledger`.  Monte-Carlo runs are averaged
across trajectories (the per-round tables report trajectory means).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

MANIFEST_FIELDS = ("strategy", "scenario", "config_hash", "git",
                   "torch_version", "backend", "device_kind", "device_count",
                   "hostname", "created")


def _fmt(v) -> str:
    if isinstance(v, dict):          # git record
        sha = v.get("sha", "")[:12]
        return f"{sha}{' (dirty)' if v.get('dirty') else ''}" or str(v)
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _by_round(rounds: list[dict]) -> dict[int, list[dict]]:
    """Group round records by round number (MC runs have one record per
    trajectory per round)."""
    out: dict[int, list[dict]] = {}
    for r in rounds:
        out.setdefault(int(r["round"]), []).append(r)
    return dict(sorted(out.items()))


def _mean(records: list[dict], *keys):
    """Trajectory-mean of a (possibly nested) telemetry field; None if the
    field is absent."""
    vals = []
    for r in records:
        v = r
        for k in keys:
            v = v.get(k) if isinstance(v, dict) else None
            if v is None:
                return None
        vals.append(np.asarray(v, dtype=np.float64))
    return np.mean(np.stack(vals), axis=0)


def manifest_section(man: dict | None) -> list[str]:
    out = ["## Run"]
    if man is None:
        return out + ["", "_no manifest record in stream_"]
    out += ["", "| field | value |", "|---|---|"]
    for k in MANIFEST_FIELDS:
        if k in man:
            out.append(f"| {k} | {_fmt(man[k])} |")
    return out


def convergence_section(per_round: dict[int, list[dict]]) -> list[str]:
    sample = _mean(next(iter(per_round.values())),
                   "telemetry", "cluster_loss")
    if sample is None:
        return []
    C = sample.shape[0]
    hdr = "| round | train loss | test acc | " + " | ".join(
        f"loss c{c}" for c in range(C)) + " | " + " | ".join(
        f"drift c{c}" for c in range(C)) + " |"
    out = ["## Per-cluster convergence", "",
           f"{C} aggregation site(s); drift = ‖θ_c − θ̄‖.", "",
           hdr, "|" + "---|" * (3 + 2 * C)]
    for t, recs in per_round.items():
        cl = _mean(recs, "telemetry", "cluster_loss")
        dr = _mean(recs, "telemetry", "consensus_drift")
        tl = _mean(recs, "train_loss")
        ta = _mean(recs, "test_acc")
        row = [f"{t}", f"{float(tl):.4f}", f"{float(ta):.4f}"]
        row += [f"{v:.4f}" for v in np.atleast_1d(cl)]
        row += [f"{v:.4f}" for v in np.atleast_1d(dr)]
        out.append("| " + " | ".join(row) + " |")
    return out


def communication_section(per_round: dict[int, list[dict]],
                          man: dict | None) -> list[str]:
    if _mean(next(iter(per_round.values())),
             "telemetry", "channel_uses") is None:
        return []
    out = ["## Communication cost (OTA channel-use ledger)", "",
           "| round | uses | cum uses | cum symbols | reclustered |",
           "|---|---|---|---|---|"]
    for t, recs in per_round.items():
        u = _mean(recs, "telemetry", "channel_uses")
        cu = _mean(recs, "telemetry", "cum_channel_uses")
        cs = _mean(recs, "telemetry", "cum_symbols")
        rc = _mean(recs, "telemetry", "reclustered")
        out.append(f"| {t} | {float(u):.0f} | {float(cu):.0f} | "
                   f"{float(cs):.3g} | {float(rc):.2f} |")
    cfg = (man or {}).get("config") or {}
    K = (man or {}).get("clients") or 0
    C = cfg.get("num_clusters")
    if K and C and int(C) < int(K):
        from repro_torch.obs.ledger import per_round_table
        tab = per_round_table(int(K), int(C))
        out += ["",
                f"Paper §IV comparison at K={K}, C={C}: "
                f"cwfl={tab['cwfl']}, decentralized={tab['decentralized']}, "
                f"server_ota={tab['server_ota']} uses/round "
                f"(cwfl saves {tab['decentralized'] / tab['cwfl']:.1f}× "
                f"vs decentralized)."]
    return out


def participation_section(per_round: dict[int, list[dict]]) -> list[str]:
    if _mean(next(iter(per_round.values())),
             "telemetry", "participants") is None:
        return []
    noise_keys = [k for k in ("noise_energy", "mac_noise_std",
                              "receive_noise_std", "power_budget_frac")
                  if _mean(next(iter(per_round.values())),
                           "telemetry", "extras", k) is not None]
    hdr = "| round | participants |" + "".join(f" {k} |" for k in noise_keys)
    out = ["## Participation & noise", "", hdr,
           "|" + "---|" * (2 + len(noise_keys))]
    for t, recs in per_round.items():
        p = _mean(recs, "telemetry", "participants")
        row = [f"{t}", f"{float(p):.2f}"]
        for k in noise_keys:
            v = _mean(recs, "telemetry", "extras", k)
            row.append(f"{float(np.mean(v)):.4g}")
        out.append("| " + " | ".join(row) + " |")
    return out


def timings_section(summary: dict | None) -> list[str]:
    timings = (summary or {}).get("timings")
    if not timings:
        return []
    out = ["## Phase timings", "", "| phase | seconds |", "|---|---|"]
    for name, secs in sorted(timings.items()):
        out.append(f"| {name} | {secs:.3f} |")
    return out


def render(run: dict) -> str:
    man, rounds, summary = run["manifest"], run["rounds"], run["summary"]
    title = "# Observability report"
    if man:
        title += f" — {man.get('strategy')} / {man.get('scenario')}"
    blocks = [[title]]
    blocks.append(manifest_section(man))
    if rounds:
        per_round = _by_round(rounds)
        n_traj = len(next(iter(per_round.values())))
        if n_traj > 1:
            blocks.append([f"_{n_traj} trajectories; per-round tables are "
                           f"trajectory means._"])
        blocks.append(convergence_section(per_round))
        blocks.append(communication_section(per_round, man))
        blocks.append(participation_section(per_round))
    if summary:
        fin = np.atleast_1d(np.asarray(summary.get("final_acc", [])))
        line = (f"**Final acc** {fin.mean():.4f}"
                + (f" ± {fin.std():.4f} ({fin.size} trajectories)"
                   if fin.size > 1 else ""))
        if "cum_channel_uses" in summary:
            cu = np.mean(np.asarray(summary["cum_channel_uses"]))
            cs = np.mean(np.asarray(summary["cum_symbols"]))
            line += (f" · **total channel uses** {cu:.0f}"
                     f" · **total symbols** {cs:.3g}")
        blocks.append(["## Summary", "", line])
    blocks.append(timings_section(summary))
    return "\n\n".join("\n".join(b) for b in blocks if b) + "\n"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("jsonl", help="telemetry JSONL stream "
                                  "(run_scenario_torch.py --telemetry OUT)")
    ap.add_argument("--out", default=None,
                    help="write the markdown here instead of stdout")
    args = ap.parse_args(argv)

    from repro_torch.obs.sink import read_run
    md = render(read_run(args.jsonl))
    if args.out:
        with open(args.out, "w") as f:
            f.write(md)
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        print(md, end="")


if __name__ == "__main__":
    main()
