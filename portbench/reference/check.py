"""The numbers that decide ``correct``: what the timed path produced
against the plain reference on the same inputs.

* ``loss_gap``: the largest relative gap, over every compared trajectory
  and round, between the program's mean client training loss and the
  reference's.  Each round's loss is taken at the start of the round's
  local training from the last round's broadcast, so it carries every
  earlier aggregation, its noise and the clustering behind it.
* ``acc_gap``: the largest absolute gap in a round's test accuracy (the
  evaluation of the consensus).
* ``param_gap`` (where the entry returns the final consensus): by the
  worst leaf, the gap between the norms of the program's and the
  reference's change of that leaf over the trajectory, against the
  reference's norm of that leaf or of the median leaf, whichever is
  larger.
* ``heads_mismatch`` (under a re-clustering scenario): the cluster-heads,
  over every trajectory, round and cluster, that differ from the
  reference's.  Exact: its limit is 0.
"""
from __future__ import annotations

import math

import torch


def _leaves(tree: dict) -> list:
    return [tree[k][j] for k in sorted(tree) for j in sorted(tree[k])]


def param_gap(finals: list, ref_finals: list, inits: list) -> float:
    worst = 0.0
    for fin, ref, init in zip(finals, ref_finals, inits):
        prog_n, ref_n = [], []
        for p, r, i in zip(_leaves(fin), _leaves(ref), _leaves(init)):
            prog_n.append(float(torch.linalg.vector_norm(
                p.double() - i.double())))
            ref_n.append(float(torch.linalg.vector_norm(
                r.double() - i.double())))
        median = sorted(ref_n)[len(ref_n) // 2]
        for pn, rn in zip(prog_n, ref_n):
            worst = max(worst, abs(pn - rn) / max(rn, median, 1e-30))
    return worst


def loss_gaps(prog_loss, ref_loss) -> torch.Tensor:
    """Element by element the relative gap of two loss tables; where the
    reference's loss is not finite (a trajectory that diverged, as the
    lowest SNRs do), 0 if the program's is the same non-finite value,
    else infinite."""
    p, r = prog_loss.double().cpu(), ref_loss.double().cpu()
    finite = torch.isfinite(r)
    gap = torch.abs(p - r) / torch.clamp(torch.abs(r), min=1e-30)
    same = (torch.isnan(p) & torch.isnan(r)) | (p == r)
    return torch.where(finite, torch.nan_to_num(gap, nan=torch.inf),
                       torch.where(same, 0.0, torch.inf))


def numbers(prog: dict, ref: dict) -> dict:
    """The compared numbers of one check.  ``prog`` and ``ref`` hold
    ``loss`` and ``acc`` (B, T); ``final`` (B param trees) where the
    entry returns it, ``ref["init"]``; ``heads`` (B, T, C) under a
    re-clustering scenario.  The reference may follow only the first
    rounds of the program's (a traffic's ``check_rounds``): the program's
    tables are compared over those."""
    T = ref["loss"].shape[1]
    out = {"loss_gap": float(torch.max(loss_gaps(prog["loss"][:, :T],
                                                 ref["loss"]))),
           "acc_gap": float(torch.max(torch.abs(
               prog["acc"][:, :T].double().cpu()
               - ref["acc"].double().cpu())))}
    if prog.get("final") is not None and prog["loss"].shape[1] == T:
        out["param_gap"] = param_gap(prog["final"], ref["final"],
                                     ref["init"])
    if ref.get("heads") is not None:
        out["heads_mismatch"] = float(
            (prog["heads"][:, :T].cpu() != ref["heads"].cpu()).sum())
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def worst(prog: dict, ref: dict) -> str:
    """Where the largest loss gap lies, for the log."""
    gaps = loss_gaps(prog["loss"][:, :ref["loss"].shape[1]], ref["loss"])
    b, t = divmod(int(torch.argmax(gaps)), gaps.shape[1])
    return (f"largest loss gap at trajectory {b} round {t}: program "
            f"{float(prog['loss'][b, t])!r} reference "
            f"{float(ref['loss'][b, t])!r}")


def verdict(values: dict, limits: dict) -> tuple[bool, list]:
    """``(correct, [[name, value, limit], ...])``: correct when every number
    is at most its limit (a number with no limit, or a NaN, fails)."""
    rows, ok = [], True
    for name, value in values.items():
        limit = limits.get(name)
        if limit is None or not value <= limit:
            ok = False
        rows.append([name, value, limit])
    return ok, rows
