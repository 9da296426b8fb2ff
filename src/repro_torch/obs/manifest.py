"""Run manifests: who/what/where provenance for every recorded run (port
of `repro.obs.manifest`, which is host-side stdlib: copied, not imported).

:func:`build_manifest` stamps one provenance record: git revision (+dirty
flag), torch/numpy/python versions, the device (the card's name, count
and power limit), hostname, timestamps, the resolved scenario/strategy
names, the full config and a stable ``config_hash`` over (config,
scenario, strategy) so runs with identical protocols are identifiable
across files — and across the two packages: the port's `FLConfig` and
`Scenario` have the JAX package's fields, so the same settings hash to
the same value in both.

Everything here is best-effort: a missing git or ``nvidia-smi`` binary
degrades to ``None`` rather than failing the run being recorded.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import platform
import socket
import subprocess
import time
from typing import Any, Optional

MANIFEST_SCHEMA = "repro.obs.manifest/v1"


def to_jsonable(obj: Any) -> Any:
    """Best-effort conversion to JSON-serializable structures: dataclasses
    → dicts, tensors and numpy arrays → lists (0-d → scalars), tuples →
    lists, a ``torch.dtype`` or ``torch.device`` → its name.  Unknown
    objects degrade to ``repr`` rather than raising — a manifest must
    never kill the run it documents."""
    import torch

    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, (torch.dtype, torch.device)):
        return str(obj)
    if isinstance(obj, torch.Tensor):
        return to_jsonable(obj.detach().cpu().tolist())
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {str(k): to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set)):
        return [to_jsonable(v) for v in obj]
    if hasattr(obj, "_asdict"):                      # NamedTuple
        return to_jsonable(obj._asdict())
    if hasattr(obj, "tolist"):                       # numpy arrays
        try:
            return to_jsonable(obj.tolist())
        except Exception:  # pragma: no cover - exotic array types
            return repr(obj)
    if hasattr(obj, "item"):                         # 0-d scalars
        try:
            return obj.item()
        except Exception:  # pragma: no cover
            return repr(obj)
    return repr(obj)


def config_hash(*objs: Any) -> str:
    """Stable 16-hex digest of the canonical JSON of ``objs`` — the run
    identity key: same (config, scenario, strategy) ⇒ same hash, across
    processes and json key orderings."""
    canon = json.dumps([to_jsonable(o) for o in objs], sort_keys=True,
                       separators=(",", ":"))
    return hashlib.sha256(canon.encode()).hexdigest()[:16]


def git_revision(cwd: Optional[str] = None) -> Optional[dict]:
    """``{"sha": <40-hex>, "dirty": bool}`` of the enclosing checkout, or
    ``None`` when git/the repo is unavailable (never raises)."""
    cwd = cwd or os.path.dirname(os.path.abspath(__file__))
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=cwd, capture_output=True,
            text=True, timeout=10, check=True).stdout.strip()
        dirty = subprocess.run(
            ["git", "status", "--porcelain"], cwd=cwd, capture_output=True,
            text=True, timeout=10, check=True).stdout.strip() != ""
        return {"sha": sha, "dirty": dirty}
    except Exception:
        return None


def _power_limit() -> Optional[str]:
    """The first card's power limit as ``nvidia-smi`` reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=10, check=True).stdout.strip().splitlines()
        return out[0].strip() if out else None
    except Exception:
        return None


def device_info() -> dict:
    """The card the port runs on: its name (``torch.cuda.
    get_device_name``), the count, the torch and CUDA versions and the
    power limit (``nvidia-smi``); ``{"platform": "cpu"}`` without one."""
    import torch

    if not torch.cuda.is_available():
        return {"platform": "cpu"}
    return {"platform": "gpu",
            "device_kind": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count(),
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "power_limit": _power_limit()}


def build_manifest(cfg: Any = None, scenario: Any = None,
                   strategy: Any = None, extra: Optional[dict] = None
                   ) -> dict:
    """One provenance record for a run.

    ``cfg``: the `FLConfig` (or any dataclass/dict); ``scenario``: a
    `Scenario` or its name; ``strategy``: a `Strategy` or its name;
    ``extra``: free-form caller fields merged at the top level (bench
    name, CLI argv, a sharded run's layout, ...).  JAX's ``mesh`` has no
    counterpart: the port's ranks are a process group's.
    """
    import numpy as np
    import torch

    scenario_name = getattr(scenario, "name", scenario)
    strategy_name = getattr(strategy, "name", strategy)
    cfg_json = to_jsonable(cfg)
    dev = device_info()
    man = {
        "schema": MANIFEST_SCHEMA,
        "created_unix": time.time(),
        "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "git": git_revision(),
        "torch_version": torch.__version__,
        "numpy_version": np.__version__,
        "python_version": platform.python_version(),
        "platform": platform.platform(),
        "hostname": socket.gethostname(),
        "backend": "cuda" if dev["platform"] == "gpu" else "cpu",
        "device_kind": dev.get("device_kind", "cpu"),
        "device_count": dev.get("device_count", 1),
        "device": dev,
        "strategy": strategy_name,
        "scenario": scenario_name,
        "config": cfg_json,
        "config_hash": config_hash(cfg_json, to_jsonable(scenario),
                                   strategy_name),
    }
    if extra:
        man.update(to_jsonable(extra))
    return man
