"""The port stands alone: no module of ``src/repro_torch``, nor
``chip_smoke.py``, nor the examples ``quickstart_torch.py``,
``paper_fig2_torch.py``, ``run_scenario_torch.py``,
``obs_report_torch.py``, ``train_lm_cwfl_torch.py`` and
``serve_decode_torch.py``, nor the chip phase scripts of the training
and dry-run slices, imports ``jax`` or the JAX package ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "quickstart_torch.py",
    ROOT / "examples" / "paper_fig2_torch.py",
    ROOT / "examples" / "run_scenario_torch.py",
    ROOT / "examples" / "obs_report_torch.py",
    ROOT / "examples" / "train_lm_cwfl_torch.py",
    ROOT / "examples" / "serve_decode_torch.py",
    ROOT / "scripts" / "lm_train_phase.py",
    ROOT / "scripts" / "mixers_phase.py",
    ROOT / "scripts" / "train_phase.py",
    ROOT / "scripts" / "launch_phase.py",
    ROOT / "scripts" / "churn_ab.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_checked_files_cover_every_slice():
    """The scan covers the modules each slice added, the compiled
    trajectory's, the sweep's, the observability's and the LM training
    slice's among them."""
    checked = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    assert {"sim/engine.py", "sim/draws.py", "sim/sharded.py",
            "obs/__init__.py", "obs/profiling.py", "core/cwfl.py",
            "core/baselines.py", "core/clustering.py", "training/local.py",
            "strategies/base.py", "strategies/builtin.py",
            "kernels/cwfl_round.py", "kernels/ota_aggregate.py",
            "kernels/ref.py", "checkpoint/__init__.py",
            "checkpoint/ckpt.py", "obs/ledger.py", "obs/manifest.py",
            "obs/monitor.py", "obs/sink.py", "obs/stream.py",
            "obs/telemetry.py", "data/tokens.py",
            "training/dist_steps.py", "training/steps.py",
            "models/ssm.py", "models/moe.py", "models/xlstm.py",
            "configs/phi4_mini_3_8b.py", "configs/llama3_405b.py",
            "core/xla_math.py", "launch/__init__.py", "launch/dryrun.py",
            "launch/mesh.py", "launch/report.py",
            "launch/roofline.py"} <= checked
    assert ROOT / "examples" / "train_lm_cwfl_torch.py" in FILES
    assert ROOT / "examples" / "serve_decode_torch.py" in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_module_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
            "               for k, v in sys.modules.items() if v is not None)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
