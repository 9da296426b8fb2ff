"""The yardstick's counts against hand counts, the trace reduction on a
made-up trace, and the import rule."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT
from portbench import counts, harness, tracing


def _cfg(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())


def test_model_widths():
    assert counts.params_count(_cfg("mnist-mlp")) == 184_214
    assert counts.params_count(_cfg("cifar-cnn")) == 698_250


def test_model_flops_per_round():
    mnist, cifar = _cfg("mnist-mlp"), _cfg("cifar-cnn")
    # 2·(784·200 + 200·100 + 100·64 + 64·10) = 367,680 a sample forward.
    assert counts.forward_flops_per_sample(mnist) == 367_680
    assert counts.local_steps(mnist) == 18 and counts.local_steps(cifar) == 57
    # About 1.10 MFLOP a sample forward and backward, 66 GFLOP a round.
    assert counts.flops_per_round(mnist) == pytest.approx(66e9, rel=0.03)
    # About 202 MFLOP a sample, 10 TFLOP a round.
    assert 3 * counts.forward_flops_per_sample(cifar) == pytest.approx(
        202e6, rel=0.01)
    assert counts.flops_per_round(cifar) == pytest.approx(10e12, rel=0.03)


def test_kernel_bytes():
    d = counts.params_count(_cfg("mnist-mlp"))
    assert counts.cwfl_round_bytes(1, 50, 3, d) == pytest.approx(78.8e6,
                                                                 rel=1e-3)
    assert counts.cwfl_round_bytes(1, 50, 3, d) / 3.35e12 == pytest.approx(
        23.5e-6, rel=1e-2)
    assert counts.cwfl_round_bytes(40, 50, 3, d) == pytest.approx(3.15e9,
                                                                  rel=2e-3)
    assert counts.cwfl_round_bytes(1, 27, 3, 698_250) / 3.35e12 == \
        pytest.approx(50.86e-6, rel=1e-3)
    # 34 clients arrived in the round of the churn sweep of 8 measured.
    assert counts.channel_view_bytes(8, 50, 34) == 875_472


class _Event:
    """A raw profiler event as torch 2.11 has it: no ``activity_type``."""

    def __init__(self, name, device, activity, start, end):
        self._v = (name, device, activity, start, end)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4] - self._v[3]


class _EventWithActivity(_Event):
    def activity_type(self):
        return self._v[2]


class _Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


@pytest.mark.parametrize("event", [_Event, _EventWithActivity])
def test_trace_reduction(event):
    cpu, gpu = "DeviceType.CPU", "DeviceType.CUDA"
    events = [event(tracing.WINDOW, cpu, "user_annotation", 0, 1000),
              event("execute", cpu, "user_annotation", 0, 600),
              event("trace_compile", cpu, "user_annotation", 600, 1000),
              event("k1", gpu, "kernel", 100, 200),
              event("k1", gpu, "kernel", 150, 300),
              event("k2", gpu, "kernel", 500, 550),
              event("Memcpy HtoD", gpu, "gpu_memcpy", 700, 800),
              event("k2", gpu, "kernel", 1100, 1200)]     # outside
    t = tracing.reduce(_Prof(events))
    assert t["window_s"] == pytest.approx(1e-6)
    assert t["busy_s"] == pytest.approx((200 + 50 + 100) * 1e-9)
    assert t["kernels"] == 3
    assert tracing.kernel_stats(t, "k1") == (2, pytest.approx(125e-9))
    assert [g[0] for g in t["idle_gaps"][:2]] == ["execute", "trace_compile"]
    assert t["idle_gaps"][0][1] == pytest.approx(200e-9)


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert harness.forbidden_modules() == ["repro"]


def test_harness_and_reference_import_no_jax():
    """Import every module of the benchmark and the program's entries it
    drives, and look at what came in."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import importlib, portbench, portbench.harness\n"
        "for m in ('portbench.control', 'portbench.counts', "
        "'portbench.inputs', 'portbench.tracing', 'portbench.entries.scan', "
        "'portbench.entries.sweep', 'portbench.reference.fl', "
        "'portbench.reference.check', 'portbench.metrics._shared'):\n"
        "    importlib.import_module(m)\n"
        "import repro_torch.training, repro_torch.sim, repro_torch.core\n"
        "print(portbench.harness.forbidden_modules())\n"
        % (str(ROOT), str(ROOT / "src")))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"
