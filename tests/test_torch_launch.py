"""The one-card launch tools (`repro_torch.launch`) against JAX's
`repro.launch`: the dry run's configuration and long-shape policy, the
model-flop counts, the report tables on the same records; and the port's
own plan on the meta device (its cuts on a small card, Kimi K2's refusal,
whisper's skip), the roofline's counts and a run of each step kind on the
CPU at reduced configurations.

JAX's ``dryrun`` and ``roofline`` set ``XLA_FLAGS`` to 512 host devices
when imported; they are imported inside a test, after the backend is up
(where the flag changes nothing), with the variable restored after."""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.launch import dryrun, mesh, report, roofline
from repro_torch.models.config import INPUT_SHAPES, InputShape

torch.set_num_threads(1)

SHAPES = list(INPUT_SHAPES)


@pytest.fixture
def jax_launch(monkeypatch):
    """JAX's launch modules, imported with the backend already up and
    ``XLA_FLAGS`` put back as it was afterwards."""
    import os

    jax.devices()
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import dryrun as jdryrun
    from repro.launch import mesh as jmesh
    from repro.launch import report as jreport
    from repro.launch import roofline as jroofline
    return jdryrun, jroofline, jreport, jmesh


def _reduced(arch, shape_name):
    shape = INPUT_SHAPES[shape_name]
    cfg = get_config(arch, reduced=True).replace(**dryrun.DTYPE_OVERRIDES)
    if shape.kind == "train":
        cfg = cfg.replace(remat=True)
    return cfg


@pytest.mark.parametrize("shape_name", SHAPES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_prepare_cfg_matches_jax_field_for_field(jax_launch, arch,
                                                 shape_name):
    """JAX's base `prepare_cfg` on a 1 × 1 mesh (its ``for_cost`` and
    ``variant`` hints have no one-card counterpart)."""
    jdryrun, _, _, jmesh = jax_launch
    one = jmesh.make_local_mesh(1, 1)
    shape = INPUT_SHAPES[shape_name]
    want = jdryrun.prepare_cfg(arch, shape, one)
    got = dryrun.prepare_cfg(arch, shape)
    assert dataclasses.asdict(got) == dataclasses.asdict(want), (
        arch, shape_name)


def test_long_shape_policy_is_jax(jax_launch):
    jdryrun = jax_launch[0]
    assert dryrun.LONG_NATIVE == jdryrun.LONG_NATIVE
    assert dryrun.LONG_SWA == jdryrun.LONG_SWA
    assert dryrun.LONG_SKIP == jdryrun.LONG_SKIP
    assert dryrun.SWA_WINDOW == jdryrun.SWA_WINDOW
    assert dryrun.DTYPE_OVERRIDES == jdryrun.DTYPE_OVERRIDES
    assert INPUT_SHAPES == {k: InputShape(*dataclasses.astuple(v))
                            for k, v in jdryrun.INPUT_SHAPES.items()}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_and_slstm_flops_match_jax(jax_launch, arch):
    """`model_flops` and `_slstm_flops` at every input shape, exactly."""
    jdryrun, jroofline, _, jmesh = jax_launch
    one = jmesh.make_local_mesh(1, 1)
    for name, shape in INPUT_SHAPES.items():
        jshape = jdryrun.INPUT_SHAPES[name]
        assert roofline.model_flops(arch, shape) == jroofline.model_flops(
            arch, jshape)
        assert roofline._slstm_flops(
            dryrun.prepare_cfg(arch, shape), shape) == \
            jroofline._slstm_flops(jdryrun.prepare_cfg(
                arch, jshape, one, for_cost=True), jshape)


def _jax_records():
    dry = [{"arch": "qwen2.5-3b", "shape": "train_4k", "mesh": "pod1",
            "status": "ok", "compile_s": 12.5, "microbatches": 8,
            "mem": {"peak_per_device": 5 * 2 ** 30},
            "collectives": {"all-reduce": {"count": 4, "bytes": 3 * 2 ** 30},
                            "all-gather": {"count": 9, "bytes": 2 ** 29},
                            "all-to-all": {"count": 1, "bytes": 10}}},
           {"arch": "whisper-tiny", "shape": "long_500k", "mesh": "pod1",
            "status": "skip", "reason": dryrun.LONG_SKIP["whisper-tiny"]},
           {"arch": "gemma2-9b", "shape": "decode_32k", "mesh": "pod2",
            "status": "fail", "error": "boom"}]
    roof = [{"arch": "qwen2.5-3b", "shape": "train_4k", "status": "ok",
             "t_compute_s": 0.0123, "t_memory_s": 0.0045,
             "t_collective_s": 0.0067, "dominant": "compute",
             "model_flops": 1.234e18, "useful_ratio": 0.81,
             "microbatches": 8},
            {"arch": "qwen2.5-3b", "shape": "train_4k", "variant": "noact",
             "status": "fail"},
            {"arch": "whisper-tiny", "shape": "long_500k", "status": "skip",
             "reason": dryrun.LONG_SKIP["whisper-tiny"]}]
    return dry, roof


def test_report_tables_match_jax(jax_launch, tmp_path):
    """`dryrun_table` and `roofline_table` render JAX's records as JAX's
    do, character for character, and say the same where there are
    none."""
    jreport = jax_launch[2]
    dry, roof = _jax_records()
    (tmp_path / "d.json").write_text(json.dumps(dry))
    (tmp_path / "r.json").write_text(json.dumps(roof))
    for fn in ("dryrun_table", "roofline_table"):
        for path in (tmp_path / ("d.json" if fn == "dryrun_table"
                                 else "r.json"), tmp_path / "none.json"):
            assert getattr(report, fn)(str(path)) == \
                getattr(jreport, fn)(str(path))


def test_unmasked_pairs_closed_form():
    for S in (1, 7, 64, 300):
        for window in (0, 1, 5, 64, 400):
            brute = sum(min(q + 1, window) if window > 0 else q + 1
                        for q in range(S))
            assert roofline.unmasked_pairs(S, window) == brute
    assert roofline.unmasked_pairs(5, causal=False, Skv=7) == 35


def test_every_row_has_a_plan_at_the_cards_memory():
    """All 40 rows at an H100 80GB HBM3's memory: each ``ok`` with a cut
    that fits, ``does_not_fit`` with its bytes, or ``skip``; only Kimi K2
    × train_4k does not fit (one of its layers holds 38.8 GB of bf16
    params and the donated step 2P), and only whisper × long_500k is
    skipped, with JAX's reason."""
    status = {}
    for arch in ARCH_NAMES:
        for shape in SHAPES:
            r = dryrun.plan(arch, shape)
            status[(arch, shape)] = r["status"]
            if r["status"] == "ok":
                assert r["bytes"]["total"] <= r["budget_bytes"]
                assert r["seq_len"] == INPUT_SHAPES[shape].seq_len
                assert r["num_layers"] % len(get_config(arch).pattern) == 0
            elif r["status"] == "skip":
                assert r["reason"] == dryrun.LONG_SKIP[arch]
    assert [k for k, v in status.items() if v == "does_not_fit"] == [
        ("kimi-k2-1t-a32b", "train_4k")]
    assert [k for k, v in status.items() if v == "skip"] == [
        ("whisper-tiny", "long_500k")]


def test_kimi_k2_train_does_not_fit_at_80_gb():
    r = dryrun.plan("kimi-k2-1t-a32b", "train_4k", card_bytes=80e9)
    assert r["status"] == "does_not_fit"
    assert r["reduced"] == {"global_batch": "256→1", "num_layers": "61→1"}
    b = r["bytes"]
    assert b["params"] > 38e9 and b["grads"] == b["params"]
    assert b["total"] > 80e9 > r["budget_bytes"]


def test_whisper_long_500k_is_skipped_with_jaxs_reason(jax_launch):
    r = dryrun.plan("whisper-tiny", "long_500k")
    assert r["status"] == "skip"
    assert r["reason"] == jax_launch[0].LONG_SKIP["whisper-tiny"]


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
def test_plan_cuts_batch_then_depth_on_a_small_card(shape_name):
    """At a reduced configuration and a card sized from its own
    reckoning: the batch is halved until the row fits; on a smaller card
    the batch is 1 and whole periods go; on a tiny one it does not fit,
    its bytes given.  Every width and the sequence stay."""
    arch = "gemma2-9b"
    cfg = _reduced(arch, shape_name).replace(num_layers=8)
    shape = INPUT_SHAPES[shape_name]

    def total(B, periods):
        c = cfg.replace(num_layers=periods * len(cfg.pattern))
        s = InputShape(shape.name, shape.seq_len, B, shape.kind)
        M = (dryrun.ds.auto_microbatches(c, s) if shape.kind == "train"
             else 1)
        return dryrun.reckon(c, s, M)["total"]

    margin = dryrun.MARGIN
    periods = cfg.num_periods
    card = (total(4, periods) + 1) / (1 - margin)
    r = dryrun.plan(arch, shape_name, cfg=cfg, card_bytes=card)
    assert r["status"] == "ok" and r["global_batch"] == 4
    assert r["reduced"] == {"global_batch": f"{shape.global_batch}→4"}
    card = (total(1, 2) + 1) / (1 - margin)
    r = dryrun.plan(arch, shape_name, cfg=cfg, card_bytes=card)
    assert r["status"] == "ok" and r["global_batch"] == 1
    assert r["num_layers"] == 2 * len(cfg.pattern)
    assert r["reduced"]["num_layers"] == f"8→{2 * len(cfg.pattern)}"
    r = dryrun.plan(arch, shape_name, cfg=cfg, card_bytes=1e6)
    assert r["status"] == "does_not_fit"
    assert r["bytes"]["total"] > r["budget_bytes"]
    assert r["num_layers"] == len(cfg.pattern) and r["global_batch"] == 1


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_meta_specs_match_jax(jax_launch, arch):
    """The meta-device batch and decode caches have the shapes of JAX's
    `train_batch_specs`, `prefill_batch_specs` and `decode_cache_specs`
    (a window's ring included) at the reduced configuration."""
    from repro.configs import get_config as jget
    from repro.models import inputs as jinputs
    from repro.models import transformer as jtfm

    cfg = get_config(arch, reduced=True)
    jcfg = jget(arch, reduced=True)
    shape = InputShape("s", 40, 3, "train")
    for kind, fn in (("train", jinputs.train_batch_specs),
                     ("prefill", jinputs.prefill_batch_specs)):
        got = dryrun.batch_specs(cfg, 40, 3, kind)
        want = fn(jcfg, shape)
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: tuple(v.shape) for k, v in want.items()}
    for window in (None, 16):
        got = dryrun.decode_cache_specs(dryrun.ds.windowed_config(
            cfg, window), 3, 64)
        jrun = jcfg
        if window:   # JAX's `make_decode_step(window_override=)` rule
            jrun = jcfg.replace(pattern=tuple(dataclasses.replace(
                s, window=(min(s.window, window) or window)
                if s.mixer == "attn" else 0) for s in jcfg.pattern))
        want = jtfm.decode_cache_specs(jrun, 3, 64)
        assert jax.tree.map(lambda x: tuple(x.shape), want) == {
            b: {"mixer": {k: tuple(v.shape) for k, v in c["mixer"].items()}}
            for b, c in got.items()}, window


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "jamba-v0.1-52b",
                                  "qwen3-moe-235b-a22b", "whisper-tiny"])
def test_counted_flops_extend_linearly(arch):
    """The counted matmuls of a prefill and a training step at 768
    positions equal their linear extension from `COUNT_SEQ`."""
    for kind in ("prefill", "train"):
        cfg = _reduced(arch, "train_4k" if kind == "train"
                       else "prefill_32k")
        direct = roofline._counted(cfg, InputShape("s", 768, 2, kind),
                                   None)
        got = roofline.step_flops(cfg, InputShape("s", 768, 2, kind))
        assert math.isclose(got["counted"], direct, rel_tol=1e-9), kind
        assert got["total"] == got["counted"] + got["attention"] + \
            got["slstm"]


def test_attention_flops_count_masks_and_training():
    cfg = _reduced("gemma2-9b", "prefill_32k")
    shape = InputShape("s", 100, 2, "prefill")
    per = 4.0 * cfg.hd * cfg.num_heads * 2
    pairs = sum(roofline.unmasked_pairs(100, s.window) for s in cfg.pattern)
    assert roofline.attention_flops(cfg, shape) == per * pairs * \
        cfg.num_periods
    train = InputShape("s", 100, 2, "train")
    assert roofline.attention_flops(cfg.replace(remat=True), train) == \
        4.5 * roofline.attention_flops(cfg, shape)
    assert roofline.attention_flops(cfg, InputShape("s", 100, 2,
                                                    "decode")) == 0.0


@pytest.mark.parametrize("arch,shape_name", [
    ("qwen2.5-3b", "train_4k"), ("qwen2.5-3b", "decode_32k"),
    ("qwen2.5-3b", "long_500k"), ("jamba-v0.1-52b", "long_500k")])
def test_run_one_on_the_cpu_at_reduced_configurations(arch, shape_name):
    """`run_one` plans, builds and runs each step kind through the port's
    builders on the CPU at a reduced configuration (qwen2.5-3b's long
    shape windowed at `SWA_WINDOW`, Jamba's native): a finite output, the
    roofline's terms, and a share under 1; no peak is measured off the
    card."""
    cfg = _reduced(arch, shape_name)
    r = dryrun.run_one(arch, shape_name, device="cpu", reps=1,
                       max_batch=1, cfg=cfg)
    assert r["status"] == "ok", r.get("error")
    assert r["run"]["finite"] and r["run"]["peak_bytes"] is None
    assert r["window_override"] == (dryrun.SWA_WINDOW if (
        shape_name == "long_500k" and arch in dryrun.LONG_SWA) else None)
    roof = r["roofline"]
    assert roof["bound"] in ("operations", "bytes")
    assert 0 < roof["share"] <= 1 and roof["mfu"] > 0
    assert roof["card"] == {"platform": "cpu"}


def test_card_table_renders_each_status(tmp_path):
    rows = [dryrun.plan("kimi-k2-1t-a32b", "train_4k"),
            dryrun.plan("whisper-tiny", "long_500k"),
            dryrun.plan("qwen2.5-3b", "long_500k")]
    ran = dict(dryrun.plan("phi4-mini-3.8b", "long_500k"),
               run={"peak_bytes": 9.5e9, "step_s": 0.0625},
               roofline={"bound": "bytes", "mfu": 0.0012, "share": 0.25})
    path = tmp_path / "rows.json"
    path.write_text(json.dumps(rows + [ran]))
    table = report.card_table(str(path)).splitlines()
    assert len(table) == 2 + 4
    assert "does_not_fit" in table[2] and "global_batch 256→1" in table[2]
    assert "| phi4-mini-3.8b | long_500k | ok | none |" in table[3]
    assert "9.50 | 0.0625 | bytes | 0.001 | 25.0 % |" in table[3]
    assert "planned" in table[4] and "skip" in table[5]
    assert report.card_table(str(tmp_path / "none.json")).startswith("_")


def test_no_production_mesh_on_one_card():
    with pytest.raises(NotImplementedError, match="one-card dry run"):
        mesh.make_production_mesh()
    with pytest.raises(NotImplementedError, match="512"):
        mesh.make_production_mesh(multi_pod=True)
    assert mesh.device_record() == {"platform": "cpu"}


def test_dryrun_main_plans_resumably(tmp_path, capsys):
    """``--meta-only --device cpu``: the rows JSON, skipped on a rerun."""
    out = tmp_path / "rows.json"
    argv = ["--arch", "whisper-tiny", "kimi-k2-1t-a32b", "--shape",
            "long_500k", "train_4k", "--meta-only", "--device", "cpu",
            "--out", str(out)]
    with pytest.raises(SystemExit) as e:
        dryrun.main(argv)
    assert e.value.code == 0
    rows = json.loads(out.read_text())
    assert {(r["arch"], r["shape"]): r["status"] for r in rows} == {
        ("whisper-tiny", "long_500k"): "skip",
        ("whisper-tiny", "train_4k"): "ok",
        ("kimi-k2-1t-a32b", "long_500k"): "ok",
        ("kimi-k2-1t-a32b", "train_4k"): "does_not_fit"}
    capsys.readouterr()
    with pytest.raises(SystemExit):
        dryrun.main(argv)
    assert "[dryrun] whisper" not in capsys.readouterr().out
    assert np.all([r["status"] != "fail" for r in rows])
