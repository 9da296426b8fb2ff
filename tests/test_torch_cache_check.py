"""``chip_smoke.py``'s cache-entry check on the CPU, at the reduced Kimi K2
(MoE with the decode path's own routing) and the reduced Jamba (mamba
states, attention and MoE): each cache entry a decode step writes against
the one a prefill over the same tokens, routed as the decoded path was,
writes at the same position.  The real decoding agrees everywhere within
the check's f32 limit; a decoding that skips one step's cache write
(every layer forgets that token's keys, values or state) reads far above
it, at that position."""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer as tfm
from repro_torch.models.inputs import make_batch

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

P, N, DROP = 40, 8, 3


@pytest.fixture(scope="module", params=["kimi-k2-1t-a32b", "jamba-v0.1-52b"])
def decoded(request):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = get_config(request.param, reduced=True)
    params = tfm.init_params(0, cfg, device="cpu")
    batch = make_batch(1, cfg, P, 2, kind="prefill", device="cpu")
    gate = chip_smoke.decode_gate(params, batch, cfg, P, N)
    yield cfg, params, batch, gate
    torch.set_num_threads(threads)


def test_the_decoded_path_writes_the_prefill_entries(decoded):
    cfg, params, batch, gate = decoded
    out = chip_smoke.cache_entry_check(params, batch, cfg, P, N,
                                       gate["routes"], tokens=gate["tokens"])
    assert out["tokens_equal"]
    assert out["worst"] <= chip_smoke.CACHE_TOL["f32"]
    layers = cfg.num_periods * sum(s.mixer in ("attn", "mamba")
                                   for s in cfg.pattern)
    assert len(out["rel_l2"]) == layers
    assert all(len(d) == N for d in out["rel_l2"].values())


def test_a_dropped_cache_write_shows_at_its_own_position(decoded):
    """Every layer's entry at the dropped position reads far above the
    limit (an attention entry never written: 1.0), and the positions
    before it stay within the limit."""
    cfg, params, batch, gate = decoded
    out = chip_smoke.cache_entry_check(params, batch, cfg, P, N,
                                       gate["routes"], drop=P + DROP)
    tol = chip_smoke.CACHE_TOL["f32"]
    assert out["worst"] > 100 * tol
    for name, dist in out["rel_l2"].items():
        assert max(dist[:DROP]) <= tol, name
        assert dist[DROP] > 100 * tol, name
    attn = [name for name in out["rel_l2"]
            if cfg.pattern[int(name[1:name.index("[")])].mixer == "attn"]
    assert attn
    assert all(out["rel_l2"][name][DROP] == 1.0 for name in attn)
