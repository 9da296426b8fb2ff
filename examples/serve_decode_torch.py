"""Batched serving demo on the PyTorch port: prefill + greedy decode with the
delta-cache engine (read-only caches inside the step; the loop owns the
cache writes), through `repro_torch.training.dist_steps`'
``make_prefill_step`` and ``make_decode_step``.  The twin of
``examples/serve_decode.py``.

    PYTHONPATH=src python examples/serve_decode_torch.py --arch gemma2-9b
    PYTHONPATH=src python examples/serve_decode_torch.py --device cpu

Reduced configurations, as the JAX example serves them; ``--window`` the
long-context sliding-window variant (``window_override``).  It runs on the
card unless ``--device cpu`` is given.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.config import InputShape  # noqa: E402
from repro_torch.models.inputs import make_batch  # noqa: E402
from repro_torch.training.dist_steps import (make_decode_step,  # noqa: E402
                                             make_prefill_step)
from repro_torch.training.serve import (apply_cache_deltas,  # noqa: E402
                                        pad_caches)
from repro_torch.utils.device import resolve_device  # noqa: E402


def serve(params, batch, cfg, tokens: int, window=None):
    """Prefill ``batch``, then ``tokens`` greedy decode steps against a
    cache of prompt + tokens positions (windowed layers: a ring of the
    window).  Returns ``(tokens (B, tokens), last logits (B, 1, V))``."""
    prompt_len = batch["tokens"].shape[1]
    if cfg.frontend == "vision_stub":
        prompt_len += cfg.prefix_tokens
    cache_len = prompt_len + tokens
    shape = InputShape("serve", cache_len, batch["tokens"].shape[0],
                       "decode")
    prefill = make_prefill_step(cfg, shape)
    decode = make_decode_step(cfg, shape, window_override=window)
    logits, caches = prefill(params, batch)
    caches = pad_caches(caches, decode.cfg, cache_len, prompt_len)
    enc_kv = None
    if cfg.frontend == "audio_stub":
        enc_kv = tfm.encoder_kv(tfm._first_cross_params(params, cfg),
                                tfm._encode_audio(params, batch, cfg), cfg)
    out = []
    for pos in range(prompt_len, cache_len):
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
        logits, deltas = decode(params, nxt, caches, pos, enc_kv)
        caches = apply_cache_deltas(caches, deltas, pos, decode.cfg)
        out.append(nxt[:, 0])
    return torch.stack(out, dim=1), logits


def config(arch: str, full: bool = False, layers=None, dtype=None):
    """The served configuration: reduced unless ``full``; ``layers`` cuts
    the depth, ``dtype`` sets the params' and compute dtype."""
    cfg = get_config(arch, reduced=not full)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    if dtype:
        cfg = cfg.replace(param_dtype=dtype, compute_dtype=dtype)
    return cfg


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", choices=ARCH_NAMES)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--window", type=int, default=None,
                    help="serving-time sliding window (window_override)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = config(args.arch)
    print(f"serving {args.arch} (reduced): {cfg.num_layers}L "
          f"d={cfg.d_model} pattern={[s.mixer for s in cfg.pattern]} "
          f"on {device}")
    params = tfm.init_params(0, cfg, device=device)
    batch = make_batch(1, cfg, args.prompt_len, args.batch, kind="prefill",
                       device=device)

    t0 = time.time()
    toks, last_logits = serve(params, batch, cfg, args.tokens, args.window)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    print(f"decoded {args.batch}×{args.tokens} tokens in {dt:.1f}s "
          f"({args.batch * args.tokens / dt:.1f} tok/s on {device})")
    for b in range(min(args.batch, 2)):
        print(f"  seq{b}: {toks[b].tolist()}")
    assert bool(torch.isfinite(last_logits.float()).all())
    print("finite logits ✓  (greedy continuation of random-weight model)")
    return {"tokens": toks, "logits": last_logits, "seconds": dt}


if __name__ == "__main__":
    main()
