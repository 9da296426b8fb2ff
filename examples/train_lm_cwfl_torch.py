"""End-to-end driver of the PyTorch port: train a transformer LM with
CWFL gradient aggregation — the twin of ``examples/train_lm_cwfl.py``.

The shard-mode integration: clients are data-parallel groups; the CWFL
consensus enters as per-example loss weights and channel noise
(`repro_torch.training.dist_steps.make_train_step`).  Data is the
synthetic Markov token stream.  Attention runs through the hand-written
flash-attention kernels on the card, forward and backward; on the CPU
through their plain versions.

Default: a ~6M-parameter model, 300 steps.  ``--large`` trains a
~100M-parameter model.

    PYTHONPATH=src python examples/train_lm_cwfl_torch.py [--steps 300]
    PYTHONPATH=src python examples/train_lm_cwfl_torch.py --device cpu

The port draws from torch's random streams, not JAX's, so its numbers
are the JAX script's in distribution, not digit for digit.
"""
import argparse
import math
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.data import make_token_dataset
from repro_torch.dist.fl_integration import make_fl_plan
from repro_torch.models.config import ArchConfig, InputShape, LayerSpec
from repro_torch.models.transformer import count_params, init_params
from repro_torch.optim import sgd
from repro_torch.training import dist_steps as ds
from repro_torch.utils.device import resolve_device


def lm_config(large: bool) -> ArchConfig:
    """The JAX example's two models: lm-100m (``large``) or lm-6m."""
    if large:   # ~100M params
        return ArchConfig(name="lm-100m", arch_type="dense", num_layers=12,
                          d_model=768, num_heads=12, num_kv_heads=4,
                          d_ff=2048, vocab_size=32768,
                          pattern=(LayerSpec(),), tie_embeddings=True)
    return ArchConfig(name="lm-6m", arch_type="dense", num_layers=4,
                      d_model=256, num_heads=4, num_kv_heads=2, d_ff=768,
                      vocab_size=4096, pattern=(LayerSpec(),),
                      tie_embeddings=True)


def run(cfg: ArchConfig, plan, params, data: torch.Tensor, *, steps: int,
        batch: int, lr: float, draws: Optional[Callable] = None,
        seed: int = 3, log_every: int = 25) -> dict:
    """Train ``params`` for ``steps`` shard-mode steps (one microbatch,
    as the JAX example) on batches of ``batch`` sequences of ``data``
    ((N, seq + 1) tokens), printing as the JAX example prints.

    ``draws``: ``None`` (batch indices and channel noise from a generator
    seeded with ``seed`` on the data's device), or ``step -> (indices
    (batch,), noise)`` with ``noise`` one unit-normal tensor a leaf
    (JAX's ``k_it`` and ``k_noise`` draws replayed).  Returns ``{"params",
    "ce" (one a step), "seconds"}``."""
    shape = InputShape("train", data.shape[1] - 1, batch, "train")
    step_fn = ds.make_train_step(cfg, shape, plan=plan, lr=lr,
                                 microbatches=1)
    opt_state = sgd(lr).init(params)
    if draws is None:
        gen = torch.Generator(data.device).manual_seed(seed)

        def draws(step):
            return (torch.randint(0, data.shape[0], (batch,), generator=gen,
                                  device=data.device), gen)

    ces = []
    t0 = time.time()
    for step in range(steps):
        idx, noise = draws(step)
        seqs = data[idx]
        params, opt_state, metrics = step_fn(
            params, opt_state, {"tokens": seqs[:, :-1],
                                "labels": seqs[:, 1:]}, noise)
        ces.append(metrics["ce"])
        if log_every and (step % log_every == 0 or step == steps - 1):
            print(f"step {step:4d}  ce={float(metrics['ce']):.4f}  "
                  f"({(time.time() - t0):.0f}s)")
    if data.device.type == "cuda":
        torch.cuda.synchronize(data.device)
    return {"params": params, "ce": [float(c) for c in ces],
            "seconds": time.time() - t0}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--large", action="store_true")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--snr-db", type=float, default=40.0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="cpu, cuda (default: the GPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = lm_config(args.large)
    print(f"model: {cfg.name}  params={count_params(cfg)/1e6:.1f}M")
    plan = make_fl_plan(args.clients, min(3, args.clients), 0,
                        snr_db=args.snr_db, device=device)
    print(f"CWFL plan: {args.clients} clients, clusters="
          f"{plan.assignment.tolist()}, channel-noise std="
          f"{plan.noise_std:.2e}")
    data = make_token_dataset(1, cfg.vocab_size, num_sequences=4096,
                              seq_len=args.seq, device=device)
    params = init_params(2, cfg, device=device)
    out = run(cfg, plan, params, data, steps=args.steps, batch=args.batch,
              lr=args.lr)
    uniform = math.log(cfg.vocab_size)
    print(f"final ce {out['ce'][-1]:.3f} vs uniform {uniform:.3f}")
    if args.ckpt:
        path = save_checkpoint(args.ckpt, args.steps, out["params"])
        print("checkpoint:", path)
    return out


if __name__ == "__main__":
    main()
