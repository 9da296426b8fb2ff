"""Reproduce the paper's Figure 2 / Table I experiment grid (scaled) with
the PyTorch port — the twin of ``examples/paper_fig2.py``.

    PYTHONPATH=src python examples/paper_fig2_torch.py          # scaled grid
    PYTHONPATH=src python examples/paper_fig2_torch.py --fast   # 4 curves
    PYTHONPATH=src python examples/paper_fig2_torch.py --full   # paper scale
    PYTHONPATH=src python examples/paper_fig2_torch.py --fast --device cpu

Runs on the GPU unless ``--device`` names another torch device.  The port
draws from its own random streams (torch's, not JAX's), so its curves are
the JAX script's in distribution, not digit for digit.  ``--out PATH``
writes the rows as JSON.
"""
import argparse

from repro_torch.paper import fig2_accuracy
from repro_torch.paper.common import BenchScale


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--out", default=None, help="write the rows here (JSON)")
    args = ap.parse_args(argv)
    scale = BenchScale.full() if args.full else BenchScale()
    rows = fig2_accuracy.run(scale, out_path=args.out,
                             subset=4 if args.fast else None,
                             device=args.device)
    print("\nsummary (final accuracy):")
    for r in rows:
        print(f"  {r['dataset']:6s} {'iid' if r['iid'] else 'noniid':6s} "
              f"{r['label']:14s} {r['final_acc']:.3f}")
    return rows


if __name__ == "__main__":
    main()
