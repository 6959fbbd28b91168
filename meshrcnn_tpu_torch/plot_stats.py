"""Plot the per-epoch meter averages of a .st stats file (counterpart of the
JAX package's plot_stats.py; reference: plot_stats.py:5-27).

    python -m meshrcnn_tpu_torch.plot_stats --statsPath <dir>/stats_0.st [--out prefix]

One figure a meter of ``utils/meters.load_stats``; with ``--out`` each is
saved as ``<out>_<key>.png`` (matplotlib's Agg backend), else shown. Reads
the stats files of ``meshrcnn_tpu_torch.train`` and ``train_backbone``. It
plots on the host and runs nothing on a device, so it has no ``--device``.
"""
from __future__ import annotations

import argparse

parser = argparse.ArgumentParser("training stats plotting script")
parser.add_argument("--statsPath", type=str, required=True, help="path to a .st file")
parser.add_argument("--out", type=str, default=None,
                    help="save the figures under this prefix instead of showing them")


def main(argv=None) -> list:
    """Plot as the flags in ``argv`` say; returns the files written."""
    options = parser.parse_args(argv)
    import matplotlib
    if options.out:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from meshrcnn_tpu_torch.utils.meters import load_stats

    written = []
    stats = load_stats(options.statsPath)
    for key, rec in stats.items():
        history = rec["history"] if isinstance(rec, dict) else rec
        if not history:
            continue
        plt.figure()
        plt.plot(range(len(history)), history)
        plt.title(rec["name"] if isinstance(rec, dict) else key)
        plt.xlabel("epoch")
        plt.ylabel("epoch average")
        if options.out:
            plt.savefig(f"{options.out}_{key}.png")
            written.append(f"{options.out}_{key}.png")
    if not options.out:
        plt.show()
    return written


if __name__ == "__main__":
    main()
