"""Plot training metrics from JSON log lines (port of
``tortoise_tts_tpu/plot.py``; reference plot.py).

    python -m tortoise_tts_tpu_torch.plot --yaml config.yaml [--xs it] \
        [--ys loss loss.mel] [--out metrics.png]

Needs ``matplotlib``, imported when a plot is drawn.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def parse_logs(paths):
    """Every JSON object of the log files, one a line; a line may carry a
    prefix before its object ("INFO:...:{json}")."""
    rows = []
    for p in paths:
        for line in Path(p).read_text().splitlines():
            line = line.strip()
            if not line.startswith("{"):
                i = line.find("{")
                if i < 0:
                    continue
                line = line[i:]
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return rows


def plot(paths, xs="it", ys=("loss",), out="metrics.png", smooth=0.95):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    rows = parse_logs(paths)
    fig, ax = plt.subplots(figsize=(10, 5))
    for y in ys:
        pts = [(r[xs], r[y]) for r in rows if xs in r and y in r]
        if not pts:
            continue
        xvals, yvals = zip(*pts)
        # exponentially weighted smoothing (reference plot.py ewm)
        sm, acc = [], None
        for v in yvals:
            acc = v if acc is None else smooth * acc + (1 - smooth) * v
            sm.append(acc)
        ax.plot(xvals, sm, label=y)
    ax.set_xlabel(xs)
    ax.legend()
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser("tortoise_tts_tpu_torch.plot")
    parser.add_argument("--yaml", type=Path, default=None)
    parser.add_argument("--logs", type=Path, nargs="*", default=None)
    parser.add_argument("--xs", default="it")
    parser.add_argument("--ys", nargs="+", default=["loss"])
    parser.add_argument("--out", default="metrics.png")
    args = parser.parse_args(argv)
    paths = args.logs
    if not paths and args.yaml:
        from .config import Config
        paths = sorted(Config.load(args.yaml).log_dir.glob("*/log.txt"))
    print(plot(paths or [], args.xs, args.ys, args.out))


if __name__ == "__main__":
    main()
