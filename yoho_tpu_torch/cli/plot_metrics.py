"""``yoho-torch plot-metrics`` (the JAX package's ``cli/plot_metrics.py``):
live training-metrics dashboard
(parity: ``train/tools/plot_metrics.py`` — lr / loss / val_loss panels,
log-scale losses, auto-refresh). Refresh is mtime-polling rather than a
watchdog dependency.

Usage: ``python -m yoho_tpu_torch.cli plot-metrics <name> <stage> [--root ...]
[--once]``; ``matplotlib`` is imported only when a plot is drawn.
"""

import argparse
import csv
from pathlib import Path


def _read_metrics(path: Path):
    updates, lrs, losses, val_updates, val_losses = [], [], [], [], []
    with open(path) as f:
        for row in csv.DictReader(f):
            try:
                updates.append(float(row["update"]))
                lrs.append(float(row["learning_rate"]))
                losses.append(float(row["loss"]))
            except (TypeError, ValueError):
                continue
            if row.get("val_loss"):
                val_updates.append(float(row["update"]))
                val_losses.append(float(row["val_loss"]))
    return updates, lrs, losses, val_updates, val_losses


def plot_live(file_path: Path, poll_seconds: float = 2.0, once: bool = False):
    import matplotlib

    if once:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(3, 1, figsize=(10, 12))
    plt.subplots_adjust(hspace=0.5)

    def update_plot():
        if not file_path.exists():
            return
        updates, lrs, losses, val_u, val_l = _read_metrics(file_path)
        for ax in axs:
            ax.clear()
        axs[0].plot(updates, lrs, linewidth=0.8)
        axs[0].set_title("Learning Rate")
        axs[0].set_xlabel("Update")
        axs[1].plot(updates, losses, linewidth=0.8)
        axs[1].set_yscale("log")
        axs[1].set_title("Loss")
        axs[1].set_xlabel("Update")
        axs[2].plot(val_u, val_l, linewidth=0.8)
        axs[2].set_yscale("log")
        axs[2].set_title("Validation Loss")
        axs[2].set_xlabel("Update")
        fig.canvas.draw_idle()

    update_plot()
    if once:
        out = file_path.with_suffix(".png")
        fig.savefig(out)
        print(f"Wrote {out}")
        return

    plt.ion()
    plt.show()
    last_mtime = 0.0
    try:
        while plt.fignum_exists(fig.number):
            if file_path.exists():
                mtime = file_path.stat().st_mtime
                if mtime != last_mtime:
                    last_mtime = mtime
                    update_plot()
            plt.pause(poll_seconds)
    except KeyboardInterrupt:
        pass


def main(argv=None):
    parser = argparse.ArgumentParser(prog="yoho-torch plot-metrics",
                                     description="Shows live plot of a training session")
    parser.add_argument("name", type=str)
    parser.add_argument("stage", type=int, choices=[0, 1, 2, 3, 4])
    parser.add_argument("--root", type=str, default="./sessions")
    parser.add_argument("--once", action="store_true",
                        help="Render a PNG next to the CSV and exit (headless)")
    args = parser.parse_args(argv)
    path = Path(args.root) / args.name / "stages" / str(args.stage) / "metrics.csv"
    plot_live(path, once=args.once)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
