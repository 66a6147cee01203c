"""Training and eval curves from ``metrics.jsonl`` (port of
``tpu_resnet/tools/plot_metrics.py``):

    python -m tpu_resnet_torch plot --dir /tmp/run1 --out /tmp/run1/curves.png

Reads ``<dir>/metrics.jsonl`` (the train series: loss, precision, lr,
steps_per_sec, the step breakdown, mfu, ``hbm_*``, written by
``train/metrics_io.py``) and, when present, ``<dir>/eval/metrics.jsonl``
(Precision and Best_Precision by restored step), and renders one PNG on
matplotlib's Agg backend: precision, loss, throughput, the step-time
breakdown (data-wait fraction and the sampled device step time,
``obs/breakdown.py``) and the MFU / step-time percentile panel (the mfu
gauge, the ``train_step_ms`` percentiles and ``hbm_utilization``).
``--csv`` also writes the merged series as CSV, byte for byte the
reference's for the same files; it is written before matplotlib is
imported, so a machine without matplotlib still gets it (and the command
then fails for the PNG).
"""

from __future__ import annotations

import os
from typing import List, Optional


def load_series(path: str) -> List[dict]:
    """metrics.jsonl → list of records (torn tail lines skipped; the
    tolerance policy lives in obs/spans.py::load_jsonl)."""
    from tpu_resnet_torch.obs.spans import load_jsonl

    return load_jsonl(path, "step")


def _column(series: List[dict], key: str):
    xs = [r["step"] for r in series if key in r]
    ys = [r[key] for r in series if key in r]
    return xs, ys


def write_csv(train: List[dict], evals: List[dict], path: str) -> None:
    import csv

    keys: List[str] = ["step"]
    for rec in train + evals:
        for k in rec:
            if k not in keys and k != "wall":
                keys.append(k)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["series"] + keys,
                           extrasaction="ignore")
        w.writeheader()
        for rec in train:
            w.writerow({"series": "train", **rec})
        for rec in evals:
            w.writerow({"series": "eval", **rec})


def plot(train_dir: str, out: Optional[str] = None,
         csv_out: Optional[str] = None) -> str:
    train = load_series(os.path.join(train_dir, "metrics.jsonl"))
    evals = load_series(os.path.join(train_dir, "eval", "metrics.jsonl"))
    if not train and not evals:
        raise FileNotFoundError(f"no metrics.jsonl under {train_dir}")
    out = out or os.path.join(train_dir, "curves.png")
    if csv_out:  # written first: it needs no matplotlib
        write_csv(train, evals, csv_out)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 5, figsize=(25, 4))
    ax = axes[0]
    for key, label in [("precision", "train precision"),
                       ("Precision", None)]:
        src = train if key == "precision" else evals
        xs, ys = _column(src, key)
        if xs:
            ax.plot(xs, ys, label=label or "eval Precision", marker="o"
                    if src is evals else None, markersize=3)
    xs, ys = _column(evals, "Best_Precision")
    if xs:
        ax.plot(xs, ys, label="eval Best_Precision", linestyle="--")
    ax.set_xlabel("step")
    ax.set_title("precision")
    ax.set_ylim(0, 1.02)
    ax.legend()
    ax.grid(alpha=0.3)

    ax = axes[1]
    for src, key, label in [(train, "loss", "train loss"),
                            (evals, "eval_loss", "eval loss")]:
        xs, ys = _column(src, key)
        if xs:
            ax.plot(xs, ys, label=label)
    ax.set_xlabel("step")
    ax.set_title("loss")
    if ax.get_legend_handles_labels()[0]:
        ax.legend()
    ax.grid(alpha=0.3)

    ax = axes[2]
    for key in ("steps_per_sec", "images_per_sec_per_chip"):
        xs, ys = _column(train, key)
        if xs:
            ax.plot(xs, ys, label=key)
    ax.set_xlabel("step")
    ax.set_title("throughput")
    if ax.get_legend_handles_labels()[0]:
        ax.legend()
    ax.grid(alpha=0.3)

    ax = axes[3]
    xs, ys = _column(train, "data_wait_frac")
    if xs:
        ax.plot(xs, [100 * y for y in ys], label="data wait %",
                color="tab:red")
    ax2 = ax.twinx()
    xs2, ys2 = _column(train, "device_step_sec_sampled")
    if xs2:
        ax2.plot(xs2, [1e3 * y for y in ys2], linestyle="--",
                 color="tab:orange", label="device step ms (sampled)")
        ax2.set_ylabel("ms")
    ax.set_xlabel("step")
    ax.set_ylim(0, 102)
    title = "step-time breakdown"
    compile_s = next((r["compile_seconds"] for r in train
                      if "compile_seconds" in r), None)
    if compile_s is not None:
        title += f" (compile {compile_s:.1f}s)"
    ax.set_title(title)
    h1, l1 = ax.get_legend_handles_labels()
    h2, l2 = ax2.get_legend_handles_labels()
    if h1 or h2:
        ax.legend(h1 + h2, l1 + l2, loc="upper right")
    ax.grid(alpha=0.3)

    # MFU + step-time percentile panel (obs/mfu.py gauges and the
    # train_step_ms histogram percentiles the loop records).
    ax = axes[4]
    xs, ys = _column(train, "mfu")
    if xs:
        ax.plot(xs, [100 * y for y in ys], color="tab:green",
                label="MFU %")
        ax.set_ylim(0, max(102, 110 * max(ys)))
    # Device-memory utilization (obs/memory.py gauges) next to MFU;
    # absent on the CPU.
    xs, ys = _column(train, "hbm_utilization")
    if xs:
        ax.plot(xs, [100 * y for y in ys], color="tab:blue",
                linestyle="-.", label="HBM util %")
    ax.set_xlabel("step")
    ax3 = ax.twinx()
    for key, style in (("train_step_ms_p50", "-"),
                       ("train_step_ms_p95", "--"),
                       ("train_step_ms_p99", ":")):
        xs3, ys3 = _column(train, key)
        if xs3:
            ax3.plot(xs3, ys3, linestyle=style, color="tab:purple",
                     alpha=0.8, label=key.replace("train_step_ms_", "step "))
    if ax3.get_legend_handles_labels()[0]:
        ax3.set_ylabel("step ms")
    title = "MFU / step-time percentiles"
    flops = next((r["model_flops_per_sec"] for r in reversed(train)
                  if "model_flops_per_sec" in r), None)
    if flops is not None:
        title += f" ({flops / 1e9:.1f} GFLOP/s)"
    hbm_peak = next((r["hbm_bytes_peak"] for r in reversed(train)
                     if "hbm_bytes_peak" in r), None)
    if hbm_peak:
        title += f" (HBM peak {hbm_peak / 2**30:.1f} GiB)"
    ax.set_title(title)
    h1, l1 = ax.get_legend_handles_labels()
    h3, l3 = ax3.get_legend_handles_labels()
    if h1 or h3:
        ax.legend(h1 + h3, l1 + l3, loc="upper right")
    ax.grid(alpha=0.3)

    fig.tight_layout()
    fig.savefig(out, dpi=110)
    plt.close(fig)
    return out
