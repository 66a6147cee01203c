"""Checkpoint-polling evaluator (port of
``tpu_resnet/evaluation/evaluator.py``, one device): poll the train dir for
a new checkpoint, load it, run the eval split, write ``Precision`` /
``Best_Precision`` / ``eval_loss`` to ``<train_dir>/eval/metrics.jsonl``
and the best so far to ``<train_dir>/eval/best_precision.json``, sleep
``train.eval_interval_secs``, repeat; ``train.eval_once`` evaluates the
newest checkpoint and returns. The whole eval split is evaluated; the short
last batch is padded and masked out. A checkpoint that does not load is
retried ``resilience.eval_restore_retries`` times with backoff, then
skipped and logged, as the reference's evaluator does. ImageNet's eval
batches arrive decoded on the device (``data/imagenet.py``
``eval_examples``). Each pass is an ``eval_pass`` span, each skipped step
an ``eval_restore_failed`` span, in ``<train_dir>/eval/events.jsonl``
(the trainer owns ``<train_dir>/events.jsonl``), stamped with the train
run's ``run_id``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional, Tuple

import torch

from tpu_resnet_torch import data as data_lib
from tpu_resnet_torch.data.augment import get_eval_preprocess
from tpu_resnet_torch.device import resolve_device
from tpu_resnet_torch.models import build_model
from tpu_resnet_torch.obs.manifest import read_run_id
from tpu_resnet_torch.obs.spans import SpanTracer
from tpu_resnet_torch.train import checkpoint
from tpu_resnet_torch.train.metrics_io import MetricsWriter
from tpu_resnet_torch.train.step import make_eval_step

log = logging.getLogger("tpu_resnet_torch")


def run_eval_pass(cfg, model, device: torch.device,
                  eval_step) -> Tuple[float, float, int]:
    """One full pass over the eval split → (precision, mean loss, count)."""
    correct = loss_sum = count = 0
    for images, labels in data_lib.eval_split_batches(
            cfg.data, cfg.train.eval_batch_size, device=device):
        c, ls, n = eval_step(model, torch.as_tensor(images, device=device),
                             torch.as_tensor(labels, device=device))
        correct, loss_sum, count = correct + c, loss_sum + ls, count + n
    count = int(count)
    return (float(correct) / max(count, 1), float(loss_sum) / max(count, 1),
            count)


def evaluate(cfg, device: Optional[str] = None) -> Optional[float]:
    """Continuous (or once) evaluation; returns the last precision."""
    device = resolve_device(device)
    model = build_model(cfg).to(device)
    eval_step = make_eval_step(cfg.data.num_classes,
                               get_eval_preprocess(cfg.data.dataset))
    eval_dir = os.path.join(cfg.train.train_dir, "eval")
    best_file = os.path.join(eval_dir, "best_precision.json")
    best = 0.0
    if os.path.exists(best_file):
        with open(best_file) as f:
            best = json.load(f)["best_precision"]
    metrics = MetricsWriter(eval_dir)
    spans = SpanTracer(eval_dir, run_id=read_run_id(cfg.train.train_dir))

    last_seen = precision = None
    try:
        while True:
            step = checkpoint.latest_step_in(cfg.train.train_dir)
            if step is None:
                log.info("no checkpoint yet in %s", cfg.train.train_dir)
            elif step != last_seen:
                last_seen = step
                if spans.run_id is None:  # the trainer started after us
                    spans.run_id = read_run_id(cfg.train.train_dir)
                saved = checkpoint.restore_with_retry(
                    cfg.train.train_dir, step,
                    retries=cfg.resilience.eval_restore_retries,
                    backoff_sec=cfg.resilience.eval_restore_backoff_sec)
                if saved is None:
                    log.error("skipping eval of checkpoint step %d: restore "
                              "failed repeatedly", step)
                    spans.event("eval_restore_failed", step=step)
                else:
                    checkpoint.load_state(model, saved)
                    t0 = time.perf_counter()
                    with spans.span("eval_pass", step=step) as attrs:
                        precision, loss, count = run_eval_pass(
                            cfg, model, device, eval_step)
                        attrs.update(precision=round(precision, 6),
                                     examples=count)
                    dt = time.perf_counter() - t0
                    best = max(best, precision)
                    with open(best_file, "w") as f:
                        json.dump({"best_precision": best, "step": step}, f)
                    metrics.write(step, {"Precision": precision,
                                         "Best_Precision": best,
                                         "eval_loss": loss})
                    log.info("eval @ step %d: precision %.4f best %.4f loss "
                             "%.4f (%.1fs, %d examples)", step, precision,
                             best, loss, dt, count)
            if cfg.train.eval_once:
                break
            time.sleep(cfg.train.eval_interval_secs)
    finally:
        spans.close()
        metrics.close()
    return precision
