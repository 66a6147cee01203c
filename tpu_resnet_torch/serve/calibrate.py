"""Calibration of the int8 serve arm (port of
``tpu_resnet/serve/calibrate.py``).

Symmetric weight quantization needs no data; the one calibrated quantity is
the input's per-tensor activation scale: the max-abs of the
eval-preprocessed images over ``serve.calibration_batches`` batches of
``serve.calibration_batch`` from the eval split, in its deterministic
order. The record, ``<dir>/calibration.json``, carries a digest of its
other fields (canonical JSON, sha256: the reference's, character for
character), which the export manifest and ``/info`` carry, so that two
arms can show they were quantized from the same evidence.
"""

from __future__ import annotations

import hashlib
import json
import os

import torch

CALIBRATION_FILE = "calibration.json"
FORMAT = "tpu_resnet.calibration.v1"


def calibration_digest(record: dict) -> str:
    """sha256 of the canonical JSON of every field but the digest."""
    body = {k: v for k, v in sorted(record.items()) if k != "digest"}
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def collect_ranges(cfg, device="cpu") -> dict:
    """Eval-preprocess the first batches of the eval split (on ``device``,
    where ImageNet's decode runs) and record the input's max-abs; returns
    the digest-stamped record, not yet written."""
    from tpu_resnet_torch import data as data_lib
    from tpu_resnet_torch.data.augment import get_eval_preprocess

    batch = int(cfg.serve.calibration_batch)
    batches = int(cfg.serve.calibration_batches)
    preprocess = get_eval_preprocess(cfg.data.dataset)
    it = data_lib.eval_split_batches(cfg.data, batch, device=device)
    act_max = 0.0
    seen = 0
    try:
        for images, labels in it:
            images = torch.as_tensor(images)
            # Padded tail rows (label -1) are zeros: skip them.
            real = (torch.as_tensor(labels) >= 0).to(images.device)
            if bool(real.any()):
                x = preprocess(images[real])
                act_max = max(act_max, float(x.abs().max()))
            seen += 1
            if seen >= batches:
                break
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()
    record = {
        "format": FORMAT,
        "dataset": cfg.data.dataset,
        "image_size": cfg.data.resolved_image_size,
        "batches": seen,
        "batch": batch,
        "act_max": {"input": act_max},
    }
    record["digest"] = calibration_digest(record)
    return record


def write_calibration(record: dict, directory: str) -> str:
    """Atomic write of ``<directory>/calibration.json``."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, CALIBRATION_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps(record, indent=2, sort_keys=True) + "\n")
    os.replace(tmp, path)
    return path


def load_calibration(directory: str) -> dict:
    """Load a record and check its digest; ValueError on a tampered or
    truncated file."""
    path = os.path.join(directory, CALIBRATION_FILE)
    with open(path) as f:
        record = json.load(f)
    if record.get("digest") != calibration_digest(record):
        raise ValueError(f"calibration digest mismatch in {path}")
    return record


def _matches(record: dict, cfg) -> bool:
    return (record.get("format") == FORMAT
            and record.get("dataset") == cfg.data.dataset
            and record.get("image_size") == cfg.data.resolved_image_size
            and record.get("batch") == int(cfg.serve.calibration_batch))


def ensure_calibration(cfg, directory: str, device="cpu") -> dict:
    """A matching, digest-valid ``calibration.json`` from ``directory``, or
    a new one collected and written there: the first start calibrates,
    restarts reuse it."""
    try:
        record = load_calibration(directory)
        if _matches(record, cfg):
            return record
    except (OSError, ValueError, json.JSONDecodeError):
        pass
    record = collect_ranges(cfg, device=device)
    write_calibration(record, directory)
    return record
