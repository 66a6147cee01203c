#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``tpu_resnet_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each printing one JSON line:

1. ``device``: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, and the seconds ``nvcc`` took to build the kernels from
   ``tpu_resnet_torch/csrc`` (one compiler per source, started together).
2. ``kernels``: each kernel against its plain PyTorch version on the card,
   at every shape the two serve paths give it with B=16, in bfloat16 and
   float32 (float32 oracle with TF32 off): max abs/rel error against the
   stated tolerance; CUDA-event median times of kernel and plain version,
   on the device alone (``ms``: calls queued back to back behind a spin)
   and per call with the host's launch gaps (``call_ms``); and the bound
   (bytes at 3.35 TB/s or float32 operations at 67 TFLOP/s, the H100
   SXM's published peaks).
3. ``serve`` (``cifar10``): CIFAR-10 ResNet-50 at full width (``--preset
   cifar10 model.fused_blocks=true model.fused_epilogue=on``) from seeded
   random weights, checkpointed to a temporary train dir and served by the
   port's ``PredictServer`` (buckets 1..16 warmed). Octet-stream and JSON
   requests are checked against the same model run through the plain
   versions on the card, and the launch counters, zeroed just before, must
   read 21 ``block_fwd`` and 7 ``sbr`` launches per forward pass.
4. ``serve`` (``imagenet``): ImageNet ResNet-50 at 224x224, full depth and
   width (``--preset imagenet model.fused_blocks=true
   model.fused_epilogue=on``), served the same way. The counters must read
   10 ``bottleneck_fwd``, 19 ``sbr`` and 0 ``block_fwd`` per forward pass.
   Logits are held against the plain-version model (max |d| within 5% of
   the largest |logit|), and the argmax must agree on every image whose
   plain-version top-1/top-2 margin exceeds twice the measured max |d|
   (random weights with 1000 classes leave many near-ties).

Then one ``{"kernels": [...]}`` line (times summed over the launches of one
forward pass of each serve path that runs the kernel, at B=16 in bfloat16,
the serving dtype; ``launches`` is the count over both serve phases), the
``nvidia-smi`` name and power limit, and last ``{"ok": true, "device":
{...}}``. Any failure raises and exits non-zero before the last line;
without CUDA the script exits 2.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BATCH = 16
# (shape, launches per forward pass) on each serve path, at B=BATCH.
SHAPES = {
    "cifar10": {
        "sbr": (((BATCH, 32, 32, 16), 3), ((BATCH, 16, 16, 32), 2),
                ((BATCH, 8, 8, 64), 2)),
        "block_fwd": (((BATCH, 32, 32, 16), 7), ((BATCH, 16, 16, 32), 7),
                      ((BATCH, 8, 8, 64), 7)),
    },
    "imagenet": {   # ResNet-50 at 224x224
        "sbr": (((BATCH, 56, 56, 64), 3), ((BATCH, 56, 56, 256), 1),
                ((BATCH, 56, 56, 128), 1), ((BATCH, 28, 28, 128), 1),
                ((BATCH, 28, 28, 512), 1), ((BATCH, 28, 28, 256), 1),
                ((BATCH, 14, 14, 256), 1), ((BATCH, 14, 14, 1024), 1),
                ((BATCH, 14, 14, 512), 1), ((BATCH, 7, 7, 512), 5),
                ((BATCH, 7, 7, 2048), 3)),
        "bottleneck_fwd": (((BATCH, 56, 56, 256), 2),
                           ((BATCH, 28, 28, 512), 3),
                           ((BATCH, 14, 14, 1024), 5)),
    },
}
KERNELS = ("sbr", "block_fwd", "bottleneck_fwd")
# Launches per forward pass of each serve path, every kernel listed.
PER_FORWARD = {path: {k: sum(n for _, n in shapes.get(k, ()))
                      for k in KERNELS}
               for path, shapes in SHAPES.items()}
# |kernel - plain| <= atol + rtol * |plain|, elementwise. sbr rounds
# exactly as the plain version does; the fused blocks sum their convs in
# another order than cuDNN/cuBLAS, and in bfloat16 that can move the stored
# value by an ulp (2^-8 relative).
TOLERANCE = {
    ("sbr", torch.float32): (1e-6, 1e-6),
    ("sbr", torch.bfloat16): (1e-6, 1e-6),
    ("block_fwd", torch.float32): (1e-4, 1e-4),
    ("block_fwd", torch.bfloat16): (1e-2, 1e-2),
    ("bottleneck_fwd", torch.float32): (1e-4, 1e-4),
    ("bottleneck_fwd", torch.bfloat16): (1e-2, 1e-2),
}
# Served logits against the plain-version model: bfloat16 activations
# through 50 layers, where one-ulp differences compound.
LOGIT_TOL = 0.05   # max |d| as a fraction of max |plain logit|
ARGMAX_AGREE = 0.99


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, queued: bool, reps: int = 20, inner: int = 10) -> float:
    """CUDA-event median of ``reps`` runs of ``inner`` calls, per call.

    ``queued``: the calls are enqueued behind a ~10 ms device spin, so they
    run back to back and the events time the device alone; otherwise the
    events also take in the host's launch gaps (wrapper checks, ctypes,
    PyTorch dispatch), which dominate a kernel shorter than its launch."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(kind: str, shape, dtype) -> tuple:
    """(least ms the card could take, what bounds it): each input read
    once, each output written once, operations at the float32 rate."""
    b, h, w, c = shape
    n = b * h * w * c
    item = torch.tensor([], dtype=dtype).element_size()
    if kind == "sbr":
        moved = 2 * n * item + 2 * c * 4
        ops = 3 * n                                  # mul, add, max
    elif kind == "block_fwd":
        moved = 2 * n * item + 2 * 9 * c * c * 4 + 4 * c * 4
        ops = 2 * (2 * b * h * w * 9 * c * c) + 6 * n
    else:   # bottleneck_fwd: c = 4f
        f = c // 4
        moved = 2 * n * item + (2 * c * f + 9 * f * f + 2 * c + 4 * f) * 4
        # 1x1 reduce, 3x3, 1x1 expand; three scale-bias-ReLUs; residual add
        ops = 2 * b * h * w * (2 * c * f + 9 * f * f) + b * h * w * (
            3 * (c + 2 * f) + c)
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_args(kind: str, shape, dtype, gen) -> tuple:
    """Seeded inputs of one kernel call on the card: activations, weights
    scaled by 1/sqrt(fan-in), folded BN scales in [0.5, 1.5) and biases of
    both signs."""
    c = shape[-1]

    def randn(*size, scale=1.0):
        return torch.randn(size, generator=gen, device="cuda") * scale

    def sb(n):
        return (torch.rand(n, generator=gen, device="cuda") + 0.5,
                randn(n, scale=0.5))

    x = randn(*shape).to(dtype)
    if kind == "sbr":
        return (x, *sb(c))
    if kind == "block_fwd":
        std = (1.0 / (9 * c)) ** 0.5
        w1, w2 = randn(3, 3, c, c, scale=std), randn(3, 3, c, c, scale=std)
        return (x, w1, w2, *sb(c), *sb(c))
    f = c // 4
    return (x, randn(c, f, scale=c ** -0.5),
            randn(3, 3, f, f, scale=(9 * f) ** -0.5),
            randn(f, c, scale=f ** -0.5), *sb(c), *sb(f), *sb(f))


def kernel_phase(wrappers):
    """Per-shape comparison and timing; returns the per-shape rows."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    cases = [(path, kind, shape, n) for path, kinds in SHAPES.items()
             for kind, shapes in kinds.items() for shape, n in shapes]
    for path, kind, shape, per_forward in cases:
        kernel, plain = wrappers[kind]
        for dtype in (torch.bfloat16, torch.float32):
            args = kernel_args(kind, shape, dtype, gen)
            got = kernel(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            d = (got.float() - want.float()).abs()
            atol, rtol = TOLERANCE[(kind, dtype)]
            excess = float((d - atol - rtol * want.float().abs()).max())
            row = {"kernel": kind, "path": path, "shape": list(shape),
                   "dtype": str(dtype).split(".")[1],
                   "per_forward": per_forward,
                   "max_abs_err": float(d.max()),
                   "max_rel_err": float(d.max() / want.float().abs().max()),
                   "atol": atol, "rtol": rtol}
            check(got.dtype == dtype and got.shape == want.shape,
                  f"{kind} {shape} {dtype}: wrong output {got.dtype} "
                  f"{tuple(got.shape)}")
            check(excess <= 0, f"{kind} {shape} {dtype}: error beyond "
                  f"tolerance: {row}")
            for key, fn in (("ms", kernel), ("plain_ms", plain)):
                row[key] = time_ms(lambda: fn(*args), queued=True)
                row["call_" + key] = time_ms(lambda: fn(*args), queued=False)
            row["bound_ms"], row["bound_by"] = bound(kind, shape, dtype)
            row["bound_us"] = row["bound_ms"] * 1e3
            rows.append(row)
    return rows


@contextlib.contextmanager
def plain_versions(ep, fb, fbn):
    """Route the model's kernel calls to the plain versions (the oracle
    run only)."""
    saved = ep.scale_bias_relu, fb.block_fwd, fbn.bottleneck_fwd
    ep.scale_bias_relu = ep.scale_bias_relu_reference
    fb.block_fwd = fb.block_fwd_reference
    fbn.bottleneck_fwd = fbn.bottleneck_fwd_reference
    try:
        yield
    finally:
        ep.scale_bias_relu, fb.block_fwd, fbn.bottleneck_fwd = saved


def post(port: int, body: bytes, content_type: str, shape=None) -> tuple:
    """POST /predict?logits=1; returns (response json, seconds)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict?logits=1", data=body,
        headers={"Content-Type": content_type,
                 **({"X-Shape": ",".join(map(str, shape))} if shape else {})})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as resp:
        out = json.loads(resp.read())
    return out, time.perf_counter() - t0


def get_status(port: int, path: str) -> int:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


# Each serve path, named by its preset: image size, the requests that check
# the served logits ((count, offset) octet-stream requests; the count of
# images in one JSON request), latency requests at N=1, and the argmax rule.
SERVE_PATHS = {
    "cifar10": {"size": 32, "octet": ((1, 0), (3, 1), (16, 4)), "json": 2,
                "lat1": 40, "argmax": "all"},
    "imagenet": {"size": 224, "octet": ((1, 0), (16, 1)), "json": 1,
                 "lat1": 20, "argmax": "margin"},
}
N_IMAGES = 256


def serve_phase(path: str, mods, gpu: str) -> dict:
    from tpu_resnet_torch.config import load_config
    from tpu_resnet_torch.models import build_model, init_weights
    from tpu_resnet_torch.serve.infer import make_serve_infer
    from tpu_resnet_torch.serve.server import PredictServer
    from tpu_resnet_torch.train import checkpoint

    spec = SERVE_PATHS[path]
    size = spec["size"]
    counters = dict(zip(KERNELS, mods))
    train_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{path}_")
    cfg = load_config(path, "", [
        "model.fused_blocks=true", "model.fused_epilogue=on",
        f"train.train_dir={train_dir}", "serve.host=127.0.0.1",
        "serve.port=0"])
    check(cfg.data.resolved_image_size == size, f"{path}: image size "
          f"{cfg.data.resolved_image_size}")
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(0))
    checkpoint.save(train_dir, 1, model)
    server = PredictServer(cfg, device="cuda")
    try:
        check(server.health()["ok"] is False, "ready before warmup")
        t0 = time.monotonic()
        server.start()
        warm_s = time.monotonic() - t0
        check(tuple(server.buckets) == (1, 2, 4, 8, 16),
              f"buckets {server.buckets}")
        check(get_status(server.port, "/healthz") == 200,
              "/healthz must be 200 once warm")
        rng = np.random.default_rng(0)
        images = rng.integers(0, 256, (N_IMAGES, size, size, 3),
                              dtype=np.uint8)

        def octet(n, off):
            return post(server.port, images[off:off + n].tobytes(),
                        "application/octet-stream", (n, size, size, 3))

        batches0 = server.batcher.stats()["batches"]
        for mod in mods:
            mod.launches = 0
        served = []  # (images, logits)
        for n, off in spec["octet"]:
            out, _ = octet(n, off)
            check(out["count"] == n, f"count {out['count']} != {n}")
            served.append((images[off:off + n], np.asarray(out["logits"])))
        js = images[20:20 + spec["json"]]
        out, _ = post(server.port,
                      json.dumps({"instances": js.tolist()}).encode(),
                      "application/json")
        check(out["count"] == len(js), f"json count {out['count']}")
        served.append((js, np.asarray(out["logits"])))
        lat1 = [octet(1, i)[1] for i in range(spec["lat1"])]
        lat16 = [octet(16, i)[1] for i in range(0, N_IMAGES, 16)]
        launches = {k: m.launches for k, m in counters.items()}
        forwards = server.batcher.stats()["batches"] - batches0
        check(forwards > 0, "no batch ran")
        want_launches = {k: n * forwards for k, n in PER_FORWARD[path].items()}
        check(launches == want_launches,
              f"{path}: launch counts {launches} over {forwards} forward "
              f"passes, expected {want_launches}")

        # Oracle: the served model, on the card, through the plain versions.
        infer = make_serve_infer(cfg, server.backend.device)
        served_model = server.backend._model

        def run_all():
            return np.concatenate([
                infer(served_model, images[i:i + 16]).float().cpu().numpy()
                for i in range(0, N_IMAGES, 16)])

        with plain_versions(*mods):
            ref = [infer(served_model, im).float().cpu().numpy()
                   for im, _ in served]
            ref_all = run_all()
        kern_all = run_all()
        got = np.concatenate([lg for _, lg in served])
        want = np.concatenate(ref)
        check(got.shape == want.shape and np.isfinite(got).all(),
              f"served logits {got.shape}, finite={np.isfinite(got).all()}")
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        err_all = float(np.abs(kern_all - ref_all).max())
        agree = float(np.mean(kern_all.argmax(-1) == ref_all.argmax(-1)))
        check(err <= LOGIT_TOL * scale,
              f"served logits differ by {err} (scale {scale})")
        check(err_all <= LOGIT_TOL * scale,
              f"batched logits differ by {err_all} (scale {scale})")
        top2 = np.sort(ref_all, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * err_all
        if spec["argmax"] == "all":
            check(bool((got.argmax(-1) == want.argmax(-1)).all()),
                  "served argmax differs from the plain-version model")
            check(agree >= ARGMAX_AGREE,
                  f"argmax agreement {agree} over {N_IMAGES}")
        else:
            check(bool(clear.any()), "no image's top-1/top-2 margin exceeds "
                  f"twice the max logit difference {err_all}")
            check(bool((kern_all.argmax(-1) == ref_all.argmax(-1))[clear]
                       .all()), "argmax differs from the plain-version "
                  "model on an image with a clear margin")
    finally:
        clean = server.drain(timeout=60)
        server.close()
        shutil.rmtree(train_dir, ignore_errors=True)
    check(clean, "server did not drain cleanly")
    result = {
        "path": path,
        "model": f"{path} ResNet-50 {size}x{size} fused_blocks=on "
                 f"fused_epilogue=on bf16",
        "params": sum(p.numel() for p in model.parameters()),
        "warmup_s": warm_s, "forwards": forwards, "launches": launches,
        "per_forward": {k: v / forwards for k, v in launches.items()},
        "logits_max_abs_err": err, "batched_max_abs_err": err_all,
        "logits_scale": scale, "logit_tol_fraction": LOGIT_TOL,
        f"argmax_agreement_{N_IMAGES}": agree,
        "clear_margin_images": int(clear.sum()),
        "p50_request_ms_n1": statistics.median(lat1) * 1e3,
        "p50_request_ms_n16": statistics.median(lat16) * 1e3,
        "images_per_s_n16": 16 * len(lat16) / sum(lat16),
        "gpu": gpu, "drained_clean": clean,
    }
    emit("serve", **result)
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from tpu_resnet_torch.device import resolve_device
    from tpu_resnet_torch.ops import _build
    from tpu_resnet_torch.ops import epilogue as ep
    from tpu_resnet_torch.ops import fused_block as fb
    from tpu_resnet_torch.ops import fused_bottleneck as fbn

    resolve_device("cuda")  # TF32 off for the float32 oracle
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.monotonic()
    libs = _build.build_all()
    emit("device", gpu=gpu, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_seconds=time.monotonic() - t0,
         libraries=sorted(libs))

    mods = (ep, fb, fbn)   # in KERNELS order
    rows = kernel_phase({
        "sbr": (ep.scale_bias_relu, ep.scale_bias_relu_reference),
        "block_fwd": (fb.block_fwd, fb.block_fwd_reference),
        "bottleneck_fwd": (fbn.bottleneck_fwd,
                           fbn.bottleneck_fwd_reference)})
    emit("kernels", gpu=gpu, rows=rows)
    served = [serve_phase(path, mods, gpu) for path in SERVE_PATHS]

    kernels = []
    for kind, source, replaces in (
            ("sbr", "tpu_resnet_torch/csrc/epilogue.cu",
             "tpu_resnet/ops/epilogue.py:110"),
            ("block_fwd", "tpu_resnet_torch/csrc/fused_block.cu",
             "tpu_resnet/ops/fused_block.py:87"),
            ("bottleneck_fwd", "tpu_resnet_torch/csrc/fused_bottleneck.cu",
             "tpu_resnet/ops/fused_bottleneck.py:154")):
        mine = [r for r in rows if r["kernel"] == kind
                and r["dtype"] == "bfloat16"]
        per_fwd = lambda key: sum(r[key] * r["per_forward"] for r in mine)
        kernels.append({
            "name": kind, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(s["launches"][kind] for s in served),
            "launches_per_forward": {s["path"]: s["per_forward"][kind]
                                     for s in served},
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": per_fwd("ms"), "plain_ms": per_fwd("plain_ms"),
            "call_ms": per_fwd("call_ms"),
            "plain_call_ms": per_fwd("call_plain_ms"),
            "bound_ms": per_fwd("bound_ms"),
            "bound_by": mine[0]["bound_by"],
            # No single PyTorch call computes any of the three: relu of an
            # affine is at least two calls, the basic block five or more,
            # the bottleneck (three convs, three BN-ReLUs, an add) seven.
            "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
