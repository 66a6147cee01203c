"""Softmax cross-entropy on integer labels, forward and backward as CUDA
kernels (port of ``tpu_resnet/ops/softmax_xent.py``).

- forward: per-example ``logsumexp(logits) - logits[label]``
  (``tr_xent_fwd``, the reference's ``_fwd_kernel``);
- backward: ``(softmax(logits) - onehot(label)) * g`` recomputed from the
  saved logits (``tr_xent_bwd``, the reference's ``_bwd_kernel``).

The kernels (``csrc/softmax_xent.cu``, one warp a row, the row read once
into registers) take [B, C] float32 logits, [B] int32 or int64 labels and
a [B] float32 cotangent, labels and cotangent at any stride (the mean's
cotangent may be one value broadcast, stride 0), so the wrappers launch
nothing but the kernel; the reference's padding of C to 128 lanes is TPU
layout and is not ported. A label outside [0, C) gathers 0.
:func:`softmax_xent_per_example` is differentiable (an
``autograd.Function`` over the two kernels) and :func:`softmax_xent_mean`
takes its mean, the train step's loss with ``optim.use_pallas_xent=on``.
A CUDA tensor goes to the kernels or the call raises; a CPU tensor takes
the plain versions beside them. ``fwd_launches``/``bwd_launches`` count the
kernel launches.

:func:`ensure_xent_probe` is the autotune A/B of ``optim.use_pallas_xent=
auto`` (reference :213-236): the gradient through the mean loss, kernel
pair against the train step's plain chain (:func:`softmax_xent_reference`),
at one (B, classes) head shape.
"""

from __future__ import annotations

import torch

from tpu_resnet_torch.ops import _build, autotune

OP_XENT = "xent"   # the autotune op id (the reference's)

fwd_launches = 0  # tr_xent_fwd launches (CUDA tensors only)
bwd_launches = 0  # tr_xent_bwd launches


def _onehot(labels: torch.Tensor, c: int) -> torch.Tensor:
    return labels.long()[:, None] == torch.arange(c, device=labels.device)


def _xent_plain(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    x = logits.float()
    picked = torch.where(_onehot(labels, x.shape[1]), x, 0.0).sum(1)
    return torch.logsumexp(x, dim=1) - picked


def softmax_xent_bwd_reference(logits: torch.Tensor, labels: torch.Tensor,
                               g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch backward: ``(softmax(logits) - onehot) * g[:, None]``,
    float32 [B, C]."""
    x = logits.float()
    probs = torch.softmax(x, dim=1)
    return (probs - _onehot(labels, x.shape[1]).float()) * g.float()[:, None]


def _check(logits: torch.Tensor, labels: torch.Tensor) -> None:
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise ValueError(f"logits must be float32 [B, C], got {logits.dtype} "
                         f"{tuple(logits.shape)}")
    if labels.shape != logits.shape[:1] or labels.dtype not in (
            torch.int32, torch.int64):
        raise ValueError(f"labels must be int32/int64 [{logits.shape[0]}], "
                         f"got {labels.dtype} {tuple(labels.shape)}")
    if labels.device != logits.device:
        raise ValueError(f"labels are on {labels.device}, logits on "
                         f"{logits.device}")
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"softmax_xent runs on cpu or cuda, not "
                         f"{logits.device}")


def _cuda_args(logits: torch.Tensor, labels: torch.Tensor) -> tuple:
    """The kernels' label arguments (pointer, 64-bit, stride); the logits'
    rows must be contiguous."""
    if not logits.is_contiguous():
        raise ValueError("softmax_xent: logits must be contiguous")
    return (labels.data_ptr(), int(labels.dtype == torch.int64),
            labels.stride(0))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _xent_kernel(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example loss: CPU → plain version, CUDA → ``tr_xent_fwd``."""
    global fwd_launches
    _check(logits, labels)
    if logits.device.type == "cpu":
        return _xent_plain(logits, labels)
    lab = _cuda_args(logits, labels)
    b, c = logits.shape
    loss = torch.empty(b, dtype=torch.float32, device=logits.device)
    err = _build.library("softmax_xent").tr_xent_fwd(
        logits.data_ptr(), *lab, loss.data_ptr(), b, c,
        logits.device.index, _stream(logits))
    _build.check(err, "softmax_xent fwd")
    fwd_launches += 1
    return loss


def softmax_xent_bwd(logits: torch.Tensor, labels: torch.Tensor,
                     g: torch.Tensor) -> torch.Tensor:
    """d(Σ g·loss)/d(logits), float32 [B, C]: CPU → plain version, CUDA →
    ``tr_xent_bwd``."""
    global bwd_launches
    _check(logits, labels)
    if g.shape != labels.shape or g.device != logits.device:
        raise ValueError(f"g must be [{logits.shape[0]}] on {logits.device}, "
                         f"got {tuple(g.shape)} on {g.device}")
    if logits.device.type == "cpu":
        return softmax_xent_bwd_reference(logits, labels, g)
    lab = _cuda_args(logits, labels)
    gf = g.float()   # itself where g is float32, the train step's case
    b, c = logits.shape
    dx = torch.empty_like(logits)
    err = _build.library("softmax_xent").tr_xent_bwd(
        logits.data_ptr(), *lab, gf.data_ptr(), gf.stride(0), dx.data_ptr(),
        b, c, logits.device.index, _stream(logits))
    _build.check(err, "softmax_xent bwd")
    bwd_launches += 1
    return dx


class _SoftmaxXent(torch.autograd.Function):
    """Per-example loss with the reference's custom VJP; ``plain`` picks
    the plain versions on any device (the chip smoke's oracle), else the
    kernels."""

    @staticmethod
    def forward(ctx, logits, labels, plain: bool):
        ctx.save_for_backward(logits, labels)
        ctx.plain = plain
        if plain:
            _check(logits, labels)
            return _xent_plain(logits, labels)
        return _xent_kernel(logits, labels)

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        bwd = softmax_xent_bwd_reference if ctx.plain else softmax_xent_bwd
        return bwd(logits, labels, g), None, None


def softmax_xent_per_example(logits: torch.Tensor,
                             labels: torch.Tensor) -> torch.Tensor:
    """Per-example softmax cross-entropy, differentiable w.r.t. ``logits``
    (float32 [B, C]); labels int [B]."""
    return _SoftmaxXent.apply(logits, labels, False)


def softmax_xent_per_example_reference(logits: torch.Tensor,
                                       labels: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version on any device, differentiable through
    :func:`softmax_xent_bwd_reference`."""
    return _SoftmaxXent.apply(logits, labels, True)


def softmax_xent_mean(logits: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """Mean loss over the batch: the train step's loss with
    ``optim.use_pallas_xent=on``."""
    return softmax_xent_per_example(logits, labels).mean()


def softmax_xent_reference(logits: torch.Tensor,
                           labels: torch.Tensor) -> torch.Tensor:
    """The plain arm of the A/B: the mean loss as the train step's plain
    chain computes it (``-Σ onehot · log_softmax``), differentiated by
    PyTorch. Not ``torch.logsumexp``: on the card its calls did not queue
    behind the probe's spin (PERF.md §6)."""
    x = logits.float()
    onehot = torch.nn.functional.one_hot(labels.long(), x.shape[1])
    return -(onehot * torch.log_softmax(x, dim=1)).sum(1).mean()


def ensure_xent_probe(batch: int, classes: int,
                      dtype: torch.dtype = torch.float32, iters: int = 100,
                      device="cuda") -> autotune.Decision:
    """The recorded decision at (batch, classes), probing first if there
    is none: the gradient through the mean loss, :func:`softmax_xent_mean`
    against :func:`softmax_xent_reference`, on seeded logits."""
    key = autotune.shape_key(batch, classes)
    existing = autotune.decision(OP_XENT, key)
    if existing is not None:
        return existing
    gen = torch.Generator(device=device).manual_seed(classes)
    logits = torch.randn(batch, classes, generator=gen, device=device,
                         dtype=dtype).requires_grad_(True)
    labels = torch.randint(0, classes, (batch,), generator=gen,
                           device=device)

    def grad_of(loss_fn):
        return lambda x, lab: torch.autograd.grad(loss_fn(x, lab), x)

    return autotune.probe(OP_XENT, key, grad_of(softmax_xent_mean),
                          grad_of(softmax_xent_reference), (logits, labels),
                          iters=iters)
