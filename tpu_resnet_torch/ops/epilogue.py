"""Fused BN+ReLU conv epilogues over NHWC: ``relu(x * scale + bias)``, the
residual-add variant ``relu(x * scale + bias) + r``, their backward, and
the timed A/B (autotune) that ``model.fused_epilogue=auto`` dispatches on.

``scale``/``bias`` are the folded BN affine (scale = gamma/sqrt(var+eps),
bias = beta - mean*scale). The math runs in float32 and the result is
stored in x's dtype, as in ``tpu_resnet/ops/epilogue.py::_sbr_kernel``.

:func:`scale_bias_relu` is differentiable. Its forward launches the CUDA
kernel ``tr_sbr`` and its backward :func:`scale_bias_relu_bwd`, the kernel
``tr_sbr_bwd`` (``csrc/epilogue.cu``, one launch), which is the reference's
custom VJP (``_sbr_bwd_kernel``): only x, scale and bias are saved, and the
ReLU mask is recomputed from x with the forward's roundings. A CUDA tensor goes to
the kernels or the call raises; a CPU tensor takes the plain versions,
:func:`scale_bias_relu_reference` (differentiable through the same
backward in plain PyTorch) and :func:`scale_bias_relu_bwd_reference`.
``launches`` and ``bwd_launches`` count the kernel launches, so a run can
show that its path went through the kernels.

:func:`scale_bias_relu_add` (``tr_sbr_add``, the reference's
``_sbr_add_kernel``) is differentiable the same way: its backward is
``tr_sbr_bwd`` with ``dr = g``, as the reference's ``_sbr_add_bwd``;
``add_launches`` counts its launches. As in the reference, no model site
calls it: it is reached through :func:`scale_bias_relu_add_auto` and the
probe (:func:`probe_epilogue` with ``include_add``).

Autotune (reference :255-361): :func:`probe_epilogue` times value and
gradient of each op, kernel against plain version, at one shape and
records the decision under ``OP_SBR``/``OP_SBR_ADD`` and :func:`sbr_key`;
:func:`probe_model_epilogues` does so for every BN+ReLU shape of a
configured ResNet (:func:`model_epilogue_shapes`). The ``*_auto`` entry
points take the kernel only where a probe chose it.
"""

from __future__ import annotations

import functools
import math
import zlib
from typing import List, NamedTuple, Tuple

import torch

from tpu_resnet_torch.ops import _build, _library, autotune

# Autotune op ids: the keys the decisions persist under (the reference's).
OP_SBR = "epilogue_sbr"
OP_SBR_ADD = "epilogue_sbr_add"

launches = 0      # tr_sbr launches (CUDA tensors only)
add_launches = 0  # tr_sbr_add launches
bwd_launches = 0  # tr_sbr_bwd launches (one a call)
# The backward's rows of partial sums a channel slice may write, and its
# tickets (csrc/epilogue.cu's kMaxSlices), kept per device and stream:
# zeroed once, every call leaves them zero, and calls on one stream run one
# after another, so they share them.
_BWD_PART_ROWS = 512
_BWD_TICKETS = 1024
_bwd_tickets = {}   # (device index, stream) -> int32 [_BWD_TICKETS]
# The forward's plan (csrc/epilogue.cu: kThreads, kSbrBlocksPerSM, the
# vectors in flight it is built for), and the waves of blocks at most.
SBR_THREADS = 256
SBR_MIN_THREADS = 64
SBR_BLOCKS_PER_SM = 4
SBR_WAVES = 4
SBR_UNROLLS = (4, 2, 1)


class SbrPlan(NamedTuple):
    """``tr_sbr``'s launch: block (slice, bx) of a (slices, nbx) grid
    covers 16-byte vectors ``[slice*vs, (slice+1)*vs)`` of a pixel in the
    chunks bx, bx + nbx, ... of ``rows * unroll`` pixels; thread (v, r) of
    a (vs, rows) block keeps vector v of the slice at pixels ``chunk +
    u*rows + r``, u < unroll, rows = threads // vs."""
    vs: int        # vectors of a pixel a block covers (its slice)
    slices: int    # vectors of a pixel / vs
    threads: int   # a block's threads: rows of vs
    unroll: int    # vectors of x in flight a thread
    nbx: int       # blocks a slice


def _divisor_at_most(n: int, m: int) -> int:
    return next(d for d in range(min(n, m), 0, -1) if n % d == 0)


def sbr_plan(shape, dtype: torch.dtype, sms: int) -> SbrPlan:
    """The forward's plan for x of ``shape`` (NHWC, C a multiple of the
    vector width) and ``dtype`` on a card of ``sms`` SMs: a slice of all a
    pixel's vectors where there are at most ``SBR_THREADS``; four vectors
    in flight a thread unless that leaves SMs without a block, then two or
    one, then fewer threads a block (at least ``SBR_MIN_THREADS``); at most
    ``SBR_WAVES`` waves of ``SBR_BLOCKS_PER_SM`` blocks an SM, the rest by
    the blocks' stride over the chunks."""
    vpp = shape[-1] * torch.tensor([], dtype=dtype).element_size() // 16
    pixels = math.prod(shape[:-1])
    vs = _divisor_at_most(vpp, SBR_THREADS)
    slices = vpp // vs
    rows = SBR_THREADS // vs

    def chunks(rows, unroll):
        return -(-pixels // (rows * unroll))

    unroll = next((u for u in SBR_UNROLLS
                   if chunks(rows, u) * slices >= sms), 1)
    while (chunks(rows, unroll) * slices < sms
           and rows // 2 * vs >= SBR_MIN_THREADS):
        rows //= 2
    nbx = max(1, min(chunks(rows, unroll),
                     -(-sms * SBR_BLOCKS_PER_SM * SBR_WAVES // slices)))
    return SbrPlan(vs, slices, rows * vs, unroll, nbx)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def scale_bias_relu_math(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """The epilogue math on float32 values (shared by the fused block's
    plain version, which applies it between its convs)."""
    return torch.clamp_min(x * scale + bias, 0.0)


def _sbr_plain(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    return scale_bias_relu_math(x.float(), scale, bias).to(x.dtype)


def scale_bias_relu_bwd_reference(x: torch.Tensor, scale: torch.Tensor,
                                  bias: torch.Tensor, g: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain PyTorch backward: (dx in x's dtype, ds, db float32 [C]) with
    the strict mask ``x*scale + bias > 0``."""
    xf = x.float()
    gm = torch.where(xf * scale + bias > 0, g.float(), 0.0)
    dims = tuple(range(x.dim() - 1))
    return ((gm * scale).to(x.dtype), (gm * xf).sum(dims), gm.sum(dims))


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> int:
    if x.dim() != 4:
        raise ValueError(f"x must be [B,H,W,C], got shape {tuple(x.shape)}")
    c = x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape != (c,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [{c}], got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if c % 8:
        raise ValueError(f"channels must be a multiple of 8, got {c}")
    return c


def _check_cuda(what: str, **tensors: torch.Tensor) -> None:
    """Contiguity and 16-byte alignment of the kernels' vector accesses."""
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.dim() == 4 and t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")


def _sbr_kernel(x: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """The forward: CPU → plain version, CUDA → ``tr_sbr``, else raise;
    while tracing, the ``tpu_resnet_torch::sbr`` op, whose body is that
    launch (``ops/_library.py``)."""
    if torch.compiler.is_compiling():
        return _library.sbr(x, scale, bias)
    return _sbr_launch(x, scale, bias)


def _sbr_launch(x: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    global launches
    c = _check(x, scale, bias)
    if x.device.type == "cpu":
        return _sbr_plain(x, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"scale_bias_relu runs on cpu or cuda, not "
                         f"{x.device}")
    _check_cuda("scale_bias_relu", x=x, scale=scale, bias=bias)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    plan = sbr_plan(x.shape, x.dtype, _sms(x.device.index))
    fn = _build.library("epilogue").tr_sbr
    err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
             x.numel(), c, plan.vs, plan.threads, plan.unroll, plan.nbx,
             _build.DTYPE_CODES[x.dtype], x.device.index,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "scale_bias_relu")
    launches += 1
    return y


def _sbr_add_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   residual: torch.Tensor) -> torch.Tensor:
    return (scale_bias_relu_math(x.float(), scale, bias)
            + residual.float()).to(x.dtype)


def _sbr_add_kernel(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    residual: torch.Tensor) -> torch.Tensor:
    """The add variant's forward: CPU → plain version, CUDA →
    ``tr_sbr_add``, else raise."""
    global add_launches
    c = _check(x, scale, bias)
    if (residual.shape != x.shape or residual.dtype != x.dtype
            or residual.device != x.device):
        raise ValueError(f"residual must match x ({x.dtype} "
                         f"{tuple(x.shape)} on {x.device}), got "
                         f"{residual.dtype} {tuple(residual.shape)} on "
                         f"{residual.device}")
    if x.device.type == "cpu":
        return _sbr_add_plain(x, scale, bias, residual)
    if x.device.type != "cuda":
        raise ValueError(f"scale_bias_relu_add runs on cpu or cuda, not "
                         f"{x.device}")
    _check_cuda("scale_bias_relu_add", x=x, residual=residual, scale=scale,
                bias=bias)
    y = torch.empty_like(x)
    fn = _build.library("epilogue").tr_sbr_add
    err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
             residual.data_ptr(), y.data_ptr(), x.numel(), c,
             _build.DTYPE_CODES[x.dtype], x.device.index,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "scale_bias_relu_add")
    add_launches += 1
    return y


def scale_bias_relu_bwd(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, g: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of :func:`scale_bias_relu` given ``g = dL/dy`` (x's shape
    and dtype): ``(dx, ds, db)``, dx in x's dtype, ds/db float32 [C]."""
    global bwd_launches
    c = _check(x, scale, bias)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"g must match x ({x.dtype} {tuple(x.shape)} on "
                         f"{x.device}), got {g.dtype} {tuple(g.shape)} on "
                         f"{g.device}")
    if x.device.type == "cpu":
        return scale_bias_relu_bwd_reference(x, scale, bias, g)
    if x.device.type != "cuda":
        raise ValueError(f"scale_bias_relu_bwd runs on cpu or cuda, not "
                         f"{x.device}")
    _check_cuda("scale_bias_relu_bwd", x=x, g=g, scale=scale, bias=bias)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    key = (x.device.index, stream)
    if key not in _bwd_tickets:
        _bwd_tickets[key] = torch.zeros(_BWD_TICKETS, dtype=torch.int32,
                                        device=x.device)
    dx = torch.empty_like(x)
    part = torch.empty(_BWD_PART_ROWS, 2 * c, dtype=torch.float32,
                       device=x.device)
    sums = torch.empty(2, c, dtype=torch.float32, device=x.device)
    fn = _build.library("epilogue").tr_sbr_bwd
    err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), g.data_ptr(),
             dx.data_ptr(), part.data_ptr(), sums.data_ptr(),
             _bwd_tickets[key].data_ptr(), x.numel(), c, _BWD_PART_ROWS,
             _build.DTYPE_CODES[x.dtype], x.device.index, stream)
    _build.check(err, "scale_bias_relu_bwd")
    bwd_launches += 1
    return dx, sums[0], sums[1]


class _ScaleBiasRelu(torch.autograd.Function):
    """relu(x*s+b) with the reference's custom VJP; ``plain`` picks the
    plain versions on any device (the chip smoke's oracle), else the
    kernels."""

    @staticmethod
    def forward(ctx, x, scale, bias, plain: bool):
        ctx.save_for_backward(x, scale, bias)
        ctx.plain = plain
        return (_sbr_plain if plain else _sbr_kernel)(x, scale, bias)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        bwd = (scale_bias_relu_bwd_reference if ctx.plain
               else scale_bias_relu_bwd)
        dx, ds, db = bwd(x, scale, bias, g.contiguous())
        return dx, ds, db, None


def scale_bias_relu(x: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """``relu(x * scale + bias)``: x [B,H,W,C] float32/bfloat16, C a
    multiple of 8; scale, bias float32 [C]. Returns x's dtype.
    Differentiable in all three (kernels on CUDA, plain on the CPU)."""
    return _ScaleBiasRelu.apply(x, scale, bias, False)


def scale_bias_relu_reference(x: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version on any device, differentiable through
    :func:`scale_bias_relu_bwd_reference`: the CPU path, the tests' and the
    chip smoke's oracle."""
    return _ScaleBiasRelu.apply(x, scale, bias, True)


class _ScaleBiasReluAdd(torch.autograd.Function):
    """relu(x*s+b) + r with the reference's custom VJP (``_sbr_add_bwd``):
    the sbr backward for x, s, b and ``dr = g``; ``plain`` as in
    :class:`_ScaleBiasRelu`."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual, plain: bool):
        ctx.save_for_backward(x, scale, bias)
        ctx.plain = plain
        return (_sbr_add_plain if plain else _sbr_add_kernel)(
            x, scale, bias, residual)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        bwd = (scale_bias_relu_bwd_reference if ctx.plain
               else scale_bias_relu_bwd)
        g = g.contiguous()
        dx, ds, db = bwd(x, scale, bias, g)
        return dx, ds, db, g, None


def scale_bias_relu_add(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor,
                        residual: torch.Tensor) -> torch.Tensor:
    """``relu(x * scale + bias) + residual``, residual of x's shape and
    dtype, summed in float32 and returned in x's dtype. Differentiable in
    all four (kernels on CUDA, plain on the CPU)."""
    return _ScaleBiasReluAdd.apply(x, scale, bias, residual, False)


def scale_bias_relu_add_reference(x: torch.Tensor, scale: torch.Tensor,
                                  bias: torch.Tensor,
                                  residual: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`scale_bias_relu_add` on any device,
    differentiable through the plain backward."""
    return _ScaleBiasReluAdd.apply(x, scale, bias, residual, True)


# ---------------------------------------------------------------- autotune
def sbr_key(shape) -> str:
    return autotune.shape_key(*shape)


def scale_bias_relu_auto(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """The kernel where a probe chose it for x's shape, else the plain
    version."""
    if autotune.use_kernel(OP_SBR, sbr_key(x.shape)):
        return scale_bias_relu(x, scale, bias)
    return scale_bias_relu_reference(x, scale, bias)


def scale_bias_relu_add_auto(x: torch.Tensor, scale: torch.Tensor,
                             bias: torch.Tensor,
                             residual: torch.Tensor) -> torch.Tensor:
    if autotune.use_kernel(OP_SBR_ADD, sbr_key(x.shape)):
        return scale_bias_relu_add(x, scale, bias, residual)
    return scale_bias_relu_add_reference(x, scale, bias, residual)


def _value_and_grad(fn):
    """``fn``'s output and the gradient of its float32 sum w.r.t. every
    argument: the training hot path that a probe times."""
    def run(*args):
        y = fn(*args)
        return y, torch.autograd.grad(y.float().sum(), args)
    return run


def probe_epilogue(shape, dtype: torch.dtype = torch.float32,
                   iters: int = 50, force: bool = False,
                   include_add: bool = True,
                   device="cuda") -> List[autotune.Decision]:
    """Time value and gradient of :func:`scale_bias_relu` (and, with
    ``include_add``, :func:`scale_bias_relu_add`) against their plain
    versions at one (B,H,W,C) shape on seeded inputs, recording the
    decisions. Each op's kernel arm launches its forward ``iters + 1``
    times. Returns the decisions."""
    key = autotune.shape_key(*shape)
    gen = torch.Generator(device=device).manual_seed(zlib.crc32(
        key.encode()))
    c = shape[-1]

    def leaf(t):
        return t.requires_grad_(True)

    x = leaf(torch.randn(shape, generator=gen, device=device).to(dtype))
    r = leaf(torch.randn(shape, generator=gen, device=device).to(dtype))
    s = leaf(torch.rand(c, generator=gen, device=device) + 0.5)
    b = leaf(torch.randn(c, generator=gen, device=device))
    out = [autotune.probe(
        OP_SBR, key, _value_and_grad(scale_bias_relu),
        _value_and_grad(scale_bias_relu_reference), (x, s, b), iters=iters,
        force=force)]
    if include_add:
        out.append(autotune.probe(
            OP_SBR_ADD, key, _value_and_grad(scale_bias_relu_add),
            _value_and_grad(scale_bias_relu_add_reference), (x, s, b, r),
            iters=iters, force=force))
    return out


def model_epilogue_shapes(cfg, local_batch: int) -> List[tuple]:
    """The (B,H,W,C) shapes of a configured ResNet's BN+ReLU sites, as the
    reference derives them from the stage geometry: per stage the block
    width f and, for bottlenecks, 4f and the downsampling block0's first
    site at the input resolution."""
    size = cfg.data.resolved_image_size
    w = cfg.model.width_multiplier
    shapes = set()
    if cfg.data.dataset == "imagenet":
        from tpu_resnet_torch.models.resnet import IMAGENET_PARAMS

        bottleneck, _ = IMAGENET_PARAMS[cfg.model.resnet_size]
        hw, prev_hw = size // 4, None   # stem /2, max-pool /2
        for f in (64, 128, 256, 512):
            shapes.add((local_batch, hw, hw, f))
            if bottleneck:
                shapes.add((local_batch, hw, hw, 4 * f))
                if prev_hw is not None:
                    shapes.add((local_batch, prev_hw, prev_hw, f))
            prev_hw, hw = hw, max(1, hw // 2)
    else:
        hw = size
        for f in (16 * w, 32 * w, 64 * w):
            shapes.add((local_batch, hw, hw, f))
            hw = max(1, hw // 2)
    return sorted(shapes)


def probe_model_epilogues(cfg, local_batch: int, iters: int = 30,
                          device="cuda") -> List[autotune.Decision]:
    """Probe ``OP_SBR`` at every shape of :func:`model_epilogue_shapes` in
    the model's compute dtype: the ``model.fused_epilogue=auto`` setup
    pass. Returns the decisions."""
    dtype = getattr(torch, cfg.model.compute_dtype)
    out = []
    for shape in model_epilogue_shapes(cfg, local_batch):
        out.extend(probe_epilogue(shape, dtype=dtype, iters=iters,
                                  include_add=False, device=device))
    return out
