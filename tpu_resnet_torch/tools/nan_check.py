"""Whether the port's kernels keep a NaN through their ReLUs, as the
reference's ``jnp.maximum(v, 0)`` and the plain versions' ``torch.clamp_min``
do (``fmaxf(v, 0)`` returns 0 for a NaN).

:func:`cases` builds one call of each kernel whose ReLU is written in CUDA
(``csrc/epilogue.cu`` ``sbr``, ``sbr_add``; ``csrc/fused_block_tc.cu``
BN1 and BN2 with their ReLU in the forward, the stats, pass 1's r2 and pass
2's dw1 operand; ``csrc/fused_bottleneck_tc.cu`` ``bn_relu`` and
``bn_relu_stats_a``; ``csrc/bottleneck_wgrad.cu``'s BN+ReLU operand, in the
bottleneck's mode and the basic block's shifted mode at C = 128 and 256),
each on a clean input and on the same input with NaNs at seeded places.
:func:`check` runs kernel and plain version (PyTorch's own convolutions:
cuDNN off, whose transforms could spread a NaN further than the product
does) on both: the kernel's output must be NaN exactly where the plain
version's is, bit for bit its own clean output wherever the plain version's
output did not change, and within a scale-aware limit of the plain version
elsewhere. Inputs lie on dyadic grids, so that a mask [v > 0] is the same
in both. ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` run it on the
card.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

# Finite outputs against the plain version: |d| <= this × max|plain| + 1e-5
# per tensor (sums over the batch in another order).
FINITE_RTOL = 1e-4
# Seeded NaNs in each poisoned input.
NANS = 3

Case = Tuple[str, tuple, Callable, Callable, tuple, tuple, dict]


def _grid(gen, size, lo, hi, step):
    return torch.randint(lo, hi + 1, size, generator=gen,
                         device="cuda").float() * step


def _poison(t: torch.Tensor, gen) -> torch.Tensor:
    """A copy of t with NANS elements set to NaN at seeded places."""
    t = t.clone()
    idx = torch.randint(0, t.numel(), (NANS,), generator=gen, device="cuda")
    t.view(-1)[idx] = float("nan")
    return t


def _block(gen, shape):
    """x, gy, w1, w2 and the eight BN vectors of the fused block on the
    grid of ``chip_smoke.block_train_args``."""
    c = shape[-1]

    def vec(lo, hi, step):
        return _grid(gen, (c,), lo, hi, step)

    vecs = (vec(4, 12, 1 / 8), vec(-4, 4, 1 / 8), vec(4, 12, 1 / 8),
            vec(-4, 4, 1 / 8), vec(-4, 4, 1 / 8), 2.0 ** vec(-1, 1, 1),
            vec(-8, 8, 1 / 8), 2.0 ** vec(-2, 0, 1))
    return (_grid(gen, shape, -8, 8, 0.25), _grid(gen, shape, -16, 16, 0.125),
            _grid(gen, (3, 3, c, c), -4, 4, 1 / 32),
            _grid(gen, (3, 3, c, c), -4, 4, 1 / 32), vecs)


def cases(seed: int = 0) -> List[Case]:
    """(name, shape, kernel, plain, clean args, poisoned args, keywords)
    of each kernel with a ReLU, float32 on the card."""
    from tpu_resnet_torch.ops import epilogue as ep
    from tpu_resnet_torch.ops import fused_block as fb
    from tpu_resnet_torch.ops import fused_bottleneck as fbn
    from tpu_resnet_torch.ops import wgrad as wg

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out: List[Case] = []
    shape = (16, 8, 8, 64)
    x = _grid(gen, shape, -8, 8, 0.25)
    s, b = _grid(gen, (64,), 4, 12, 1 / 8), _grid(gen, (64,), -4, 4, 1 / 8)
    r = _grid(gen, shape, -8, 8, 0.25)
    out.append(("sbr", shape, ep.scale_bias_relu,
                ep.scale_bias_relu_reference, (x, s, b),
                (_poison(x, gen), s, b), {}))
    out.append(("sbr_add", shape, ep.scale_bias_relu_add,
                ep.scale_bias_relu_add_reference, (x, s, b, r),
                (_poison(x, gen), s, b, r), {}))
    for shape in ((4, 8, 8, 64), (2, 6, 6, 128), (2, 5, 5, 256)):
        x, gy, w1, w2, vecs = _block(gen, shape)
        xn = _poison(x, gen)
        g1, b1, g2, b2 = vecs[:4]
        fwd = (w1, w2, g1, b1, g2, b2)
        out.append(("block_fwd", shape, fb.block_fwd, fb.block_fwd_reference,
                    (x, *fwd), (xn, *fwd), {}))
        out.append(("block_stats", shape, fb.block_stats,
                    fb.block_stats_reference, (x, w1, g1, b1),
                    (xn, w1, g1, b1), {}))
        # The forward from a c1 that holds the NaNs: BN2 and its ReLU as c1
        # is read.
        c1 = fb.block_stats_reference(x, w1, g1, b1)[2]
        out.append(("block_fwd_c1", shape,
                    lambda *a, c1: fb.block_fwd(*a, c1=c1),
                    lambda *a, c1: fb.block_fwd_reference(*a, c1=c1),
                    (x, *fwd), (x, *fwd), {"c1": (c1, _poison(c1, gen))}))
        out.append(("block_bwd1", shape, fb.block_bwd1,
                    fb.train_bwd_pass1_reference, (x, gy, w1, w2, *vecs),
                    (xn, gy, w1, w2, *vecs), {}))
        # Pass 2 on the plain pass 1's sums and handoff of each input.
        with torch.backends.cudnn.flags(enabled=False):
            h = [fb.train_bwd_pass1_reference(v, gy, w1, w2, *vecs)
                 for v in (x, xn)]
        t = h[0][:2]
        out.append(("block_bwd2", shape,
                    lambda *a, dz2, z2hat: fb.block_bwd2(*a, dz2=dz2,
                                                         z2hat=z2hat),
                    lambda *a, dz2, z2hat: fb.train_bwd_pass2_reference(
                        *a, dz2=dz2, z2hat=z2hat),
                    (x, gy, w1, w2, *vecs, *t), (xn, gy, w1, w2, *vecs, *t),
                    {"dz2": (h[0][3], h[1][3]),
                     "z2hat": (h[0][4], h[1][4])}))
    shape = (2, 7, 7, 256)
    f = 64
    x = _grid(gen, shape, -8, 8, 0.25)
    weights = (_grid(gen, (256, f), -4, 4, 1 / 32),
               _grid(gen, (3, 3, f, f), -2, 2, 1 / 32),
               _grid(gen, (f, 256), -4, 4, 1 / 32))
    folds = []
    for n in (256, f, f):
        folds += [2.0 ** _grid(gen, (n,), -1, 0, 1),
                  _grid(gen, (n,), -4, 4, 1 / 16)]
    xn = _poison(x, gen)
    out.append(("bottleneck_fwd", shape, fbn.bottleneck_fwd,
                fbn.bottleneck_fwd_reference, (x, *weights, *folds),
                (xn, *weights, *folds), {}))
    bn1 = (folds[0], folds[1], _grid(gen, (256,), -2, 2, 1 / 4),
           2.0 ** _grid(gen, (256,), -1, 0, 1))
    out.append(("bottleneck_stats_a", shape, fbn.bottleneck_stats_a,
                fbn.bottleneck_stats_a_reference, (x, weights[0], *bn1),
                (xn, weights[0], *bn1), {}))
    d = _grid(gen, (*shape[:3], 64), -16, 16, 0.125)

    def wgrad(a, bmat, *bn):
        return wg.weight_grad("bottleneck_wgrad", wg.BN_RELU, a, bmat, 256,
                              64, a, 1, bn)

    def wgrad_plain(a, bmat, *bn):
        return wg.weight_grad_reference(wg.BN_RELU, a, bmat, bn)

    out.append(("bottleneck_wgrad", shape, wgrad, wgrad_plain,
                (x, d, *bn1), (xn, d, *bn1), {}))
    return out


def _tuple(out) -> tuple:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def check(case: Case) -> Dict:
    """Kernel and plain version on the clean and the poisoned input: the
    NaN elements, whether the kernel's NaNs are the plain version's, whether
    the kernel's output is bit for bit its clean one wherever the plain
    version's did not move, and the finite outputs' worst |d| over
    FINITE_RTOL·max|plain| + 1e-5."""
    name, shape, kernel, plain, clean, poisoned, kw = case
    runs = {}
    for which, args in (("clean", clean), ("nan", poisoned)):
        extra = {k: v[which == "nan"] for k, v in kw.items()}
        got = _tuple(kernel(*args, **extra))
        with torch.backends.cudnn.flags(enabled=False):
            want = _tuple(plain(*args, **extra))
        runs[which] = (got, want)
    torch.cuda.synchronize()
    (got, want), (got_clean, want_clean) = runs["nan"], runs["clean"]
    nans, masks_equal, unchanged_equal, excess = 0, True, True, 0.0
    for g, w, gc, wc in zip(got, want, got_clean, want_clean):
        g, w, gc, wc = g.float(), w.float(), gc.float(), wc.float()
        nan = w.isnan()
        nans += int(nan.sum())
        masks_equal &= torch.equal(g.isnan(), nan)
        same = ~nan & (w == wc)
        unchanged_equal &= torch.equal(g[same], gc[same])
        fin = ~nan & ~g.isnan()
        if fin.any():
            limit = FINITE_RTOL * float(w[fin].abs().max()) + 1e-5
            excess = max(excess, float((g[fin] - w[fin]).abs().max()) / limit)
    return {"kernel": name, "shape": list(shape), "nan_elements": nans,
            "nan_masks_equal": masks_equal,
            "unchanged_bit_equal": unchanged_equal,
            "finite_err_over_limit": excess,
            "ok": nans > 0 and masks_equal and unchanged_equal
            and excess <= 1}
