"""The ImageNet decode stage: JPEG bytes and the crop draws of a batch →
uint8 [B, S, S, 3] on the batch's device.

On the card (``csrc/jpeg_decode.cu``):

- :class:`NvJpegDecoder` decodes a batch's images with nvJPEG into one
  device buffer (interleaved RGB, or the luma plane of a grey image), in
  one C call for their headers and one for their decode; an image that
  nvJPEG refuses raises, naming it;
- :func:`resize_crop` launches ``tr_resize_crop`` once for the batch: the
  aspect-preserving resize to the drawn side and the crop, antialiased
  like PIL's ``BILINEAR`` (the reference's ``resize_bilinear_window``,
  ``tpu_resnet/native/loader.cc:266``), computing only the cropped window.

On the CPU the same stage decodes with the plain decoder
(``data/jpeg.py``) and resizes with :func:`resize_crop_reference`, the
kernel's plain version: both take the host's axis tables
(:func:`crop_tables`, ``precompute_axis`` of ``loader.cc:220-257``) and add
the same float32 products in the same order, so they agree to the bit.
A CUDA tensor goes to the kernel or the call raises; nothing falls back to
the plain decoder on the card.

``launches`` counts ``tr_resize_crop`` launches (the engine's worker
threads launch it, so the count moves under a lock).
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Sequence, Tuple

import numpy as np
import torch

from tpu_resnet_torch.ops import _build

launches = 0  # tr_resize_crop launches (CUDA tensors only)
_count_lock = threading.Lock()

# nvjpegStatus_t names; codes from 1000 up are CUDA errors.
NVJPEG_STATUS = {1: "NOT_INITIALIZED", 2: "INVALID_PARAMETER",
                 3: "BAD_JPEG", 4: "JPEG_NOT_SUPPORTED",
                 5: "ALLOCATOR_FAILURE", 6: "EXECUTION_FAILED",
                 7: "ARCH_MISMATCH", 8: "INTERNAL_ERROR",
                 9: "IMPLEMENTATION_NOT_SUPPORTED",
                 10: "INCOMPLETE_BITSTREAM"}
# nvjpegChromaSubsampling_t → the sampling's name.
NVJPEG_SAMPLING = {0: "4:4:4", 1: "4:2:2", 2: "4:2:0", 3: "4:4:0",
                   4: "4:1:1", 5: "4:1:0", 6: "grey", 7: "4:1:0V",
                   -1: "unknown"}


# ------------------------------------------------------ the host's tables
def resized_size(w: int, h: int, side: int) -> Tuple[int, int]:
    """The size the shorter side ``side`` gives, the other side rounded
    half up (the reference's ``_resize_keep_aspect``)."""
    scale = side / min(w, h)
    return max(1, int(w * scale + 0.5)), max(1, int(h * scale + 0.5))


def crop_offsets(rw: int, rh: int, fx: float, fy: float,
                 out_size: int) -> Tuple[int, int]:
    """The crop's corner in the resized image: floor-central for fx < 0
    (eval), else fx, fy map uniformly onto the valid offsets (train)."""
    if fx < 0:
        return (rw - out_size) // 2, (rh - out_size) // 2
    return (min(int(fx * (rw - out_size + 1)), rw - out_size),
            min(int(fy * (rh - out_size + 1)), rh - out_size))


def _axes(n_in, n_out, start, n: int):
    """The triangle filter of resizing n_in[a] samples to n_out[a], support
    scaled by the downscale factor, at outputs start[a] .. start[a] + n of
    each axis a (``loader.cc``'s ``precompute_axis``, vectorised over the
    axes): first int32 [A, n], count int32 [A, n], weights float32 [A, n,
    K], K the longest filter, zero-padded. Each element is computed in
    double and rounded to float as the C code computes it, the weights'
    total added in tap order."""
    n_in = np.asarray(n_in, np.int64)[:, None]
    scale = n_in / np.asarray(n_out, np.int64)[:, None]
    support = np.maximum(scale, 1.0)
    k = int(np.ceil(support).max()) * 2 + 1
    outputs = np.asarray(start, np.int64)[:, None] + np.arange(n)
    center = (outputs + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), n_in)
    count = xmax - xmin
    taps = xmin[..., None] + np.arange(k)
    t = np.abs((taps + 0.5 - center[..., None]) / support[..., None])
    v = np.where((t < 1.0) & (np.arange(k) < count[..., None]), 1.0 - t, 0.0)
    total = np.zeros(center.shape)
    for tap in range(k):  # in order, as the C loop adds
        total += v[..., tap]
    wf = v.astype(np.float32).astype(np.float64)
    weights = np.where(total[..., None] > 0,
                       wf / np.where(total > 0, total, 1.0)[..., None], wf)
    return (xmin.astype(np.int32), count.astype(np.int32),
            weights.astype(np.float32))


def precompute_axis(n_in: int, n_out: int):
    """The whole axis of resizing ``n_in`` samples to ``n_out``: (first
    int32 [n_out], count int32 [n_out], weights float32 [n_out, ksize])."""
    return tuple(a[0] for a in _axes([n_in], [n_out], [0], n_out))


def crop_table_batch(sizes: Sequence[Tuple[int, int]], draws,
                     out_size: int):
    """The axis tables of a batch's crop windows, from (w, h) sizes and
    (side, fx, fy) draws: first, count int32 [B, 2, S] and weights float32
    [B, 2, S, K], axis 0 rows (y) and axis 1 columns (x), K the batch's
    longest filter, zero-padded."""
    axes = []
    for (w, h), (side, fx, fy) in zip(sizes, draws):
        rw, rh = resized_size(w, h, side)
        if rw < out_size or rh < out_size:
            raise ValueError(f"resize side {side} of a {w}x{h} image gives "
                             f"{rw}x{rh}, smaller than the {out_size} crop")
        x0, y0 = crop_offsets(rw, rh, fx, fy, out_size)
        axes += [(h, rh, y0), (w, rw, x0)]
    a = np.array(axes, np.int64)
    first, count, weights = _axes(a[:, 0], a[:, 1], a[:, 2], out_size)
    shape = (len(sizes), 2, out_size)
    return (first.reshape(shape), count.reshape(shape),
            weights.reshape(*shape, -1))


def crop_tables(w: int, h: int, side: int, fx: float, fy: float,
                out_size: int):
    """One image's :func:`crop_table_batch`: first, count [2, S], weights
    [2, S, K]."""
    return tuple(t[0] for t in crop_table_batch([(w, h)], [(side, fx, fy)],
                                                out_size))


# ---------------------------------------------------- resize: plain, kernel
def resize_crop_reference(rgb: torch.Tensor, first, count,
                          weights) -> torch.Tensor:
    """Plain PyTorch version of ``tr_resize_crop`` for one image: uint8
    [H, W, C] (C 3, or 1 read as grey) and its tables → uint8 [S, S, 3].
    The horizontal pass over the rows the window touches, then the
    vertical one, float32, each product and sum rounded on its own."""
    dev = rgb.device
    first = torch.as_tensor(np.asarray(first), device=dev).long()
    count = torch.as_tensor(np.asarray(count), device=dev).long()
    weights = torch.as_tensor(np.asarray(weights), device=dev)
    h, w, _ = rgb.shape
    src = rgb.expand(h, w, 3) if rgb.shape[2] == 1 else rgb
    src = src.float()
    lo = int(first[0].min())
    hi = int((first[0] + count[0]).max())
    rows = src[lo:hi]                               # [R, W, 3]
    tmp = torch.zeros(hi - lo, first.shape[1], 3, device=dev)
    for k in range(weights.shape[2]):
        wk = torch.where(k < count[1], weights[1, :, k], 0.0)
        cols = torch.clamp(first[1] + k, max=w - 1)
        tmp = tmp + wk[None, :, None] * rows[:, cols]
    out = torch.zeros(first.shape[1], first.shape[1], 3, device=dev)
    for k in range(weights.shape[2]):
        wk = torch.where(k < count[0], weights[0, :, k], 0.0)
        r = torch.clamp(first[0] + k - lo, max=hi - lo - 1)
        out = out + wk[:, None, None] * tmp[r]
    return torch.clamp(out + 0.5, 0.0, 255.0).to(torch.uint8)


def resize_crop(src: torch.Tensor, offsets: torch.Tensor, dims: torch.Tensor,
                first: torch.Tensor, count: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """Resize and crop a batch: ``src`` uint8, image b at ``offsets[b]``
    (int64) as [h, w, c] with ``dims[b]`` = (w, h, c), int32; tables first,
    count int32 [B, 2, S] and weights float32 [B, 2, S, K] as
    :func:`crop_tables` gives them. → uint8 [B, S, S, 3]. On CUDA one
    ``tr_resize_crop`` launch; on the CPU the plain version per image."""
    global launches
    b, _, s = first.shape
    tensors = (src, offsets, dims, first, count, weights)
    want = (torch.uint8, torch.int64, torch.int32, torch.int32, torch.int32,
            torch.float32)
    for t, dt in zip(tensors, want):
        if t.dtype != dt or t.device != src.device:
            raise ValueError(f"resize_crop: expected {dt} on {src.device}, "
                             f"got {t.dtype} on {t.device}")
    if (offsets.shape != (b,) or dims.shape != (b, 3)
            or count.shape != first.shape
            or weights.shape[:3] != first.shape or first.shape[1] != 2):
        raise ValueError("resize_crop: malformed tables")
    if src.device.type == "cpu":
        out = torch.empty(b, s, s, 3, dtype=torch.uint8)
        for i in range(b):
            w, h, c = (int(v) for v in dims[i])
            off = int(offsets[i])
            out[i] = resize_crop_reference(
                src[off:off + h * w * c].view(h, w, c), first[i], count[i],
                weights[i])
        return out
    if src.device.type != "cuda":
        raise ValueError(f"resize_crop runs on cpu or cuda, not {src.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("resize_crop: tensors must be contiguous")
    out = torch.empty(b, s, s, 3, dtype=torch.uint8, device=src.device)
    lib = _build.library("jpeg_decode")
    _build.check(lib.tr_resize_crop(
        *(t.data_ptr() for t in tensors), b, s, weights.shape[3],
        out.data_ptr(), src.device.index or 0,
        torch.cuda.current_stream(src.device).cuda_stream), "tr_resize_crop")
    with _count_lock:
        launches += 1
    return out


# ------------------------------------------------------------------ nvJPEG
class NvJpegDecoder:
    """One nvJPEG handle and decode state, for one thread at a time."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._lib = _build.library("jpeg_decode")
        self._dec = ctypes.c_void_p()
        _nvjpeg_check(self._lib.tr_jpeg_create(self.device.index or 0,
                                               ctypes.byref(self._dec)),
                      "nvjpegCreateSimple")

    def infos(self, jpegs: Sequence[bytes], names: Sequence[str] = None
              ) -> List[Tuple[int, str, int, int]]:
        """(components, sampling, width, height) of each JPEG, one C call
        for the batch."""
        n = len(jpegs)
        names = names or [f"image {j}" for j in range(n)]
        out, bad = (ctypes.c_int * (4 * n))(), ctypes.c_int(0)
        _check_batch(self._lib.tr_jpeg_info_batch(
            self._dec, n, (ctypes.c_char_p * n)(*jpegs),
            (ctypes.c_longlong * n)(*map(len, jpegs)), out,
            ctypes.byref(bad)), "nvjpegGetImageInfo", names, bad)
        return [(out[4 * j], NVJPEG_SAMPLING.get(out[4 * j + 1],
                                                  str(out[4 * j + 1])),
                 out[4 * j + 2], out[4 * j + 3]) for j in range(n)]

    def decode_batch(self, jpegs: Sequence[bytes],
                     names: Sequence[str] = None):
        """Decode ``jpegs`` into one device buffer on the current stream,
        one C call that returns when the stream has done it: (src uint8,
        offsets int64 [B], sizes [(w, h, c)]), image j at ``offsets[j]`` as
        [h, w, c], c 3 (RGB) or 1 (grey). Refuses images of other component
        counts (CMYK) with their name."""
        n = len(jpegs)
        names = names or [f"image {j}" for j in range(n)]
        sizes = []
        for (comps, sampling, w, h), what in zip(self.infos(jpegs, names),
                                                 names):
            if comps not in (1, 3):
                raise ValueError(f"{what}: {comps} components ({sampling}); "
                                 "the decode stage takes grey or 3-component "
                                 "JPEGs")
            sizes.append((w, h, comps))
        nbytes = [w * h * c for w, h, c in sizes]
        offsets = np.cumsum([0] + nbytes[:-1]).astype(np.int64)
        src = torch.empty(sum(nbytes), dtype=torch.uint8, device=self.device)
        bad = ctypes.c_int(0)
        _check_batch(self._lib.tr_jpeg_decode_batch(
            self._dec, n, (ctypes.c_char_p * n)(*jpegs),
            (ctypes.c_longlong * n)(*map(len, jpegs)),
            (ctypes.c_int * n)(*(c for _, _, c in sizes)),
            (ctypes.c_int * n)(*(w for w, _, _ in sizes)), src.data_ptr(),
            (ctypes.c_longlong * n)(*offsets.tolist()),
            torch.cuda.current_stream(self.device).cuda_stream,
            ctypes.byref(bad)), "nvjpegDecode", names, bad)
        return src, offsets, sizes

    def close(self) -> None:
        if self._dec:
            dec, self._dec = self._dec, ctypes.c_void_p()
            _nvjpeg_check(self._lib.tr_jpeg_destroy(dec), "nvjpegDestroy")


def _check_batch(status: int, what: str, names, bad) -> None:
    if status:
        _nvjpeg_check(status, f"{what} of {names[bad.value]}")


def _nvjpeg_check(status: int, what: str) -> None:
    if status >= 1000:
        raise RuntimeError(f"{what}: CUDA error {status - 1000}")
    if status:
        raise RuntimeError(f"{what}: nvJPEG status {status} "
                           f"({NVJPEG_STATUS.get(status, '?')})")


# ------------------------------------------------------------ the stage
def decode_crop_batch(jpegs: Sequence[bytes], draws: Sequence[tuple],
                      out_size: int, device: torch.device,
                      decoder: NvJpegDecoder = None,
                      names: Sequence[str] = None) -> torch.Tensor:
    """Decode, resize and crop a batch: ``draws[j]`` = (side, fx, fy) of
    ``jpegs[j]`` (fx < 0: the eval crop) → uint8 [len(jpegs), S, S, 3] on
    ``device``, queued on the current stream there. ``decoder`` (CUDA
    only) is the calling thread's; ``names`` label the images in errors."""
    from tpu_resnet_torch.data import jpeg as plain_jpeg

    device = torch.device(device)
    if not jpegs:
        raise ValueError("decode_crop_batch: no images")
    if device.type == "cuda":
        if decoder is None:
            raise ValueError("decode_crop_batch on CUDA needs the thread's "
                             "NvJpegDecoder")
        src, offsets, sizes = decoder.decode_batch(jpegs, names)
        tables = crop_table_batch([s[:2] for s in sizes], draws, out_size)
        return resize_crop(src, *(torch.from_numpy(a).to(device) for a in (
            offsets, np.array(sizes, np.int32), *tables)))
    images = []
    for j, data in enumerate(jpegs):
        what = names[j] if names else f"image {j}"
        try:
            images.append(plain_jpeg.decode(data))
        except ValueError as e:
            raise ValueError(f"{what}: {e}") from None
    sizes = [(im.shape[1], im.shape[0]) for im in images]
    offsets = np.cumsum([0] + [w * h * 3 for w, h in sizes[:-1]])
    return resize_crop(
        torch.from_numpy(np.concatenate([im.reshape(-1) for im in images])),
        *(torch.from_numpy(a) for a in (
            offsets.astype(np.int64),
            np.array([(w, h, 3) for w, h in sizes], np.int32),
            *crop_table_batch(sizes, draws, out_size))))
