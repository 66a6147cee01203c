// The ImageNet input pipeline's decode stage on the card: an nvJPEG shim
// (one handle and decode state per decoding thread, images decoded one at
// a time into device memory on the caller's stream, each call waiting for
// the stream before the state is reused) and `tr_resize_crop`,
// the aspect-preserving triangle-filter resize and crop of a whole batch
// in one launch.
//
// tr_resize_crop replaces no TPU kernel: it is the card's counterpart of
// the reference's host C++ `resize_bilinear_window`
// (tpu_resnet/native/loader.cc:266), which computes only the cropped
// window of the resized image. The per-image axis tables (first source
// index, tap count and normalised weights of each output row and column,
// loader.cc:220-257's `precompute_axis`) come from the host
// (ops/jpeg_decode.py `crop_tables`), so the kernel does the filter's
// arithmetic alone: for each output pixel and channel,
//   v = sum_ky wy[ky] * (sum_kx wx[kx] * src[y0 + ky][x0 + kx])
// in float32, each product and sum rounded on its own (no fused
// multiply-add) in the order of the plain version, which runs the
// horizontal pass first over the rows the window touches and then the
// vertical pass: both give the same float for every output, and the
// rounding (v + 0.5, clamped to [0, 255], truncated) is the same.
//
// Bound: a (b, y, x) output reads count_y x count_x source pixels (4 x 4
// at ImageNet's ~1.5x downscale) through L1/L2; every source pixel of the
// window is read from device memory about once, so the kernel is bound by
// the window's bytes and the output's (the operations, ~2 x 16 x 3 a
// pixel, are far below the float32 rate). One thread an output pixel,
// three channels in registers; blocks of 32 x 8 pixels of one image.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstdint>
#include <cstring>

namespace {

struct Decoder {
  int device;
  nvjpegHandle_t handle;
  nvjpegJpegState_t state;
  cudaEvent_t done;  // blocking: a waiting thread sleeps, it does not spin
};

// nvJPEG statuses are returned as they are (1..9); CUDA errors as
// 1000 + the cudaError_t.
constexpr int kCudaBase = 1000;

// v + 0.5 clamped to [0, 255], truncated: the plain version's rounding.
__device__ __forceinline__ uint8_t to_u8(float v) {
  return (uint8_t)__float2uint_rz(fminf(255.f, fmaxf(0.f, __fadd_rn(v, .5f))));
}

__global__ void resize_crop_kernel(const uint8_t* __restrict__ src,
                                   const long long* __restrict__ src_off,
                                   const int* __restrict__ dims,
                                   const int* __restrict__ first,
                                   const int* __restrict__ count,
                                   const float* __restrict__ weights, int S,
                                   int K, uint8_t* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= S || y >= S) return;
  const int w = dims[3 * b], c = dims[3 * b + 2];
  const uint8_t* img = src + src_off[b];
  // Axis 0 of the tables is y (rows), axis 1 x (columns).
  const int fy = first[(2 * b) * S + y], ny = count[(2 * b) * S + y];
  const int fx = first[(2 * b + 1) * S + x], nx = count[(2 * b + 1) * S + x];
  const float* wy = weights + ((size_t)(2 * b) * S + y) * K;
  const float* wx = weights + ((size_t)(2 * b + 1) * S + x) * K;
  const int g = c == 3 ? 1 : 0;  // grey: one plane read as R, G and B
  float v0 = 0.f, v1 = 0.f, v2 = 0.f;
  for (int ky = 0; ky < ny; ++ky) {
    const uint8_t* row = img + ((size_t)(fy + ky) * w + fx) * c;
    float h0 = 0.f, h1 = 0.f, h2 = 0.f;
    for (int kx = 0; kx < nx; ++kx) {
      const float t = wx[kx];
      const uint8_t* p = row + kx * c;
      h0 = __fadd_rn(h0, __fmul_rn(t, (float)p[0]));
      h1 = __fadd_rn(h1, __fmul_rn(t, (float)p[g]));
      h2 = __fadd_rn(h2, __fmul_rn(t, (float)p[2 * g]));
    }
    const float t = wy[ky];
    v0 = __fadd_rn(v0, __fmul_rn(t, h0));
    v1 = __fadd_rn(v1, __fmul_rn(t, h1));
    v2 = __fadd_rn(v2, __fmul_rn(t, h2));
  }
  uint8_t* o = out + (((size_t)b * S + y) * S + x) * 3;
  o[0] = to_u8(v0);
  o[1] = to_u8(v1);
  o[2] = to_u8(v2);
}

}  // namespace

// A decoder for one thread: nvJPEG's default (hybrid) back end.
extern "C" int tr_jpeg_create(int device, void** out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return kCudaBase + err;
  Decoder* d = new Decoder();
  d->device = device;
  nvjpegStatus_t st = nvjpegCreateSimple(&d->handle);
  if (st != NVJPEG_STATUS_SUCCESS) {
    delete d;
    return st;
  }
  st = nvjpegJpegStateCreate(d->handle, &d->state);
  if (st != NVJPEG_STATUS_SUCCESS) {
    nvjpegDestroy(d->handle);
    delete d;
    return st;
  }
  err = cudaEventCreateWithFlags(
      &d->done, cudaEventBlockingSync | cudaEventDisableTiming);
  if (err != cudaSuccess) {
    nvjpegJpegStateDestroy(d->state);
    nvjpegDestroy(d->handle);
    delete d;
    return kCudaBase + err;
  }
  *out = d;
  return 0;
}

extern "C" int tr_jpeg_destroy(void* dec) {
  Decoder* d = static_cast<Decoder*>(dec);
  cudaSetDevice(d->device);
  cudaEventDestroy(d->done);
  nvjpegStatus_t a = nvjpegJpegStateDestroy(d->state);
  nvjpegStatus_t b = nvjpegDestroy(d->handle);
  delete d;
  return a != NVJPEG_STATUS_SUCCESS ? a : b;
}

// The images of a batch, one call each for their headers and their
// decode, so that the caller's thread gives up the Python interpreter's
// lock once a batch and not several times an image (the engine's worker
// threads share it with the training loop's).
//
// out[4j..4j+3] = components, nvjpegChromaSubsampling_t, width, height of
// image j. On failure *bad is the image refused.
extern "C" int tr_jpeg_info_batch(void* dec, int n,
                                  const unsigned char* const* datas,
                                  const long long* lens, int* out, int* bad) {
  Decoder* d = static_cast<Decoder*>(dec);
  for (int j = 0; j < n; ++j) {
    int widths[NVJPEG_MAX_COMPONENT] = {0};
    int heights[NVJPEG_MAX_COMPONENT] = {0};
    int ncomp = 0;
    nvjpegChromaSubsampling_t subs = NVJPEG_CSS_UNKNOWN;
    nvjpegStatus_t st = nvjpegGetImageInfo(d->handle, datas[j],
                                           (size_t)lens[j], &ncomp, &subs,
                                           widths, heights);
    if (st != NVJPEG_STATUS_SUCCESS) {
      *bad = j;
      return st;
    }
    out[4 * j] = ncomp;
    out[4 * j + 1] = (int)subs;
    out[4 * j + 2] = widths[0];
    out[4 * j + 3] = heights[0];
  }
  return 0;
}

// Decode image j into dst + offsets[j] on `stream`: interleaved RGB
// (channels[j] 3, pitch 3 x width) or the luma plane alone (channels[j] 1,
// a grey image). Each decode waits for the stream before the state is
// used again: without that wait, an image decoded while the stream lagged
// behind a training step now and then came out corrupted (chip_smoke.py's
// check of each batch against a synchronous decode): nvjpegDecode returns
// with work still queued that reads the state's buffers, which the next
// decode refills. The wait sleeps on a blocking event, so that threads
// waiting behind a training step leave the host's cores to it and to the
// other decoders. On failure *bad is the image refused.
extern "C" int tr_jpeg_decode_batch(void* dec, int n,
                                    const unsigned char* const* datas,
                                    const long long* lens,
                                    const int* channels, const int* widths,
                                    void* dst, const long long* offsets,
                                    void* stream, int* bad) {
  Decoder* d = static_cast<Decoder*>(dec);
  cudaError_t err = cudaSetDevice(d->device);
  if (err != cudaSuccess) return kCudaBase + err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int j = 0; j < n; ++j) {
    *bad = j;
    nvjpegImage_t img;
    std::memset(&img, 0, sizeof(img));
    img.channel[0] = static_cast<unsigned char*>(dst) + offsets[j];
    img.pitch[0] = (size_t)widths[j] * channels[j];
    nvjpegStatus_t st = nvjpegDecode(
        d->handle, d->state, datas[j], (size_t)lens[j],
        channels[j] == 3 ? NVJPEG_OUTPUT_RGBI : NVJPEG_OUTPUT_Y, &img, s);
    if (st != NVJPEG_STATUS_SUCCESS) return st;
    err = cudaEventRecord(d->done, s);
    if (err == cudaSuccess) err = cudaEventSynchronize(d->done);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return kCudaBase + err;
  }
  return 0;
}

// src: the batch's decoded images, image b at src_off[b] bytes, h x w x c
// (dims[b] = w, h, c; c 3 or 1); first, count: int [B, 2, S] (y, then x);
// weights: float [B, 2, S, K]; out: uint8 [B, S, S, 3]. One launch.
extern "C" int tr_resize_crop(const void* src, const void* src_off,
                              const void* dims, const void* first,
                              const void* count, const void* weights, int B,
                              int S, int K, void* out, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B < 0 || S <= 0 || K <= 0) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const dim3 block(32, 8);
  const dim3 grid((S + 31) / 32, (S + 7) / 8, B);
  resize_crop_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const long long*>(src_off),
      static_cast<const int*>(dims), static_cast<const int*>(first),
      static_cast<const int*>(count), static_cast<const float*>(weights), S, K,
      static_cast<uint8_t*>(out));
  return cudaGetLastError();
}
