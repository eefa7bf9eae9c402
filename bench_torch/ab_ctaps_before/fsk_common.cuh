// Shared device helpers for the mix/FIR/decimate, complex-taps and FSK kernels.
//
// Built by srcdsp_tpu_torch/kernels/_build.py with nvcc for sm_90a, without
// --use_fast_math: sinf, cosf, atan2f and sincospif keep their accurate forms.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace srcdsp {

constexpr int kThreads = 256;  // a power of two: block_sum halves it
constexpr int kPad = 128;      // columns of the O&M partial-sum output st
constexpr size_t kDefaultSmem = 48 * 1024;

// e^{j 2 pi w / 2^32} for a u32 phase word. The word is read as a signed turn
// in [-0.5, 0.5): whole turns drop out, and sincospif(2 * turn) is accurate
// to about one ulp over the whole range.
__device__ __forceinline__ void phasor(uint32_t w, float* c, float* s) {
  const float two_turns = (float)(int32_t)w * 4.656612873077393e-10f;  // * 2^-31
  sincospif(two_turns, s, c);
}

// Input samples are float32 or bfloat16 (bf16 ingest); all arithmetic is f32.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Window sources. load(c, r, g, &a, &b) reads sample g of channel c's stream
// (the history-prepended input) for the block of output row r, and returns
// false, leaving a and b alone, where the stream has no sample g. A kernel
// body templated on the source computes the same bits from either.

// Raw planes x [C, 2, L].
template <typename T>
struct Planes {
  const T* x;
  long long L;
  __device__ __forceinline__ bool load(int c, int r, long long g, float* a,
                                       float* b) const {
    if (g < 0 || g >= L) return false;
    const T* xr = x + (long long)c * 2 * L;
    *a = to_f32(xr[g]);
    *b = to_f32(xr[L + g]);
    return true;
  }
};

// Producer frames xr_f, xi_f [C, NT, span]: frame row r holds stream samples
// [r*stride, r*stride + span). A sample left of row r's frame (the FSK
// kernels' output J-1 reads up to decim samples there) comes from row r-1,
// which holds [(r-1)*stride, r*stride + hist), so no geometry of taps and
// decimation needs it to lie in row r's own frame. Left of row 0 the stream
// has no samples.
template <typename T>
struct Frames {
  const T* xr;
  const T* xi;
  int NT, stride, span;
  __device__ __forceinline__ bool load(int c, int r, long long g, float* a,
                                       float* b) const {
    const long long row = g >= (long long)r * stride ? r : r - 1;
    if (row < 0) return false;
    const long long k = ((long long)c * NT + row) * span + (g - row * stride);
    *a = to_f32(xr[k]);
    *b = to_f32(xi[k]);
    return true;
  }
};

// History and body as two operands, one channel: x_hist [2, H] and x_body
// [2, N], each plane contiguous, with plane strides hs and bs (so slices of
// one [2, H + N] array serve as they are). Stream sample g is x_hist[g] for
// g < H and x_body[g - H] after it: the history-prepended stream without the
// concat.
template <typename T>
struct Split {
  const T* xh;
  const T* xb;
  long long H, N, hs, bs;
  __device__ __forceinline__ bool load(int, int, long long g, float* a, float* b) const {
    if (g < 0 || g >= H + N) return false;
    if (g < H) {
      *a = to_f32(xh[g]);
      *b = to_f32(xh[hs + g]);
    } else {
      *a = to_f32(xb[g - H]);
      *b = to_f32(xb[bs + g - H]);
    }
    return true;
  }
};

// Shared-memory places of window sample i: DenseIndex puts it at i;
// PaddedIndex adds one float after every 2^log2s samples (K1's layout, where
// the lanes of a warp read 2^log2s samples apart).
struct DenseIndex {
  __device__ __forceinline__ int operator()(int i) const { return i; }
};
struct PaddedIndex {
  int log2s;
  __device__ __forceinline__ int operator()(int i) const { return i + (i >> log2s); }
};

// Stage samples [base, base + len) of channel c into shared memory (zero
// where the source has none), sample i at at(i). With MIX, each sample is
// multiplied once by the NCO phasor of its u32 word w0 + g * dw. A thread
// reads BATCH samples (blockDim.x apart) before it mixes and stores any, so
// that BATCH loads are in flight at once.
template <bool MIX, class Src, class Index = DenseIndex, int BATCH = 1>
__device__ __forceinline__ void stage_window(const Src& src, int c, int r, long long base,
                                             int len, uint32_t w0, uint32_t dw,
                                             float* sr, float* si, Index at = Index{}) {
  for (int i0 = threadIdx.x; i0 < len; i0 += BATCH * blockDim.x) {
    float a[BATCH], b[BATCH];
    bool got[BATCH];
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      const int i = i0 + q * (int)blockDim.x;
      a[q] = b[q] = 0.f;
      got[q] = i < len && src.load(c, r, base + i, &a[q], &b[q]);
    }
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      const int i = i0 + q * (int)blockDim.x;
      if (i >= len) break;
      if (got[q] && MIX) {
        float cs, sn;
        phasor(w0 + (uint32_t)(base + i) * dw, &cs, &sn);
        const float mr = a[q] * cs - b[q] * sn;
        const float mi = a[q] * sn + b[q] * cs;
        a[q] = mr;
        b[q] = mi;
      }
      sr[at(i)] = a[q];
      si[at(i)] = b[q];
    }
  }
}

// Complex FIR output from a staged window: sum_a g[a] * s[e - a], with the
// explicit fmaf order every complex-taps kernel shares, so that the kernels
// over raw planes and over frames round alike.
__device__ __forceinline__ void ctaps_dot(const float* sr, const float* si,
                                          const float* hr, const float* hi, int e,
                                          int T, float* yr, float* yi) {
  float ar = 0.f, ai = 0.f;
  for (int a = 0; a < T; ++a) {
    const float vr = sr[e - a];
    const float vi = si[e - a];
    const float gr = hr[a];
    const float gi = hi[a];
    ar = fmaf(gr, vr, fmaf(-gi, vi, ar));
    ai = fmaf(gr, vi, fmaf(gi, vr, ai));
  }
  *yr = ar;
  *yi = ai;
}

// Real-tap FIR output from a staged (mixed) window: sum_a h[a] * s[e - a],
// one FMA chain per plane (K18's; K1 runs the same chain per output,
// register-blocked, in mixfir.cu).
__device__ __forceinline__ void real_dot(const float* sr, const float* si, const float* h,
                                         int e, int T, float* yr, float* yi) {
  float ar = 0.f, ai = 0.f;
  for (int a = 0; a < T; ++a) {
    const float w = h[a];
    ar = fmaf(w, sr[e - a], ar);
    ai = fmaf(w, si[e - a], ai);
  }
  *yr = ar;
  *yi = ai;
}

// Deterministic block-wide sum (fixed tree order, no atomics). `red` holds
// blockDim.x floats; every thread gets the total.
__device__ __forceinline__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const float total = red[0];
  __syncthreads();
  return total;
}

// Allow more than 48 KB of dynamic shared memory when a launch needs it.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Makes `device` current for an entry point's launch and gives the caller's
// device back on return, so a launch on another card leaves the calling
// thread's current device as it was. err holds the first failure.
struct DeviceScope {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceScope(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess) err = cudaSetDevice(device);
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace srcdsp
