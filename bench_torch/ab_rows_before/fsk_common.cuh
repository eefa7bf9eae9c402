// Shared device helpers for the mix/FIR/decimate, complex-taps and FSK kernels.
//
// Built by srcdsp_tpu_torch/kernels/_build.py with nvcc for sm_90a, without
// --use_fast_math: sinf, cosf, atan2f and sincospif keep their accurate forms.
#pragma once

#include <cstdint>
#include <initializer_list>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace srcdsp {

constexpr int kThreads = 256;  // threads a block of the frame, rows and edge-LDPC kernels
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
// Two consecutive bf16 samples as one 4-byte load (p 4-byte aligned).
__device__ __forceinline__ void pair_f32(const __nv_bfloat16* p, float* v) {
  const __nv_bfloat162 w = *reinterpret_cast<const __nv_bfloat162*>(p);
  v[0] = __low2float(w);
  v[1] = __high2float(w);
}

// Window sources. view(c, base) is channel c's stream (the
// history-prepended input) from sample base on. at(i) is the place of its
// sample i, step(p, n) moves a place n samples on, and load(p, &a, &b) reads
// the sample at p and returns false, leaving a and b alone, where the stream
// has no such sample. A view does once, per thread, the 64-bit work of a
// window and a place carries what a sample's address needs, so the samples a
// thread stages cost a few 32-bit operations each. A kernel body templated on
// the source computes the same bits from any of them. kBytes: bytes a sample
// a plane. For 2-byte samples load2(p, a, b) reads samples p and p + 1 (p
// even) with one 4-byte load a plane, where Paired says it may.

// Raw planes x [C, 2, L].
template <typename T>
struct Planes {
  static constexpr int kBytes = sizeof(T);
  static constexpr bool kPaired = false;
  const T* x;
  long long L;
  struct View {
    const T* xc;   // the channel's first plane
    long long base, L;
    int lo, hi;    // the samples it has: base + [lo, hi)
    __device__ __forceinline__ int at(int i) const { return i; }
    __device__ __forceinline__ void step(int& i, int n) const { i += n; }
    __device__ __forceinline__ bool load(int i, float* a, float* b) const {
      if (i < lo || i >= hi) return false;
      *a = to_f32(xc[base + i]);
      *b = to_f32(xc[L + base + i]);
      return true;
    }
    __device__ __forceinline__ bool load2(int i, float* a, float* b) const {
      if (i < lo || i >= hi) return false;  // lo, hi even when paired
      pair_f32(xc + base + i, a);
      pair_f32(xc + L + base + i, b);
      return true;
    }
  };
  __device__ __forceinline__ View view(int c, long long base) const {
    const long long lo = -base, hi = L - base;
    return {x + (long long)c * 2 * L, base, L, (int)(lo > 0 ? lo : 0),
            (int)(hi < 0 ? 0 : hi > INT32_MAX ? INT32_MAX : hi)};
  }
};

// Producer frames xr_f, xi_f [C, NT, span]: frame row r holds stream samples
// [r*stride, r*stride + span), so rows overlap by span - stride. Sample g is
// read from row min(g / stride, NT - 1), the row that deframe
// (kernels/mixfir_preframed.py) takes it from, whatever row a block's outputs
// lie in: a window that spans several rows reads each sample from its own
// frame. The stream ends at (NT - 1)*stride + span and has no samples left
// of 0. A view starts at row0 = floor(base / stride); a place is a row past
// row0 and a column, found by one division at the start of a batch and then
// moved on by adds.
template <typename T>
struct Frames {
  static constexpr int kBytes = sizeof(T);
  static constexpr bool kPaired = false;
  const T* xr;
  const T* xi;
  int NT, stride, span;
  struct Pos {
    int dr, col;  // row row0 + dr, column col < stride of the unclamped rows
  };
  struct View {
    const T* pr;  // channel c's row row0 in xr_f, in xi_f
    const T* pi;
    int off0, first, last, stride, span;  // rows row0 + [first, last] exist
    __device__ __forceinline__ Pos at(int i) const {
      const int off = off0 + i;
      const int dr = off / stride;
      return {dr, off - dr * stride};
    }
    __device__ __forceinline__ void step(Pos& p, int n) const {
      for (p.col += n; p.col >= stride; p.col -= stride) ++p.dr;
    }
    __device__ __forceinline__ bool element(Pos p, long long* k) const {
      if (p.dr > last) {  // past the last row's start: its tail
        p.col += (p.dr - last) * stride;
        p.dr = last;
      }
      if (p.dr < first || p.col >= span) return false;
      *k = (long long)p.dr * span + p.col;
      return true;
    }
    __device__ __forceinline__ bool load(Pos p, float* a, float* b) const {
      long long k;
      if (!element(p, &k)) return false;
      *a = to_f32(pr[k]);
      *b = to_f32(pi[k]);
      return true;
    }
    __device__ __forceinline__ bool load2(Pos p, float* a, float* b) const {
      long long k;  // even, and k + 1 in the same row: stride and span are even
      if (!element(p, &k)) return false;
      pair_f32(pr + k, a);
      pair_f32(pi + k, b);
      return true;
    }
  };
  __device__ __forceinline__ View view(int c, long long base) const {
    long long row0 = base / stride;
    if (row0 * stride > base) --row0;  // floor
    const long long k0 = ((long long)c * NT + row0) * span;
    return {xr + k0, xi + k0, (int)(base - row0 * stride), (int)-row0, (int)(NT - 1 - row0),
            stride, span};
  }
};

// History and body as two operands, one channel: x_hist [2, H] and x_body
// [2, N], each plane contiguous, with plane strides hs and bs (so slices of
// one [2, H + N] array serve as they are). Stream sample g is x_hist[g] for
// g < H and x_body[g - H] after it: the history-prepended stream without the
// concat.
template <typename T>
struct Split {
  static constexpr int kBytes = sizeof(T);
  static constexpr bool kPaired = false;
  const T* xh;
  const T* xb;
  long long H, N, hs, bs;
  struct View {
    const T* xh;
    const T* xb;
    long long kh, kb, hs, bs;  // element of window sample 0 in x_hist, in x_body
    int lo, mid, hi;           // samples [lo, mid) lie in x_hist, [mid, hi) in x_body
    __device__ __forceinline__ int at(int i) const { return i; }
    __device__ __forceinline__ void step(int& i, int n) const { i += n; }
    __device__ __forceinline__ bool load(int i, float* a, float* b) const {
      if (i < lo || i >= hi) return false;
      const bool h = i < mid;
      const T* p = h ? xh : xb;
      const long long k = (h ? kh : kb) + i;
      *a = to_f32(p[k]);
      *b = to_f32(p[(h ? hs : bs) + k]);
      return true;
    }
  };
  __device__ __forceinline__ View view(int, long long base) const {
    auto clip = [](long long v) { return (int)(v < 0 ? 0 : v > INT32_MAX ? INT32_MAX : v); };
    return {xh, xb, base, base - H, hs, bs, clip(-base), clip(H - base), clip(H + N - base)};
  }
};

// A 2-byte source whose windows the host has checked for pairs: planes or
// rows 4-byte aligned, with an even length, stride and span, and every
// window starting on an even sample. stage_window reads it two samples a
// load.
template <class Src>
struct Paired : Src {
  static constexpr bool kPaired = true;
};

// Whether a bf16 source may go Paired: its pointers 4-byte aligned and the
// sizes given even.
inline bool pairs_fit(std::initializer_list<const void*> ptrs,
                      std::initializer_list<long long> sizes) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) & 3) return false;
  for (long long n : sizes)
    if (n & 1) return false;
  return true;
}

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

// Sample (a, b) times the NCO phasor of its u32 word w, in place.
__device__ __forceinline__ void mix_sample(float& a, float& b, uint32_t w) {
  float cs, sn;
  phasor(w, &cs, &sn);
  const float mr = a * cs - b * sn;
  const float mi = a * sn + b * cs;
  a = mr;
  b = mi;
}

// Stage samples [base, base + len) of channel c into shared memory (zero
// where the source has none), sample i at at(i). With MIX, each sample is
// multiplied once by the NCO phasor of its u32 word w0 + g * dw. A thread
// reads BATCH samples (blockDim.x apart) before it mixes and stores any, so
// that BATCH loads a plane are in flight at once. 2-byte samples with
// BATCH > 1 go as pairs from a Paired source: BATCH pairs a thread
// (2*blockDim.x samples apart), one 4-byte load each, the same bytes as
// 2*BATCH samples (each mixed by its own word with MIX); unmixed from
// another 2-byte source, 2*BATCH samples a thread.
template <bool MIX, class Src, class Index = DenseIndex, int BATCH = 1>
__device__ __forceinline__ void stage_window(const Src& src, int c, long long base, int len,
                                             uint32_t w0, uint32_t dw,
                                             float* sr, float* si, Index at = Index{}) {
  constexpr bool kWide = !MIX && BATCH > 1 && Src::kBytes == 2;
  constexpr int B = kWide ? 2 * BATCH : BATCH;
  const auto view = src.view(c, base);
  if constexpr (BATCH > 1 && Src::kBytes == 2 && Src::kPaired) {
    for (int i0 = 2 * threadIdx.x; i0 < len; i0 += 2 * BATCH * blockDim.x) {
      float a[BATCH][2], b[BATCH][2];
      bool got[BATCH];
      auto p = view.at(i0);
#pragma unroll
      for (int q = 0; q < BATCH; ++q) {
        const int i = i0 + 2 * q * (int)blockDim.x;
        got[q] = i < len && view.load2(p, a[q], b[q]);
        view.step(p, 2 * blockDim.x);
      }
#pragma unroll
      for (int q = 0; q < BATCH; ++q) {
        const int i = i0 + 2 * q * (int)blockDim.x;
        if (i >= len) break;
        if (MIX && got[q]) {
          mix_sample(a[q][0], b[q][0], w0 + (uint32_t)(base + i) * dw);
          mix_sample(a[q][1], b[q][1], w0 + (uint32_t)(base + i + 1) * dw);
        }
        sr[at(i)] = got[q] ? a[q][0] : 0.f;
        si[at(i)] = got[q] ? b[q][0] : 0.f;
        if (i + 1 < len) {
          sr[at(i + 1)] = got[q] ? a[q][1] : 0.f;
          si[at(i + 1)] = got[q] ? b[q][1] : 0.f;
        }
      }
    }
  } else {
    for (int i0 = threadIdx.x; i0 < len; i0 += B * blockDim.x) {
      float a[B], b[B];
      bool got[B];
      auto p = view.at(i0);
#pragma unroll
      for (int q = 0; q < B; ++q) {
        const int i = i0 + q * (int)blockDim.x;
        a[q] = b[q] = 0.f;
        got[q] = i < len && view.load(p, &a[q], &b[q]);
        view.step(p, blockDim.x);
      }
#pragma unroll
      for (int q = 0; q < B; ++q) {
        const int i = i0 + q * (int)blockDim.x;
        if (i >= len) break;
        if (got[q] && MIX) mix_sample(a[q], b[q], w0 + (uint32_t)(base + i) * dw);
        sr[at(i)] = a[q];
        si[at(i)] = b[q];
      }
    }
  }
}

// Real-tap FIR output from a staged (mixed) window: sum_a h[a] * s[e - a],
// one FMA chain per plane (K18's; the ring of fir_ring.cuh runs the same
// chain per output, register-blocked).
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
