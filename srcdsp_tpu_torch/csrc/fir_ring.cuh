// The register-ring FIR body shared by every front-end kernel: K1 and K20
// (mixfir.cu), K4, K5 and K17 (ctaps.cu), K2, K3 and K7 (fsk.cu).
//
// A block owns kOutputs = threads*R consecutive outputs of one channel and
// stages their window once into shared memory; each thread then computes R
// consecutive outputs with 2R accumulators in registers.
// For tap a = b*decim + rho, output k reads the sample at position k - b of
// residue rho; a thread keeps, per residue, a ring of R registers with the
// positions its R outputs need, so each shared load feeds R outputs (2 FMAs
// each for real taps, 4 for complex ones) and each group of decim taps loads
// decim new samples. The lanes of a warp read samples S = R*decim apart; the
// window has one float of padding after every S (PaddedIndex), which puts
// the 32 lanes on 32 banks (S + 1 is odd). Taps come as broadcast float4
// loads, zero past T to a whole chunk of R*decim taps. Any other decim runs
// the same kernels with R = 1 (D = 0), one output a thread in tap order: no
// fallback of another kind exists.
//
// Summation order: every output is one fmaf chain per plane over
// a = 0, 1, ..., T-1 (then the zero taps of the last chunk, which add +-0 to
// a sum that starts at +0 and so is never -0: no bit moves), and it depends
// on the tap index alone. Real taps: ar = fmaf(h, vr, ar), ai = fmaf(h, vi,
// ai). Complex taps g = gr + j gi:
//   ar = fmaf(gr, vr, fmaf(-gi, vi, ar));  ai = fmaf(gr, vi, fmaf(gi, vr, ai)),
// the order of the one-output-per-thread forms these bodies replaced, so
// their bits did not move, and every window source gives the same bits.
//
// The ownership and index map are mirrored in numpy by kernels/mixfir.py
// (ring_shape, fir_geometry, fir_base, fir_ring_index, fir_ring_address,
// fir_output) and checked by tests/test_torch_mixfir.py,
// tests/test_torch_ctaps.py and tests/test_torch_fsk_kernels.py.
#pragma once

#include <type_traits>

#include "fsk_common.cuh"

namespace srcdsp {

constexpr int kStageBatch = 8;  // window samples a thread loads before it mixes or stores any

constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }

// Ownership at decimation D (D = 0: any other decimation, read at run time,
// one output a thread); MINB blocks of THREADS resident per SM (the default:
// 64 registers a thread).
template <int D, int R, int THREADS, int MINB = 1024 / THREADS>
struct RingShape {
  static constexpr int kD = D;
  static constexpr int kR = D == 0 ? 1 : R;                       // outputs a thread owns
  static constexpr int kThreads = THREADS;                        // threads of a block
  static constexpr int kMinBlocks = MINB;                         // per SM (launch bounds)
  static constexpr int kOutputs = kThreads * kR;                  // outputs a block owns
  static constexpr int kChunk = D == 0 ? 1 : kR * D;              // taps per chunk
  static constexpr int kLog2Stride = D == 0 ? 5 : ilog2(kR * D);  // padding stride
};

// K1, K20 (and K2 below decim 4; fsk.cu).
template <int D>
using FirShape = RingShape<D, D == 4 ? 4 : 8, D == 4 ? 256 : 128>;
// K4, K5, K17 (complex taps: a second float4 of taps in registers): the same
// numbers, measured apart (bench_torch/ab_ctaps.py); R = 8 at decim 4 spills.
template <int D>
using CtapsShape = RingShape<D, D == 4 ? 4 : 8, D == 4 ? 256 : 128>;

__host__ __device__ constexpr int fir_pad(int i, int log2s) { return i + (i >> log2s); }

// Shared memory of a ring: the taps (tq floats a plane, zero past T, first
// so that float4 loads are aligned), then the two padded window planes of
// `span` samples, `plane` floats each. The window starts `lead` samples
// before the block's first output's hist-th sample: hist + lead is the
// least multiple of the padding stride that is at least hist, tp - 1 and
// T - 1 + pre, so the zero taps of the last chunk, and an output `pre`
// samples left of the block's first (the FSK bodies' predecessor, pre =
// decim), read inside the window, and every thread's ring sits on a
// multiple of the stride.
struct RingGeometry {
  int tp, tq, lead, span, plane;
};

template <class S>
__host__ __device__ inline RingGeometry ring_geometry(int decim, int T, int hist, int pre = 0) {
  constexpr int kStride = 1 << S::kLog2Stride;
  RingGeometry g;
  g.tp = (T + S::kChunk - 1) / S::kChunk * S::kChunk;
  g.tq = (g.tp + 3) / 4 * 4;
  int need = g.tp - 1 > hist ? g.tp - 1 : hist;
  if (T - 1 + pre > need) need = T - 1 + pre;
  g.lead = (need + kStride - 1) / kStride * kStride - hist;
  g.span = S::kOutputs * decim + hist + g.lead;
  g.plane = fir_pad(g.span - 1, S::kLog2Stride) + 1;
  return g;
}

// One output as a plain chain over taps 0..T-1: the sample of tap a at
// window index e - a (padded with log2s). The D = 0 body, and the FSK
// bodies' predecessor of a block's first output.
template <bool CPLX>
__device__ __forceinline__ void chain_output(const float* __restrict__ hr,
                                             const float* __restrict__ hi,
                                             const float* __restrict__ sr,
                                             const float* __restrict__ si, int e, int T,
                                             int log2s, float* yr, float* yi) {
  float ar = 0.f, ai = 0.f;
  for (int a = 0; a < T; ++a) {
    const int i = fir_pad(e - a, log2s);
    const float vr = sr[i], vi = si[i], h = hr[a];
    if constexpr (CPLX) {
      const float g = hi[a];
      ar = fmaf(h, vr, fmaf(-g, vi, ar));
      ai = fmaf(h, vi, fmaf(g, vr, ai));
    } else {
      ar = fmaf(h, vr, ar);
      ai = fmaf(h, vi, ai);
    }
  }
  *yr = ar;
  *yi = ai;
}

__device__ __forceinline__ float lane_of(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// The ring (D >= 1). Output k of the thread accumulates tap a over the
// sample at window index base + k*D - a (base: output 0 at tap 0, O past a
// multiple of the stride S = R*D, 0 <= O < D; K1's bodies run O = 0, the
// resampler's classes each their own); hr (and hi for complex taps) hold tp
// taps.
template <class S, bool CPLX, int O = 0>
__device__ __forceinline__ void ring_outputs(const float* __restrict__ hr,
                                             const float* __restrict__ hi,
                                             const float* __restrict__ sr,
                                             const float* __restrict__ si, int base, int tp,
                                             float (&ar)[S::kR], float (&ai)[S::kR]) {
  constexpr int D = S::kD, R = S::kR, L2S = S::kLog2Stride, STRIDE = R * D;
  static_assert(D >= 1 && O >= 0 && O < D, "the ring needs a static decimation");
  // ring[rho][(p mod R)] holds the sample at position p of residue rho, index
  // base + p*D - rho; group b (taps b*D .. b*D + D - 1) needs p = -b .. R-1-b.
  // With y a multiple of S and 0 <= m < 2S, fir_pad(y + m) = fir_pad(y) + m
  // + (m >= S): one padded address per chunk, the rest are immediates.
  float wr[D][R], wi[D][R];
  const int pb = fir_pad(base - O, L2S);
#pragma unroll
  for (int rho = 0; rho < D; ++rho)
#pragma unroll
    for (int p = 1; p < R; ++p) {  // index (base - O) + (O + p*D - rho), 0 < O + p*D - rho < S
      wr[rho][p] = sr[pb + O + p * D - rho];
      wi[rho][p] = si[pb + O + p * D - rho];
    }
  for (int a0 = 0; a0 < tp; a0 += STRIDE) {  // a chunk: groups a0/D .. a0/D + R-1, a0/D % R == 0
    const int py = fir_pad(base - O - a0 - STRIDE, L2S);
    float4 h4, g4;
#pragma unroll
    for (int u = 0; u < R; ++u) {
#pragma unroll
      for (int rho = 0; rho < D; ++rho) {
        const int q = u * D + rho;  // a = a0 + q
        if (q % 4 == 0) {
          h4 = *reinterpret_cast<const float4*>(hr + a0 + q);
          if constexpr (CPLX) g4 = *reinterpret_cast<const float4*>(hi + a0 + q);
        }
        const float h = lane_of(h4, q % 4);
        // position -b enters the slot that position R-b left; its index is
        // base - a0 - q = (base - O - a0 - S) + (S + O - q)
        const int enter = (R - u) % R;
        const int i = py + (STRIDE + O - q) + (q <= O);
        wr[rho][enter] = sr[i];
        wi[rho][enter] = si[i];
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const float vr = wr[rho][(k - u + R) % R], vi = wi[rho][(k - u + R) % R];
          if constexpr (CPLX) {
            const float g = lane_of(g4, q % 4);
            ar[k] = fmaf(h, vr, fmaf(-g, vi, ar[k]));
            ai[k] = fmaf(h, vi, fmaf(g, vr, ai[k]));
          } else {
            ar[k] = fmaf(h, vr, ar[k]);
            ai[k] = fmaf(h, vi, ai[k]);
          }
        }
      }
    }
  }
}

// The R outputs of one thread, from zero: the ring (base O past a multiple
// of S), or at D = 0 the chain.
template <class S, bool CPLX, int O = 0>
__device__ __forceinline__ void ring_block(const float* __restrict__ hr,
                                           const float* __restrict__ hi,
                                           const float* __restrict__ sr,
                                           const float* __restrict__ si, int base, int tp,
                                           int T, float (&ar)[S::kR], float (&ai)[S::kR]) {
  if constexpr (S::kD == 0) {
    chain_output<CPLX>(hr, hi, sr, si, base, T, S::kLog2Stride, &ar[0], &ai[0]);
  } else {
#pragma unroll
    for (int k = 0; k < S::kR; ++k) ar[k] = ai[k] = 0.f;
    ring_outputs<S, CPLX, O>(hr, hi, sr, si, base, tp, ar, ai);
  }
}

// Taps [T] into shared memory, zero past T up to tp.
__device__ __forceinline__ void stage_taps(const float* __restrict__ taps, int T, int tp,
                                           float* sh) {
  for (int a = threadIdx.x; a < tp; a += blockDim.x) sh[a] = a < T ? taps[a] : 0.f;
}

// Outputs j .. j + R - 1 of a row-major [total] pair, as float4 where R
// allows it and the address is aligned; nothing past total.
template <int R>
__device__ __forceinline__ void store_outputs(float* __restrict__ yr, float* __restrict__ yi,
                                              long long j, long long total, const float (&vr)[R],
                                              const float (&vi)[R]) {
  if constexpr (R % 4 == 0) {
    if (j + R <= total &&
        ((reinterpret_cast<uintptr_t>(yr + j) | reinterpret_cast<uintptr_t>(yi + j)) & 15) == 0) {
#pragma unroll
      for (int k = 0; k < R; k += 4) {
        *reinterpret_cast<float4*>(yr + j + k) = {vr[k], vr[k + 1], vr[k + 2], vr[k + 3]};
        *reinterpret_cast<float4*>(yi + j + k) = {vi[k], vi[k + 1], vi[k + 2], vi[k + 3]};
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (j + k < total) {
      yr[j + k] = vr[k];
      yi[j + k] = vi[k];
    }
}

// f(std::integral_constant<int, D>{}) for the instantiation that runs `decim`.
template <class F>
int by_decim(int decim, F f) {
  switch (decim) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    default: return f(std::integral_constant<int, 0>{});
  }
}

// Registers, local-memory bytes (spills) and resident blocks per SM of a
// kernel at `threads` and `smem`; returns the cudaError_t, or 0.
template <class Kernel>
int kernel_info(Kernel kernel, int threads, size_t smem, int* regs, int* local_bytes,
                int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

}  // namespace srcdsp
