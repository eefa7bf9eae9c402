// The device FFT shared by K10 (fft.cu) and K11 (fftconv.cu): one frame of
// N = 2^log2n complex float32 samples (256 <= N <= 8192) transformed in shared
// memory by one block.
//
// Radix-2 decimation in time, in place: the frame is loaded in bit-reversed
// order, then the log2(N) butterfly stages run two at a time (a radix-4 pass:
// each thread carries four samples through both stages in registers, so a
// pass costs one shared-memory round trip for two stages), with one plain
// radix-2 stage first when log2(N) is odd. After the last pass X[k] sits in
// natural order. Twiddles come from a table tw[j] = e^{-2 pi i j / N},
// j < N/2, made in float64 on the host and rounded to float32 once: no sinf
// or cosf per butterfly. The inverse uses the conjugate twiddles. Every
// complex product is written out with explicit roundings (fmaf and
// __fmul_rn), so no instantiation leaves a contraction to the compiler and
// all of them round alike. No atomics: each sample is written by one thread
// per pass.
//
// Shared-memory layout: the real and imaginary planes, each with one float of
// padding after every 32 samples (fft_pad), so the strided accesses (bit
// reversal, the digit-order store) spread over the banks.
#pragma once

#include <cuda_runtime.h>

#include "fsk_common.cuh"

namespace srcdsp {

constexpr int kFftThreads = 256;
constexpr int kFftMinLog2 = 8;   // 256 points
constexpr int kFftMaxLog2 = 13;  // 8192 points: 2 x 8448 floats = 67.6 KB of shared memory

__host__ __device__ __forceinline__ int fft_pad(int k) { return k + (k >> 5); }

// Floats of one padded plane of n samples.
__host__ __device__ __forceinline__ int fft_plane_floats(int n) { return n + (n >> 5); }

__device__ __forceinline__ int bit_reverse(int k, int log2n) {
  return (int)(__brev((unsigned)k) >> (32 - log2n));
}

// a * w, or a * conj(w) when INV.
template <bool INV>
__device__ __forceinline__ void cmul(float ar, float ai, float wr, float wi, float* yr,
                                     float* yi) {
  if (INV) wi = -wi;
  *yr = fmaf(ar, wr, -__fmul_rn(ai, wi));
  *yi = fmaf(ar, wi, __fmul_rn(ai, wr));
}

// Samples [0, N) of a frame from global memory into shared memory, each at
// the padded index of its bit reversal. Reads are coalesced.
__device__ __forceinline__ void fft_load_bitrev(const float* __restrict__ xr,
                                                const float* __restrict__ xi, float* sr,
                                                float* si, int log2n) {
  const int n = 1 << log2n;
  for (int g = threadIdx.x; g < n; g += blockDim.x) {
    const int r = fft_pad(bit_reverse(g, log2n));
    sr[r] = xr[g];
    si[r] = xi[g];
  }
}

// The butterfly stages over the bit-reversed frame in shared memory, leaving
// X[k] = sum_n x[n] e^{-+2 pi i k n / N} (the sign + when INV; no 1/N) at
// fft_pad(k). Starts with a barrier (the caller's stores are then visible) and
// ends with one.
template <bool INV>
__device__ void fft_stages(float* sr, float* si, const float* __restrict__ twr,
                           const float* __restrict__ twi, int log2n) {
  const int n = 1 << log2n;
  int s = 1;  // the next stage: butterflies of length 2^s
  if (log2n & 1) {
    // stage 1 alone: length 2, twiddle 1
    __syncthreads();
    for (int q = threadIdx.x; q < n / 2; q += blockDim.x) {
      const int a = fft_pad(2 * q), b = fft_pad(2 * q + 1);
      const float ur = sr[a], ui = si[a], vr = sr[b], vi = si[b];
      sr[a] = ur + vr;
      si[a] = ui + vi;
      sr[b] = ur - vr;
      si[b] = ui - vi;
    }
    s = 2;
  }
  for (; s < log2n; s += 2) {
    // stages s and s+1 on the quadruple (base, +h, +2h, +3h), h = 2^(s-1):
    // stage s pairs (0,1) and (2,3) with W_{2h}^k; stage s+1 pairs (0,2) with
    // W_{4h}^k and (1,3) with W_{4h}^{k+h} = W_{4h}^k * (-i) (+i when INV)
    __syncthreads();
    const int h = 1 << (s - 1);
    const int step1 = n >> s;        // W_{2h}^k = tw[k * N / 2h]
    const int step2 = n >> (s + 1);  // W_{4h}^k = tw[k * N / 4h]
    for (int q = threadIdx.x; q < n / 4; q += blockDim.x) {
      const int k = q & (h - 1);
      const int base = ((q >> (s - 1)) << (s + 1)) + k;
      const int i0 = fft_pad(base), i1 = fft_pad(base + h), i2 = fft_pad(base + 2 * h),
                i3 = fft_pad(base + 3 * h);
      const float a0r = sr[i0], a0i = si[i0], a1r = sr[i1], a1i = si[i1];
      const float a2r = sr[i2], a2i = si[i2], a3r = sr[i3], a3i = si[i3];
      const float w1r = __ldg(twr + k * step1), w1i = __ldg(twi + k * step1);
      const float w2r = __ldg(twr + k * step2), w2i = __ldg(twi + k * step2);
      float tr, ti;
      cmul<INV>(a1r, a1i, w1r, w1i, &tr, &ti);
      const float b0r = a0r + tr, b0i = a0i + ti, b1r = a0r - tr, b1i = a0i - ti;
      cmul<INV>(a3r, a3i, w1r, w1i, &tr, &ti);
      const float b2r = a2r + tr, b2i = a2i + ti, b3r = a2r - tr, b3i = a2i - ti;
      cmul<INV>(b2r, b2i, w2r, w2i, &tr, &ti);
      sr[i0] = b0r + tr;
      si[i0] = b0i + ti;
      sr[i2] = b0r - tr;
      si[i2] = b0i - ti;
      cmul<INV>(b3r, b3i, w2r, w2i, &tr, &ti);
      const float rr = INV ? -ti : ti;  // t * (-i), or t * (+i) when INV
      const float ri = INV ? tr : -tr;
      sr[i1] = b1r + rr;
      si[i1] = b1i + ri;
      sr[i3] = b1r - rr;
      si[i3] = b1i - ri;
    }
  }
  __syncthreads();
}

}  // namespace srcdsp
