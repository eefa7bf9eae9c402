// Shared device helpers for the mix/FIR/decimate and FSK kernels.
//
// Built by srcdsp_tpu_torch/kernels/_build.py with nvcc for sm_90a, without
// --use_fast_math: sinf, cosf, atan2f and sincospif keep their accurate forms.
#pragma once

#include <cstdint>
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

// Stage samples [base, base + len) of one channel's I and Q planes into
// shared memory; indices outside [0, L) read as zero. With MIX, each sample
// is multiplied once by the NCO phasor of its u32 word w0 + g * dw.
template <bool MIX>
__device__ __forceinline__ void stage_window(const float* __restrict__ xr,
                                             const float* __restrict__ xi,
                                             long long L, long long base, int len,
                                             uint32_t w0, uint32_t dw,
                                             float* sr, float* si) {
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const long long g = base + i;
    float a = 0.f, b = 0.f;
    if (g >= 0 && g < L) {
      a = xr[g];
      b = xi[g];
      if (MIX) {
        float c, s;
        phasor(w0 + (uint32_t)g * dw, &c, &s);
        const float mr = a * c - b * s;
        const float mi = a * s + b * c;
        a = mr;
        b = mi;
      }
    }
    sr[i] = a;
    si[i] = b;
  }
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

}  // namespace srcdsp
