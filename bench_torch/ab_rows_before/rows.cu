// Row-form fused NCO mix + FIR + decimate (K18).
//
// Replaces srcdsp_tpu/kernels/mixfir_rows.py make_mix_fir_rows_kernel
// (_kernel): the input is a [2, R, 128] row view of the history-prepended
// planes, each sample is mixed once by a factored phasor
//   e^{j 2 pi (w0 + (row*128 + lane)*dw) / 2^32}
//     = e^{j 2 pi (w0 + row*128*dw) / 2^32} * e^{j 2 pi lane*dw / 2^32},
// and the FIR is K1's direct real-tap convolution. The TPU kernel's chunked
// [B, 128] x [128, BC] matmuls are a matrix-unit lowering with no
// counterpart here.
//
// One block per output row of OT outputs, as K1. Because OT*decim is a
// multiple of 128, the row's window of OT*decim + hist samples is whole rows
// of the view, starting at row r*OT*decim/128. The block makes the 128 lane
// phasors and one phasor per window row (two sincospif per 128 samples where
// K1 makes one per sample), mixes each staged sample by their product
// c = cr*cl - sr*sl, s = cr*sl + sr*cl, then convolves from shared memory.
// Its output equals K1's to float32 rounding of the phasor product, not to
// the bit. What bounds it is what bounds K1 (csrc/mixfir.cu): shared-memory
// loads in the tap loop; the phasors it saves are a small part of the work.
#include "fsk_common.cuh"

using namespace srcdsp;

constexpr int kLane = 128;

__global__ void rows_kernel(const float* __restrict__ x, const float* __restrict__ taps,
                            float* __restrict__ yr, float* __restrict__ yi, uint32_t w0,
                            uint32_t dw, long long L, int OT, int decim, int T, int hist) {
  extern __shared__ float smem[];
  const int r = blockIdx.x;
  const int span = OT * decim + hist;
  const int nrows = span / kLane;
  float* sr = smem;
  float* si = sr + span;
  float* sh = si + span;
  float* cl = sh + T;
  float* sl = cl + kLane;
  float* crw = sl + kLane;
  float* srw = crw + nrows;

  const long long row0 = (long long)r * (OT * decim / kLane);
  for (int a = threadIdx.x; a < T; a += blockDim.x) sh[a] = taps[a];
  for (int l = threadIdx.x; l < kLane; l += blockDim.x) phasor((uint32_t)l * dw, &cl[l], &sl[l]);
  for (int k = threadIdx.x; k < nrows; k += blockDim.x)
    phasor(w0 + (uint32_t)((row0 + k) * kLane) * dw, &crw[k], &srw[k]);
  __syncthreads();

  const float* xr = x + row0 * kLane;
  const float* xi = xr + L;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const int k = i / kLane;
    const int l = i % kLane;
    const float c = crw[k] * cl[l] - srw[k] * sl[l];
    const float s = crw[k] * sl[l] + srw[k] * cl[l];
    const float a = xr[i];
    const float b = xi[i];
    sr[i] = a * c - b * s;
    si[i] = a * s + b * c;
  }
  __syncthreads();

  const long long out = (long long)r * OT;
  for (int j = threadIdx.x; j < OT; j += blockDim.x)
    real_dot(sr, si, sh, j * decim + hist, T, &yr[out + j], &yi[out + j]);
}

// x [2, L] f32 with L = R*128 (the [2, R, 128] view, contiguous), taps f32
// [T], w0/dw u32 words (w0 the word of x sample 0); yr, yi f32 [NT, OT].
// OT*decim and hist are multiples of 128, and row NT-1's window ends inside x.
extern "C" int srcdsp_mixfir_rows(const void* x, const void* taps, void* yr, void* yi,
                                  unsigned int w0, unsigned int dw, long long L, int NT, int OT,
                                  int decim, int T, int hist, void* stream) {
  const int span = OT * decim + hist;
  const size_t smem = (size_t)(2 * span + T + 2 * kLane + 2 * (span / kLane)) * sizeof(float);
  cudaError_t err = allow_smem(rows_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  rows_kernel<<<NT, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)taps, (float*)yr, (float*)yi, w0, dw, L, OT, decim, T,
      hist);
  return (int)cudaGetLastError();
}
