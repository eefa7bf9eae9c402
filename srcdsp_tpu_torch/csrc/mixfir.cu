// Fused NCO mix + FIR + decimate (K1), and its halo-fused form (K20).
//
// K1 replaces srcdsp_tpu/kernels/mixfir.py (make_mix_fir_kernel and
// make_mix_fir_kernel_mc, both through _compute): the TPU kernel builds
// overlapping windows and runs the FIR as banded-Toeplitz MXU matmuls. Here
// the FIR is a direct convolution from shared memory.
//
// K20 replaces srcdsp_tpu/kernels/halo_fused.py make_halo_fused_kernel
// (_kernel): one time shard of a sharded stream, whose history is its left
// neighbour's last hist samples (or the carried stream tail on shard 0). The
// TPU kernel pushes its own tail to the right neighbour by a remote DMA,
// computes blocks 1..G-1 while it flies and block 0 last. Here the body is
// K1's, templated on its window source: K1 reads Planes, K20 reads Split, the
// history [2, hist] in place through its pointer and plane stride (a peer
// read when the neighbour is on another card) and the shard's body [2, N].
// Only row 0's block reads the history; the other blocks run as soon as they
// are scheduled, which is the overlap the TPU kernel builds by hand. No block
// spins on a flag set by another kernel: nothing guarantees the two would be
// resident together, and the inputs are complete before the launch.
//
// One block per (output row of OT outputs, channel). The block stages the
// row's OT*decim + hist input samples into shared memory, mixing each sample
// once by its exact u32 phase word, then each thread convolves T taps for
// its outputs. Staging reads each input sample from device memory about once
// (rows overlap by hist samples). What bounds it: at T = 64 the work is about
// 8 flop per byte moved, under the H100's ~20 f32 flop per byte, so the
// floor is device-memory bytes; this simple form does not reach it, because
// every FMA issues a shared-memory load (strided by decim, so bank-conflicted)
// and the loads, not the bytes, set its time (about 20 % of the memory roof
// at config-1 shapes on an H100 SXM at 700 W).
//
// Layout (the JAX kernel's): x [C, 2, L] f32 with L = hist + N, the first
// hist samples history; output J of a channel is
//   y[J] = sum_a h[a] * u[J*decim + hist - a],
// u[g] = x[g] * e^{j 2 pi (w0 + g*dw) / 2^32}; yr, yi [C, NT, OT].
#include "fsk_common.cuh"

using namespace srcdsp;

template <class Src>
__device__ __forceinline__ void mixfir_body(const Src& src, int c, uint32_t w0, uint32_t dw,
                                            const float* __restrict__ taps, int taps_stride,
                                            float* __restrict__ yr, float* __restrict__ yi,
                                            int NT, int OT, int decim, int T, int hist) {
  extern __shared__ float smem[];
  const int r = blockIdx.x;
  const int span = OT * decim + hist;
  float* sr = smem;
  float* si = sr + span;
  float* sh = si + span;

  const float* tc = taps + (long long)c * taps_stride;
  for (int a = threadIdx.x; a < T; a += blockDim.x) sh[a] = tc[a];
  stage_window<true>(src, c, r, (long long)r * OT * decim, span, w0, dw, sr, si);
  __syncthreads();

  const long long out = ((long long)c * NT + r) * OT;
  for (int j = threadIdx.x; j < OT; j += blockDim.x) {
    real_dot(sr, si, sh, j * decim + hist, T, &yr[out + j], &yi[out + j]);
  }
}

__global__ void mixfir_kernel(const float* __restrict__ x,
                              const int32_t* __restrict__ words0,
                              const int32_t* __restrict__ dwords,
                              const float* __restrict__ taps, int taps_stride,
                              float* __restrict__ yr, float* __restrict__ yi,
                              int L, int NT, int OT, int decim, int T, int hist) {
  const int c = blockIdx.y;
  mixfir_body(Planes<float>{x, L}, c, (uint32_t)words0[c], (uint32_t)dwords[c], taps,
              taps_stride, yr, yi, NT, OT, decim, T, hist);
}

__global__ void halo_fused_kernel(Split<float> src, uint32_t w0, uint32_t dw,
                                  const float* __restrict__ taps, float* __restrict__ yr,
                                  float* __restrict__ yi, int NT, int OT, int decim, int T,
                                  int hist) {
  mixfir_body(src, 0, w0, dw, taps, 0, yr, yi, NT, OT, decim, T, hist);
}

// taps_stride: 0 when all channels share one [T] tap set, T for [C, T].
// Returns the launch's cudaError_t as an int (0 on success).
extern "C" int srcdsp_mixfir(const void* x, const void* words0, const void* dwords,
                             const void* taps, int taps_stride, void* yr, void* yi,
                             int C, int L, int NT, int OT, int decim, int T, int hist,
                             void* stream) {
  const size_t smem = (size_t)(2 * (OT * decim + hist) + T) * sizeof(float);
  cudaError_t err = allow_smem(mixfir_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  mixfir_kernel<<<dim3(NT, C), kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const int32_t*)words0, (const int32_t*)dwords,
      (const float*)taps, taps_stride, (float*)yr, (float*)yi, L, NT, OT, decim, T, hist);
  return (int)cudaGetLastError();
}

// K20: x_hist [2, hist] and x_body [2, N] f32, each plane contiguous, plane
// strides hist_stride and body_stride; w0 is the word of stream sample 0 (the
// first history sample: word0 + (p*N - hist)*dword for shard p); yr, yi
// [NT, OT]. Launched on `device` (the shard's card); the caller's current
// device is restored on return.
extern "C" int srcdsp_halo_fused(const void* x_hist, const void* x_body, const void* taps,
                                 void* yr, void* yi, unsigned int w0, unsigned int dw,
                                 long long hist_stride, long long body_stride, int N, int NT,
                                 int OT, int decim, int T, int hist, int device, void* stream) {
  DeviceScope on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  const size_t smem = (size_t)(2 * (OT * decim + hist) + T) * sizeof(float);
  cudaError_t err = allow_smem(halo_fused_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  halo_fused_kernel<<<dim3(NT, 1), kThreads, smem, (cudaStream_t)stream>>>(
      Split<float>{(const float*)x_hist, (const float*)x_body, hist, N, hist_stride,
                   body_stride},
      w0, dw, (const float*)taps, (float*)yr, (float*)yi, NT, OT, decim, T, hist);
  return (int)cudaGetLastError();
}
