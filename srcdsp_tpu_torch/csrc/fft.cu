// Batched FFT (K10): replaces srcdsp_tpu/kernels/fft_pallas.py
// make_fft_kernel.fn_rows_p (digit-order store) and make_fft_kernel.fn_nat
// (natural-order store).
//
// The TPU kernel runs the four-step factorization N = n1 * n2 as two DFT
// matrix products on its matrix unit. On CUDA cores that form costs
// 8 N (n1 + n2) flop per frame (5.2 MFLOP at N = 4096, n1 = 32, n2 = 128), 21x
// the 5 N log2 N of a radix FFT, so it is not carried over: one block
// transforms one frame with the radix-2/4 FFT of fft_common.cuh in shared
// memory (32 KB of samples at N = 4096).
//
// What bounds it: per frame 8 N bytes in and 8 N out against 5 N log2 N flop,
// about 3.75 flop per byte at N = 4096, far under the H100's 67 TFLOP/s /
// 3.35 TB/s = 20, so device memory bounds it (0.160 ms for 8192 frames of
// 4096). The design reads and writes each sample once, coalesced, and keeps
// every intermediate stage in shared memory; the shared-memory passes
// (log2(N)/2 round trips) are what it spends beyond that.
//
// The output order is only the store index (template flag NATURAL):
//  * natural: X[k] at offset k of the frame;
//  * digit (the TPU kernel's layout): X[k] at frame row k mod n1, lane
//    k div n1 of the [n1, n2] frame tile, offset (k mod n1) * n2 + k div n1.
// Both store the same shared-memory values, so the digit store followed by
// the [n1, n2] -> [n2, n1] transpose equals the natural store bit for bit.
#include "fft_common.cuh"

using namespace srcdsp;

namespace {

template <bool NATURAL>
__global__ void __launch_bounds__(kFftThreads)
    fft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
               const float* __restrict__ twr, const float* __restrict__ twi,
               float* __restrict__ yr, float* __restrict__ yi, int log2n, int log2n2) {
  extern __shared__ float smem[];
  const int n = 1 << log2n;
  float* sr = smem;
  float* si = smem + fft_plane_floats(n);
  const long long off = (long long)blockIdx.x * n;

  fft_load_bitrev(xr + off, xi + off, sr, si, log2n);
  fft_stages<false>(sr, si, twr, twi, log2n);

  if (NATURAL) {
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      yr[off + k] = sr[fft_pad(k)];
      yi[off + k] = si[fft_pad(k)];
    }
  } else {
    // output offset p = k1 * n2 + k2 holds X[k1 + n1 * k2]
    const int log2n1 = log2n - log2n2;
    const int mask2 = (1 << log2n2) - 1;
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      const int k = fft_pad((p >> log2n2) + ((p & mask2) << log2n1));
      yr[off + p] = sr[k];
      yi[off + p] = si[k];
    }
  }
}

template <bool NATURAL>
int launch(const float* xr, const float* xi, const float* tw, float* yr, float* yi, int B,
           int log2n, int log2n2, cudaStream_t stream) {
  const int n = 1 << log2n;
  const size_t smem = 2 * (size_t)fft_plane_floats(n) * sizeof(float);
  cudaError_t err = allow_smem(fft_kernel<NATURAL>, smem);
  if (err != cudaSuccess) return (int)err;
  fft_kernel<NATURAL><<<B, kFftThreads, smem, stream>>>(xr, xi, tw, tw + n / 2, yr, yi, log2n,
                                                        log2n2);
  return (int)cudaGetLastError();
}

}  // namespace

// x planes xr, xi [B, N] f32 (the [B*n1, n2] planes are the same memory);
// tw [2, N/2] f32, tw[j] = e^{-2 pi i j / N}; yr, yi [B, N] f32 in natural order
// when natural != 0, else in digit order. N = 2^log2n, n2 = 2^log2n2 <= N.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for a size the
// kernel does not take), or 0.
extern "C" int srcdsp_fft(const void* xr, const void* xi, const void* tw, void* yr, void* yi,
                          int B, int log2n, int log2n2, int natural, void* stream) {
  if (log2n < kFftMinLog2 || log2n > kFftMaxLog2 || log2n2 < 0 || log2n2 > log2n || B <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (natural)
    return launch<true>((const float*)xr, (const float*)xi, (const float*)tw, (float*)yr,
                        (float*)yi, B, log2n, log2n2, s);
  return launch<false>((const float*)xr, (const float*)xi, (const float*)tw, (float*)yr,
                       (float*)yi, B, log2n, log2n2, s);
}
