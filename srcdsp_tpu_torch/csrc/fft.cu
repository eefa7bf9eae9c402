// Batched FFT (K10): replaces srcdsp_tpu/kernels/fft_pallas.py
// make_fft_kernel.fn_rows_p (digit-order store) and make_fft_kernel.fn_nat
// (natural-order store).
//
// The TPU kernel runs the four-step factorization N = n1 * n2 as two DFT
// matrix products on its matrix unit. On CUDA cores that form costs
// 8 N (n1 + n2) flop per frame (5.2 MFLOP at N = 4096, n1 = 32, n2 = 128), 21x
// the 5 N log2 N of a radix FFT, so it is not carried over.
//
// What bounds it: per frame 8 N bytes in and 8 N out against 5 N log2 N flop,
// about 3.75 flop per byte at N = 4096, far under the H100's 67 TFLOP/s /
// 3.35 TB/s = 20, so device memory bounds it: 0.160 ms for 8192 frames of
// 4096. What the design does about it: each sample crosses device memory once
// each way, coalesced, and in between stays in registers (fft_regs.cuh: 16
// samples per thread, radix-16 Stockham passes, 4096 = 16.16.16), so shared
// memory carries only the two exchanges between the three passes, about
// 33 k 4-byte accesses per 4096-point frame, each warp's at most 2-way
// bank-conflicted. A block is 256 threads: one frame at N = 4096, several
// below (16 frames of 256 ... 2 of 2048), one frame of 512 threads at 8192;
// 64 registers a thread keep 4 blocks of 256 on an SM.
//
// The output order is only the store index (`natural`, a kernel argument, so
// both orders run one instantiation of the arithmetic):
//  * natural: X[k] at offset k of the frame, stored from registers (register
//    s of thread t holds X[t + T*s]: consecutive threads, consecutive offsets);
//  * digit (the TPU kernel's layout): X[k] at frame row k mod n1, lane
//    k div n1 of the [n1, n2] frame tile, offset (k mod n1) * n2 + k div n1,
//    staged through shared memory in natural order so that the store to
//    device memory is coalesced.
// Both store the same register values, so the digit store followed by the
// [n1, n2] -> [n2, n1] transpose equals the natural store bit for bit.
#include "fft_regs.cuh"
#include "fsk_common.cuh"

using namespace srcdsp;

namespace {

template <int LOG2N>
__global__ void __launch_bounds__(FftRegsShape<LOG2N>::kThreads, FftRegsShape<LOG2N>::kMinBlocks)
    fft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
               const float* __restrict__ tw, float* __restrict__ yr, float* __restrict__ yi,
               int B, int log2n2, int natural) {
  using S = FftRegsShape<LOG2N>;
  constexpr int N = S::kN, T = S::kT;
  extern __shared__ float smem[];
  const int t = threadIdx.x % T;
  const int local = threadIdx.x / T;
  const long long frame = (long long)blockIdx.x * S::kFrames + local;
  const bool live = frame < B;  // a short last block still takes every barrier
  float* sr = smem + local * 2 * S::kPlane;
  float* si = sr + S::kPlane;
  const long long off = frame * N;

  float vr[kFftRegsVals], vi[kFftRegsVals];
#pragma unroll
  for (int s = 0; s < kFftRegsVals; ++s) {
    vr[s] = live ? xr[off + t + T * s] : 0.f;
    vi[s] = live ? xi[off + t + T * s] : 0.f;
  }
  fft_regs_forward<LOG2N>(vr, vi, t, sr, si, tw);

  if (natural) {
    if (live) {
#pragma unroll
      for (int s = 0; s < kFftRegsVals; ++s) {
        yr[off + t + T * s] = vr[s];
        yi[off + t + T * s] = vi[s];
      }
    }
    return;
  }
  // digit order: stage X in natural order, then offset p = k1 * n2 + k2
  // takes X[k1 + n1 * k2]
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kFftRegsVals; ++s) {
    const int a = fft_regs_pad(t + T * s);
    sr[a] = vr[s];
    si[a] = vi[s];
  }
  __syncthreads();
  if (!live) return;
  const int log2n1 = LOG2N - log2n2;
  const int mask2 = (1 << log2n2) - 1;
#pragma unroll
  for (int s = 0; s < kFftRegsVals; ++s) {
    const int p = t + T * s;
    const int a = fft_regs_pad(((p & mask2) << log2n1) + (p >> log2n2));
    yr[off + p] = sr[a];
    yi[off + p] = si[a];
  }
}

template <int LOG2N>
int launch(const float* xr, const float* xi, const float* tw, float* yr, float* yi, int B,
           int log2n2, int natural, cudaStream_t stream) {
  using S = FftRegsShape<LOG2N>;
  cudaError_t err = allow_smem(fft_kernel<LOG2N>, S::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + S::kFrames - 1) / S::kFrames;
  fft_kernel<LOG2N><<<blocks, S::kThreads, S::kSmem, stream>>>(xr, xi, tw, yr, yi, B, log2n2,
                                                               natural);
  return (int)cudaGetLastError();
}

template <int LOG2N>
int occupancy(int* blocks_per_sm) {
  using S = FftRegsShape<LOG2N>;
  cudaError_t err = allow_smem(fft_kernel<LOG2N>, S::kSmem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fft_kernel<LOG2N>,
                                                             S::kThreads, S::kSmem);
}

}  // namespace

// x planes xr, xi [B, N] f32 (the [B*n1, n2] planes are the same memory);
// tw [2, T] f32, the per-pass twiddle table of stockham_twiddles
// (kernels/fft_pallas.py); yr, yi [B, N] f32 in natural order when
// natural != 0, else in digit order. N = 2^log2n, n2 = 2^log2n2 <= N.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for a size the
// kernel does not take), or 0.
extern "C" int srcdsp_fft(const void* xr, const void* xi, const void* tw, void* yr, void* yi,
                          int B, int log2n, int log2n2, int natural, void* stream) {
  if (log2n2 < 0 || log2n2 > log2n || B <= 0) return (int)cudaErrorInvalidValue;
  const float *a = (const float*)xr, *b = (const float*)xi, *w = (const float*)tw;
  float *c = (float*)yr, *d = (float*)yi;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (log2n) {
    case 8: return launch<8>(a, b, w, c, d, B, log2n2, natural, s);
    case 9: return launch<9>(a, b, w, c, d, B, log2n2, natural, s);
    case 10: return launch<10>(a, b, w, c, d, B, log2n2, natural, s);
    case 11: return launch<11>(a, b, w, c, d, B, log2n2, natural, s);
    case 12: return launch<12>(a, b, w, c, d, B, log2n2, natural, s);
    case 13: return launch<13>(a, b, w, c, d, B, log2n2, natural, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Resident blocks per SM of the kernel at N = 2^log2n, into *blocks_per_sm.
// Returns the cudaError_t, or 0.
extern "C" int srcdsp_fft_occupancy(int log2n, int* blocks_per_sm) {
  switch (log2n) {
    case 8: return occupancy<8>(blocks_per_sm);
    case 9: return occupancy<9>(blocks_per_sm);
    case 10: return occupancy<10>(blocks_per_sm);
    case 11: return occupancy<11>(blocks_per_sm);
    case 12: return occupancy<12>(blocks_per_sm);
    case 13: return occupancy<13>(blocks_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}
