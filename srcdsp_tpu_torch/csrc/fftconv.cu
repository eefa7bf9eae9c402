// Fused overlap-save FFT convolution (K11): replaces
// srcdsp_tpu/kernels/fftconv_pallas.py make_fftconv_kernel.fn (_kernel and
// _kernel_pipelined, one _compute). The TPU kernel's four-step matrix
// products, twiddle tiles, karatsuba and pipelined forms shape only its
// matrix unit and DMA; they have no counterpart here.
//
// Frame f of channel c is the N = fft_size samples at f * hop of the
// channel's history-prepended stream; it gives outputs [f * hop, (f + 1) *
// hop), the last hop samples of IFFT(FFT(frame) * H[c]) (H: the FFT of the
// taps zero-padded to N, made in float64 on the host, natural order). The
// first overlap = N - hop samples of each inverse are the circular wrap and
// are never stored.
//
// What bounds it: per output sample 8 bytes read (N / hop = 4/3 times at
// N = 4096, hop = 3072, the repeats mostly from L2) and 8 written, against
// 2 * 5 N log2 N + 6 N flop per hop outputs, about 30 flop per output: under
// 4 flop per byte of device memory, so bytes bound it (0.128 ms for one
// config-3 chunk of 16 x 1,671,168 samples).
//
// The design: each frame runs K10's register-resident radix-16 Stockham
// schedule (fft_regs.cuh) twice, so between the coalesced load and the
// coalesced store the frame stays in registers and crosses shared memory
// only in the transforms' exchanges (two each at N = 4096, at most 2-way
// bank-conflicted). Thread t of a frame loads sample t + T*s into register
// s; after the forward transform register s holds X[t + T*s], so H, in
// natural order, is read coalesced and multiplied in registers, with no
// bit-reversal pass. The inverse is conj(FFT(conj(Z))) / N, the same forward
// schedule again (fftconv_plain in kernels/fftconv_pallas.py writes it the
// same way); register s then holds y[t + T*s] and is stored where
// t + T*s >= overlap (registers 4..15 at N = 4096, overlap 1024). Blocks are
// FftRegsShape's: one frame of 256 threads at 4096, several frames below, a
// short last block masked by `live`, 512 threads at 8192. Every frame is
// computed the same way wherever it lies, so chunked, streamed and
// time-sharded calls equal one launch bit for bit.
#include "fft_regs.cuh"
#include "fsk_common.cuh"

using namespace srcdsp;

namespace {

// Resident blocks per SM: 2 of 256 threads (up to 128 registers; 1 of 512 at
// N = 8192). At K10's 64 registers, or 80, the two transforms and H spill.
template <int LOG2N>
constexpr int kFftconvMinBlocks =
    FftRegsShape<LOG2N>::kThreads >= 512 ? 1 : 512 / FftRegsShape<LOG2N>::kThreads;

template <int LOG2N>
__global__ void __launch_bounds__(FftRegsShape<LOG2N>::kThreads, kFftconvMinBlocks<LOG2N>)
    fftconv_kernel(const float* __restrict__ x, const float* __restrict__ h,
                   const float* __restrict__ tw, float* __restrict__ yr, float* __restrict__ yi,
                   long long L, int F, int hop, long long h_stride) {
  using S = FftRegsShape<LOG2N>;
  constexpr int N = S::kN, T = S::kT;
  extern __shared__ float smem[];
  const int t = threadIdx.x % T;
  const int local = threadIdx.x / T;
  const int f = blockIdx.x * S::kFrames + local;
  const int c = blockIdx.y;
  const bool live = f < F;  // a short last block still takes every barrier
  float* sr = smem + local * 2 * S::kPlane;
  float* si = sr + S::kPlane;
  const float* xr = x + (long long)c * 2 * L + (long long)f * hop;
  const float* xi = xr + L;

  float vr[kFftRegsVals], vi[kFftRegsVals];
#pragma unroll
  for (int s = 0; s < kFftRegsVals; ++s) {
    vr[s] = live ? xr[t + T * s] : 0.f;
    vi[s] = live ? xi[t + T * s] : 0.f;
  }
  fft_regs_forward<LOG2N>(vr, vi, t, sr, si, tw);

  // Z = X * H, conjugated for the inverse
  const float* hr = h + (long long)c * h_stride;
  const float* hi = hr + N;
#pragma unroll
  for (int s = 0; s < kFftRegsVals; ++s) {
    fft_regs_cmul(vr[s], vi[s], __ldg(hr + t + T * s), __ldg(hi + t + T * s));
    vi[s] = -vi[s];
  }
  __syncthreads();  // the inverse's first exchange writes what the forward's last one read
  fft_regs_forward<LOG2N>(vr, vi, t, sr, si, tw);

  if (!live) return;
  const int overlap = N - hop;
  const float inv_n = 1.0f / (float)N;  // exact: N is a power of two
  const long long out = (long long)c * F * hop + (long long)f * hop - overlap;
#pragma unroll
  for (int s = 0; s < kFftRegsVals; ++s) {
    const int k = t + T * s;
    if (k >= overlap) {
      yr[out + k] = vr[s] * inv_n;
      yi[out + k] = -vi[s] * inv_n;
    }
  }
}

template <int LOG2N>
int launch(const float* x, const float* h, const float* tw, float* yr, float* yi, int C,
           long long L, int F, int hop, long long h_stride, cudaStream_t stream) {
  using S = FftRegsShape<LOG2N>;
  cudaError_t err = allow_smem(fftconv_kernel<LOG2N>, S::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (F + S::kFrames - 1) / S::kFrames;
  fftconv_kernel<LOG2N><<<dim3(blocks, C), S::kThreads, S::kSmem, stream>>>(
      x, h, tw, yr, yi, L, F, hop, h_stride);
  return (int)cudaGetLastError();
}

template <int LOG2N>
int info(int* regs, int* local_bytes, int* blocks_per_sm) {
  using S = FftRegsShape<LOG2N>;
  cudaFuncAttributes attr;
  cudaError_t err = allow_smem(fftconv_kernel<LOG2N>, S::kSmem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fftconv_kernel<LOG2N>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fftconv_kernel<LOG2N>,
                                                        S::kThreads, S::kSmem);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

}  // namespace

// x [C, 2, L] f32, L = overlap + F * hop (each channel's history-prepended
// stream); h [Ct, 2, N] f32, Ct = C when per_channel != 0, else 1; tw the
// [2, kTwiddles] per-pass table of stockham_twiddles(N)
// (kernels/fft_pallas.py); yr, yi [C, F * hop] f32. N = 2^log2n, 256 <= N <=
// 8192, 0 < hop <= N. Returns the launch's cudaError_t (cudaErrorInvalidValue
// for a size the kernel does not take), or 0.
extern "C" int srcdsp_fftconv(const void* x, const void* h, const void* tw, void* yr, void* yi,
                              int C, long long L, int F, int hop, int log2n, int per_channel,
                              void* stream) {
  const int n = 1 << log2n;
  if (log2n < 8 || log2n > 13 || hop <= 0 || hop > n || C <= 0 || C > 65535 || F <= 0 ||
      L != (long long)(n - hop) + (long long)F * hop)
    return (int)cudaErrorInvalidValue;
  const float *a = (const float*)x, *b = (const float*)h, *w = (const float*)tw;
  float *p = (float*)yr, *q = (float*)yi;
  const long long hs = per_channel ? 2LL * n : 0LL;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (log2n) {
    case 8: return launch<8>(a, b, w, p, q, C, L, F, hop, hs, s);
    case 9: return launch<9>(a, b, w, p, q, C, L, F, hop, hs, s);
    case 10: return launch<10>(a, b, w, p, q, C, L, F, hop, hs, s);
    case 11: return launch<11>(a, b, w, p, q, C, L, F, hop, hs, s);
    case 12: return launch<12>(a, b, w, p, q, C, L, F, hop, hs, s);
    default: return launch<13>(a, b, w, p, q, C, L, F, hop, hs, s);
  }
}

// Registers, local-memory bytes (spills) and resident blocks per SM of the
// kernel at N = 2^log2n. Returns the cudaError_t, or 0.
extern "C" int srcdsp_fftconv_info(int log2n, int* regs, int* local_bytes, int* blocks_per_sm) {
  switch (log2n) {
    case 8: return info<8>(regs, local_bytes, blocks_per_sm);
    case 9: return info<9>(regs, local_bytes, blocks_per_sm);
    case 10: return info<10>(regs, local_bytes, blocks_per_sm);
    case 11: return info<11>(regs, local_bytes, blocks_per_sm);
    case 12: return info<12>(regs, local_bytes, blocks_per_sm);
    case 13: return info<13>(regs, local_bytes, blocks_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}
