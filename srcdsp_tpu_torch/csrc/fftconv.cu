// Fused overlap-save FFT convolution (K11): replaces
// srcdsp_tpu/kernels/fftconv_pallas.py make_fftconv_kernel.fn (_kernel and
// _kernel_pipelined, one _compute).
//
// One block per (frame, channel). Frame f of channel c is the N = fft_size
// samples at f * hop of the channel's history-prepended stream; the block
// loads them (bit-reversed, fft_common.cuh), runs the forward FFT in shared
// memory, multiplies by H[c] (the FFT of the taps zero-padded to N, made in
// float64 on the host, natural order) and puts the product back in
// bit-reversed order in the same pass (a swap of k and bitrev(k), each pair
// owned by one thread), runs the inverse FFT with conjugate twiddles, and
// stores the last hop samples times 1/N (exact: N is a power of two) to
// y[c, f * hop : (f + 1) * hop]. The first overlap = N - hop samples of each
// inverse are the circular wrap and are never stored. The TPU kernel's
// four-step matrix products, twiddle tiles, karatsuba and pipelined forms
// shape only its matrix unit and DMA; they have no counterpart here.
//
// What bounds it: per output sample 8 bytes read (N/hop = 4/3 times, the
// repeats mostly from L2) and 8 written, against 2 * 5 N log2 N + 6 N flop per
// hop outputs, about 30 flop per output at N = 4096, hop = 3072: under 4 flop
// per byte of device memory, so bytes bound it. The design reads the input
// once per frame and never writes the spectrum to device memory; its cost
// beyond the bytes is the shared-memory passes of the two transforms.
#include "fft_common.cuh"

using namespace srcdsp;

namespace {

__global__ void __launch_bounds__(kFftThreads)
    fftconv_kernel(const float* __restrict__ x, const float* __restrict__ h,
                   const float* __restrict__ twr, const float* __restrict__ twi,
                   float* __restrict__ yr, float* __restrict__ yi, long long L, int F, int hop,
                   int log2n, long long h_stride) {
  extern __shared__ float smem[];
  const int n = 1 << log2n;
  float* sr = smem;
  float* si = smem + fft_plane_floats(n);
  const int f = blockIdx.x;
  const int c = blockIdx.y;
  const float* xr = x + (long long)c * 2 * L + (long long)f * hop;

  fft_load_bitrev(xr, xr + L, sr, si, log2n);
  fft_stages<false>(sr, si, twr, twi, log2n);

  // Z = X * H, stored bit-reversed for the inverse transform
  const float* hr = h + (long long)c * h_stride;
  const float* hi = hr + n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int r = bit_reverse(k, log2n);
    if (k > r) continue;
    const int pk = fft_pad(k), pr = fft_pad(r);
    float zkr, zki;
    cmul<false>(sr[pk], si[pk], __ldg(hr + k), __ldg(hi + k), &zkr, &zki);
    if (k == r) {
      sr[pk] = zkr;
      si[pk] = zki;
      continue;
    }
    float zrr, zri;
    cmul<false>(sr[pr], si[pr], __ldg(hr + r), __ldg(hi + r), &zrr, &zri);
    sr[pr] = zkr;
    si[pr] = zki;
    sr[pk] = zrr;
    si[pk] = zri;
  }
  fft_stages<true>(sr, si, twr, twi, log2n);

  const int overlap = n - hop;
  const float inv_n = 1.0f / (float)n;
  const long long out = (long long)c * F * hop + (long long)f * hop;
  for (int j = threadIdx.x; j < hop; j += blockDim.x) {
    const int k = fft_pad(overlap + j);
    yr[out + j] = sr[k] * inv_n;
    yi[out + j] = si[k] * inv_n;
  }
}

}  // namespace

// x [C, 2, L] f32, L = overlap + F * hop (each channel's history-prepended
// stream); h [Ct, 2, N] f32, Ct = C when per_channel != 0, else 1; tw [2, N/2]
// f32, tw[j] = e^{-2 pi i j / N}; yr, yi [C, F * hop] f32. N = 2^log2n,
// 0 < hop <= N. Returns the launch's cudaError_t (cudaErrorInvalidValue for a
// size the kernel does not take), or 0.
extern "C" int srcdsp_fftconv(const void* x, const void* h, const void* tw, void* yr, void* yi,
                              int C, long long L, int F, int hop, int log2n, int per_channel,
                              void* stream) {
  const int n = 1 << log2n;
  if (log2n < kFftMinLog2 || log2n > kFftMaxLog2 || hop <= 0 || hop > n || C <= 0 ||
      C > 65535 || F <= 0 || L != (long long)(n - hop) + (long long)F * hop)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)fft_plane_floats(n) * sizeof(float);
  cudaError_t err = allow_smem(fftconv_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const float* t = (const float*)tw;
  fftconv_kernel<<<dim3(F, C), kFftThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)h, t, t + n / 2, (float*)yr, (float*)yi, L, F, hop, log2n,
      per_channel ? 2LL * n : 0LL);
  return (int)cudaGetLastError();
}
