// K10 and K11 at the sizes below 16384 that are not powers of two: one block
// a frame, the frame in shared memory. Replaces, at those sizes,
// srcdsp_tpu/kernels/fft_pallas.py make_fft_kernel.fn_rows_p / fn_nat (K10)
// and srcdsp_tpu/kernels/fftconv_pallas.py make_fftconv_kernel.fn (K11). The
// TPU kernels run the four-step N = n1 * n2 as DFT matrix products for any
// n2 % 128 == 0, n1 % 8 == 0 (3072, 5120, 7168, 11264, 12288, ...);
// fft_regs.cuh's register schedule takes only powers of two.
//
// What bounds it: as at the powers of two, 8 bytes a sample in and 8 out
// against about 5 N log2 N flop a frame (a direct DFT over a prime p above 7
// adds 8 p flop a sample), so device memory bounds it: 0.160 ms for 2^25
// samples. What the design does about it: each sample crosses device memory
// once each way, coalesced; in between the frame stays in shared memory
// (24 KB at 3072, 96 KB at 12288, twice that with a direct pass), and the
// passes of fft_lines.cuh run in place on it, each butterfly through
// registers, a barrier between passes. The output order is the store index:
// natural order reads X[k] at rev[k] for offset k, digit order reads
// X[(p mod n2) n1 + p div n2] for offset p, so both store the same shared
// values and the digit store, unscrambled, equals the natural store bit for
// bit. K11 multiplies X[k] by H[k] where the forward passes left it (rev[k],
// H read coalesced in natural order), conjugates, and runs the transposed
// (DIT) passes, which leave natural order: no permutation between the
// transforms. It stores the last hop samples of the conjugated inverse times
// 1/N. Every frame is computed the same way wherever it lies, so chunked,
// streamed and time-sharded calls equal one launch bit for bit.
#include "fft_lines.cuh"
#include "fir_ring.cuh"

using namespace srcdsp;

namespace {

// x planes [B, N]; y planes [B, N] natural (digit == 0) or digit order of
// the caller's [n1, n2] tile. One block a frame.
__global__ void __launch_bounds__(kLinesThreads)
    fft_mixed_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                     const float* __restrict__ tw, const int* __restrict__ rev,
                     float* __restrict__ yr, float* __restrict__ yi, const LinePlan plan, int n1,
                     int n2, int digit) {
  __shared__ LinePlan p;
  extern __shared__ float smem[];
  lines_stage_plan(p, plan);
  const int N = plan.L;
  LinePlanes s(smem, N);
  const long long off = (long long)blockIdx.x * N;
  lines_copy(
      N, [&](int j, float& re, float& im) { re = xr[off + j], im = xi[off + j]; },
      [&](int j, float re, float im) { s.r[fft_regs_pad(j)] = re, s.i[fft_regs_pad(j)] = im; });
  __syncthreads();
  lines_transform<false>(s.r, s.i, s.sr, s.si, p, tw, tw + plan.tw_size);
  for (int q = threadIdx.x; q < N; q += blockDim.x) {
    const int k = digit ? (q % n2) * n1 + q / n2 : q;
    const int a = fft_regs_pad(__ldg(rev + k));
    yr[off + q] = s.r[a];
    yi[off + q] = s.i[a];
  }
}

// x [C, 2, L] (each channel's history-prepended stream), frame f of channel c
// the N samples at f * hop; h [Ct, 2, N] natural order (h_stride 0 for
// shared taps); y planes [C, F * hop]. Grid (F, C).
__global__ void __launch_bounds__(kLinesThreads)
    fftconv_mixed_kernel(const float* __restrict__ x, const float* __restrict__ h,
                         const float* __restrict__ tw, const int* __restrict__ rev,
                         float* __restrict__ yr, float* __restrict__ yi, const LinePlan plan,
                         long long L, int F, int hop, long long h_stride) {
  __shared__ LinePlan p;
  extern __shared__ float smem[];
  lines_stage_plan(p, plan);
  const int N = plan.L;
  LinePlanes s(smem, N);
  const int f = blockIdx.x, c = blockIdx.y;
  const float* xr = x + (long long)c * 2 * L + (long long)f * hop;
  const float* xi = xr + L;
  lines_copy(
      N, [&](int j, float& re, float& im) { re = xr[j], im = xi[j]; },
      [&](int j, float re, float im) { s.r[fft_regs_pad(j)] = re, s.i[fft_regs_pad(j)] = im; });
  __syncthreads();
  lines_transform<false>(s.r, s.i, s.sr, s.si, p, tw, tw + plan.tw_size);
  // Z = X * H where X lies, conjugated for the inverse
  const float* hr = h + (long long)c * h_stride;
  const float* hi = hr + N;
  for (int k = threadIdx.x; k < N; k += blockDim.x) {
    const int a = fft_regs_pad(__ldg(rev + k));
    float zr = s.r[a], zi = s.i[a];
    fft_regs_cmul(zr, zi, __ldg(hr + k), __ldg(hi + k));
    s.r[a] = zr;
    s.i[a] = -zi;
  }
  __syncthreads();
  lines_transform<true>(s.r, s.i, s.sr, s.si, p, tw, tw + plan.tw_size);
  const int overlap = N - hop;
  const float inv_n = 1.0f / (float)N;
  const long long out = (long long)c * F * hop + (long long)f * hop - overlap;
  for (int n = overlap + threadIdx.x; n < N; n += blockDim.x) {
    yr[out + n] = s.r[fft_regs_pad(n)] * inv_n;
    yi[out + n] = -s.i[fft_regs_pad(n)] * inv_n;
  }
}

}  // namespace

// x planes xr, xi [B, N] f32; tw [2, T] (_line_table); rev [N] int32
// (_line_rev); yr, yi [B, N] f32, natural order (digit == 0) or the digit
// order of [n1, n2]; the plan's `passes` radices (_line_radices(N)). Returns
// the launch's cudaError_t (cudaErrorInvalidValue for a plan that does not
// fit), or 0.
extern "C" int srcdsp_fft_mixed(const void* xr, const void* xi, const void* tw, const void* rev,
                                void* yr, void* yi, int B, const int* radices, int passes, int n,
                                int n1, int n2, int digit, void* stream) {
  LinePlan plan{};
  if (B <= 0 || n1 <= 0 || n2 <= 0 || (long long)n1 * n2 != n ||
      !lines_make_plan(plan, radices, passes, n, 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = lines_smem(plan);
  cudaError_t err = allow_smem(fft_mixed_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  fft_mixed_kernel<<<B, kLinesThreads, smem, (cudaStream_t)stream>>>(
      (const float*)xr, (const float*)xi, (const float*)tw, (const int*)rev, (float*)yr,
      (float*)yi, plan, n1, n2, digit);
  return (int)cudaGetLastError();
}

// x [C, 2, L] f32, L = overlap + F * hop; h [Ct, 2, N] f32, Ct = C when
// per_channel != 0, else 1; tw, rev as srcdsp_fft_mixed; yr, yi [C, F * hop].
// 0 < hop <= N. Returns the launch's cudaError_t, or 0.
extern "C" int srcdsp_fftconv_mixed(const void* x, const void* h, const void* tw,
                                    const void* rev, void* yr, void* yi, int C, long long L, int F,
                                    int hop, const int* radices, int passes, int n,
                                    int per_channel, void* stream) {
  LinePlan plan{};
  if (hop <= 0 || hop > n || C <= 0 || C > 65535 || F <= 0 ||
      L != (long long)(n - hop) + (long long)F * hop ||
      !lines_make_plan(plan, radices, passes, n, 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = lines_smem(plan);
  cudaError_t err = allow_smem(fftconv_mixed_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  fftconv_mixed_kernel<<<dim3(F, C), kLinesThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)h, (const float*)tw, (const int*)rev, (float*)yr,
      (float*)yi, plan, L, F, hop, per_channel ? 2LL * n : 0LL);
  return (int)cudaGetLastError();
}

int srcdsp::fft_mixed_info(int which, int smem, int* regs, int* local_bytes,
                           int* blocks_per_sm) {
  if (which == 0)
    return kernel_info(fft_mixed_kernel, kLinesThreads, smem, regs, local_bytes, blocks_per_sm);
  if (which == 1)
    return kernel_info(fftconv_mixed_kernel, kLinesThreads, smem, regs, local_bytes,
                       blocks_per_sm);
  return (int)cudaErrorInvalidValue;
}
