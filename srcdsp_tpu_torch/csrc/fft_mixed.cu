// K10 and K11 one block a frame at the sizes past the powers of two up to
// 16384 points: N = P M, P odd (3, 5, ..., 15; 1 at 16384), M = 1024, 2048 or
// 4096 (16384 at P = 1), a template instantiation each (MIXED_SHAPES).
// Replaces, at those sizes, srcdsp_tpu/kernels/fft_pallas.py
// make_fft_kernel.fn_rows_p / fn_nat (K10) and
// srcdsp_tpu/kernels/fftconv_pallas.py make_fftconv_kernel.fn (K11). The TPU
// kernels run the four-step N = n1 * n2 as DFT matrix products for any
// n2 % 128 == 0, n1 % 8 == 0 (3072, 5120, 11264, 12288, 16384, ...);
// fft.cu's register schedule takes powers of two up to 8192.
//
// What bounds it: as at the powers of two, 8 bytes a sample in and 8 out
// against about 5 N log2 N flop a frame plus the odd DFT's 2 (P - 1) real
// FMAs a sample, under 20 flop a byte, so device memory bounds it: 0.160 ms
// for 2^25 samples. What the design does about it (fft_lines.cuh): a frame is
// one block of N / 16 threads, 16 values a thread in registers. The odd pass
// reads its P inputs a butterfly straight from device memory (coalesced:
// neighbouring threads take neighbouring butterflies), runs the P-point DFT
// in registers and writes the twiddled outputs to shared memory; the P
// sub-transforms of M points then run fft_regs.cuh's radix-16 Stockham
// passes on their registers (two exchanges through shared memory), every
// radix and length a template parameter. So the frame crosses shared memory
// four times and device memory once each way, with no spare planes: two
// padded planes (24 KB at 3072, 92 KB at 11264, 135 KB at 16384), at most 64
// registers a thread where a second block fits, and 16384 in one block of
// 1024 threads.
//
// The output order: register s of thread (k_p, t) holds X[k_p + P (t +
// (M/16) s)]. Both stores stage it in natural order in shared memory at
// mixed_stage(k) = k + k / 31 (a map that keeps every warp's staging write,
// natural read and digit read at most 2-way bank-conflicted at every size
// and n2; tests/test_torch_fft_sizes.py checks it) and read it back in the
// store's order: natural offset k, or digit offset p = (k mod n1) n2 + k div
// n1. Both store the same values, so the digit store, unscrambled, equals
// the natural store bit for bit. At 16384 the natural store goes from the
// registers (X[t + 1024 s]).
//
// K11 multiplies X by H in registers where the forward leaves it: H is laid
// out once on the host in that order (kernels/fftconv_pallas.py,
// entry k_p M + k_m holding H[k_p + P k_m]), so the product reads it
// coalesced. The inverse is conj(FFT(conj(Z))) / N in the transposed order
// (fft_lines.cuh): the Stockham sub-transforms on the registers as they lie,
// one exchange, then the odd pass, whose outputs are the natural-order time
// samples, stored straight to device memory where past the overlap: no
// permutation between the transforms. Every frame is computed the same way
// wherever it lies, so chunked, streamed and time-sharded calls equal one
// launch bit for bit.
#include <type_traits>

#include "fft_lines.cuh"
#include "fir_ring.cuh"

using namespace srcdsp;

namespace {

// The sizes of the one-block body: (P, log2 M).
#define MIXED_SHAPES(X)                                                                     \
  X(3, 10) X(5, 10) X(7, 10) X(9, 10) X(11, 10) X(13, 10) X(15, 10) X(3, 11) X(5, 11) X(7, 11) \
  X(3, 12) X(1, 14)

// p div d = __umulhi(p, m) for m = ceil(2^32 / d), exact for p d < 2^32 (here
// p < 16384 and d <= 16384).
inline unsigned mixed_div(int d) {
  return (unsigned)(((1ull << 32) + (unsigned)d - 1) / (unsigned)d);
}

// Where the natural-order staging keeps X[k] (kernels/fft_pallas.py _mixed_stage).
__host__ __device__ constexpr int mixed_stage(int k) { return k + k / 31; }

template <int P, int LOG2M>
struct MixedShape : LineShape<P, LOG2M> {
  using L = LineShape<P, LOG2M>;
  static constexpr int kN = L::kL, kT = L::kTL;                  // points, threads
  static constexpr int kMinBlocks = kT >= 1024 ? 1 : 1024 / kT;  // 64 registers where 2+ fit
  static constexpr int kSub = L::kM + L::kM / 32;                // floats between sub-transforms
  static constexpr int kPlane = lines_plane(kN) > mixed_stage(kN - 1) + 1
                                    ? lines_plane(kN)
                                    : mixed_stage(kN - 1) + 1;
  static constexpr size_t kSmem = 2 * (size_t)kPlane * sizeof(float);
};

// The forward transform of the frame at (xr, xi) (sample n at n): on return
// register s of thread (k_p, t) holds X[k_p + P (t + (M/16) s)]; the planes
// are free after the caller's next barrier. tw: the table through an opaque
// pointer (fft_lines.cuh lines_opaque: the twiddles are plain loads that
// stay behind the barriers).
template <int P, int LOG2M>
__device__ __forceinline__ void mixed_forward(float (&vr)[kFftRegsVals],
                                              float (&vi)[kFftRegsVals],
                                              const float* __restrict__ xr,
                                              const float* __restrict__ xi, float* sr, float* si,
                                              const float* tw) {
  using S = MixedShape<P, LOG2M>;
  const int t = threadIdx.x, kp = S::kp_of(t), tm = S::tm_of(t);
  if constexpr (P == 1) {
#pragma unroll
    for (int q = 0; q < kFftRegsVals; ++q) {
      vr[q] = xr[t + S::kT * q];
      vi[q] = xi[t + S::kT * q];
    }
  } else {
    odd_pass_fwd<P, S::kM, S::kT>(
        t,
        [&](int nm, int n, float& re, float& im) {
          re = xr[nm + S::kM * n], im = xi[nm + S::kM * n];
        },
        [&](int nm, int k, float re, float im) {
          const int a = fft_regs_pad(nm) + k * S::kSub;
          sr[a] = re, si[a] = im;
        },
        tw, tw + S::kOdd);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kFftRegsVals; ++q) {
      const int a = kp * S::kSub + fft_regs_pad(tm + S::kTM * q);
      vr[q] = sr[a];
      vi[q] = si[a];
    }
    __syncthreads();  // the first exchange writes what other threads read
  }
  fft_regs_forward<LOG2M, FftPadAt, false>(vr, vi, tm, sr + kp * S::kSub, si + kp * S::kSub,
                                            tw + 2 * S::kOdd);
}

// x planes [B, N]; y planes [B, N] natural (DIGIT false) or digit order of
// the caller's [n1, n2] tile. One block a frame.
template <int P, int LOG2M, bool DIGIT>
__global__ void __launch_bounds__(MixedShape<P, LOG2M>::kT, MixedShape<P, LOG2M>::kMinBlocks)
    fft_mixed_kernel(const float* __restrict__ xr, const float* __restrict__ xi, const float* tw,
                     float* __restrict__ yr, float* __restrict__ yi, int n1, int n2,
                     unsigned div2) {
  using S = MixedShape<P, LOG2M>;
  extern __shared__ float smem[];
  float* sr = smem;
  float* si = smem + S::kPlane;
  lines_zero_set();
  const long long off = (long long)blockIdx.x * S::kN;
  float vr[kFftRegsVals], vi[kFftRegsVals];
  mixed_forward<P, LOG2M>(vr, vi, xr + off, xi + off, sr, si, lines_opaque(tw));
  // the store's indices made after the transform (lines_zero)
  const int t = threadIdx.x + lines_zero(), kp = S::kp_of(t), tm = S::tm_of(t);
  if constexpr (P == 1 && !DIGIT) {
#pragma unroll
    for (int q = 0; q < kFftRegsVals; ++q) {
      yr[off + t + S::kT * q] = vr[q];
      yi[off + t + S::kT * q] = vi[q];
    }
    return;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kFftRegsVals; ++q) {
    const int a = mixed_stage(kp + P * (tm + S::kTM * q));
    sr[a] = vr[q];
    si[a] = vi[q];
  }
  __syncthreads();
#pragma unroll 4  // four stores in flight a thread: all sixteen would spill at 64 registers
  for (int q = 0; q < kFftRegsVals; ++q) {
    const int p = t + S::kT * q;
    int k = p;
    if constexpr (DIGIT) {
      const int r = __umulhi(p, div2);  // p div n2; k = (p mod n2) n1 + p div n2
      k = (p - r * n2) * n1 + r;
    }
    const int a = mixed_stage(k);
    yr[off + p] = sr[a];
    yi[off + p] = si[a];
  }
}

// x [C, 2, L] (each channel's history-prepended stream), frame f of channel c
// the N samples at f * hop; h [Ct, 2, N] in the forward's order (entry
// k_p M + k_m holds H[k_p + P k_m]; h_stride 0 for shared taps); y planes
// [C, F * hop]. Grid (F, C).
template <int P, int LOG2M>
__global__ void __launch_bounds__(MixedShape<P, LOG2M>::kT, MixedShape<P, LOG2M>::kMinBlocks)
    fftconv_mixed_kernel(const float* __restrict__ x, const float* h, const float* tw,
                         float* __restrict__ yr, float* __restrict__ yi, long long L, int F,
                         int hop, long long h_stride) {
  using S = MixedShape<P, LOG2M>;
  extern __shared__ float smem[];
  float* sr = smem;
  float* si = smem + S::kPlane;
  const int f = blockIdx.x, c = blockIdx.y;
  lines_zero_set();
  const float* xr = x + (long long)c * 2 * L + (long long)f * hop;
  const float* xi = xr + L;
  float vr[kFftRegsVals], vi[kFftRegsVals];
  mixed_forward<P, LOG2M>(vr, vi, xr, xi, sr, si, lines_opaque(tw));
  // Z = X * H where X lies, conjugated for the inverse; the product and the
  // inverse with this thread's indices made after the forward (lines_zero)
  const int t2 = threadIdx.x + lines_zero(), kp2 = S::kp_of(t2), tm2 = S::tm_of(t2);
  const float* hr = lines_opaque(h) + (long long)c * h_stride + kp2 * S::kM + tm2;
  const float* hi = hr + S::kN;
#pragma unroll
  for (int q = 0; q < kFftRegsVals; ++q) {
    fft_regs_cmul(vr[q], vi[q], hr[S::kTM * q], hi[S::kTM * q]);
    vi[q] = -vi[q];
  }
  __syncthreads();  // the inverse's first exchange writes what the forward's last one read
  tw = lines_opaque(tw);
  fft_regs_forward<LOG2M, FftPadAt, false>(vr, vi, tm2, sr + kp2 * S::kSub, si + kp2 * S::kSub,
                                           tw + 2 * S::kOdd);
  const int overlap = S::kN - hop;
  const float inv_n = 1.0f / (float)S::kN;
  const long long out = (long long)c * F * hop + (long long)f * hop - overlap;
  const int t3 = threadIdx.x + lines_zero();  // the store's indices made after the inverse
  if constexpr (P == 1) {
#pragma unroll
    for (int q = 0; q < kFftRegsVals; ++q) {
      const int n = t3 + S::kT * q;
      if (n >= overlap) {
        yr[out + n] = vr[q] * inv_n;
        yi[out + n] = -vi[q] * inv_n;
      }
    }
  } else {
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kFftRegsVals; ++q) {
      const int a = kp2 * S::kSub + fft_regs_pad(tm2 + S::kTM * q);
      sr[a] = vr[q];
      si[a] = vi[q];
    }
    __syncthreads();
    odd_pass_dit<P, S::kM, S::kT>(
        t3,
        [&](int km, int n, float& re, float& im) {
          const int a = fft_regs_pad(km) + n * S::kSub;
          re = sr[a], im = si[a];
        },
        [&](int km, int k, float re, float im) {
          const int n = km + S::kM * k;
          if (n >= overlap) {
            yr[out + n] = re * inv_n;
            yi[out + n] = -im * inv_n;
          }
        },
        tw, tw + S::kOdd);
  }
}

// Calls fn(std::integral_constant P, std::integral_constant LOG2M) for a
// shape of MIXED_SHAPES; cudaErrorInvalidValue for any other.
template <class Fn>
int with_mixed_shape(int p, int log2m, Fn fn) {
  switch (p * 64 + log2m) {
#define SRCDSP_MIXED_CASE(P, M) \
  case P * 64 + M:              \
    return fn(std::integral_constant<int, P>{}, std::integral_constant<int, M>{});
    MIXED_SHAPES(SRCDSP_MIXED_CASE)
#undef SRCDSP_MIXED_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x planes xr, xi [B, N] f32, N = p 2^log2m; tw the plan's table
// (kernels/fft_pallas.py _reg_line_table: the odd section, then
// stockham_twiddles(M)); yr, yi [B, N] f32, natural order (digit == 0) or the
// digit order of [n1, n2]. Returns the launch's cudaError_t
// (cudaErrorInvalidValue for a shape not instantiated), or 0.
extern "C" int srcdsp_fft_mixed(const void* xr, const void* xi, const void* tw, void* yr,
                                void* yi, int B, int p, int log2m, int n1, int n2, int digit,
                                void* stream) {
  if (B <= 0 || n1 <= 0 || n2 <= 0 || log2m < 0 || log2m > 14 ||
      (long long)n1 * n2 != (long long)p << log2m)
    return (int)cudaErrorInvalidValue;
  return with_mixed_shape(p, log2m, [&](auto pc, auto mc) {
    constexpr int kP = decltype(pc)::value, kLog2M = decltype(mc)::value;
    using S = MixedShape<kP, kLog2M>;
    auto kernel = digit ? fft_mixed_kernel<kP, kLog2M, true> : fft_mixed_kernel<kP, kLog2M, false>;
    cudaError_t err = allow_smem(kernel, S::kSmem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<B, S::kT, S::kSmem, (cudaStream_t)stream>>>(
        (const float*)xr, (const float*)xi, (const float*)tw, (float*)yr, (float*)yi, n1, n2,
        mixed_div(n2));
    return (int)cudaGetLastError();
  });
}

// x [C, 2, L] f32, L = overlap + F * hop; h [Ct, 2, N] f32 in the forward's
// order (kernels/fftconv_pallas.py), Ct = C when per_channel != 0, else 1; tw
// as srcdsp_fft_mixed; yr, yi [C, F * hop]. 0 < hop <= N. Returns the
// launch's cudaError_t, or 0.
extern "C" int srcdsp_fftconv_mixed(const void* x, const void* h, const void* tw, void* yr,
                                    void* yi, int C, long long L, int F, int hop, int p,
                                    int log2m, int per_channel, void* stream) {
  const long long n = (long long)p << (log2m < 0 || log2m > 14 ? 0 : log2m);
  if (log2m < 0 || log2m > 14 || hop <= 0 || hop > n || C <= 0 || C > 65535 || F <= 0 ||
      L != (n - hop) + (long long)F * hop)
    return (int)cudaErrorInvalidValue;
  return with_mixed_shape(p, log2m, [&](auto pc, auto mc) {
    constexpr int kP = decltype(pc)::value, kLog2M = decltype(mc)::value;
    using S = MixedShape<kP, kLog2M>;
    cudaError_t err = allow_smem(fftconv_mixed_kernel<kP, kLog2M>, S::kSmem);
    if (err != cudaSuccess) return (int)err;
    fftconv_mixed_kernel<kP, kLog2M><<<dim3(F, C), S::kT, S::kSmem, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)h, (const float*)tw, (float*)yr, (float*)yi, L, F, hop,
        per_channel ? 2LL * S::kN : 0LL);
    return (int)cudaGetLastError();
  });
}

// Registers, local-memory bytes and resident blocks per SM of the one-block
// kernel `which` (0 K10 natural, 1 K10 digit, 2 K11) at N = p 2^log2m. Returns
// the cudaError_t, or 0.
extern "C" int srcdsp_fft_mixed_info(int which, int p, int log2m, int* regs, int* local_bytes,
                                     int* blocks_per_sm) {
  return with_mixed_shape(p, log2m, [&](auto pc, auto mc) {
    constexpr int kP = decltype(pc)::value, kLog2M = decltype(mc)::value;
    using S = MixedShape<kP, kLog2M>;
    const auto info = [&](auto kernel) {
      return kernel_info(kernel, S::kT, S::kSmem, regs, local_bytes, blocks_per_sm);
    };
    switch (which) {
      case 0: return info(fft_mixed_kernel<kP, kLog2M, false>);
      case 1: return info(fft_mixed_kernel<kP, kLog2M, true>);
      default: return info(fftconv_mixed_kernel<kP, kLog2M>);
    }
  });
}
