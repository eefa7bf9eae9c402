// The register-resident Stockham FFT of K10 (fft.cu): one frame of
// N = 2^LOG2N complex float32 samples (256 <= N <= 8192 there; fft_lines.cuh
// runs it on the power-of-two factor of the other sizes, 16 <= N <= 16384),
// forward transform, X[k] = sum_n x[n] e^{-2 pi i k n / N}, no scaling.
//
// Each of T = N/16 threads of a frame keeps 16 complex samples in registers.
// The transform runs as radix-16 passes with at most one radix-2, -4 or -8
// pass last for the leftover factor (4096 = 16.16.16, 8192 = 16.16.16.2,
// 2048 = 16.16.8, ...). In the Stockham form every pass reads its inputs at
// the same places, thread t's register s holding element t + T*s, and writes
// its outputs where the next pass reads them in order, so there is no bit
// reversal: pass q, of radix R over spans of NS = R_0 * ... * R_{q-1}, takes
// butterfly j = t + T*g (g < 16/R) from registers s = g + (16/R)*m (m < R),
// multiplies input m by W_N^{m * (j mod NS) * N / (NS * R)}, runs the R-point
// DFT in registers and sends output m to element (j div NS) * NS * R +
// (j mod NS) + m * NS. After the last pass register s of thread t holds
// X[t + T*s], so the natural-order store goes from registers, coalesced.
//
// Between passes the frame crosses shared memory once: each thread writes
// its 16 outputs at their Stockham places, a barrier, each thread reads its
// 16 next inputs (fft_exchange). The index is padded by one float after every
// 32 (fft_regs_pad), which keeps every warp's exchange write and read at most
// 2-way bank-conflicted at every N (kernels/fft_pallas.py mirrors this
// schedule and tests/test_torch_fft.py checks the banks).
//
// Twiddles: inside a butterfly the constant factors of W16 and W8; between
// passes a table made on the host in float64 and rounded to float32 once
// (kernels/fft_pallas.py stockham_twiddles, the values of fft_twiddles laid
// out per pass), read through L1, so a warp reads consecutive entries. Every
// product is written with explicit roundings (fmaf, __fmul_rn), so no
// instantiation leaves a contraction to the compiler.
#pragma once

#include <cuda_runtime.h>

namespace srcdsp {

constexpr int kFftRegsVals = 16;  // complex samples a thread keeps in registers

// Shared-memory index of element i of a plane: one float of padding after every 32.
__host__ __device__ constexpr int fft_regs_pad(int i) { return i + (i >> 5); }

// Radix of pass q: 16, then the leftover 2, 4 or 8 last.
__host__ __device__ constexpr int fft_pass_radix(int log2n, int q) {
  return q < log2n / 4 ? 16 : 1 << (log2n % 4);
}
__host__ __device__ constexpr int fft_pass_count(int log2n) {
  return log2n / 4 + (log2n % 4 != 0);
}
// NS of pass q: the product of the radices before it.
__host__ __device__ constexpr int fft_pass_span(int log2n, int q) {
  return q == 0 ? 1 : fft_pass_span(log2n, q - 1) * fft_pass_radix(log2n, q - 1);
}
// Offset of pass q's twiddles in the table: (R - 1) * NS entries for each pass
// after the first, entry (m - 1) * NS + k holding W_N^{m k N / (NS R)}.
__host__ __device__ constexpr int fft_twiddle_offset(int log2n, int q) {
  return q <= 1 ? 0
                : fft_twiddle_offset(log2n, q - 1) +
                      (fft_pass_radix(log2n, q - 1) - 1) * fft_pass_span(log2n, q - 1);
}

template <int LOG2N>
struct FftRegsShape {
  static constexpr int kN = 1 << LOG2N;
  static constexpr int kT = kN / kFftRegsVals;                   // threads per frame
  static constexpr int kFrames = kT >= 256 ? 1 : 256 / kT;       // frames per block
  static constexpr int kThreads = kT * kFrames;                  // 256 (512 at N = 8192)
  static constexpr int kMinBlocks = 1024 / kThreads;             // 64 registers a thread
  static constexpr int kPlane = fft_regs_pad(kN - 1) + 1;        // floats of one padded plane
  static constexpr size_t kSmem = (size_t)kFrames * 2 * kPlane * sizeof(float);
  static constexpr int kPasses = fft_pass_count(LOG2N);
  static constexpr int kTwiddles = fft_twiddle_offset(LOG2N, kPasses);
};

// x * w with explicit roundings.
__device__ __forceinline__ void fft_regs_cmul(float& xr, float& xi, float wr, float wi) {
  const float yr = fmaf(xr, wr, -__fmul_rn(xi, wi));
  xi = fmaf(xr, wi, __fmul_rn(xi, wr));
  xr = yr;
}

constexpr float kFftCos8 = 0.92387953251128674f;   // cos(pi/8)
constexpr float kFftSin8 = 0.38268343236508978f;   // sin(pi/8)
constexpr float kFftSqrtHalf = 0.70710678118654752f;  // 1/sqrt(2)

// x * W16^E (E < 16 used: 0, 1, 2, 3, 4, 6, 9).
template <int E>
__device__ __forceinline__ void fft_regs_rot16(float& xr, float& xi) {
  if constexpr (E == 0) {
  } else if constexpr (E == 4) {  // -i
    const float t = xr;
    xr = xi;
    xi = -t;
  } else if constexpr (E == 2) {  // (1 - i)/sqrt(2)
    const float t = __fmul_rn(xr + xi, kFftSqrtHalf);
    xi = __fmul_rn(xi - xr, kFftSqrtHalf);
    xr = t;
  } else if constexpr (E == 6) {  // (-1 - i)/sqrt(2)
    const float t = __fmul_rn(xi - xr, kFftSqrtHalf);
    xi = -__fmul_rn(xr + xi, kFftSqrtHalf);
    xr = t;
  } else if constexpr (E == 1) {
    fft_regs_cmul(xr, xi, kFftCos8, -kFftSin8);
  } else if constexpr (E == 3) {
    fft_regs_cmul(xr, xi, kFftSin8, -kFftCos8);
  } else {
    static_assert(E == 9, "W16 exponent");
    fft_regs_cmul(xr, xi, -kFftCos8, kFftSin8);
  }
}

// 2- and 4-point DFTs in place (W4 = -i).
__device__ __forceinline__ void fft_regs_dft2(float& ar, float& ai, float& br, float& bi) {
  const float tr = ar - br, ti = ai - bi;
  ar = ar + br;
  ai = ai + bi;
  br = tr;
  bi = ti;
}

__device__ __forceinline__ void fft_regs_dft4(float& x0r, float& x0i, float& x1r, float& x1i,
                                              float& x2r, float& x2i, float& x3r, float& x3i) {
  const float t0r = x0r + x2r, t0i = x0i + x2i, t1r = x0r - x2r, t1i = x0i - x2i;
  const float t2r = x1r + x3r, t2i = x1i + x3i, t3r = x1r - x3r, t3i = x1i - x3i;
  x0r = t0r + t2r;
  x0i = t0i + t2i;
  x2r = t0r - t2r;
  x2i = t0i - t2i;
  x1r = t1r + t3i;  // t1 + (-i) t3
  x1i = t1i - t3r;
  x3r = t1r - t3i;  // t1 - (-i) t3
  x3i = t1i + t3r;
}

// The R-point DFT of registers a[g + G*m], m < R, in place: y[m] = sum_n
// a[n] W_R^{nm}. R = 16 and 8 split n = 4 n1 + n2, m = m1 + (R/4) m2: the
// R/4-point DFTs over n1, the twiddles W_R^{n2 m1}, the 4-point DFTs over n2.
template <int R, int G>
__device__ __forceinline__ void fft_regs_dft(float (&ar)[kFftRegsVals], float (&ai)[kFftRegsVals],
                                             int g) {
  float xr[R], xi[R];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    xr[m] = ar[g + G * m];
    xi[m] = ai[g + G * m];
  }
  if constexpr (R == 2) {
    fft_regs_dft2(xr[0], xi[0], xr[1], xi[1]);
  } else if constexpr (R == 4) {
    fft_regs_dft4(xr[0], xi[0], xr[1], xi[1], xr[2], xi[2], xr[3], xi[3]);
  } else {
    constexpr int A = R / 4;  // points of the first DFTs (4 for R 16, 2 for R 8)
    // first DFTs over n1: x[n2 + 4 n1] -> x[n2 + 4 m1]
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) {
      if constexpr (A == 4)
        fft_regs_dft4(xr[n2], xi[n2], xr[n2 + 4], xi[n2 + 4], xr[n2 + 8], xi[n2 + 8],
                      xr[n2 + 12], xi[n2 + 12]);
      else
        fft_regs_dft2(xr[n2], xi[n2], xr[n2 + 4], xi[n2 + 4]);
    }
    // twiddles W_R^{n2 m1} = W16^{(16/R) n2 m1}
    constexpr int K = 16 / R;
    fft_regs_rot16<K * 1>(xr[5], xi[5]);
    fft_regs_rot16<K * 2>(xr[6], xi[6]);
    fft_regs_rot16<K * 3>(xr[7], xi[7]);
    if constexpr (A == 4) {
      fft_regs_rot16<2>(xr[9], xi[9]);
      fft_regs_rot16<4>(xr[10], xi[10]);
      fft_regs_rot16<6>(xr[11], xi[11]);
      fft_regs_rot16<3>(xr[13], xi[13]);
      fft_regs_rot16<6>(xr[14], xi[14]);
      fft_regs_rot16<9>(xr[15], xi[15]);
    }
    // 4-point DFTs over n2: x[4 m1 + n2] -> x[4 m1 + m2] = y[m1 + A m2]
#pragma unroll
    for (int m1 = 0; m1 < A; ++m1)
      fft_regs_dft4(xr[4 * m1], xi[4 * m1], xr[4 * m1 + 1], xi[4 * m1 + 1], xr[4 * m1 + 2],
                    xi[4 * m1 + 2], xr[4 * m1 + 3], xi[4 * m1 + 3]);
#pragma unroll
    for (int m1 = 0; m1 < A; ++m1)
#pragma unroll
      for (int m2 = 0; m2 < 4; ++m2) {
        ar[g + G * (m1 + A * m2)] = xr[4 * m1 + m2];
        ai[g + G * (m1 + A * m2)] = xi[4 * m1 + m2];
      }
    return;
  }
#pragma unroll
  for (int m = 0; m < R; ++m) {
    ar[g + G * m] = xr[m];
    ai[g + G * m] = xi[m];
  }
}

template <int LOG2N, int Q, bool kLdg = true>
__device__ __forceinline__ void fft_regs_pass(float (&vr)[kFftRegsVals],
                                              float (&vi)[kFftRegsVals], int t,
                                              const float* __restrict__ twr,
                                              const float* __restrict__ twi) {
  constexpr int R = fft_pass_radix(LOG2N, Q), NS = fft_pass_span(LOG2N, Q);
  constexpr int G = kFftRegsVals / R, T = FftRegsShape<LOG2N>::kT;
  constexpr int OFF = fft_twiddle_offset(LOG2N, Q);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if constexpr (NS > 1) {
      const int k = (t + T * g) & (NS - 1);  // j mod NS
#pragma unroll
      for (int m = 1; m < R; ++m) {
        const int e = OFF + (m - 1) * NS + k;
        if constexpr (kLdg)
          fft_regs_cmul(vr[g + G * m], vi[g + G * m], __ldg(twr + e), __ldg(twi + e));
        else
          fft_regs_cmul(vr[g + G * m], vi[g + G * m], twr[e], twi[e]);
      }
    }
    fft_regs_dft<R, G>(vr, vi, g);
  }
}

// Shared-memory index of element e of a frame: the padded plane (fft_regs_pad).
// The transform takes any such map (fft_lines.cuh lays a line out across a
// tile of lines).
struct FftPadAt {
  __device__ __forceinline__ int operator()(int e) const { return fft_regs_pad(e); }
};

// Pass Q's outputs to their Stockham places in shared memory, then the next
// pass's inputs back: register s <- element t + T*s, element e at at(e).
// Starts with a barrier when an earlier exchange's reads may still be running.
template <int LOG2N, int Q, class At>
__device__ __forceinline__ void fft_exchange(float (&vr)[kFftRegsVals], float (&vi)[kFftRegsVals],
                                             int t, float* sr, float* si, At at) {
  constexpr int R = fft_pass_radix(LOG2N, Q), NS = fft_pass_span(LOG2N, Q);
  constexpr int G = kFftRegsVals / R, T = FftRegsShape<LOG2N>::kT;
  if constexpr (Q > 0) __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int j = t + T * g;
    const int base = (j / NS) * NS * R + (j & (NS - 1));
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const int a = at(base + m * NS);
      sr[a] = vr[g + G * m];
      si[a] = vi[g + G * m];
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kFftRegsVals; ++s) {
    const int a = at(t + T * s);
    vr[s] = sr[a];
    vi[s] = si[a];
  }
}

template <int LOG2N, int Q, bool kLdg, class At>
__device__ __forceinline__ void fft_regs_passes(float (&vr)[kFftRegsVals],
                                                float (&vi)[kFftRegsVals], int t, float* sr,
                                                float* si, const float* twr, const float* twi,
                                                At at) {
  fft_regs_pass<LOG2N, Q, kLdg>(vr, vi, t, twr, twi);
  if constexpr (Q + 1 < fft_pass_count(LOG2N)) {
    fft_exchange<LOG2N, Q>(vr, vi, t, sr, si, at);
    fft_regs_passes<LOG2N, Q + 1, kLdg>(vr, vi, t, sr, si, twr, twi, at);
  }
}

// The whole transform of one frame. On entry register s of thread t (t < T)
// holds x[t + T*s]; on return X[t + T*s]. sr, si: the two planes of shared
// memory the exchanges use, element e at at(e) (by default this frame's two
// padded planes of kPlane floats each). tw: the [2, kTwiddles] table, read
// as fft_regs_pass's kLdg says. Every thread of the block must call it (it
// has barriers), and the last barrier leaves sr, si free only after the
// caller's next __syncthreads().
template <int LOG2N, class At = FftPadAt, bool kLdg = true>
__device__ __forceinline__ void fft_regs_forward(float (&vr)[kFftRegsVals],
                                                 float (&vi)[kFftRegsVals], int t, float* sr,
                                                 float* si, const float* tw, At at = At()) {
  fft_regs_passes<LOG2N, 0, kLdg>(vr, vi, t, sr, si, tw, tw + FftRegsShape<LOG2N>::kTwiddles,
                                  at);
}

}  // namespace srcdsp
