// The arithmetic of K10's and K11's bodies past fft_regs.cuh's powers of two
// (fft_mixed.cu: one block a frame up to 16384 points; fft_4step.cu: the
// four-step's column and row transforms). kernels/fft_pallas.py mirrors every
// index map and table here (_mixed_*, _line_*, _odd_*, _bluestein_*), and
// tests/test_torch_fft_sizes.py runs them in numpy against np.fft.fft and
// checks their shared-memory banks.
//
// A transform of L = P M points, P odd (1, 3, ..., 15), M = 2^LOG2M, both
// template parameters, runs on P * M / 16 threads, 16 complex values a
// thread in registers:
//
//  * forward (decimation in frequency over P): with n = n_m + M n_p and
//    k = k_p + P k_m,
//      X[k_p + P k_m] = sum_{n_m} W_M^{n_m k_m} W_L^{n_m k_p}
//                       sum_{n_p} x[n_m + M n_p] W_P^{n_p k_p}.
//    The odd pass (odd_pass_fwd) takes butterfly n_m's P inputs at rows
//    n_m + M n_p, runs the P-point DFT in registers (odd_dft), multiplies
//    output k_p by W_L^{n_m k_p} and writes it to row n_m + M k_p; then the P
//    sub-transforms over n_m (rows k_p M ... k_p M + M - 1) run fft_regs.cuh's
//    Stockham schedule, thread (k_p, t) holding register s = element
//    t + (M/16) s. After it register s of thread (k_p, t) holds
//    X[k_p + P (t + (M/16) s)].
//  * the transposed order (K11's inverse, from the forward's order back to
//    natural): with n = n_p + P n_m and k = k_m + M k_p,
//      X[k_m + M k_p] = sum_{n_p} W_P^{n_p k_p} W_L^{n_p k_m}
//                       sum_{n_m} x[n_p + P n_m] W_M^{n_m k_m}:
//    the Stockham sub-transforms run first, on the registers exactly where
//    the forward left them, then the odd pass (odd_pass_dit) multiplies input
//    n_p by W_L^{n_p k_m} before its DFT and writes natural order.
//
// So a radix or a length is never chosen at run time, and no butterfly takes
// a run-time % or /. The P-point DFTs (3 ... 15) are register butterflies in
// the symmetric form (the pairs n, P - n), their constants cos and sin
// 2 pi j / P literal float32 values in constant memory (kOddTrig), each the
// float64 value rounded once. The twiddles W_L^{j k} (k = 1 ... P - 1,
// j < M) come from a table made on the host in float64 and rounded to
// float32 once, entry (k - 1) M + j, so neighbouring threads (neighbouring
// j) read neighbouring entries; the Stockham passes read stockham_twiddles(M)
// after it. Products are written with explicit roundings (fft_regs_cmul,
// fmaf), so no instantiation leaves a contraction to the compiler, and every
// frame is computed the same way wherever it lies.
//
// The four-step's lines lie in a tile of `lanes` adjacent lines (a power of
// two), element j of lane l at shared-memory index pad(j lanes + l) of each
// plane (LineAt), lanes fastest among a block's threads, so a warp's
// accesses of one row are consecutive words; the tile loads with cp.async.
// A line of no instantiated shape (an odd factor above 15, as 1021 in
// 1024 x 1021 or 17 in 136 x 128) runs as a Bluestein line at the end of this
// file: a chirp, then the convolution on two M-point register transforms of
// the same schedule at P = 1, M = 2^LOG2M >= 2L - 1.
//
// Registers bound the design: 16 values a thread and 32 warps an SM leave 64
// registers (at 16384 points a frame is 1024 threads, so 64 is the cap), and
// the compiler, given one straight-line kernel, would hoist twiddle loads
// and address arithmetic ahead of the barriers and spill them. So the tables
// are read through opaque pointers with plain loads (lines_opaque), which
// stay behind the barriers, and the indices a store or a second transform
// needs are made from a shared-memory zero read after the transform
// (lines_zero), which nothing can move above its barrier.
#pragma once

#include "fft_regs.cuh"

namespace srcdsp {

// cos and sin of 2 pi j / P for j = 1 ... (P - 1) / 2, P = 3, 5, ..., 15 in
// turn (odd_trig_offset), float32 literals of the float64 values
// (kernels/fft_pallas.py _odd_trig checks each).
static __constant__ float kOddTrig[56] = {
    -0.5f, 0.8660253882408142f,  // 3
    0.30901700258255005f, 0.9510565400123596f, -0.80901700258255f, 0.5877852439880371f,  // 5
    0.6234897971153259f, 0.7818315029144287f, -0.22252093255519867f, 0.9749279022216797f,
    -0.9009688496589661f, 0.4338837265968323f,  // 7
    0.7660444378852844f, 0.6427876353263855f, 0.1736481785774231f, 0.9848077297210693f, -0.5f,
    0.8660253882408142f, -0.9396926164627075f, 0.3420201539993286f,  // 9
    0.8412535190582275f, 0.5406408309936523f, 0.4154150187969208f, 0.9096319675445557f,
    -0.1423148363828659f, 0.9898214340209961f, -0.6548607349395752f, 0.7557495832443237f,
    -0.9594929814338684f, 0.28173255920410156f,  // 11
    0.8854560256004333f, 0.4647231698036194f, 0.5680647492408752f, 0.8229838609695435f,
    0.1205366775393486f, 0.9927088618278503f, -0.35460489988327026f, 0.9350162148475647f,
    -0.7485107779502869f, 0.6631226539611816f, -0.9709418416023254f, 0.23931565880775452f,  // 13
    0.9135454297065735f, 0.4067366421222687f, 0.6691306233406067f, 0.7431448101997375f,
    0.30901700258255005f, 0.9510565400123596f, -0.10452846437692642f, 0.9945219159126282f,
    -0.5f, 0.8660253882408142f, -0.80901700258255f, 0.5877852439880371f,
    -0.9781476259231567f, 0.2079116851091385f,  // 15
};

__host__ __device__ constexpr int odd_trig_offset(int p) {
  return p <= 3 ? 0 : odd_trig_offset(p - 2) + (p - 3);
}

// The P-point DFT y[k] = sum_n x[n] W_P^{nk} of registers x (overwritten),
// each output handed to out(k, re, im) as it is made: with a_n = x_n +
// x_{P-n} and b_n = x_n - x_{P-n} (n = 1 ... (P - 1)/2), A_k = x_0 +
// sum a_n cos(2 pi nk/P), B_k = sum b_n sin(2 pi nk/P), y[k] = A_k - i B_k
// and y[P - k] = A_k + i B_k.
template <int P, class Out>
__device__ __forceinline__ void odd_dft(float (&xr)[P], float (&xi)[P], Out out) {
  constexpr int H = (P - 1) / 2, OFF = odd_trig_offset(P);
  float y0r = xr[0], y0i = xi[0];
#pragma unroll
  for (int n = 1; n <= H; ++n) {
    const float ar = xr[n] + xr[P - n], ai = xi[n] + xi[P - n];
    const float br = xr[n] - xr[P - n], bi = xi[n] - xi[P - n];
    xr[n] = ar;
    xi[n] = ai;
    xr[P - n] = br;
    xi[P - n] = bi;
    y0r += ar;
    y0i += ai;
  }
  out(0, y0r, y0i);
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    float pr = xr[0], pi = xi[0], qr = 0.f, qi = 0.f;
#pragma unroll
    for (int n = 1; n <= H; ++n) {
      const int j = (n * k) % P;  // a constant once unrolled
      if (j == 0) {               // cos 0 = 1, sin 0 = 0 (P = 9, 15)
        pr += xr[n];
        pi += xi[n];
        continue;
      }
      const int u = j <= H ? j : P - j;
      const float c = kOddTrig[OFF + 2 * (u - 1)];
      const float s = j <= H ? kOddTrig[OFF + 2 * (u - 1) + 1] : -kOddTrig[OFF + 2 * (u - 1) + 1];
      pr = fmaf(xr[n], c, pr);
      pi = fmaf(xi[n], c, pi);
      qr = fmaf(xr[P - n], s, qr);
      qi = fmaf(xi[P - n], s, qi);
    }
    out(k, pr + qi, pi - qr);
    out(P - k, pr - qi, pi + qr);
  }
}

// The forward's odd pass over butterflies n_m = t + T i < M: the P inputs at
// rows n_m + M n_p (load(n_m, n_p, re, im)), the DFT, output k times
// W_L^{n_m k} (entry (k - 1) M + n_m of twr, twi) to row n_m + M k
// (store(n_m, k, re, im)). The callers address row n_m + M n as a base of
// n_m plus n times a constant stride, so a butterfly's P addresses share one
// register. The twiddles are plain loads through an opaque table pointer
// (lines_opaque): the read-only path would let the compiler hoist them,
// and the Stockham passes', ahead of the barriers and spill them.
template <int P, int M, int T, class Load, class Store>
__device__ __forceinline__ void odd_pass_fwd(int t, Load load, Store store, const float* twr,
                                             const float* twi) {
  constexpr int I = (M + T - 1) / T;
#pragma unroll 1
  for (int i = 0; i < I; ++i) {
    const int nm = t + T * i;
    if (nm >= M) continue;
    float xr[P], xi[P];
#pragma unroll
    for (int n = 0; n < P; ++n) load(nm, n, xr[n], xi[n]);
    odd_dft<P>(xr, xi, [&](int k, float yr, float yi) {
      if (k) fft_regs_cmul(yr, yi, twr[(k - 1) * M + nm], twi[(k - 1) * M + nm]);
      store(nm, k, yr, yi);
    });
  }
}

// The transposed order's odd pass over butterflies k_m = t + T i < M: the P
// inputs at rows k_m + M n_p (load(k_m, n_p, re, im)), input n_p times
// W_L^{n_p k_m}, the DFT, output k_p to row (and natural index) k_m + M k_p
// (store(k_m, k_p, re, im)).
template <int P, int M, int T, class Load, class Store>
__device__ __forceinline__ void odd_pass_dit(int t, Load load, Store store, const float* twr,
                                             const float* twi) {
  constexpr int I = (M + T - 1) / T;
#pragma unroll 1
  for (int i = 0; i < I; ++i) {
    const int km = t + T * i;
    if (km >= M) continue;
    float xr[P], xi[P];
#pragma unroll
    for (int n = 0; n < P; ++n) {
      load(km, n, xr[n], xi[n]);
      if (n) fft_regs_cmul(xr[n], xi[n], twr[(n - 1) * M + km], twi[(n - 1) * M + km]);
    }
    odd_dft<P>(xr, xi, [&](int k, float yr, float yi) { store(km, k, yr, yi); });
  }
}

// p as an opaque value: loads through it are not merged with the same loads
// made through p before (a second transform reloads its twiddles where it
// needs them instead of keeping the first transform's live across), and
// are plain loads that stay behind the barriers (the read-only path would
// let the compiler hoist them ahead and spill them). Never a shared-memory
// pointer: the compiler would lose its address space.
template <class T>
__device__ __forceinline__ T* lines_opaque(T* p) {
  asm volatile("" : "+l"(p));
  return p;
}

// 0, read from shared memory: a volatile shared load cannot move above a
// barrier, so indices and addresses derived from it are computed after the
// last barrier before it, not hoisted ahead of a transform and kept live
// (spilled) across it. Thread 0 sets it (lines_zero_set) before the
// kernel's first barrier.
__device__ __forceinline__ volatile int& lines_zero_slot() {
  __shared__ int zero;
  return zero;
}
__device__ __forceinline__ void lines_zero_set() {
  if (threadIdx.x == 0) lines_zero_slot() = 0;
}
__device__ __forceinline__ int lines_zero() { return lines_zero_slot(); }

// A transform of L = P 2^LOG2M points on P M / 16 threads (the mirrored
// kernels/fft_pallas.py _line_shape). Its table: the odd section [2, kOdd]
// (W_L^{j k} at (k - 1) M + j), then stockham_twiddles(M) [2, kStock].
template <int P, int LOG2M>
struct LineShape {
  static_assert(P % 2 == 1 && P <= 15 && LOG2M >= 4, "odd factor up to 15, M >= 16");
  static constexpr int kM = 1 << LOG2M, kL = P * kM;
  static constexpr int kTM = kM / kFftRegsVals;  // threads of a sub-transform
  static constexpr int kLog2TM = LOG2M - 4;
  static constexpr int kTL = P * kTM;            // threads of a line
  static constexpr int kOdd = (P - 1) * kM;
  static constexpr int kStock = FftRegsShape<LOG2M>::kTwiddles;
  static constexpr int kTable = 2 * (kOdd + kStock);  // floats of the table
  // Sub-transform k_p and its thread t of a line's thread tl (tl < kTL).
  __device__ __forceinline__ static int kp_of(int tl) { return P == 1 ? 0 : tl >> kLog2TM; }
  __device__ __forceinline__ static int tm_of(int tl) { return P == 1 ? tl : tl & (kTM - 1); }
};

// Element e of sub-transform rows: element j of lane `lane` of the tile at
// pad(j lanes + lane), j = row0 + e (lanes = 1 << log2lanes).
struct LineAt {
  int log2lanes, lane, row0;
  __device__ __forceinline__ int operator()(int e) const {
    return fft_regs_pad(((row0 + e) << log2lanes) + lane);
  }
};

// A block's tile of lines: its two planes, and this thread's lane and its
// index within its line (threadIdx.x = lane + lanes * tl).
struct LineTile {
  float *r, *i;
  int log2lanes, lane, tl;
  __device__ LineTile(float* smem, int plane, int log2lanes_)
      : r(smem), i(smem + plane), log2lanes(log2lanes_),
        lane(threadIdx.x & ((1 << log2lanes_) - 1)), tl(threadIdx.x >> log2lanes_) {}
  __device__ __forceinline__ int at(int j) const { return fft_regs_pad((j << log2lanes) + lane); }
  // at(j + M n) - at(j) for M lanes a multiple of 32
  __device__ __forceinline__ int stride(int M) const {
    return (M << log2lanes) + ((M << log2lanes) >> 5);
  }
  // The same tile with this thread's indices read anew after the last
  // barrier (lines_zero), for what follows a transform.
  __device__ __forceinline__ LineTile fresh() const {
    LineTile c = *this;
    const int t = threadIdx.x + lines_zero();
    c.lane = t & ((1 << log2lanes) - 1);
    c.tl = t >> log2lanes;
    return c;
  }
};

// Floats of one padded plane of `elems` elements.
__host__ __device__ constexpr int lines_plane(int elems) { return fft_regs_pad(elems - 1) + 1; }

// 4 bytes from device memory into shared memory, asynchronously.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src));
}

// A tile's `count` = L lanes elements from (xr, xi) into the planes (r, i),
// element j of lane l (lanes = 1 << log2lanes) from j W + l to pad(j lanes +
// l), by asynchronous copies (no register holds them), then a barrier.
__device__ __forceinline__ void tile_load_async(float* r, float* i, int log2lanes,
                                                const float* __restrict__ xr,
                                                const float* __restrict__ xi, int count,
                                                long long W) {
  const int mask = (1 << log2lanes) - 1;
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const long long g = (long long)(t >> log2lanes) * W + (t & mask);
    const int a = fft_regs_pad(t);
    cp_async4(r + a, xr + g);
    cp_async4(i + a, xi + g);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
}

// The forward transform of this thread's line, its rows in the tile on
// entry (behind a barrier): on return register s holds X[k_p + P (t +
// (M/16) s)] (line_order). tw: the line's table (LineShape), an opaque
// pointer (lines_opaque).
template <int P, int LOG2M>
__device__ __forceinline__ void line_forward(float (&vr)[kFftRegsVals],
                                             float (&vi)[kFftRegsVals], const LineTile& s,
                                             const float* tw) {
  using S = LineShape<P, LOG2M>;
  if constexpr (P > 1) {
    const int rs = s.stride(S::kM);
    odd_pass_fwd<P, S::kM, S::kTL>(
        s.tl,
        [&](int nm, int n, float& re, float& im) {
          const int a = s.at(nm) + n * rs;
          re = s.r[a], im = s.i[a];
        },
        [&](int nm, int k, float re, float im) {
          const int a = s.at(nm) + k * rs;
          s.r[a] = re, s.i[a] = im;
        },
        tw, tw + S::kOdd);
    __syncthreads();
  }
  const int kp = S::kp_of(s.tl), tm = S::tm_of(s.tl);
  const LineAt sub{s.log2lanes, s.lane, kp * S::kM};
#pragma unroll
  for (int q = 0; q < kFftRegsVals; ++q) {
    const int a = sub(tm + S::kTM * q);
    vr[q] = s.r[a];
    vi[q] = s.i[a];
  }
  __syncthreads();  // the first exchange writes what other threads read
  fft_regs_forward<LOG2M, LineAt, false>(vr, vi, tm, s.r, s.i, tw + 2 * S::kOdd, sub);
}

// The transposed order on the registers where line_forward left them
// (register s of thread (k_p, t) holding x[k_p + P (t + (M/16) s)]): the
// Stockham sub-transforms, then (P > 1) the odd pass through the tile. On
// return y[e] in natural order lies in register s at e = t + (M/16) s for
// P = 1, else in the tile's row e (behind a barrier). A second transform in
// a kernel takes s.fresh() and lines_opaque(tw).
template <int P, int LOG2M>
__device__ __forceinline__ void line_forward_dit(float (&vr)[kFftRegsVals],
                                                 float (&vi)[kFftRegsVals], const LineTile& s,
                                                 const float* tw) {
  using S = LineShape<P, LOG2M>;
  const int kp = S::kp_of(s.tl), tm = S::tm_of(s.tl);
  const LineAt sub{s.log2lanes, s.lane, kp * S::kM};
  __syncthreads();  // the first exchange writes what the last transform read
  fft_regs_forward<LOG2M, LineAt, false>(vr, vi, tm, s.r, s.i, tw + 2 * S::kOdd, sub);
  if constexpr (P > 1) {
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kFftRegsVals; ++q) {
      const int a = sub(tm + S::kTM * q);
      s.r[a] = vr[q];
      s.i[a] = vi[q];
    }
    __syncthreads();
    const int rs = s.stride(S::kM);
    odd_pass_dit<P, S::kM, S::kTL>(
        s.tl,
        [&](int km, int n, float& re, float& im) {
          const int a = s.at(km) + n * rs;
          re = s.r[a], im = s.i[a];
        },
        [&](int km, int k, float re, float im) {
          const int a = s.at(km) + k * rs;
          s.r[a] = re, s.i[a] = im;
        },
        tw, tw + S::kOdd);
    __syncthreads();
  }
}

// Registers in line_forward's order to the tile's rows in natural order
// (barriers before and after).
template <int P, int LOG2M>
__device__ __forceinline__ void line_stage(const float (&vr)[kFftRegsVals],
                                           const float (&vi)[kFftRegsVals], const LineTile& s) {
  using S = LineShape<P, LOG2M>;
  const int kp = S::kp_of(s.tl), tm = S::tm_of(s.tl);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kFftRegsVals; ++q) {
    const int a = s.at(kp + P * (tm + S::kTM * q));
    s.r[a] = vr[q];
    s.i[a] = vi[q];
  }
  __syncthreads();
}

// k / d for 0 <= k, d <= 2^20 by a multiply and a shift (m = 2^40 / d + 1,
// made on the host: a 64-bit division in a kernel costs registers).
struct LineDiv {
  unsigned long long m;
  explicit LineDiv(int d) : m((1ull << 40) / (unsigned)d + 1) {}
  __device__ __forceinline__ int operator()(int k) const {
    return (int)(((unsigned long long)k * m) >> 40);
  }
};


// --- Bluestein lines: a line of no register shape ------------------------------
//
// A four-step line of L points that no register shape holds (a prime above
// 15, as 17 in 136 or 1021, or an odd part no two factors up to 15 make, as
// 27 in 864) is the cyclic convolution of length M = 2^LOG2M >= 2L - 1 (512 ...
// 4096) that a chirp makes of it: with c[n] = W_{2L}^{n^2 mod 2L} (n k =
// (n^2 + k^2 - (k - n)^2) / 2),
//   X[k] = c[k] sum_{n < L} x[n] c[n] conj(c[k - n]).
// So, with a[n] = x[n] c[n] zero-padded to M, b[m] = conj(c[m]) for |m| < L
// wrapped mod M (zero elsewhere) and B = FFT_M(b) / M:
//   X[k] = c[k] conj(FFT_M(conj(FFT_M(a) B)))[k],  k < L,
// conj(FFT(conj(Z))) being M IFFT(Z). Both transforms are fft_regs.cuh's
// forward at P = 1 on the tile (line_forward<1, LOG2M>'s schedule: thread t
// of a line holds element t + (M/16) q in register q, in natural order before
// and after), so no radix or length is chosen at run time. The table of a
// line (kernels/fft_pallas.py _bluestein_table): stockham_twiddles(M) [2,
// kStock], B [2, M] in natural order (the forward's order at P = 1), c [2, L];
// every entry made on the host in float64 from integer exponents (n^2 mod 2L
// in 64-bit integers) and rounded to float32 once, so the device computes no
// sin or cos. The table is read through lines_opaque and the indices after
// each transform come from lines_zero, as for the register lines.

template <int LOG2M>
struct BluesteinShape {
  static_assert(LOG2M >= 9 && LOG2M <= 12, "M = 512 ... 4096");
  static constexpr int kM = 1 << LOG2M;
  static constexpr int kT = kM / kFftRegsVals;           // threads of a line
  static constexpr int kStock = FftRegsShape<LOG2M>::kTwiddles;
  static constexpr int kB = 2 * kStock;                  // B's planes in the table
  static constexpr int kChirp = kB + 2 * kM;             // c's planes
};

// Register q of thread t of this thread's line <- element t + (M/16) q of its
// lane in the tile, for elements below L (behind the tile's barrier).
template <int LOG2M>
__device__ __forceinline__ void bluestein_load(float (&vr)[kFftRegsVals],
                                               float (&vi)[kFftRegsVals], const LineTile& s,
                                               int L) {
  using S = BluesteinShape<LOG2M>;
#pragma unroll
  for (int q = 0; q < kFftRegsVals; ++q) {
    const int n = s.tl + S::kT * q;
    if (n < L) {
      const int a = s.at(n);
      vr[q] = s.r[a];
      vi[q] = s.i[a];
    }
  }
}

// The L-point DFT of this thread's line in registers: on entry register q of
// thread t (s.tl) holds x[t + (M/16) q] (registers at L and past it are not
// read); on return X[t + (M/16) q] where t + (M/16) q < L. The tile is the
// transforms' exchange space: it starts with a barrier, so the caller's last
// reads of the tile may precede it; a store through the tile afterwards needs
// a barrier first (line_stage has it). tw: the line's table.
template <int LOG2M>
__device__ __forceinline__ void bluestein_line(float (&vr)[kFftRegsVals],
                                               float (&vi)[kFftRegsVals], const LineTile& s,
                                               int L, const float* tw) {
  using S = BluesteinShape<LOG2M>;
  {
    const float* cr = lines_opaque(tw) + S::kChirp;
    const float* ci = cr + L;
#pragma unroll
    for (int q = 0; q < kFftRegsVals; ++q) {
      const int n = s.tl + S::kT * q;
      if (n < L) {
        fft_regs_cmul(vr[q], vi[q], cr[n], ci[n]);
      } else {
        vr[q] = 0.f;
        vi[q] = 0.f;
      }
    }
  }
  __syncthreads();  // the first exchange writes what the caller last read
  fft_regs_forward<LOG2M, LineAt, false>(vr, vi, s.tl, s.r, s.i, lines_opaque(tw),
                                         LineAt{s.log2lanes, s.lane, 0});
  // times B where the forward left it (natural order), conjugated
  const LineTile s2 = s.fresh();
  {
    const float* br = lines_opaque(tw) + S::kB;
    const float* bi = br + S::kM;
#pragma unroll
    for (int q = 0; q < kFftRegsVals; ++q) {
      const int k = s2.tl + S::kT * q;
      fft_regs_cmul(vr[q], vi[q], br[k], bi[k]);
      vi[q] = -vi[q];
    }
  }
  __syncthreads();  // the second transform's first exchange writes what the first's last read
  fft_regs_forward<LOG2M, LineAt, false>(vr, vi, s2.tl, s2.r, s2.i, lines_opaque(tw),
                                         LineAt{s2.log2lanes, s2.lane, 0});
  // conjugated and times c[k]
  const LineTile s3 = s.fresh();
  const float* cr = lines_opaque(tw) + S::kChirp;
  const float* ci = cr + L;
#pragma unroll
  for (int q = 0; q < kFftRegsVals; ++q) {
    const int k = s3.tl + S::kT * q;
    if (k < L) {
      vi[q] = -vi[q];
      fft_regs_cmul(vr[q], vi[q], cr[k], ci[k]);
    }
  }
}

}  // namespace srcdsp
