// The arithmetic of K10's and K11's bodies past fft_regs.cuh's powers of two
// (fft_mixed.cu: one block a frame up to 16384 points; fft_4step.cu: the
// four-step's column and row transforms). kernels/fft_pallas.py mirrors every
// index map here (_mixed_*, _line_*, _odd_* and the generic _line_*), and
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
// 1024 x 1021 or 17 in 136 x 128) runs the generic in-place passes at the
// end of this file (LinePlan): a run-time radix a pass, a direct DFT pass
// over a prime above 7 into a spare pair of planes, X[k] left at rev[k].
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


// --- generic lines: shapes not instantiated (run-time passes) -----------------

constexpr int kLinesThreads = 256;    // threads of a generic line's block
constexpr int kLinesMaxPasses = 24;   // L <= 2^20: at most 20 passes

// One generic line's passes (kernels/fft_pallas.py LineGeometry).
struct LinePlan {
  int L;        // points of a line
  int lanes;    // lines a block holds
  int passes;
  int direct;   // a pass is a direct DFT over a prime above 7 (the block has 4 planes)
  int tw_size;  // floats of one plane of this plan's table
  int radix[kLinesMaxPasses];
  int span[kLinesMaxPasses];
  int tw_off[kLinesMaxPasses];  // pass q's section of the table
};

// A block's planes in dynamic shared memory: (r, i) its `elems` elements,
// (sr, si) the spare pair of a direct pass.
struct LinePlanes {
  float *r, *i, *sr, *si;
  __device__ LinePlanes(float* smem, int elems) {
    const int plane = lines_plane(elems);
    r = smem;
    i = smem + plane;
    sr = smem + 2 * plane;
    si = smem + 3 * plane;
  }
};

__host__ __device__ inline bool lines_register_radix(int r) {
  return r == 2 || r == 3 || r == 4 || r == 5 || r == 7 || r == 8 || r == 16;
}

// The plan of `passes` radices for lines of L points, `lanes` a block; spans
// as _line_spans, table sections as _line_table_offsets. Returns false if it
// does not fit.
inline bool lines_make_plan(LinePlan& p, const int* radices, int passes, int L, int lanes) {
  if (passes < 0 || passes > kLinesMaxPasses || L <= 0 || lanes <= 0) return false;
  p.L = L;
  p.lanes = lanes;
  p.passes = passes;
  p.direct = 0;
  int m = L, off = 0;
  for (int q = 0; q < passes; ++q) {
    const int r = radices[q];
    if (r < 2 || m % r) return false;
    m /= r;
    p.radix[q] = r;
    p.span[q] = m;
    p.tw_off[q] = off;
    off += (r - 1) * m + r;
    if (!lines_register_radix(r)) p.direct = 1;
  }
  p.tw_size = off;
  return m == 1;
}

// Dynamic shared memory of a block: 2 planes, 4 with a direct pass.
inline size_t lines_smem(const LinePlan& p) {
  return (size_t)(p.direct ? 4 : 2) * lines_plane(p.L * p.lanes) * sizeof(float);
}

__device__ __forceinline__ int lines_at(int j, int lane, int lanes) {
  return fft_regs_pad(j * lanes + lane);
}

// y[k] = sum_n x[n] W_R^{nk} in registers for R = 3, 5, 7 (W_R^j = w[j]).
template <int R>
__device__ __forceinline__ void lines_dft_odd(float (&ar)[kFftRegsVals],
                                              float (&ai)[kFftRegsVals],
                                              const float* __restrict__ wtr,
                                              const float* __restrict__ wti) {
  float wr[R], wi[R], yr[R], yi[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    wr[j] = __ldg(wtr + j);
    wi[j] = __ldg(wti + j);
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    float sr = ar[0], si = ai[0];
#pragma unroll
    for (int n = 1; n < R; ++n) {
      const int j = (n * k) % R;
      sr = fmaf(ar[n], wr[j], fmaf(-ai[n], wi[j], sr));
      si = fmaf(ar[n], wi[j], fmaf(ai[n], wr[j], si));
    }
    yr[k] = sr;
    yi[k] = si;
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    ar[k] = yr[k];
    ai[k] = yi[k];
  }
}

template <int R>
__device__ __forceinline__ void lines_dft(float (&ar)[kFftRegsVals], float (&ai)[kFftRegsVals],
                                          const float* __restrict__ wtr,
                                          const float* __restrict__ wti) {
  if constexpr (R == 3 || R == 5 || R == 7)
    lines_dft_odd<R>(ar, ai, wtr, wti);
  else
    fft_regs_dft<R, 1>(ar, ai, 0);
}

// Pass q (radix R, register butterflies) in place; DIT: the twiddles first.
// tw_r, tw_i: this plan's table; pass q's twiddle (m, n0) at (m - 1) M + n0
// of its section, its DFT constants after them.
template <int R, bool DIT>
__device__ __forceinline__ void lines_pass(float* sr, float* si, const LinePlan& p, int q,
                                           const float* __restrict__ tw_r,
                                           const float* __restrict__ tw_i) {
  const int M = p.span[q], lanes = p.lanes;
  const float* __restrict__ twr = tw_r + p.tw_off[q];
  const float* __restrict__ twi = tw_i + p.tw_off[q];
  const int count = lanes * (p.L / R);
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int lane = i % lanes, bf = i / lanes, n0 = bf % M;
    const int base = (bf - n0) * R + n0;
    float ar[kFftRegsVals], ai[kFftRegsVals];
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const int a = lines_at(base + M * m, lane, lanes);
      ar[m] = sr[a];
      ai[m] = si[a];
    }
    if (DIT && n0) {
#pragma unroll
      for (int m = 1; m < R; ++m) {
        const int e = (m - 1) * M + n0;
        fft_regs_cmul(ar[m], ai[m], __ldg(twr + e), __ldg(twi + e));
      }
    }
    lines_dft<R>(ar, ai, twr + (R - 1) * M, twi + (R - 1) * M);
    if (!DIT && n0) {
#pragma unroll
      for (int m = 1; m < R; ++m) {
        const int e = (m - 1) * M + n0;
        fft_regs_cmul(ar[m], ai[m], __ldg(twr + e), __ldg(twi + e));
      }
    }
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const int a = lines_at(base + M * m, lane, lanes);
      sr[a] = ar[m];
      si[a] = ai[m];
    }
  }
}

// Pass q as a direct DFT over any prime R, from (sr, si) into (dr, di): one
// output a thread, its R inputs read from shared memory.
template <bool DIT>
__device__ __forceinline__ void lines_pass_direct(const float* sr, const float* si, float* dr,
                                                  float* di, const LinePlan& p, int q,
                                                  const float* __restrict__ tw_r,
                                                  const float* __restrict__ tw_i) {
  const int R = p.radix[q], M = p.span[q], lanes = p.lanes;
  const float* __restrict__ twr = tw_r + p.tw_off[q];
  const float* __restrict__ twi = tw_i + p.tw_off[q];
  const float* __restrict__ wtr = twr + (R - 1) * M;  // W_R^j
  const float* __restrict__ wti = twi + (R - 1) * M;
  const int count = lanes * p.L;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int lane = i % lanes, r = i / lanes;
    const int k = r % R, bf = r / R, n0 = bf % M;
    const int base = (bf - n0) * R + n0;
    float accr = 0.f, acci = 0.f;
    int j = 0;  // (n k) mod R
    for (int n = 0; n < R; ++n) {
      const int a = lines_at(base + M * n, lane, lanes);
      float xr = sr[a], xi = si[a];
      if (DIT && n0 && n) {
        const int e = (n - 1) * M + n0;
        fft_regs_cmul(xr, xi, __ldg(twr + e), __ldg(twi + e));
      }
      const float wr = __ldg(wtr + j), wi = __ldg(wti + j);
      accr = fmaf(xr, wr, fmaf(-xi, wi, accr));
      acci = fmaf(xr, wi, fmaf(xi, wr, acci));
      j += k;
      if (j >= R) j -= R;
    }
    if (!DIT && n0 && k) {
      const int e = (k - 1) * M + n0;
      fft_regs_cmul(accr, acci, __ldg(twr + e), __ldg(twi + e));
    }
    const int a = lines_at(base + M * k, lane, lanes);
    dr[a] = accr;
    di[a] = acci;
  }
}

template <bool DIT>
__device__ __forceinline__ void lines_pass_any(float*& sr, float*& si, float*& xr, float*& xi,
                                               const LinePlan& p, int q,
                                               const float* __restrict__ twr,
                                               const float* __restrict__ twi) {
  switch (p.radix[q]) {
    case 2: lines_pass<2, DIT>(sr, si, p, q, twr, twi); break;
    case 3: lines_pass<3, DIT>(sr, si, p, q, twr, twi); break;
    case 4: lines_pass<4, DIT>(sr, si, p, q, twr, twi); break;
    case 5: lines_pass<5, DIT>(sr, si, p, q, twr, twi); break;
    case 7: lines_pass<7, DIT>(sr, si, p, q, twr, twi); break;
    case 8: lines_pass<8, DIT>(sr, si, p, q, twr, twi); break;
    case 16: lines_pass<16, DIT>(sr, si, p, q, twr, twi); break;
    default: {
      lines_pass_direct<DIT>(sr, si, xr, xi, p, q, twr, twi);
      float* t = sr;
      sr = xr;
      xr = t;
      t = si;
      si = xi;
      xi = t;
    }
  }
}

// The whole transform of the block's lines: forward DIF (natural order in,
// X[k] at rev[k] out) or the transposed DIT (rev order in, natural out). The
// data is in (sr, si) on entry and on return (a direct pass swaps it with the
// spare planes xr, xi). Every thread of the block calls it; the caller's
// stores into (sr, si) must be behind a barrier, and it ends with one.
template <bool DIT>
__device__ __forceinline__ void lines_transform(float*& sr, float*& si, float*& xr, float*& xi,
                                                const LinePlan& p,
                                                const float* __restrict__ twr,
                                                const float* __restrict__ twi) {
  for (int s = 0; s < p.passes; ++s) {
    lines_pass_any<DIT>(sr, si, xr, xi, p, DIT ? p.passes - 1 - s : s, twr, twi);
    __syncthreads();
  }
}

// A block's copy of its plan in shared memory (read with run-time pass
// indices, which a kernel parameter would take through local memory).
__device__ __forceinline__ void lines_stage_plan(LinePlan& dst, const LinePlan& src) {
  if (threadIdx.x == 0) {
    dst.L = src.L;
    dst.lanes = src.lanes;
    dst.passes = src.passes;
    dst.direct = src.direct;
    dst.tw_size = src.tw_size;
#pragma unroll
    for (int q = 0; q < kLinesMaxPasses; ++q) {
      dst.radix[q] = src.radix[q];
      dst.span[q] = src.span[q];
      dst.tw_off[q] = src.tw_off[q];
    }
  }
}

}  // namespace srcdsp
