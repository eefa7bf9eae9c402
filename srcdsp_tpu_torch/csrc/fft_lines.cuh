// In-place mixed-radix passes over lines in shared memory: the arithmetic of
// K10's and K11's bodies for the sizes past fft_regs.cuh's powers of two
// (fft_mixed.cu: one block a frame; fft_4step.cu: the four-step's column and
// row transforms). kernels/fft_pallas.py mirrors every index map here
// (_line_radices, _line_spans, _line_elements, _line_twiddle_exponent,
// _line_table_offsets, _line_table, _line_twiddle_index, _line_dft_index,
// _line_rev) and tests/test_torch_fft_sizes.py runs them in numpy against
// np.fft.fft.
//
// A line is one L-point transform. A block holds `lanes` adjacent lines,
// element j of lane l at shared-memory index pad(j * lanes + l) of each plane
// (one float of padding after every 32, as fft_regs_pad). Neighbouring
// threads take neighbouring lanes, then neighbouring butterflies, so a warp's
// accesses of one pass are consecutive words.
//
// The forward transform is decimation in frequency, in place: pass q of radix
// R over spans M = L / (R_0 ... R_q) takes butterfly bf's elements base + M m
// (m < R, base = (bf - n0) R + n0, n0 = bf mod M), runs the R-point DFT and
// multiplies output m by W_{R M}^{n0 m}, back into the same R places, so a
// pass needs no second buffer and a barrier only between passes. The radices
// (_line_radices) are the odd primes of L ascending, then 16s and the leftover
// 2, 4 or 8: 2, 4, 8 and 16 are fft_regs.cuh's register DFTs, 3, 5 and 7 a
// direct DFT in registers, and any other prime p a direct DFT pass from one
// pair of planes into the other (p reads per output). After the passes X[k]
// lies at rev[k] = sum_q d_q M_q for k = d_0 + R_0 (d_1 + R_1 (...)): the
// kernels read it there (the store index, or H's index in K11). The
// transposed passes (DIT: the passes in reverse order, each twiddle before
// its DFT) take that order as input and leave natural order: K11's inverse
// without a permutation.
//
// Twiddles and DFT constants come from a table laid out per pass
// (kernels/fft_pallas.py _line_table): pass q's section at tw_off[q] holds its
// (R - 1) M twiddles, W_{R M}^{n0 m} at (m - 1) M + n0, then the R constants
// W_R^j, each made in float64 on the host and rounded to float32 once. So a
// warp's neighbouring butterflies read neighbouring entries (lanes of one
// butterfly the same one), where one table of W_N^e would scatter them over
// N entries that shared memory leaves L1 no room to hold. Products are
// written with explicit roundings (fft_regs_cmul, fmaf), so no instantiation
// leaves a contraction to the compiler, and every frame is computed the same
// way wherever it lies.
#pragma once

#include "fft_regs.cuh"

namespace srcdsp {

constexpr int kLinesThreads = 256;    // threads of every block of the two bodies
constexpr int kLinesMaxPasses = 24;   // L <= 2^20: at most 20 passes

// One transform's passes (kernels/fft_pallas.py LineGeometry).
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

// Floats of one padded plane of `elems` elements.
__host__ __device__ constexpr int lines_plane(int elems) { return fft_regs_pad(elems - 1) + 1; }

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

// Registers, local-memory bytes and resident blocks per SM of fft_mixed.cu's
// kernel `which` (0 fft_mixed_kernel, 1 fftconv_mixed_kernel) at `smem` bytes
// of dynamic shared memory; fft_4step.cu's srcdsp_fft_lines_info exports it.
int fft_mixed_info(int which, int smem, int* regs, int* local_bytes, int* blocks_per_sm);

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

// Elements t < count of the block (t = threadIdx.x + blockDim.x * i):
// load(t, re, im) then store(t, re, im), eight loads in flight a thread
// before their stores (a store into shared memory may not pass a device load
// the compiler cannot prove apart from it, so one at a time would wait out
// each load's latency).
template <class Load, class Store>
__device__ __forceinline__ void lines_copy(int count, Load load, Store store) {
  constexpr int U = 8;
  for (int t0 = threadIdx.x; t0 < count; t0 += U * blockDim.x) {
    float vr[U], vi[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * blockDim.x;
      if (t < count) load(t, vr[u], vi[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * blockDim.x;
      if (t < count) store(t, vr[u], vi[u]);
    }
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
