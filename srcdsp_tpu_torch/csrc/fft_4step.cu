// K10 and K11 from 17408 to 2^20 points (the sizes the JAX kernels take
// there, n2 % 128 == 0, n1 % 8 == 0, past the one-block body's 16384): the
// four-step N = f1 * f2 over a scratch buffer in device memory. Replaces, at
// those sizes, srcdsp_tpu/kernels/fft_pallas.py make_fft_kernel.fn_rows_p /
// fn_nat (K10) and srcdsp_tpu/kernels/fftconv_pallas.py
// make_fftconv_kernel.fn (K11). The TPU kernels hold the whole frame in VMEM
// as an [n1, n2] tile; past 16384 complex f32 points a frame fits no block
// of 1024 threads at 16 values a thread, and at 2^20 no shared memory.
//
// With input index n = b + f2 a and output index k = c + f1 d (a, c < f1;
// b, d < f2):
//   X[c + f1 d] = sum_b W_f2^{b d} W_N^{b c} sum_a x[b + f2 a] W_f1^{a c}.
// Step 1 (cols) takes a tile of adjacent columns b of the frame seen as
// [f1, f2], runs their f1-point transforms, multiplies output c by W_N^{b c}
// and writes the scratch [f2, f1] at b f1 + c, so step 2 (rows) reads its
// lines c as adjacent columns again, runs the f2-point transforms and stores
// X[c + f1 d] at its natural or digit offset. K11 takes three kernels over
// two scratch buffers: step 1 on the frame at f hop of the channel's stream;
// mid runs each column c's forward row transform, multiplies X[c + f1 d] by
// H (natural order, read along the tile's lanes), conjugates, runs the
// inverse's transform over d in the transposed order (natural e out) and
// multiplies by W_N^{c e} (the four-step of the inverse with its index split
// c + f1 d), into the second scratch at c f2 + e; out runs the inverse's
// f1-point transforms over c and stores n = e + f2 g, the last hop samples
// conjugated and times 1/N. So the product is fused into the forward's last
// step and the inverse's first.
//
// What bounds it: the bytes. Each sample is read once and written once by the
// transform (16 bytes; 0.160 ms for 2^25 samples at 3.35 TB/s), but a
// four-step in two kernels moves it twice: 32 bytes a sample of K10 (K11:
// 48, of which the scratch round trips are 32). What the design does about
// it: a line is fft_lines.cuh's compile-time register schedule (LineShape:
// L = P 2^LOG2M, 16 values a thread, FOUR_STEP_LINES instantiated), a block a
// tile of `lanes` adjacent lines (8 to 64, up to 8192 points, 16384 where
// that leaves fewer than 8 lanes), lanes fastest among its threads, so every
// device access moves whole runs of `lanes` words and every shared access of
// a row is consecutive words. The tile loads by cp.async (no register holds
// it in flight); at 64 registers two blocks of 512 threads share an SM, so
// one block's load runs under the other's transform. Each kernel stages its
// line's output in natural order in the tile and writes the scratch or the
// result in whole rows. A line FOUR_STEP_LINES does not hold (a prime factor
// above 15, as 17 in 136 x 128 or 1021 in 1024 x 1021, an odd part that no
// two factors up to 15 make, as 243, or an odd factor on other than 32 to 128
// points) runs the generic passes of fft_lines.cuh (256
// threads, a direct DFT pass over a prime above 7, X[k] at rev[k]). The
// wrapper works in batches of frames whose scratch fits 256 MiB. Every frame
// is computed the same way wherever it lies, so the digit store, unscrambled,
// equals the natural store bit for bit, and chunked, streamed and
// time-sharded K11 calls equal one launch.
#include <type_traits>

#include "fft_lines.cuh"
#include "fir_ring.cuh"

using namespace srcdsp;

namespace {

// The register lines of the four-step: (P, log2 M). M = 2^5 ... 2^7 beside an
// odd factor, so an odd part q = q1 q2 (both up to 15) splits across the two
// lines at every power of two from 2^10 to 2^14 (kernels/fft_pallas.py
// _odd_pair).
#define FOUR_STEP_LINES(X)                                                                   \
  X(1, 4) X(1, 5) X(1, 6) X(1, 7) X(1, 8) X(1, 9) X(1, 10) X(1, 11) X(3, 5) X(5, 5) X(7, 5) \
  X(9, 5) X(11, 5) X(13, 5) X(15, 5) X(3, 6) X(5, 6) X(7, 6) X(9, 6) X(11, 6) X(13, 6)     \
  X(15, 6) X(3, 7) X(5, 7) X(7, 7) X(9, 7) X(11, 7) X(13, 7) X(15, 7)

// --- register lines ----------------------------------------------------------

// A register line's block: at most 512 threads (kLineThreads); two blocks an
// SM at 64 registers, one where the kernel needs more to hold no spill (an
// odd factor above 7, and K11's mid step with its two transforms). K11's
// last step on 3 x 32 points spills 8 bytes at 64 registers, so it takes
// more too (its blocks hold 192 threads: 32 lanes of 6).
constexpr int kLineThreads = 512;
template <int P>
constexpr int kLineMinBlocks = P <= 7 ? 2 : 1;
template <int P, int LOG2M>
constexpr int kOutMinBlocks = P == 3 && LOG2M == 5 ? 1 : kLineMinBlocks<P>;

// Step 1: frame g0 + blockIdx.y (channel G / F, frame G mod F at ch *
// chan_stride + f * frame_stride of xr, xi) seen as [f1, f2]; this block's
// columns b = line0 + lane; output c times W_N^{b c} (post[b f1 + c], its
// imaginary plane N floats on) into the scratch [f2, f1] of batch frame
// blockIdx.y.
template <int P, int LOG2M>
__global__ void __launch_bounds__(kLineThreads, kLineMinBlocks<P>)
    fft4_cols_regs(const float* __restrict__ xr, const float* __restrict__ xi,
                   long long chan_stride, long long frame_stride, int F, long long g0,
                   const float* tw, const float* __restrict__ post, float* __restrict__ s1r,
                   float* __restrict__ s1i, int log2lanes, int N) {
  using S = LineShape<P, LOG2M>;
  extern __shared__ float smem[];
  const int count = S::kL << log2lanes;
  const LineTile s(smem, lines_plane(count), log2lanes);
  lines_zero_set();
  const int G = (int)(g0 + blockIdx.y);
  const long long base = (G / F) * chan_stride + (G % F) * frame_stride;
  const int line0 = blockIdx.x << log2lanes;
  tile_load_async(s.r, s.i, log2lanes, xr + base + line0, xi + base + line0, count, N / S::kL);
  float vr[kFftRegsVals], vi[kFftRegsVals];
  line_forward<P, LOG2M>(vr, vi, s, lines_opaque(tw));
  const LineTile s2 = s.fresh();  // the epilogue's indices made here
  line_stage<P, LOG2M>(vr, vi, s2);
  // the tile's columns are consecutive rows of the scratch
  const long long at = (long long)blockIdx.y * N + (long long)line0 * S::kL;
  const float* pr = post + (long long)line0 * S::kL;
  const float* pi = pr + N;
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const int l = t / S::kL, c = t - l * S::kL;
    const int a = fft_regs_pad((c << s2.log2lanes) + l);
    float ur = s2.r[a], ui = s2.i[a];
    fft_regs_cmul(ur, ui, __ldg(pr + t), __ldg(pi + t));
    s1r[at + t] = ur;
    s1i[at + t] = ui;
  }
}

// Step 2 of K10: lines c = line0 + lane of batch frame blockIdx.y's scratch
// [f2, f1]; X[c + f1 d] to frame g0 + blockIdx.y of y, natural (digit == 0)
// or the digit order of [n1, n2].
template <int P, int LOG2M>
__global__ void __launch_bounds__(kLineThreads, kLineMinBlocks<P>)
    fft4_rows_regs(const float* __restrict__ s1r, const float* __restrict__ s1i, long long g0,
                   const float* tw, float* __restrict__ yr, float* __restrict__ yi,
                   int log2lanes, int N, int n1, int n2, const LineDiv div1, int digit) {
  using S = LineShape<P, LOG2M>;
  extern __shared__ float smem[];
  const int count = S::kL << log2lanes, W = N / S::kL;
  const LineTile s(smem, lines_plane(count), log2lanes);
  lines_zero_set();
  const long long so = (long long)blockIdx.y * N;
  const int line0 = blockIdx.x << log2lanes;
  tile_load_async(s.r, s.i, log2lanes, s1r + so + line0, s1i + so + line0, count, W);
  float vr[kFftRegsVals], vi[kFftRegsVals];
  line_forward<P, LOG2M>(vr, vi, s, lines_opaque(tw));
  const LineTile s2 = s.fresh();  // the store's indices made here
  const long long out = (g0 + blockIdx.y) * N;
  if (!digit) {  // the lanes of a row d are consecutive offsets
    const int kp = S::kp_of(s2.tl), tm = S::tm_of(s2.tl);
#pragma unroll
    for (int q = 0; q < kFftRegsVals; ++q) {
      const int k = line0 + s2.lane + W * (kp + P * (tm + S::kTM * q));
      yr[out + k] = vr[q];
      yi[out + k] = vi[q];
    }
    return;
  }
  line_stage<P, LOG2M>(vr, vi, s2);
  // offset (k mod n1) n2 + k div n1: a line's run of d where f1 == n1
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const int l = t / S::kL, d = t - l * S::kL;
    const int k = line0 + l + W * d, r = div1(k);
    const long long o = out + (long long)(k - r * n1) * n2 + r;
    const int a = fft_regs_pad((d << s2.log2lanes) + l);
    yr[o] = s2.r[a];
    yi[o] = s2.i[a];
  }
}

// K11's middle step: lines c = line0 + lane of batch frame blockIdx.y's
// scratch [f2, f1]; the forward row transform, X[c + f1 d] times H (channel
// (g0 + blockIdx.y) / F) and conjugated, the inverse's transform over d in
// the transposed order (natural e), times W_N^{c e} (post2[c f2 + e]), into
// the second scratch [f1, f2] at c f2 + e.
template <int P, int LOG2M>
__global__ void __launch_bounds__(kLineThreads, 1)
    fftconv4_mid_regs(const float* __restrict__ s1r, const float* __restrict__ s1i,
                      const float* h, long long h_stride, int F, long long g0,
                      const float* tw, const float* __restrict__ post2,
                      float* __restrict__ s2r, float* __restrict__ s2i, int log2lanes, int N) {
  using S = LineShape<P, LOG2M>;
  extern __shared__ float smem[];
  const int count = S::kL << log2lanes, W = N / S::kL;
  const LineTile s(smem, lines_plane(count), log2lanes);
  lines_zero_set();
  const long long so = (long long)blockIdx.y * N;
  const int line0 = blockIdx.x << log2lanes, ch = (int)(g0 + blockIdx.y) / F;
  tile_load_async(s.r, s.i, log2lanes, s1r + so + line0, s1i + so + line0, count, W);
  float vr[kFftRegsVals], vi[kFftRegsVals];
  line_forward<P, LOG2M>(vr, vi, s, lines_opaque(tw));
  // the product, the inverse and the store with indices made after the
  // forward (fresh) and an opaque H pointer (lines_opaque)
  const LineTile s2 = s.fresh();
  const float* hr = lines_opaque(h) + ch * h_stride + line0 + s2.lane;
  const float* hi = hr + N;
  const int kp = S::kp_of(s2.tl), tm = S::tm_of(s2.tl);
#pragma unroll
  for (int q = 0; q < kFftRegsVals; ++q) {
    const int k = W * (kp + P * (tm + S::kTM * q));
    fft_regs_cmul(vr[q], vi[q], hr[k], hi[k]);
    vi[q] = -vi[q];
  }
  line_forward_dit<P, LOG2M>(vr, vi, s2, lines_opaque(tw));
  if constexpr (P == 1) line_stage<1, LOG2M>(vr, vi, s2);
  const long long at = so + (long long)line0 * S::kL;
  const float* pr = post2 + (long long)line0 * S::kL;
  const float* pi = pr + N;
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const int l = t / S::kL, e = t - l * S::kL;
    const int a = fft_regs_pad((e << s2.log2lanes) + l);
    float ur = s2.r[a], ui = s2.i[a];
    fft_regs_cmul(ur, ui, __ldg(pr + t), __ldg(pi + t));
    s2r[at + t] = ur;
    s2i[at + t] = ui;
  }
}

// K11's last step: lines e = line0 + lane of batch frame blockIdx.y's second
// scratch [f1, f2]; the inverse's f1-point transform over c; n = e + f2 g,
// conjugated and times 1/N, stored where n >= overlap at (channel, frame f)
// of y [C, F hop].
template <int P, int LOG2M>
__global__ void __launch_bounds__(kLineThreads, kOutMinBlocks<P, LOG2M>)
    fftconv4_out_regs(const float* __restrict__ s2r, const float* __restrict__ s2i, int F,
                      int hop, long long g0, const float* tw, float* __restrict__ yr,
                      float* __restrict__ yi, int log2lanes, int N) {
  using S = LineShape<P, LOG2M>;
  extern __shared__ float smem[];
  const int count = S::kL << log2lanes, W = N / S::kL;
  const LineTile s(smem, lines_plane(count), log2lanes);
  lines_zero_set();
  const long long so = (long long)blockIdx.y * N;
  const int line0 = blockIdx.x << log2lanes;
  tile_load_async(s.r, s.i, log2lanes, s2r + so + line0, s2i + so + line0, count, W);
  float vr[kFftRegsVals], vi[kFftRegsVals];
  line_forward<P, LOG2M>(vr, vi, s, lines_opaque(tw));
  // staged in natural order g, then stored in rows: frame f of channel c
  // lands at (c F + f) hop = G hop of y [C, F hop]
  line_stage<P, LOG2M>(vr, vi, s.fresh());
  const int overlap = N - hop;
  const long long out = (g0 + blockIdx.y) * hop - overlap;
  const float inv_n = 1.0f / (float)N;
  const int mask = (1 << log2lanes) - 1;
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const int n = line0 + (t & mask) + W * (t >> log2lanes);  // lane e, row g
    if (n >= overlap) {
      const int a = fft_regs_pad(t);
      yr[out + n] = s.r[a] * inv_n;
      yi[out + n] = -s.i[a] * inv_n;
    }
  }
}

// --- generic lines (shapes FOUR_STEP_LINES does not hold) ----------------------

// Step 1 on generic lines (fft4_cols_regs's contract; tw this line's
// section, its imaginary plane tw_size floats on; X[c] at rev[c]).
__global__ void __launch_bounds__(kLinesThreads)
    fft4_step1_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                      long long chan_stride, long long frame_stride, int F, long long g0,
                      const float* __restrict__ tw, const float* __restrict__ post,
                      const int* __restrict__ rev, float* __restrict__ s1r,
                      float* __restrict__ s1i, const LinePlan plan, int N) {
  __shared__ LinePlan p;
  extern __shared__ float smem[];
  lines_stage_plan(p, plan);
  const int L = plan.L, lanes = plan.lanes, W = N / L;
  LinePlanes s(smem, L * lanes);
  const long long G = g0 + blockIdx.y;
  const long long base = (G / F) * chan_stride + (G % F) * frame_stride;
  const int line0 = blockIdx.x * lanes;
  tile_load_async(s.r, s.i, __ffs(lanes) - 1, xr + base + line0, xi + base + line0, L * lanes, W);
  lines_transform<false>(s.r, s.i, s.sr, s.si, p, tw, tw + plan.tw_size);
  const long long so = (long long)blockIdx.y * N;
  for (int t = threadIdx.x; t < L * lanes; t += blockDim.x) {
    const int c = t % L, lane = t / L, b = line0 + lane;
    const int a = lines_at(__ldg(rev + c), lane, lanes);
    float vr = s.r[a], vi = s.i[a];
    const int e = b * L + c;
    fft_regs_cmul(vr, vi, __ldg(post + e), __ldg(post + N + e));
    s1r[so + (long long)b * L + c] = vr;
    s1i[so + (long long)b * L + c] = vi;
  }
}

// Step 2 of K10 on generic lines (fft4_rows_regs's contract).
__global__ void __launch_bounds__(kLinesThreads)
    fft4_step2_kernel(const float* __restrict__ s1r, const float* __restrict__ s1i, long long g0,
                      const float* __restrict__ tw, const int* __restrict__ rev,
                      float* __restrict__ yr, float* __restrict__ yi, const LinePlan plan, int N,
                      int n1, int n2, int digit) {
  __shared__ LinePlan p;
  extern __shared__ float smem[];
  lines_stage_plan(p, plan);
  const int L = plan.L, lanes = plan.lanes, W = N / L;
  LinePlanes s(smem, L * lanes);
  const long long so = (long long)blockIdx.y * N;
  const int line0 = blockIdx.x * lanes;
  tile_load_async(s.r, s.i, __ffs(lanes) - 1, s1r + so + line0, s1i + so + line0, L * lanes, W);
  lines_transform<false>(s.r, s.i, s.sr, s.si, p, tw, tw + plan.tw_size);
  const long long out = (g0 + blockIdx.y) * N;
  for (int t = threadIdx.x; t < L * lanes; t += blockDim.x) {
    // natural: neighbouring threads on neighbouring lines (offsets k); digit:
    // on neighbouring d (offsets c n2 + d where f1 == n1)
    const int lane = digit ? t / L : t % lanes, d = digit ? t % L : t / lanes;
    const int k = line0 + lane + W * d;
    const int a = lines_at(__ldg(rev + d), lane, lanes);
    const long long o = out + (digit ? (long long)(k % n1) * n2 + k / n1 : k);
    yr[o] = s.r[a];
    yi[o] = s.i[a];
  }
}

// K11's middle step on generic lines (fftconv4_mid_regs's contract).
__global__ void __launch_bounds__(kLinesThreads)
    fftconv4_mid_kernel(const float* __restrict__ s1r, const float* __restrict__ s1i,
                        const float* __restrict__ h, long long h_stride, int F, long long g0,
                        const float* __restrict__ tw, const float* __restrict__ post2,
                        const int* __restrict__ rev, float* __restrict__ s2r,
                        float* __restrict__ s2i, const LinePlan plan, int N) {
  __shared__ LinePlan p;
  extern __shared__ float smem[];
  lines_stage_plan(p, plan);
  const int L = plan.L, lanes = plan.lanes, W = N / L;
  LinePlanes s(smem, L * lanes);
  const long long so = (long long)blockIdx.y * N;
  const int line0 = blockIdx.x * lanes;
  tile_load_async(s.r, s.i, __ffs(lanes) - 1, s1r + so + line0, s1i + so + line0, L * lanes, W);
  lines_transform<false>(s.r, s.i, s.sr, s.si, p, tw, tw + plan.tw_size);
  const float* hr = h + ((g0 + blockIdx.y) / F) * h_stride;
  const float* hi = hr + N;
  for (int t = threadIdx.x; t < L * lanes; t += blockDim.x) {
    const int lane = t % lanes, d = t / lanes;
    const int k = line0 + lane + W * d;
    const int a = lines_at(__ldg(rev + d), lane, lanes);
    float zr = s.r[a], zi = s.i[a];
    fft_regs_cmul(zr, zi, __ldg(hr + k), __ldg(hi + k));
    s.r[a] = zr;
    s.i[a] = -zi;
  }
  __syncthreads();
  lines_transform<true>(s.r, s.i, s.sr, s.si, p, tw, tw + plan.tw_size);
  for (int t = threadIdx.x; t < L * lanes; t += blockDim.x) {
    const int e = t % L, lane = t / L, c = line0 + lane;
    const int a = lines_at(e, lane, lanes);
    float vr = s.r[a], vi = s.i[a];
    const int x = c * L + e;
    fft_regs_cmul(vr, vi, __ldg(post2 + x), __ldg(post2 + N + x));
    s2r[so + (long long)c * L + e] = vr;
    s2i[so + (long long)c * L + e] = vi;
  }
}

// K11's last step on generic lines (fftconv4_out_regs's contract).
__global__ void __launch_bounds__(kLinesThreads)
    fftconv4_out_kernel(const float* __restrict__ s2r, const float* __restrict__ s2i, int F,
                        int hop, long long g0, const float* __restrict__ tw,
                        const int* __restrict__ rev, float* __restrict__ yr,
                        float* __restrict__ yi, const LinePlan plan, int N) {
  __shared__ LinePlan p;
  extern __shared__ float smem[];
  lines_stage_plan(p, plan);
  const int L = plan.L, lanes = plan.lanes, W = N / L;
  LinePlanes s(smem, L * lanes);
  const long long so = (long long)blockIdx.y * N;
  const int line0 = blockIdx.x * lanes;
  tile_load_async(s.r, s.i, __ffs(lanes) - 1, s2r + so + line0, s2i + so + line0, L * lanes, W);
  lines_transform<false>(s.r, s.i, s.sr, s.si, p, tw, tw + plan.tw_size);
  const long long G = g0 + blockIdx.y;
  const int overlap = N - hop;
  const float inv_n = 1.0f / (float)N;
  const long long out = (G / F) * F * hop + (G % F) * hop - overlap;
  for (int t = threadIdx.x; t < L * lanes; t += blockDim.x) {
    const int lane = t % lanes, g = t / lanes;
    const int n = line0 + lane + W * g;
    if (n < overlap) continue;
    const int a = lines_at(__ldg(rev + g), lane, lanes);
    yr[out + n] = s.r[a] * inv_n;
    yi[out + n] = -s.i[a] * inv_n;
  }
}

// --- the host side -------------------------------------------------------------

// One of the two line kinds of a four-step (kernels/fft_pallas.py
// line_descriptor): {p, log2m, log2lanes, 0} a register line (p odd, 1 ...
// 15), {0, 0, log2lanes, passes, radices...} a generic line.
struct Line {
  int p = 0, log2m = 0, log2lanes = 0, L = 0;
  LinePlan plan{};
  int threads() const { return p ? (L << log2lanes) / kFftRegsVals : kLinesThreads; }
  size_t smem() const {
    return p ? 2 * (size_t)lines_plane(L << log2lanes) * sizeof(float) : lines_smem(plan);
  }
  int lanes() const { return 1 << log2lanes; }
};

bool make_line(Line& d, const int* desc, int L) {
  d.p = desc[0], d.log2m = desc[1], d.log2lanes = desc[2], d.L = L;
  if (d.log2lanes < 0 || d.log2lanes > 10) return false;
  if (d.p) return d.log2m >= 4 && d.log2m <= 14 && (d.p << d.log2m) == L &&
                  (L << d.log2lanes) / kFftRegsVals <= kLineThreads;
  return lines_make_plan(d.plan, desc + 4, desc[3], L, d.lanes());
}

// Calls fn(std::integral_constant P, std::integral_constant LOG2M) for a
// register line of FOUR_STEP_LINES; cudaErrorInvalidValue for any other.
template <class Fn>
int with_line(const Line& d, Fn fn) {
  switch (d.p * 64 + d.log2m) {
#define SRCDSP_LINE_CASE(P, M) \
  case P * 64 + M:             \
    return fn(std::integral_constant<int, P>{}, std::integral_constant<int, M>{});
    FOUR_STEP_LINES(SRCDSP_LINE_CASE)
#undef SRCDSP_LINE_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class Kernel>
int launch_ready(Kernel kernel, const Line& d) {
  return (int)allow_smem(kernel, d.smem());
}

// The two lines of a four-step: columns (f1 points, f2 of them) and rows (f2
// points, f1 of them).
bool make_lines(Line& cols, Line& rows, const int* desc1, const int* desc2, int f1, int f2) {
  if (f1 <= 0 || f2 <= 0 || (long long)f1 * f2 > (1 << 20)) return false;
  return make_line(cols, desc1, f1) && f2 % cols.lanes() == 0 && make_line(rows, desc2, f2) &&
         f1 % rows.lanes() == 0;
}

// Step 1 over `frames` frames from g0.
int cols_step(const Line& d, int frames, cudaStream_t st, const float* xr, const float* xi,
              long long chan_stride, long long frame_stride, int F, long long g0,
              const float* tw, const float* post, const int* rev, float* s1r, float* s1i,
              int n) {
  const dim3 grid(n / d.L / d.lanes(), frames);
  if (!d.p) {
    const int err = launch_ready(fft4_step1_kernel, d);
    if (err) return err;
    fft4_step1_kernel<<<grid, kLinesThreads, d.smem(), st>>>(
        xr, xi, chan_stride, frame_stride, F, g0, tw, post, rev, s1r, s1i, d.plan, n);
    return 0;
  }
  return with_line(d, [&](auto pc, auto mc) {
    constexpr int kP = decltype(pc)::value, kLog2M = decltype(mc)::value;
    const int err = launch_ready(fft4_cols_regs<kP, kLog2M>, d);
    if (err) return err;
    fft4_cols_regs<kP, kLog2M><<<grid, d.threads(), d.smem(), st>>>(
        xr, xi, chan_stride, frame_stride, F, g0, tw, post, s1r, s1i, d.log2lanes, n);
    return 0;
  });
}

}  // namespace

// x planes xr, xi [B, N] f32, N = f1 * f2 <= 2^20; tw1, tw2 the two lines'
// tables and post the two post-twiddle planes [2, N] each (W_N^{b c} at
// b f1 + c, then W_N^{c e} at c f2 + e; kernels/fft_pallas.py
// FftPlan.tables); rev1 [f1], rev2 [f2] int32 (a generic line's _line_rev);
// scratch [2, batch * N] f32; yr, yi [B, N], natural order (digit == 0) or
// the digit order of [n1, n2]; desc1, desc2 the lines (line_descriptor).
// Runs the frames in batches of `batch`, two launches a batch. Returns the
// first launch's cudaError_t (cudaErrorInvalidValue for lines that do not
// fit), or 0.
extern "C" int srcdsp_fft_4step(const void* xr, const void* xi, const void* tw1, const void* tw2,
                                const void* post, const void* rev1, const void* rev2,
                                void* scratch, void* yr, void* yi, int B, int batch,
                                const int* desc1, const int* desc2, int f1, int f2, int n1,
                                int n2, int digit, void* stream) {
  Line cols, rows;
  if (B <= 0 || batch <= 0 || batch > 65535 || n1 <= 0 || n2 <= 0 ||
      !make_lines(cols, rows, desc1, desc2, f1, f2) || (long long)n1 * n2 != (long long)f1 * f2)
    return (int)cudaErrorInvalidValue;
  const int n = f1 * f2;
  const float* w1 = (const float*)tw1;
  const float* w2 = (const float*)tw2;
  const float* post1 = (const float*)post;
  float* s1r = (float*)scratch;
  float* s1i = s1r + (long long)batch * n;
  const cudaStream_t st = (cudaStream_t)stream;
  for (long long g0 = 0; g0 < B; g0 += batch) {
    const int frames = (int)(B - g0 < batch ? B - g0 : batch);
    int err = cols_step(cols, frames, st, (const float*)xr, (const float*)xi, 0, n, B, g0, w1,
                        post1, (const int*)rev1, s1r, s1i, n);
    if (err) return err;
    const dim3 grid(f1 / rows.lanes(), frames);
    if (!rows.p) {
      err = launch_ready(fft4_step2_kernel, rows);
      if (err) return err;
      fft4_step2_kernel<<<grid, kLinesThreads, rows.smem(), st>>>(
          s1r, s1i, g0, w2, (const int*)rev2, (float*)yr, (float*)yi, rows.plan, n, n1, n2,
          digit);
    } else {
      err = with_line(rows, [&](auto pc, auto mc) {
        constexpr int kP = decltype(pc)::value, kLog2M = decltype(mc)::value;
        const int e = launch_ready(fft4_rows_regs<kP, kLog2M>, rows);
        if (e) return e;
        fft4_rows_regs<kP, kLog2M><<<grid, rows.threads(), rows.smem(), st>>>(
            s1r, s1i, g0, w2, (float*)yr, (float*)yi, rows.log2lanes, n, n1, n2, LineDiv(n1),
            digit);
        return 0;
      });
      if (err) return err;
    }
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

// x [C, 2, L] f32, L = overlap + F * hop; h [Ct, 2, N] f32 natural order,
// Ct = C when per_channel != 0, else 1; tw1, tw2, post, rev1, rev2, desc1,
// desc2 as srcdsp_fft_4step; scratch [4, batch * N] f32; yr, yi [C, F * hop].
// The C * F frames run in batches of `batch`, three launches a batch. Returns
// the first launch's cudaError_t, or 0.
extern "C" int srcdsp_fftconv_4step(const void* x, const void* h, const void* tw1,
                                    const void* tw2, const void* post, const void* rev1,
                                    const void* rev2, void* scratch, void* yr, void* yi, int C,
                                    long long L, int F, int hop, int batch, const int* desc1,
                                    const int* desc2, int f1, int f2, int per_channel,
                                    void* stream) {
  Line cols, rows;
  if (!make_lines(cols, rows, desc1, desc2, f1, f2)) return (int)cudaErrorInvalidValue;
  const int n = f1 * f2;
  if (hop <= 0 || hop > n || C <= 0 || F <= 0 || batch <= 0 || batch > 65535 ||
      L != (long long)(n - hop) + (long long)F * hop)
    return (int)cudaErrorInvalidValue;
  const float* w1 = (const float*)tw1;
  const float* w2 = (const float*)tw2;
  const float* post1 = (const float*)post;
  const float* post2 = post1 + 2LL * n;
  const float* xr = (const float*)x;
  const int* r1 = (const int*)rev1;
  const int* r2 = (const int*)rev2;
  float* s1r = (float*)scratch;
  float* s1i = s1r + (long long)batch * n;
  float* s2r = s1i + (long long)batch * n;
  float* s2i = s2r + (long long)batch * n;
  const long long h_stride = per_channel ? 2LL * n : 0LL;
  const long long frames_all = (long long)C * F;
  const cudaStream_t st = (cudaStream_t)stream;
  for (long long g0 = 0; g0 < frames_all; g0 += batch) {
    const int frames = (int)(frames_all - g0 < batch ? frames_all - g0 : batch);
    int err = cols_step(cols, frames, st, xr, xr + L, 2 * L, hop, F, g0, w1, post1, r1, s1r,
                        s1i, n);
    if (err) return err;
    const dim3 gmid(f1 / rows.lanes(), frames), gout(f2 / cols.lanes(), frames);
    if (!rows.p) {
      err = launch_ready(fftconv4_mid_kernel, rows);
      if (err) return err;
      fftconv4_mid_kernel<<<gmid, kLinesThreads, rows.smem(), st>>>(
          s1r, s1i, (const float*)h, h_stride, F, g0, w2, post2, r2, s2r, s2i, rows.plan, n);
    } else {
      err = with_line(rows, [&](auto pc, auto mc) {
        constexpr int kP = decltype(pc)::value, kLog2M = decltype(mc)::value;
        const int e = launch_ready(fftconv4_mid_regs<kP, kLog2M>, rows);
        if (e) return e;
        fftconv4_mid_regs<kP, kLog2M><<<gmid, rows.threads(), rows.smem(), st>>>(
            s1r, s1i, (const float*)h, h_stride, F, g0, w2, post2, s2r, s2i, rows.log2lanes, n);
        return 0;
      });
      if (err) return err;
    }
    if (!cols.p) {
      err = launch_ready(fftconv4_out_kernel, cols);
      if (err) return err;
      fftconv4_out_kernel<<<gout, kLinesThreads, cols.smem(), st>>>(
          s2r, s2i, F, hop, g0, w1, r1, (float*)yr, (float*)yi, cols.plan, n);
    } else {
      err = with_line(cols, [&](auto pc, auto mc) {
        constexpr int kP = decltype(pc)::value, kLog2M = decltype(mc)::value;
        const int e = launch_ready(fftconv4_out_regs<kP, kLog2M>, cols);
        if (e) return e;
        fftconv4_out_regs<kP, kLog2M><<<gout, cols.threads(), cols.smem(), st>>>(
            s2r, s2i, F, hop, g0, w1, (float*)yr, (float*)yi, cols.log2lanes, n);
        return 0;
      });
      if (err) return err;
    }
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

// Registers, local-memory bytes and resident blocks per SM of step `which`
// (0 cols, 1 rows, 2 K11's mid, 3 K11's out) on the line `desc` of L points.
// Returns the cudaError_t, or 0.
extern "C" int srcdsp_fft_4step_info(int which, const int* desc, int L, int* regs,
                                     int* local_bytes, int* blocks_per_sm) {
  Line d;
  if (!make_line(d, desc, L) || which < 0 || which > 3) return (int)cudaErrorInvalidValue;
  const auto info = [&](auto kernel) {
    return kernel_info(kernel, d.threads(), d.smem(), regs, local_bytes, blocks_per_sm);
  };
  if (!d.p) {
    switch (which) {
      case 0: return info(fft4_step1_kernel);
      case 1: return info(fft4_step2_kernel);
      case 2: return info(fftconv4_mid_kernel);
      default: return info(fftconv4_out_kernel);
    }
  }
  return with_line(d, [&](auto pc, auto mc) {
    constexpr int kP = decltype(pc)::value, kLog2M = decltype(mc)::value;
    switch (which) {
      case 0: return info(fft4_cols_regs<kP, kLog2M>);
      case 1: return info(fft4_rows_regs<kP, kLog2M>);
      case 2: return info(fftconv4_mid_regs<kP, kLog2M>);
      default: return info(fftconv4_out_regs<kP, kLog2M>);
    }
  });
}
