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
// two factors up to 15 make, as 27 in 864, or an odd factor on other than 32
// to 128 points) is a Bluestein line of fft_lines.cuh (bluestein_line): a
// chirp, then the cyclic convolution on two register transforms of M = 2^9 ...
// 2^12 >= 2L - 1 points (BLUESTEIN_LINES), a tile of up to 8192 points (lanes
// M: 16 lanes at M = 512, 8 at 1024, 4 at 2048, 2 at 4096 where the line count
// allows), 512 threads at up to 128 registers, one block an SM. The
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

// The Bluestein lines' transform lengths: log2 M (kernels/fft_pallas.py
// BLUESTEIN_LOG2M), M the least power of two >= 2L - 1 for L = 17 ... 2040.
#define BLUESTEIN_LINES(X) X(9) X(10) X(11) X(12)

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

// --- Bluestein lines (shapes FOUR_STEP_LINES does not hold) -------------------

// A Bluestein line's block: lanes x M / 16 threads, at most 512 (a tile of
// 8192 points), up to 128 registers: at 1024 threads and 64 registers every
// step spilled (4 to 504 bytes, the mid step most), at 512 and 128 none.
constexpr int kBluesteinThreads = 512;

// Step 1 on Bluestein lines of L points (fft4_cols_regs's contract; tw the
// line's table, divL dividing by L).
template <int LOG2M>
__global__ void __launch_bounds__(kBluesteinThreads, 1)
    fft4_cols_bluestein(const float* __restrict__ xr, const float* __restrict__ xi,
                        long long chan_stride, long long frame_stride, int F, long long g0,
                        const float* tw, const float* __restrict__ post, float* __restrict__ s1r,
                        float* __restrict__ s1i, int log2lanes, int N, int L,
                        const LineDiv divL) {
  using S = BluesteinShape<LOG2M>;
  extern __shared__ float smem[];
  const int count = L << log2lanes;
  const LineTile s(smem, lines_plane(S::kM << log2lanes), log2lanes);
  lines_zero_set();
  const long long G = g0 + blockIdx.y;
  const long long base = (G / F) * chan_stride + (G % F) * frame_stride;
  const int line0 = blockIdx.x << log2lanes;
  tile_load_async(s.r, s.i, log2lanes, xr + base + line0, xi + base + line0, count, N / L);
  float vr[kFftRegsVals], vi[kFftRegsVals];
  bluestein_load<LOG2M>(vr, vi, s, L);
  bluestein_line<LOG2M>(vr, vi, s, L, tw);
  const LineTile s2 = s.fresh();  // the epilogue's indices made here
  line_stage<1, LOG2M>(vr, vi, s2);
  const long long at = (long long)blockIdx.y * N + (long long)line0 * L;
  const float* pr = post + (long long)line0 * L;
  const float* pi = pr + N;
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const int l = divL(t), c = t - l * L;
    const int a = fft_regs_pad((c << s2.log2lanes) + l);
    float ur = s2.r[a], ui = s2.i[a];
    fft_regs_cmul(ur, ui, __ldg(pr + t), __ldg(pi + t));
    s1r[at + t] = ur;
    s1i[at + t] = ui;
  }
}

// Step 2 of K10 on Bluestein lines (fft4_rows_regs's contract).
template <int LOG2M>
__global__ void __launch_bounds__(kBluesteinThreads, 1)
    fft4_rows_bluestein(const float* __restrict__ s1r, const float* __restrict__ s1i,
                        long long g0, const float* tw, float* __restrict__ yr,
                        float* __restrict__ yi, int log2lanes, int N, int L, int n1, int n2,
                        const LineDiv div1, const LineDiv divL, int digit) {
  using S = BluesteinShape<LOG2M>;
  extern __shared__ float smem[];
  const int count = L << log2lanes, W = N / L;
  const LineTile s(smem, lines_plane(S::kM << log2lanes), log2lanes);
  lines_zero_set();
  const long long so = (long long)blockIdx.y * N;
  const int line0 = blockIdx.x << log2lanes;
  tile_load_async(s.r, s.i, log2lanes, s1r + so + line0, s1i + so + line0, count, W);
  float vr[kFftRegsVals], vi[kFftRegsVals];
  bluestein_load<LOG2M>(vr, vi, s, L);
  bluestein_line<LOG2M>(vr, vi, s, L, tw);
  const LineTile s2 = s.fresh();  // the store's indices made here
  const long long out = (g0 + blockIdx.y) * N;
  if (!digit) {  // the lanes of a row d are consecutive offsets
#pragma unroll
    for (int q = 0; q < kFftRegsVals; ++q) {
      const int d = s2.tl + S::kT * q;
      if (d < L) {
        const int k = line0 + s2.lane + W * d;
        yr[out + k] = vr[q];
        yi[out + k] = vi[q];
      }
    }
    return;
  }
  line_stage<1, LOG2M>(vr, vi, s2);
  // offset (k mod n1) n2 + k div n1: a line's run of d where f1 == n1
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const int l = divL(t), d = t - l * L;
    const int k = line0 + l + W * d, r = div1(k);
    const long long o = out + (long long)(k - r * n1) * n2 + r;
    const int a = fft_regs_pad((d << s2.log2lanes) + l);
    yr[o] = s2.r[a];
    yi[o] = s2.i[a];
  }
}

// K11's middle step on Bluestein lines (fftconv4_mid_regs's contract): the
// forward, times H and conjugated, then the inverse's transform over d as a
// second Bluestein forward (natural order in and out), times W_N^{c e}.
template <int LOG2M>
__global__ void __launch_bounds__(kBluesteinThreads, 1)
    fftconv4_mid_bluestein(const float* __restrict__ s1r, const float* __restrict__ s1i,
                           const float* h, long long h_stride, int F, long long g0,
                           const float* tw, const float* __restrict__ post2,
                           float* __restrict__ s2r, float* __restrict__ s2i, int log2lanes,
                           int N, int L, const LineDiv divL) {
  using S = BluesteinShape<LOG2M>;
  extern __shared__ float smem[];
  const int count = L << log2lanes, W = N / L;
  const LineTile s(smem, lines_plane(S::kM << log2lanes), log2lanes);
  lines_zero_set();
  const long long so = (long long)blockIdx.y * N;
  const int line0 = blockIdx.x << log2lanes;
  const long long ch = (g0 + blockIdx.y) / F;
  tile_load_async(s.r, s.i, log2lanes, s1r + so + line0, s1i + so + line0, count, W);
  float vr[kFftRegsVals], vi[kFftRegsVals];
  bluestein_load<LOG2M>(vr, vi, s, L);
  bluestein_line<LOG2M>(vr, vi, s, L, tw);
  // the product and the inverse with indices made after the forward (fresh)
  // and an opaque H pointer (lines_opaque)
  const LineTile s2 = s.fresh();
  const float* hr = lines_opaque(h) + ch * h_stride + line0 + s2.lane;
  const float* hi = hr + N;
#pragma unroll
  for (int q = 0; q < kFftRegsVals; ++q) {
    const int d = s2.tl + S::kT * q;
    if (d < L) {
      fft_regs_cmul(vr[q], vi[q], hr[W * d], hi[W * d]);
      vi[q] = -vi[q];
    }
  }
  bluestein_line<LOG2M>(vr, vi, s2, L, tw);
  const LineTile s3 = s.fresh();
  line_stage<1, LOG2M>(vr, vi, s3);
  const long long at = so + (long long)line0 * L;
  const float* pr = post2 + (long long)line0 * L;
  const float* pi = pr + N;
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const int l = divL(t), e = t - l * L;
    const int a = fft_regs_pad((e << s3.log2lanes) + l);
    float ur = s3.r[a], ui = s3.i[a];
    fft_regs_cmul(ur, ui, __ldg(pr + t), __ldg(pi + t));
    s2r[at + t] = ur;
    s2i[at + t] = ui;
  }
}

// K11's last step on Bluestein lines (fftconv4_out_regs's contract).
template <int LOG2M>
__global__ void __launch_bounds__(kBluesteinThreads, 1)
    fftconv4_out_bluestein(const float* __restrict__ s2r, const float* __restrict__ s2i, int F,
                           int hop, long long g0, const float* tw, float* __restrict__ yr,
                           float* __restrict__ yi, int log2lanes, int N, int L) {
  using S = BluesteinShape<LOG2M>;
  extern __shared__ float smem[];
  const int count = L << log2lanes, W = N / L;
  const LineTile s(smem, lines_plane(S::kM << log2lanes), log2lanes);
  lines_zero_set();
  const long long so = (long long)blockIdx.y * N;
  const int line0 = blockIdx.x << log2lanes;
  tile_load_async(s.r, s.i, log2lanes, s2r + so + line0, s2i + so + line0, count, W);
  float vr[kFftRegsVals], vi[kFftRegsVals];
  bluestein_load<LOG2M>(vr, vi, s, L);
  bluestein_line<LOG2M>(vr, vi, s, L, tw);
  // staged in natural order g, then stored in rows: frame f of channel c
  // lands at (c F + f) hop = G hop of y [C, F hop]
  line_stage<1, LOG2M>(vr, vi, s.fresh());
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

// --- the host side -------------------------------------------------------------

// One of the two line kinds of a four-step (kernels/fft_pallas.py
// LineShape.descriptor, BluesteinLine.descriptor): {p, log2m, log2lanes}, a
// register line of L = p 2^log2m points (p odd, 1 ... 15), or (p == 0) a
// Bluestein line of L points on M = 2^log2m >= 2L - 1.
struct Line {
  int p = 0, log2m = 0, log2lanes = 0, L = 0;
  int line_points() const { return p ? L : 1 << log2m; }  // a line's rows in the tile
  int threads() const { return (line_points() << log2lanes) / kFftRegsVals; }
  size_t smem() const {
    return 2 * (size_t)lines_plane(line_points() << log2lanes) * sizeof(float);
  }
  int lanes() const { return 1 << log2lanes; }
};

bool make_line(Line& d, const int* desc, int L) {
  d.p = desc[0], d.log2m = desc[1], d.log2lanes = desc[2], d.L = L;
  if (d.log2lanes < 0 || d.log2lanes > 10 || d.log2m < 4 || d.log2m > 14 || L <= 0) return false;
  if (d.p) return (d.p << d.log2m) == L && d.threads() <= kLineThreads;
  return 2 * L - 1 <= (1 << d.log2m) && d.threads() <= kBluesteinThreads;
}

// Calls fn(std::integral_constant P, std::integral_constant LOG2M) for a
// register line of FOUR_STEP_LINES, with P = 0 for a Bluestein line of
// BLUESTEIN_LINES; cudaErrorInvalidValue for any other.
template <class Fn>
int with_line(const Line& d, Fn fn) {
  switch (d.p * 64 + d.log2m) {
#define SRCDSP_LINE_CASE(P, M) \
  case P * 64 + M:             \
    return fn(std::integral_constant<int, P>{}, std::integral_constant<int, M>{});
    FOUR_STEP_LINES(SRCDSP_LINE_CASE)
#undef SRCDSP_LINE_CASE
#define SRCDSP_BLUESTEIN_CASE(M) \
  case M:                        \
    return fn(std::integral_constant<int, 0>{}, std::integral_constant<int, M>{});
    BLUESTEIN_LINES(SRCDSP_BLUESTEIN_CASE)
#undef SRCDSP_BLUESTEIN_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launches kernel<<<grid, d's threads and shared memory, st>>>(args...) after
// allowing its shared memory; returns that call's cudaError_t, or 0.
template <class Kernel, class... Args>
int launch(Kernel kernel, const Line& d, dim3 grid, cudaStream_t st, Args... args) {
  const int err = (int)allow_smem(kernel, d.smem());
  if (err) return err;
  kernel<<<grid, d.threads(), d.smem(), st>>>(args...);
  return 0;
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
              const float* tw, const float* post, float* s1r, float* s1i, int n) {
  const dim3 grid(n / d.L / d.lanes(), frames);
  return with_line(d, [&](auto pc, auto mc) {
    constexpr int kP = decltype(pc)::value, kLog2M = decltype(mc)::value;
    if constexpr (kP == 0)
      return launch(fft4_cols_bluestein<kLog2M>, d, grid, st, xr, xi, chan_stride, frame_stride,
                    F, g0, tw, post, s1r, s1i, d.log2lanes, n, d.L, LineDiv(d.L));
    else
      return launch(fft4_cols_regs<kP, kLog2M>, d, grid, st, xr, xi, chan_stride, frame_stride,
                    F, g0, tw, post, s1r, s1i, d.log2lanes, n);
  });
}

}  // namespace

// x planes xr, xi [B, N] f32, N = f1 * f2 <= 2^20; tw1, tw2 the two lines'
// tables and post the two post-twiddle planes [2, N] each (W_N^{b c} at
// b f1 + c, then W_N^{c e} at c f2 + e; kernels/fft_pallas.py
// FftPlan.tables); scratch [2, batch * N] f32; yr, yi [B, N], natural order
// (digit == 0) or the digit order of [n1, n2]; desc1, desc2 the lines (Line).
// Runs the frames in batches of `batch`, two launches a batch. Returns the
// first launch's cudaError_t (cudaErrorInvalidValue for lines that do not
// fit), or 0.
extern "C" int srcdsp_fft_4step(const void* xr, const void* xi, const void* tw1, const void* tw2,
                                const void* post, void* scratch, void* yr, void* yi, int B,
                                int batch, const int* desc1, const int* desc2, int f1, int f2,
                                int n1, int n2, int digit, void* stream) {
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
  float* y_r = (float*)yr;
  float* y_i = (float*)yi;
  const cudaStream_t st = (cudaStream_t)stream;
  for (long long g0 = 0; g0 < B; g0 += batch) {
    const int frames = (int)(B - g0 < batch ? B - g0 : batch);
    int err = cols_step(cols, frames, st, (const float*)xr, (const float*)xi, 0, n, B, g0, w1,
                        post1, s1r, s1i, n);
    if (err) return err;
    const dim3 grid(f1 / rows.lanes(), frames);
    err = with_line(rows, [&](auto pc, auto mc) {
      constexpr int kP = decltype(pc)::value, kLog2M = decltype(mc)::value;
      if constexpr (kP == 0)
        return launch(fft4_rows_bluestein<kLog2M>, rows, grid, st, s1r, s1i, g0, w2, y_r, y_i,
                      rows.log2lanes, n, rows.L, n1, n2, LineDiv(n1), LineDiv(rows.L), digit);
      else
        return launch(fft4_rows_regs<kP, kLog2M>, rows, grid, st, s1r, s1i, g0, w2, y_r, y_i,
                      rows.log2lanes, n, n1, n2, LineDiv(n1), digit);
    });
    if (err) return err;
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

// x [C, 2, L] f32, L = overlap + F * hop; h [Ct, 2, N] f32 natural order,
// Ct = C when per_channel != 0, else 1; tw1, tw2, post, desc1, desc2 as
// srcdsp_fft_4step; scratch [4, batch * N] f32; yr, yi [C, F * hop]. The
// C * F frames run in batches of `batch`, three launches a batch. Returns the
// first launch's cudaError_t, or 0.
extern "C" int srcdsp_fftconv_4step(const void* x, const void* h, const void* tw1,
                                    const void* tw2, const void* post, void* scratch, void* yr,
                                    void* yi, int C, long long L, int F, int hop, int batch,
                                    const int* desc1, const int* desc2, int f1, int f2,
                                    int per_channel, void* stream) {
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
  const float* hk = (const float*)h;
  float* s1r = (float*)scratch;
  float* s1i = s1r + (long long)batch * n;
  float* s2r = s1i + (long long)batch * n;
  float* s2i = s2r + (long long)batch * n;
  float* y_r = (float*)yr;
  float* y_i = (float*)yi;
  const long long h_stride = per_channel ? 2LL * n : 0LL;
  const long long frames_all = (long long)C * F;
  const cudaStream_t st = (cudaStream_t)stream;
  for (long long g0 = 0; g0 < frames_all; g0 += batch) {
    const int frames = (int)(frames_all - g0 < batch ? frames_all - g0 : batch);
    int err = cols_step(cols, frames, st, xr, xr + L, 2 * L, hop, F, g0, w1, post1, s1r, s1i, n);
    if (err) return err;
    const dim3 gmid(f1 / rows.lanes(), frames), gout(f2 / cols.lanes(), frames);
    err = with_line(rows, [&](auto pc, auto mc) {
      constexpr int kP = decltype(pc)::value, kLog2M = decltype(mc)::value;
      if constexpr (kP == 0)
        return launch(fftconv4_mid_bluestein<kLog2M>, rows, gmid, st, s1r, s1i, hk, h_stride, F,
                      g0, w2, post2, s2r, s2i, rows.log2lanes, n, rows.L, LineDiv(rows.L));
      else
        return launch(fftconv4_mid_regs<kP, kLog2M>, rows, gmid, st, s1r, s1i, hk, h_stride, F,
                      g0, w2, post2, s2r, s2i, rows.log2lanes, n);
    });
    if (err) return err;
    err = with_line(cols, [&](auto pc, auto mc) {
      constexpr int kP = decltype(pc)::value, kLog2M = decltype(mc)::value;
      if constexpr (kP == 0)
        return launch(fftconv4_out_bluestein<kLog2M>, cols, gout, st, s2r, s2i, F, hop, g0, w1,
                      y_r, y_i, cols.log2lanes, n, cols.L);
      else
        return launch(fftconv4_out_regs<kP, kLog2M>, cols, gout, st, s2r, s2i, F, hop, g0, w1,
                      y_r, y_i, cols.log2lanes, n);
    });
    if (err) return err;
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
  return with_line(d, [&](auto pc, auto mc) {
    constexpr int kP = decltype(pc)::value, kLog2M = decltype(mc)::value;
    if constexpr (kP == 0) {
      switch (which) {
        case 0: return info(fft4_cols_bluestein<kLog2M>);
        case 1: return info(fft4_rows_bluestein<kLog2M>);
        case 2: return info(fftconv4_mid_bluestein<kLog2M>);
        default: return info(fftconv4_out_bluestein<kLog2M>);
      }
    } else {
      switch (which) {
        case 0: return info(fft4_cols_regs<kP, kLog2M>);
        case 1: return info(fft4_rows_regs<kP, kLog2M>);
        case 2: return info(fftconv4_mid_regs<kP, kLog2M>);
        default: return info(fftconv4_out_regs<kP, kLog2M>);
      }
    }
  });
}
