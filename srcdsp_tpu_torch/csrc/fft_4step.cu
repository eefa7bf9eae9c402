// K10 and K11 from 16384 to 2^20 points (the sizes the JAX kernels take
// there: n2 % 128 == 0, n1 % 8 == 0): the four-step N = f1 * f2 over a
// scratch buffer in device memory. Replaces, at those sizes,
// srcdsp_tpu/kernels/fft_pallas.py make_fft_kernel.fn_rows_p / fn_nat (K10)
// and srcdsp_tpu/kernels/fftconv_pallas.py make_fftconv_kernel.fn (K11). The
// TPU kernels hold the whole frame in VMEM as an [n1, n2] tile; a frame of
// 16384 complex f32 points is 128 KB, one block an SM at most, and at 2^20
// points it fits no block's shared memory.
//
// With input index n = b + f2 a and output index k = c + f1 d (a, c < f1;
// b, d < f2):
//   X[c + f1 d] = sum_b W_f2^{b d} W_N^{b c} sum_a x[b + f2 a] W_f1^{a c}.
// Step 1 (fft4_step1_kernel) takes a tile of adjacent columns b of the frame
// seen as [f1, f2], runs their f1-point transforms on fft_lines.cuh's passes,
// multiplies output c by W_N^{b c} (b c < N) and writes the scratch [f2, f1]
// at b f1 + c, so step 2 (fft4_step2_kernel) reads its lines c as adjacent
// columns again, runs the f2-point transforms and stores X[c + f1 d] at its
// natural or digit offset. K11 takes three kernels over two scratch buffers:
// step 1 on the frame at f hop of the channel's stream; fftconv4_mid_kernel
// runs each column c's forward row transform, multiplies X[c + f1 d] by H
// where the passes left it, conjugates, runs the inverse's first step on the
// same line (the transposed passes: DFT over d, natural order e out) and
// multiplies by W_N^{c e} (the four-step of the inverse with its index split
// c + f1 d), into the second scratch at c f2 + e; fftconv4_out_kernel runs
// the inverse's f1-point transforms over c and stores n = e + f2 g, the last
// hop samples conjugated and times 1/N. So the product is fused into the
// forward's last step and the inverse's first.
//
// What bounds it: the bytes. Each sample is read once and written once by the
// transform (16 bytes; 0.160 ms for 2^25 samples at 3.35 TB/s), but a
// four-step in two kernels moves it twice: 32 bytes a sample of K10 (K11:
// 48, of which the scratch round trips are 32). What the design does about
// it: every device access is coalesced along the lanes (a tile of up to 32
// adjacent lines, up to 8192 points a block: 16 KB to 128 KB of shared
// memory), the scratch is laid out so that both steps read adjacent lines,
// and the arithmetic between is fft_lines.cuh's in-place passes in shared
// memory. The wrapper works in batches of frames whose scratch fits 256 MiB.
// Every frame is computed the same way wherever it lies, so the digit store,
// unscrambled, equals the natural store bit for bit, and chunked, streamed
// and time-sharded K11 calls equal one launch.
#include "fft_lines.cuh"
#include "fir_ring.cuh"

using namespace srcdsp;

namespace {

// Lines line0 ... line0 + lanes - 1 of a [L, W] matrix at (xr, xi) (element
// j of line l at l + j W) into the tile, then a barrier.
__device__ __forceinline__ void tile_load(LinePlanes& s, const float* __restrict__ xr,
                                          const float* __restrict__ xi, int L, int lanes,
                                          int W, int line0) {
  lines_copy(
      L * lanes,
      [&](int t, float& re, float& im) {
        const long long g = (long long)(t / lanes) * W + line0 + t % lanes;
        re = xr[g], im = xi[g];
      },
      [&](int t, float re, float im) {
        const int a = lines_at(t / lanes, t % lanes, lanes);
        s.r[a] = re, s.i[a] = im;
      });
  __syncthreads();
}

// Step 1: frame g0 + blockIdx.y (channel G / F, frame G mod F at ch *
// chan_stride + f * frame_stride of xr, xi) seen as [f1, f2]; this block's
// columns b; output c times W_N^{b c} (post[b f1 + c]) into the scratch
// [f2, f1] of batch frame blockIdx.y. tw, post: sections of a table whose
// imaginary plane lies T floats after its real one.
__global__ void __launch_bounds__(kLinesThreads)
    fft4_step1_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                     long long chan_stride, long long frame_stride, int F, long long g0,
                     const float* __restrict__ tw, const float* __restrict__ post, int T,
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
  tile_load(s, xr + base, xi + base, L, lanes, W, line0);
  lines_transform<false>(s.r, s.i, s.sr, s.si, p, tw, tw + T);
  const long long so = (long long)blockIdx.y * N;
  for (int t = threadIdx.x; t < L * lanes; t += blockDim.x) {
    const int c = t % L, lane = t / L, b = line0 + lane;
    const int a = lines_at(__ldg(rev + c), lane, lanes);
    float vr = s.r[a], vi = s.i[a];
    const int e = b * L + c;
    fft_regs_cmul(vr, vi, __ldg(post + e), __ldg(post + T + e));
    s1r[so + (long long)b * L + c] = vr;
    s1i[so + (long long)b * L + c] = vi;
  }
}

// Step 2 of K10: lines c of batch frame blockIdx.y's scratch [f2, f1]; X[c +
// f1 d] to frame g0 + blockIdx.y of y, natural (digit == 0) or digit order of
// [n1, n2].
__global__ void __launch_bounds__(kLinesThreads)
    fft4_step2_kernel(const float* __restrict__ s1r, const float* __restrict__ s1i, long long g0,
                     const float* __restrict__ tw, int T, const int* __restrict__ rev,
                     float* __restrict__ yr, float* __restrict__ yi, const LinePlan plan, int N,
                     int n1, int n2, int digit) {
  __shared__ LinePlan p;
  extern __shared__ float smem[];
  lines_stage_plan(p, plan);
  const int L = plan.L, lanes = plan.lanes, W = N / L;
  LinePlanes s(smem, L * lanes);
  const long long so = (long long)blockIdx.y * N;
  const int line0 = blockIdx.x * lanes;
  tile_load(s, s1r + so, s1i + so, L, lanes, W, line0);
  lines_transform<false>(s.r, s.i, s.sr, s.si, p, tw, tw + T);
  const long long out = (g0 + blockIdx.y) * N;
  for (int t = threadIdx.x; t < L * lanes; t += blockDim.x) {
    // natural: neighbouring threads on neighbouring lines (offsets k); digit:
    // on neighbouring d (offsets c n2 + d where f1 == n1)
    const int lane = digit ? t / L : t % lanes, d = digit ? t % L : t / lanes;
    const int k = line0 + lane + W * d;
    const int a = lines_at(__ldg(rev + d), lane, lanes);
    const long long o = out + (digit ? (k % n1) * n2 + k / n1 : k);
    yr[o] = s.r[a];
    yi[o] = s.i[a];
  }
}

// K11's middle step: lines c of batch frame blockIdx.y's scratch [f2, f1];
// the forward row transform, X[c + f1 d] times H (channel (g0 + blockIdx.y)
// / F) and conjugated, the inverse's DFT over d (transposed passes, natural
// e out), times W_N^{c e} (post[c f2 + e]), into the second scratch [f1, f2]
// at c f2 + e.
__global__ void __launch_bounds__(kLinesThreads)
    fftconv4_mid_kernel(const float* __restrict__ s1r, const float* __restrict__ s1i,
                        const float* __restrict__ h, long long h_stride, int F, long long g0,
                        const float* __restrict__ tw, const float* __restrict__ post, int T,
                        const int* __restrict__ rev, float* __restrict__ s2r,
                        float* __restrict__ s2i, const LinePlan plan, int N) {
  __shared__ LinePlan p;
  extern __shared__ float smem[];
  lines_stage_plan(p, plan);
  const int L = plan.L, lanes = plan.lanes, W = N / L;
  LinePlanes s(smem, L * lanes);
  const long long so = (long long)blockIdx.y * N;
  const int line0 = blockIdx.x * lanes;
  tile_load(s, s1r + so, s1i + so, L, lanes, W, line0);
  lines_transform<false>(s.r, s.i, s.sr, s.si, p, tw, tw + T);
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
  lines_transform<true>(s.r, s.i, s.sr, s.si, p, tw, tw + T);
  for (int t = threadIdx.x; t < L * lanes; t += blockDim.x) {
    const int e = t % L, lane = t / L, c = line0 + lane;
    const int a = lines_at(e, lane, lanes);
    float vr = s.r[a], vi = s.i[a];
    const int x = c * L + e;
    fft_regs_cmul(vr, vi, __ldg(post + x), __ldg(post + T + x));
    s2r[so + (long long)c * L + e] = vr;
    s2i[so + (long long)c * L + e] = vi;
  }
}

// K11's last step: lines e of batch frame blockIdx.y's second scratch [f1,
// f2]; the inverse's f1-point transform over c; n = e + f2 g, conjugated and
// times 1/N, stored where n >= overlap at (channel, frame f) of y [C, F hop].
__global__ void __launch_bounds__(kLinesThreads)
    fftconv4_out_kernel(const float* __restrict__ s2r, const float* __restrict__ s2i, int F,
                        int hop, long long g0, const float* __restrict__ tw, int T,
                        const int* __restrict__ rev, float* __restrict__ yr,
                        float* __restrict__ yi, const LinePlan plan, int N) {
  __shared__ LinePlan p;
  extern __shared__ float smem[];
  lines_stage_plan(p, plan);
  const int L = plan.L, lanes = plan.lanes, W = N / L;
  LinePlanes s(smem, L * lanes);
  const long long so = (long long)blockIdx.y * N;
  const int line0 = blockIdx.x * lanes;
  tile_load(s, s2r + so, s2i + so, L, lanes, W, line0);
  lines_transform<false>(s.r, s.i, s.sr, s.si, p, tw, tw + T);
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

template <typename Kernel>
cudaError_t prepare(Kernel kernel, const LinePlan& plan) {
  return allow_smem(kernel, lines_smem(plan));
}

// The two plans: columns (f1 points, f2 lines) and rows (f2 points, f1 lines).
bool make_plans(LinePlan& cols, LinePlan& rows, const int* rad1, int p1, int lanes1,
                const int* rad2, int p2, int lanes2, int f1, int f2) {
  if (f1 <= 0 || f2 <= 0 || (long long)f1 * f2 > (1 << 20)) return false;
  return lines_make_plan(cols, rad1, p1, f1, lanes1) && f2 % lanes1 == 0 &&
         lines_make_plan(rows, rad2, p2, f2, lanes2) && f1 % lanes2 == 0;
}

// The table of a four-step (kernels/fft_pallas.py FftPlan.tables): the
// columns' section, the rows', then post1 (W_N^{b c} at b f1 + c) and post2
// (W_N^{c e} at c f2 + e), N entries each; floats of one plane.
int four_step_table(const LinePlan& cols, const LinePlan& rows, int n) {
  return cols.tw_size + rows.tw_size + 2 * n;
}

}  // namespace

// x planes xr, xi [B, N] f32, N = f1 * f2 <= 2^20; tw [2, T] (the table of
// four_step_table);
// rev [f1 + f2] int32 (_line_rev of f1, then of f2); scratch [2, batch * N]
// f32; yr, yi [B, N], natural order (digit == 0) or the digit order of [n1,
// n2]. The two plans' radices and lanes (kernels/fft_pallas.py fft_plan).
// Runs the frames in batches of `batch`, two launches a batch. Returns the
// first launch's cudaError_t (cudaErrorInvalidValue for plans that do not
// fit), or 0.
extern "C" int srcdsp_fft_4step(const void* xr, const void* xi, const void* tw, const void* rev,
                                void* scratch, void* yr, void* yi, int B, int batch,
                                const int* rad1, int p1, int lanes1, const int* rad2, int p2,
                                int lanes2, int f1, int f2, int n1, int n2, int digit,
                                void* stream) {
  LinePlan cols{}, rows{};
  if (B <= 0 || batch <= 0 || batch > 65535 || n1 <= 0 || n2 <= 0 ||
      !make_plans(cols, rows, rad1, p1, lanes1, rad2, p2, lanes2, f1, f2) ||
      (long long)n1 * n2 != (long long)f1 * f2)
    return (int)cudaErrorInvalidValue;
  const int n = f1 * f2;
  cudaError_t err = prepare(fft4_step1_kernel, cols);
  if (err == cudaSuccess) err = prepare(fft4_step2_kernel, rows);
  if (err != cudaSuccess) return (int)err;
  const int T = four_step_table(cols, rows, n);
  const float* w1 = (const float*)tw;
  const float* w2 = w1 + cols.tw_size;
  const float* post1 = w2 + rows.tw_size;
  const int* r1 = (const int*)rev;
  const int* r2 = r1 + f1;
  float* s1r = (float*)scratch;
  float* s1i = s1r + (long long)batch * n;
  const cudaStream_t s = (cudaStream_t)stream;
  for (long long g0 = 0; g0 < B; g0 += batch) {
    const int frames = (int)(B - g0 < batch ? B - g0 : batch);
    fft4_step1_kernel<<<dim3(f2 / lanes1, frames), kLinesThreads, lines_smem(cols), s>>>(
        (const float*)xr, (const float*)xi, 0, n, B, g0, w1, post1, T, r1, s1r, s1i, cols, n);
    fft4_step2_kernel<<<dim3(f1 / lanes2, frames), kLinesThreads, lines_smem(rows), s>>>(
        s1r, s1i, g0, w2, T, r2, (float*)yr, (float*)yi, rows, n, n1, n2, digit);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// x [C, 2, L] f32, L = overlap + F * hop; h [Ct, 2, N] f32, Ct = C when
// per_channel != 0, else 1; tw, rev as srcdsp_fft_4step; scratch [4, batch *
// N] f32; yr, yi [C, F * hop]. The C * F frames run in batches of `batch`,
// three launches a batch. Returns the first launch's cudaError_t, or 0.
extern "C" int srcdsp_fftconv_4step(const void* x, const void* h, const void* tw,
                                    const void* rev, void* scratch, void* yr, void* yi, int C,
                                    long long L, int F, int hop, int batch, const int* rad1,
                                    int p1, int lanes1, const int* rad2, int p2, int lanes2,
                                    int f1, int f2, int per_channel, void* stream) {
  LinePlan cols{}, rows{};
  if (!make_plans(cols, rows, rad1, p1, lanes1, rad2, p2, lanes2, f1, f2)) {
    return (int)cudaErrorInvalidValue;
  }
  const int n = f1 * f2;
  if (hop <= 0 || hop > n || C <= 0 || F <= 0 || batch <= 0 || batch > 65535 ||
      L != (long long)(n - hop) + (long long)F * hop)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(fft4_step1_kernel, cols);
  if (err == cudaSuccess) err = prepare(fftconv4_mid_kernel, rows);
  if (err == cudaSuccess) err = prepare(fftconv4_out_kernel, cols);
  if (err != cudaSuccess) return (int)err;
  const int T = four_step_table(cols, rows, n);
  const float* w1 = (const float*)tw;
  const float* w2 = w1 + cols.tw_size;
  const float* post1 = w2 + rows.tw_size;
  const float* post2 = post1 + n;
  const float* xr = (const float*)x;
  const int* r1 = (const int*)rev;
  const int* r2 = r1 + f1;
  float* s1r = (float*)scratch;
  float* s1i = s1r + (long long)batch * n;
  float* s2r = s1i + (long long)batch * n;
  float* s2i = s2r + (long long)batch * n;
  const long long h_stride = per_channel ? 2LL * n : 0LL;
  const long long frames_all = (long long)C * F;
  const cudaStream_t s = (cudaStream_t)stream;
  for (long long g0 = 0; g0 < frames_all; g0 += batch) {
    const int frames = (int)(frames_all - g0 < batch ? frames_all - g0 : batch);
    fft4_step1_kernel<<<dim3(f2 / lanes1, frames), kLinesThreads, lines_smem(cols), s>>>(
        xr, xr + L, 2 * L, hop, F, g0, w1, post1, T, r1, s1r, s1i, cols, n);
    fftconv4_mid_kernel<<<dim3(f1 / lanes2, frames), kLinesThreads, lines_smem(rows), s>>>(
        s1r, s1i, (const float*)h, h_stride, F, g0, w2, post2, T, r2, s2r, s2i, rows, n);
    fftconv4_out_kernel<<<dim3(f2 / lanes1, frames), kLinesThreads, lines_smem(cols), s>>>(
        s2r, s2i, F, hop, g0, w1, T, r1, (float*)yr, (float*)yi, cols, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Registers, local-memory bytes and resident blocks per SM of kernel `which`
// of the two bodies (0 fft_mixed_kernel, 1 fftconv_mixed_kernel, 2
// fft4_step1_kernel, 3 fft4_step2_kernel, 4 fftconv4_mid_kernel, 5
// fftconv4_out_kernel) at `smem` bytes of dynamic shared memory. Returns the
// cudaError_t, or 0.
extern "C" int srcdsp_fft_lines_info(int which, int smem, int* regs, int* local_bytes,
                                     int* blocks_per_sm) {
  switch (which) {
    case 0:
    case 1: return fft_mixed_info(which, smem, regs, local_bytes, blocks_per_sm);
    case 2:
      return kernel_info(fft4_step1_kernel, kLinesThreads, smem, regs, local_bytes,
                         blocks_per_sm);
    case 3:
      return kernel_info(fft4_step2_kernel, kLinesThreads, smem, regs, local_bytes,
                         blocks_per_sm);
    case 4:
      return kernel_info(fftconv4_mid_kernel, kLinesThreads, smem, regs, local_bytes,
                         blocks_per_sm);
    case 5:
      return kernel_info(fftconv4_out_kernel, kLinesThreads, smem, regs, local_bytes,
                         blocks_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}
