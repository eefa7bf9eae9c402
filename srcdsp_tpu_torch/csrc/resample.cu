// Fused NCO mix + rational L/M resampler (K8, K9).
//
// Two kernels from one template body, resample_kernel<D, Src>:
//  * K8, mix_resample (raw planes [C, 2, L]), replaces
//    srcdsp_tpu/kernels/resample_pallas.py make_mix_resample_kernel and
//    make_mix_resample_kernel_mc (both through mixfir._compute);
//  * K9, resample_preframed (producer frames [NT, span], f32 or bf16),
//    replaces srcdsp_tpu/kernels/resample_preframed.py
//    make_resample_preframed_kernel (_kernel). Each sample is read from the
//    frame row deframe takes it from (Frames in fsk_common.cuh), so K9 gives
//    K8's bits on the same stream; bf16 frames go two samples a load where the
//    host finds them aligned (Paired).
//
// The TPU kernels run the resampler as a stride-L banded Toeplitz matmul,
// H[a, j] = h[j*M + hist*L - a*L], whose band is mostly structural zeros; K9
// also folds the NCO into complex bands to keep the per-sample mix off the TPU
// vector unit. Here the sum is polyphase. Output J (flat over [NT, OT]; the
// stream's sample 0 is the first of hist history samples) is
//   y[J] = sum_{q < Q} h[phi + q*L] * m[top - q],   Q = ceil(T / L),
//   phi = (J*M) mod L,  top = hist + floor(J*M / L),
// with m the mixed stream (each sample times the phasor of its exact u32 word
// w0 + g*dw). The outputs J = J0 + j + L*r of a block (J0 a multiple of L)
// with one class j < L share the phase phi_j = (j*M) mod L and read
// top = hist + J0*M/L + o_j + M*r, o_j = floor(j*M / L): each class is a
// decimate-by-M FIR with the Q taps h_phi_j, which is what the register ring
// of fir_ring.cuh computes with decim D = M (K1's FirShape: R = 4 outputs a
// thread in blocks of 256 at M = 4, 8 in blocks of 128 at M = 1 and 2; any
// other M the generic instantiation, R = 1 in tap order).
//
// The ring's shared-memory addresses are one padded base per chunk plus
// immediates, which needs each thread's base on a multiple of its padding
// stride S = R*M; class j's base sits o_j < M samples past one. So the ring
// takes o_j as a static offset (ring_outputs<S, false, O>, one instantiation
// per O < M, chosen per class): index y + O + m of a base y on the stride is
// fir_pad(y) + O + m + (O + m >= S), still immediates. Lanes of a warp sit S
// apart within one class, on the window padded one float per S samples
// (S + 1 odd: 32 banks), whatever o_j. The zero taps that pad a row to a
// whole chunk add +-0 to a sum that is never -0, so every output is the one
// fmaf chain per plane over q = 0..Q-1 from +0 of the one-output-a-thread
// form this replaced: its bits did not move.
//
// A block owns `outputs` = nr*L consecutive outputs of one channel (nr = W
// warps x 32 lanes x R outputs a class; W = 8 at config 2, 3072 outputs),
// stages their window once, mixed (stage_window<true>, kStageBatch loads in
// flight a thread), with the L class tap rows; each warp then takes class
// tasks (class j, sub-block of 32*R outputs) in turn. A thread's R outputs of
// one class lie L apart in the output, so they go to a shared output tile
// (one float of padding per R*L outputs: lanes R*L + 1 apart, conflict-free
// for even R*L) and the block stores the tile as consecutive floats.
//
// What bounds it: at the config-2 combined taps (T = 429, L/M = 3/4) an
// output costs 143 taps x 4 flop and an input sample (8 bytes in, 0.75
// outputs = 6 bytes out) 429 flop: about 31 flop per byte, above the H100's
// 67 TFLOP/s / 3.35 TB/s = 20, so f32 multiply-adds bound it. The ring
// issues 2 shared loads per 2R FMAs (the old form 3 per 2) and runs 144
// taps a class for Q = 143.
//
// kernels/resample_pallas.py mirrors the geometry, ownership, index map and
// tile (ring_*, class_*), and tests/test_torch_resample_kernel.py checks it.
#include "fir_ring.cuh"

using namespace srcdsp;

namespace {

constexpr int kMaxWordChannels = 32;        // channels per launch: words travel by value
constexpr size_t kSmemBudget = 96 * 1024;   // W halves until a block fits (2 blocks an SM)
constexpr size_t kMaxSmem = 227 * 1024;     // a block's most dynamic shared memory

struct Words {
  uint32_t w0[kMaxWordChannels];
  uint32_t dw[kMaxWordChannels];
};

// K1's shapes (bench_torch/ab_resample.py times others).
template <int D>
using ResampleShape = FirShape<D>;

// The block geometry, computed on the host and passed by value.
struct ResampleGeometry {
  int q;          // taps a phase, ceil(T / L)
  int tpc;        // taps a class runs and floats of its row: Q in whole chunks
  int lead;       // window samples before the block's hist-th
  int warps;      // W: warps a class task spans (a power of two)
  int step;       // classes a warp moves on by: warps a block / W
  int nr;         // outputs of one class a block owns: W*32*R
  int outputs;    // outputs a block owns: nr*L
  int span;       // window samples
  int plane;      // floats of one padded window plane
  int out_plane;  // floats of one plane of the output tile: outputs + nr/R
};

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

size_t resample_smem(const ResampleGeometry& g, int up) {
  return (size_t)(up * g.tpc + 2 * g.plane + 2 * g.out_plane) * sizeof(float);
}

// hist + lead is the least multiple of the padding stride that is at least
// hist and tpc - 1, so the zero taps of the last chunk read inside the
// window; the last thread's last output of the last class reads below
// nr*M + hist + lead (o_j < M).
template <class S>
ResampleGeometry resample_geometry(int up, int down, int Q, int hist) {
  constexpr int kStride = 1 << S::kLog2Stride;
  ResampleGeometry g;
  g.q = Q;
  g.tpc = round_up(Q, S::kD ? S::kChunk : 4);
  g.lead = round_up(g.tpc - 1 > hist ? g.tpc - 1 : hist, kStride) - hist;
  for (g.warps = S::kThreads / 32;; g.warps /= 2) {
    g.nr = g.warps * 32 * S::kR;
    g.outputs = g.nr * up;
    g.span = g.nr * down + hist + g.lead;
    g.plane = fir_pad(g.span - 1, S::kLog2Stride) + 1;
    g.out_plane = g.outputs + g.nr / S::kR;
    g.step = S::kThreads / 32 / g.warps;
    if (g.warps == 1 || resample_smem(g, up) <= kSmemBudget) break;
  }
  return g;
}

// sub*32 + lane of the calling thread's class task (rs below), from a fresh
// read of threadIdx.x (asm volatile): kept in a register across the ring it
// made the M = 4 instantiation over raw planes spill at 64 registers.
__device__ __forceinline__ int task_lane(const ResampleGeometry& g) {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t & (g.warps * 32 - 1);
}

// Class j's ring at its offset o = o_j (< D) as ring_block's static O.
template <class S, int O = 0>
__device__ __forceinline__ void class_ring(int o, const float* __restrict__ h,
                                           const float* __restrict__ sr,
                                           const float* __restrict__ si, int base,
                                           const ResampleGeometry& g, float (&ar)[S::kR],
                                           float (&ai)[S::kR]) {
  if constexpr (O + 1 < S::kD) {
    if (o != O) {
      class_ring<S, O + 1>(o, h, sr, si, base, g, ar, ai);
      return;
    }
  }
  ring_block<S, false, O>(h, nullptr, sr, si, base, g.tpc, g.q, ar, ai);
}

// The block's window, staged mixed, as a call of its own (one a block):
// inlined beside the class loop, the M = 4 instantiation over raw planes
// spilled 4 bytes at 64 registers.
template <class Src, int BATCH>
__device__ __noinline__ void stage_mixed(const Src& src, int c, long long base, int span,
                                         uint32_t w0, uint32_t dw, float* sr, float* si,
                                         int log2s) {
  stage_window<true, Src, PaddedIndex, BATCH>(src, c, base, span, w0, dw, sr, si,
                                              PaddedIndex{log2s});
}

template <int D, class Src>
__global__ void __launch_bounds__(ResampleShape<D>::kThreads, ResampleShape<D>::kMinBlocks)
    resample_kernel(Src src, Words words, const float* __restrict__ taps_ph,
                    float* __restrict__ yr, float* __restrict__ yi, long long total, int up,
                    int down, int hist, ResampleGeometry g) {
  using S = ResampleShape<D>;
  constexpr int R = S::kR;
  constexpr int kBatch = Src::kBytes == 2 && Src::kPaired ? kStageBatch / 2 : kStageBatch;
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.y;
  const int d = D ? D : down;
  float* sh = smem;              // [up, tpc] class tap rows
  float* sr = sh + up * g.tpc;   // the padded window planes
  float* si = sr + g.plane;
  float* tr = si + g.plane;      // the output tile planes
  float* ti = tr + g.out_plane;
  const long long j0 = (long long)blockIdx.x * g.outputs;  // the block's first output

  // row j: h[phi_j + q*L] for q < Q (taps_ph row phi_j), then zeros
  for (int i = threadIdx.x; i < up * g.tpc; i += blockDim.x) {
    const int j = i / g.tpc, q = i - j * g.tpc;
    sh[i] = q < g.q ? taps_ph[(j * d % up) * g.q + q] : 0.f;
  }
  stage_mixed<Src, kBatch>(src, c, (long long)blockIdx.x * g.nr * d - g.lead, g.span,
                           words.w0[c], words.dw[c], sr, si, S::kLog2Stride);
  __syncthreads();

  // warp w runs class tasks (j, sub) = (w/W + n*step, w mod W): task
  // j*W + sub = w + n*(warps a block); lane l of it owns r = rs*R + k,
  // rs = sub*32 + l = task_lane(g), k < R
  for (int j = (threadIdx.x >> 5) / g.warps; j < up; j += g.step) {
    const int o = j * d / up;
    float ar[R], ai[R];
    class_ring<S>(o, sh + j * g.tpc, sr, si, task_lane(g) * R * d + hist + g.lead + o, g, ar,
                  ai);
    const int p = task_lane(g) * (R * up + 1) + j;  // output r*L + j at r*L + j + r/R
#pragma unroll
    for (int k = 0; k < R; ++k) {
      tr[p + k * up] = ar[k];
      ti[p + k * up] = ai[k];
    }
  }
  __syncthreads();

  // store the tile: output i at tile float i + i/(R*L), the quotient carried
  // by adds
  const int rl = R * up, dq = blockDim.x / rl, dr = blockDim.x - dq * rl;
  const long long left = total - j0;
  const int n = left < g.outputs ? (int)left : g.outputs;
  float* yrc = yr + (long long)c * total + j0;
  float* yic = yi + (long long)c * total + j0;
  int qd = threadIdx.x / rl, rm = threadIdx.x - qd * rl;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    yrc[i] = tr[i + qd];
    yic[i] = ti[i + qd];
    qd += dq;
    rm += dr;
    if (rm >= rl) {
      rm -= rl;
      ++qd;
    }
  }
}

template <int D, class Src>
int launch(const Src& src, const Words& words, int channels, const void* taps_ph, float* yr,
           float* yi, long long total, int up, int down, int Q, int hist, cudaStream_t stream) {
  using S = ResampleShape<D>;
  const ResampleGeometry g = resample_geometry<S>(up, down, Q, hist);
  const size_t smem = resample_smem(g, up);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(resample_kernel<D, Src>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((total + g.outputs - 1) / g.outputs), channels);
  resample_kernel<D, Src><<<grid, S::kThreads, smem, stream>>>(
      src, words, (const float*)taps_ph, yr, yi, total, up, down, hist, g);
  return (int)cudaGetLastError();
}

// The instantiation that runs `down` (by_decim: D = down for 1, 2 and 4, else
// the generic D = 0).
template <class Src>
int dispatch(const Src& src, const Words& words, int channels, const void* taps_ph, void* yr,
             void* yi, long long total, int up, int down, int Q, int hist, void* stream) {
  return by_decim(down, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    return launch<D>(src, words, channels, taps_ph, (float*)yr, (float*)yi, total, up, down, Q,
                     hist, (cudaStream_t)stream);
  });
}

// cudaErrorInvalidValue for a shape the kernels do not take: the grid's
// extent, total / outputs, fits 2^31; hist covers the Q - 1 samples a phase
// reaches back.
bool bad_shape(long long total, int up, int down, int Q, int hist) {
  return total <= 0 || total > (1LL << 40) || up <= 0 || down <= 0 || up > 4096 || Q <= 0 ||
         hist < Q - 1;
}

}  // namespace

// K8: x [C, 2, L] f32 with L = hist + NIN; taps_ph [up, Q] f32 on the device;
// words0, dwords: HOST arrays of C u32 words, passed to the kernel by value
// (no copy to the device); yr, yi [C, NT, OT]. Channels go in launches of up
// to kMaxWordChannels. Returns the first failing launch's cudaError_t, or 0.
extern "C" int srcdsp_mix_resample(const void* x, const void* taps_ph, void* yr, void* yi,
                                   const void* words0, const void* dwords, int C, int L,
                                   int NT, int OT, int up, int down, int Q, int hist,
                                   void* stream) {
  const long long total = (long long)NT * OT;
  if (C <= 0 || bad_shape(total, up, down, Q, hist)) return (int)cudaErrorInvalidValue;
  const uint32_t* w0 = (const uint32_t*)words0;
  const uint32_t* dw = (const uint32_t*)dwords;
  for (int c0 = 0; c0 < C; c0 += kMaxWordChannels) {
    const int n = C - c0 < kMaxWordChannels ? C - c0 : kMaxWordChannels;
    Words words{};
    for (int c = 0; c < n; ++c) {
      words.w0[c] = w0[c0 + c];
      words.dw[c] = dw[c0 + c];
    }
    const long long out = (long long)c0 * total;
    const int rc = dispatch(Planes<float>{(const float*)x + (long long)c0 * 2 * L, L}, words, n,
                            taps_ph, (float*)yr + out, (float*)yi + out, total, up, down, Q,
                            hist, stream);
    if (rc != 0) return rc;
  }
  return 0;
}

// K9: frames xr_f, xi_f [NT, span] (f32, or bf16 when bf16 != 0) with
// span = OT*down/up + hist; w0/dw u32 words; else as K8 with C = 1.
extern "C" int srcdsp_resample_preframed(const void* xr_f, const void* xi_f,
                                         const void* taps_ph, void* yr, void* yi,
                                         unsigned int w0, unsigned int dw, int NT, int span,
                                         int OT, int up, int down, int Q, int hist, int bf16,
                                         void* stream) {
  const long long total = (long long)NT * OT;
  if (bad_shape(total, up, down, Q, hist)) return (int)cudaErrorInvalidValue;
  Words words{};
  words.w0[0] = w0;
  words.dw[0] = dw;
  const int stride = (OT * down) / up;
  if (bf16) {
    const Frames<__nv_bfloat16> src{(const __nv_bfloat16*)xr_f, (const __nv_bfloat16*)xi_f, NT,
                                    stride, span};
    if (pairs_fit({xr_f, xi_f}, {stride, span}))  // windows start on even samples
      return dispatch(Paired<Frames<__nv_bfloat16>>{src}, words, 1, taps_ph, yr, yi, total, up,
                      down, Q, hist, stream);
    return dispatch(src, words, 1, taps_ph, yr, yi, total, up, down, Q, hist, stream);
  }
  return dispatch(Frames<float>{(const float*)xr_f, (const float*)xi_f, NT, stride, span}, words,
                  1, taps_ph, yr, yi, total, up, down, Q, hist, stream);
}

// Registers, local-memory bytes (spills) and resident blocks per SM of the
// instantiation that runs up/down at Q taps a phase and `hist`, over source 0
// (raw planes, K8) or 1 (frames, K9), f32 or (bf16 != 0, source 1) bf16 read
// in pairs. Returns the cudaError_t, or 0.
extern "C" int srcdsp_resample_info(int source, int bf16, int up, int down, int Q, int hist,
                                    int* regs, int* local_bytes, int* blocks_per_sm) {
  if (source < 0 || source > 1 || (bf16 && source == 0) || bad_shape(up, up, down, Q, hist))
    return (int)cudaErrorInvalidValue;
  return by_decim(down, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    using S = ResampleShape<D>;
    const size_t smem = resample_smem(resample_geometry<S>(up, down, Q, hist), up);
    if (source == 0)
      return kernel_info(resample_kernel<D, Planes<float>>, S::kThreads, smem, regs,
                         local_bytes, blocks_per_sm);
    return bf16 ? kernel_info(resample_kernel<D, Paired<Frames<__nv_bfloat16>>>, S::kThreads,
                              smem, regs, local_bytes, blocks_per_sm)
                : kernel_info(resample_kernel<D, Frames<float>>, S::kThreads, smem, regs,
                              local_bytes, blocks_per_sm);
  });
}
