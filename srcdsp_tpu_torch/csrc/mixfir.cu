// Fused NCO mix + FIR + decimate (K1), and its halo-fused form (K20).
//
// K1 replaces srcdsp_tpu/kernels/mixfir.py (make_mix_fir_kernel and
// make_mix_fir_kernel_mc, both through _compute): the TPU kernel builds
// overlapping windows and runs the FIR as banded-Toeplitz MXU matmuls. Here
// the FIR is a direct convolution from shared memory, register-blocked.
//
// K20 replaces srcdsp_tpu/kernels/halo_fused.py make_halo_fused_kernel
// (_kernel): one time shard of a sharded stream, whose history is its left
// neighbour's last hist samples (or the carried stream tail on shard 0). The
// TPU kernel pushes its own tail to the right neighbour by a remote DMA,
// computes blocks 1..G-1 while it flies and block 0 last. Here the body is
// K1's, templated on its window source: K1 reads Planes, K20 reads Split, the
// history [2, hist] in place through its pointer and plane stride (a peer
// read when the neighbour is on another card) and the shard's body [2, N].
// Only block 0 reads the history; the other blocks run as soon as they are
// scheduled, which is the overlap the TPU kernel builds by hand. No block
// spins on a flag set by another kernel: nothing guarantees the two would be
// resident together, and the inputs are complete before the launch.
//
// Layout (the JAX kernel's): x [C, 2, L] f32 with L = hist + N, the first
// hist samples history; output J of a channel is
//   y[J] = sum_a h[a] * u[J*decim + hist - a],
// u[g] = x[g] * e^{j 2 pi (w0 + g*dw) / 2^32}; yr, yi [C, NT, OT], which the
// kernel sees as NT*OT outputs per channel.
//
// What bounds it: at T = 64 the work is about 8 flop per byte moved, under
// the H100's 67 TFLOP/s / 3.35 TB/s = 20, so device-memory bytes set the
// floor (0.240 ms at config 1, 2^26 samples, decim 2). The earlier form gave
// each thread one output at a time: three shared loads (a tap and a sample
// per plane) for two FMAs, the samples `decim` words apart across a warp, so
// shared-memory load issue and bank conflicts, not bytes, set its time.
//
// The design. A block owns kOutputs = threads*R consecutive outputs of one
// channel (several rows of OT: the hist overlap is staged once per block),
// stages their window mixed (stage_window<true>: each sample mixed once by
// its exact u32 word, kStageBatch loads in flight a thread), then each thread
// computes R consecutive outputs (R = 8 at decim 1 and 2 in blocks of 128
// threads, 4 at decim 4 in blocks of 256) with 2R accumulators in registers,
// at most 64 registers so that 32 warps fit an SM.
// For tap a = b*decim + rho, output k reads the sample at position k - b of
// residue rho; a thread keeps, per residue, a ring of R registers with the
// positions its R outputs need, so each shared load feeds R FMAs per plane
// and each group of decim taps loads decim new samples. The lanes of a warp
// read samples S = R*decim apart; the window has one float of padding after
// every S (PaddedIndex), which puts the 32 lanes on 32 banks (S + 1 is odd).
// Taps come as broadcast float4 loads, zero past T to a whole chunk of
// R*decim taps. Any other decim runs the same kernel with R = 1 (D = 0).
//
// Summation order: every output is one fmaf chain per plane over
// a = 0, 1, ..., T-1 (then the zero taps of the last chunk, which add +-0 to
// a finite sum), the order of the earlier one-output-per-thread form, and it
// depends on the tap index alone: K20 == K1, chunked == one launch and
// sharded == unsharded hold bit for bit, and so do K1's bits across the
// redesign.
//
// kernels/mixfir.py mirrors the ownership and index map (fir_*), and
// tests/test_torch_mixfir.py checks it: every output reads u[J*decim + hist
// - a], every warp's window loads hit 32 banks, the blocks tile the output.
#include <type_traits>

#include "fsk_common.cuh"

using namespace srcdsp;

namespace {

constexpr int kStageBatch = 8;         // window samples a thread loads before it mixes any
constexpr int kMaxWordChannels = 32;   // channels per launch: words travel by value

struct Words {
  uint32_t w0[kMaxWordChannels];
  uint32_t dw[kMaxWordChannels];
};

constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }

// Ownership at decimation D (D = 0: any other decimation, read at run time).
template <int D>
struct FirShape {
  static constexpr int kR = D == 4 ? 4 : (D == 1 || D == 2) ? 8 : 1;  // outputs a thread owns
  static constexpr int kThreads = D == 4 ? 256 : 128;                  // threads of a block
  static constexpr int kMinBlocks = 1024 / kThreads;                   // per SM: 64 registers
  static constexpr int kOutputs = kThreads * kR;                       // outputs a block owns
  static constexpr int kChunk = D == 0 ? 1 : kR * D;                   // taps per chunk
  static constexpr int kLog2Stride = D == 0 ? 5 : ilog2(kR * D);       // padding stride
};

__host__ __device__ constexpr int fir_pad(int i, int log2s) { return i + (i >> log2s); }

// Shared memory of a block: the taps (tp floats, zero past T, first so that
// float4 loads are aligned), then the two padded window planes of `span`
// samples. The window starts `lead` samples before the block's first
// output's hist-th sample: hist + lead is the least multiple of the padding
// stride that is at least hist and tp - 1, so the zero taps of the last
// chunk read inside the window and every thread's ring sits on a multiple of
// the stride (lead is 0 whenever hist is a multiple of 32 and tp - 1 <= hist,
// as for every wrapper's hist, taps - 1 rounded up to 128).
struct FirGeometry {
  int tp, lead, span, plane;
  size_t smem;
};

template <int D>
__host__ __device__ FirGeometry fir_geometry(int decim, int T, int hist) {
  using S = FirShape<D>;
  constexpr int kStride = 1 << S::kLog2Stride;
  FirGeometry g;
  g.tp = (T + S::kChunk - 1) / S::kChunk * S::kChunk;
  const int need = g.tp - 1 > hist ? g.tp - 1 : hist;
  g.lead = (need + kStride - 1) / kStride * kStride - hist;
  g.span = S::kOutputs * decim + hist + g.lead;
  g.plane = fir_pad(g.span - 1, S::kLog2Stride) + 1;
  g.smem = (size_t)(g.tp + 2 * g.plane) * sizeof(float);
  return g;
}

// Output k of the thread accumulates tap a over the sample at window index
// base + k*D - a (base: output 0 at tap 0, a multiple of the stride S = R*D).
template <int D>
__device__ __forceinline__ void fir_outputs(const float* __restrict__ sh,
                                            const float* __restrict__ sr,
                                            const float* __restrict__ si, int base, int tp,
                                            float (&ar)[FirShape<D>::kR],
                                            float (&ai)[FirShape<D>::kR]) {
  using S = FirShape<D>;
  constexpr int R = S::kR, L2S = S::kLog2Stride, STRIDE = R * D;
  // ring[rho][(p mod R)] holds the sample at position p of residue rho, index
  // base + p*D - rho; group b (taps b*D .. b*D + D - 1) needs p = -b .. R-1-b.
  // With y a multiple of S and 0 <= m <= S, fir_pad(y + m) = fir_pad(y) + m
  // + (m == S): one padded address per chunk, the rest are immediates.
  float wr[D][R], wi[D][R];
  const int pb = fir_pad(base, L2S);
#pragma unroll
  for (int rho = 0; rho < D; ++rho)
#pragma unroll
    for (int p = 1; p < R; ++p) {  // index base + (p*D - rho), 0 < p*D - rho < S
      wr[rho][p] = sr[pb + p * D - rho];
      wi[rho][p] = si[pb + p * D - rho];
    }
  for (int a0 = 0; a0 < tp; a0 += STRIDE) {  // a chunk: groups a0/D .. a0/D + R-1, a0/D % R == 0
    const int py = fir_pad(base - a0 - STRIDE, L2S);
    float4 h4;
#pragma unroll
    for (int u = 0; u < R; ++u) {
#pragma unroll
      for (int rho = 0; rho < D; ++rho) {
        const int q = u * D + rho;  // a = a0 + q
        if (q % 4 == 0) h4 = *reinterpret_cast<const float4*>(sh + a0 + q);
        const float h = q % 4 == 0 ? h4.x : q % 4 == 1 ? h4.y : q % 4 == 2 ? h4.z : h4.w;
        // position -b enters the slot that position R-b left; its index is
        // base - a0 - q = (base - a0 - S) + (S - q)
        const int enter = (R - u) % R;
        const int i = py + (STRIDE - q) + (q == 0);
        wr[rho][enter] = sr[i];
        wi[rho][enter] = si[i];
#pragma unroll
        for (int k = 0; k < R; ++k) {
          ar[k] = fmaf(h, wr[rho][(k - u + R) % R], ar[k]);
          ai[k] = fmaf(h, wi[rho][(k - u + R) % R], ai[k]);
        }
      }
    }
  }
}

template <int D, class Src>
__device__ __forceinline__ void mixfir_body(const Src& src, int c, uint32_t w0, uint32_t dw,
                                            const float* __restrict__ taps,
                                            float* __restrict__ yr, float* __restrict__ yi,
                                            long long total, int decim, int T, int hist) {
  using S = FirShape<D>;
  constexpr int R = S::kR;
  extern __shared__ __align__(16) float smem[];
  const int d = D ? D : decim;
  const FirGeometry g = fir_geometry<D>(d, T, hist);
  float* sh = smem;
  float* sr = sh + g.tp;
  float* si = sr + g.plane;
  const long long j0 = (long long)blockIdx.x * S::kOutputs;  // the block's first output

  for (int a = threadIdx.x; a < g.tp; a += blockDim.x) sh[a] = a < T ? taps[a] : 0.f;
  stage_window<true, Src, PaddedIndex, kStageBatch>(src, c, blockIdx.x, j0 * d - g.lead, g.span,
                                                    w0, dw, sr, si, PaddedIndex{S::kLog2Stride});
  __syncthreads();

  float ar[R], ai[R];
#pragma unroll
  for (int k = 0; k < R; ++k) ar[k] = ai[k] = 0.f;
  const int base = threadIdx.x * R * d + hist + g.lead;
  if constexpr (D == 0) {
    for (int a = 0; a < T; ++a) {
      const float h = sh[a];
      const int i = fir_pad(base - a, S::kLog2Stride);
      ar[0] = fmaf(h, sr[i], ar[0]);
      ai[0] = fmaf(h, si[i], ai[0]);
    }
  } else {
    fir_outputs<D>(sh, sr, si, base, g.tp, ar, ai);
  }

  const long long j = j0 + (long long)threadIdx.x * R;
  if constexpr (R % 4 == 0) {
    if (j + R <= total && ((reinterpret_cast<uintptr_t>(yr + j) |
                            reinterpret_cast<uintptr_t>(yi + j)) & 15) == 0) {
#pragma unroll
      for (int k = 0; k < R; k += 4) {
        *reinterpret_cast<float4*>(yr + j + k) = {ar[k], ar[k + 1], ar[k + 2], ar[k + 3]};
        *reinterpret_cast<float4*>(yi + j + k) = {ai[k], ai[k + 1], ai[k + 2], ai[k + 3]};
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (j + k < total) {
      yr[j + k] = ar[k];
      yi[j + k] = ai[k];
    }
}

// K1: channel blockIdx.y of a launch group; x, taps, yr, yi start at the group.
template <int D>
__global__ void __launch_bounds__(FirShape<D>::kThreads, FirShape<D>::kMinBlocks)
    mixfir_kernel(const float* __restrict__ x, Words words, const float* __restrict__ taps,
                  int taps_stride, float* __restrict__ yr, float* __restrict__ yi, long long L,
                  long long total, int decim, int T, int hist) {
  const int c = blockIdx.y;
  mixfir_body<D>(Planes<float>{x, L}, c, words.w0[c], words.dw[c],
                 taps + (long long)c * taps_stride, yr + c * total, yi + c * total, total,
                 decim, T, hist);
}

template <int D>
__global__ void __launch_bounds__(FirShape<D>::kThreads, FirShape<D>::kMinBlocks)
    halo_fused_kernel(Split<float> src, uint32_t w0, uint32_t dw,
                      const float* __restrict__ taps, float* __restrict__ yr,
                      float* __restrict__ yi, long long total, int decim, int T, int hist) {
  mixfir_body<D>(src, 0, w0, dw, taps, yr, yi, total, decim, T, hist);
}

template <int D>
int launch_mixfir(const float* x, const Words& words, int channels, const float* taps,
                  int taps_stride, float* yr, float* yi, long long L, long long total, int decim,
                  int T, int hist, cudaStream_t stream) {
  using S = FirShape<D>;
  const FirGeometry g = fir_geometry<D>(decim, T, hist);
  cudaError_t err = allow_smem(mixfir_kernel<D>, g.smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((total + S::kOutputs - 1) / S::kOutputs), channels);
  mixfir_kernel<D><<<grid, S::kThreads, g.smem, stream>>>(x, words, taps, taps_stride, yr, yi,
                                                          L, total, decim, T, hist);
  return (int)cudaGetLastError();
}

template <int D>
int launch_halo_fused(const Split<float>& src, uint32_t w0, uint32_t dw, const float* taps,
                      float* yr, float* yi, long long total, int decim, int T, int hist,
                      cudaStream_t stream) {
  using S = FirShape<D>;
  const FirGeometry g = fir_geometry<D>(decim, T, hist);
  cudaError_t err = allow_smem(halo_fused_kernel<D>, g.smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((total + S::kOutputs - 1) / S::kOutputs), 1);
  halo_fused_kernel<D><<<grid, S::kThreads, g.smem, stream>>>(src, w0, dw, taps, yr, yi, total,
                                                              decim, T, hist);
  return (int)cudaGetLastError();
}

template <class Kernel>
int kernel_info(Kernel kernel, int threads, size_t smem, int* regs, int* local_bytes,
                int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

// f(std::integral_constant<int, D>{}) for the instantiation that runs `decim`.
template <class F>
int by_decim(int decim, F f) {
  switch (decim) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    default: return f(std::integral_constant<int, 0>{});
  }
}

// total outputs a channel: the grid's x extent, total / kOutputs, fits 2^31.
bool bad_shape(long long total, int decim, int T, int hist) {
  return total <= 0 || decim <= 0 || T <= 0 || hist < 0 || total > (1LL << 40);
}

}  // namespace

// K1. x [C, 2, L] f32 (L >= hist + NT*OT*decim); taps [T] (taps_stride 0) or
// [C, T] (taps_stride T) f32 on the device; yr, yi [C, NT, OT]; words0,
// dwords: HOST arrays of C u32 words, passed to the kernel by value (no copy
// to the device), in launches of up to kMaxWordChannels channels. Returns the
// first failing launch's cudaError_t (cudaErrorInvalidValue for a shape the
// kernel does not take), or 0.
extern "C" int srcdsp_mixfir(const void* x, const void* taps, int taps_stride, void* yr,
                             void* yi, const void* words0, const void* dwords, int C,
                             long long L, int NT, int OT, int decim, int T, int hist,
                             void* stream) {
  const long long total = (long long)NT * OT;
  if (C <= 0 || bad_shape(total, decim, T, hist) || L < hist + total * decim)
    return (int)cudaErrorInvalidValue;
  const uint32_t* w0 = (const uint32_t*)words0;
  const uint32_t* dw = (const uint32_t*)dwords;
  for (int c0 = 0; c0 < C; c0 += kMaxWordChannels) {
    const int n = C - c0 < kMaxWordChannels ? C - c0 : kMaxWordChannels;
    Words words{};
    for (int c = 0; c < n; ++c) {
      words.w0[c] = w0[c0 + c];
      words.dw[c] = dw[c0 + c];
    }
    const float* xg = (const float*)x + (long long)c0 * 2 * L;
    const float* tg = (const float*)taps + (long long)c0 * taps_stride;
    float* rg = (float*)yr + c0 * total;
    float* ig = (float*)yi + c0 * total;
    const int rc = by_decim(decim, [&](auto d) {
      constexpr int D = decltype(d)::value;
      return launch_mixfir<D>(xg, words, n, tg, taps_stride, rg, ig, L, total, decim, T, hist,
                              (cudaStream_t)stream);
    });
    if (rc != 0) return rc;
  }
  return 0;
}

// K20: x_hist [2, hist] and x_body [2, N] f32, each plane contiguous, plane
// strides hist_stride and body_stride; w0 is the word of stream sample 0 (the
// first history sample: word0 + (p*N - hist)*dword for shard p); yr, yi
// [NT, OT]. Launched on `device` (the shard's card); the caller's current
// device is restored on return.
extern "C" int srcdsp_halo_fused(const void* x_hist, const void* x_body, const void* taps,
                                 void* yr, void* yi, unsigned int w0, unsigned int dw,
                                 long long hist_stride, long long body_stride, int N, int NT,
                                 int OT, int decim, int T, int hist, int device, void* stream) {
  const long long total = (long long)NT * OT;
  if (bad_shape(total, decim, T, hist) || (long long)N < total * decim)
    return (int)cudaErrorInvalidValue;
  DeviceScope on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  const Split<float> src{(const float*)x_hist, (const float*)x_body, hist, N, hist_stride,
                         body_stride};
  return by_decim(decim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return launch_halo_fused<D>(src, w0, dw, (const float*)taps, (float*)yr, (float*)yi, total,
                                decim, T, hist, (cudaStream_t)stream);
  });
}

// Registers, local-memory bytes (spills) and resident blocks per SM of the K1
// (halo == 0) or K20 (halo != 0) instantiation that runs `decim`, at T taps
// and `hist`. Returns the cudaError_t, or 0.
extern "C" int srcdsp_mixfir_info(int halo, int decim, int T, int hist, int* regs,
                                  int* local_bytes, int* blocks_per_sm) {
  if (bad_shape(1, decim, T, hist)) return (int)cudaErrorInvalidValue;
  return by_decim(decim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    const size_t smem = fir_geometry<D>(decim, T, hist).smem;
    return halo ? kernel_info(halo_fused_kernel<D>, FirShape<D>::kThreads, smem, regs,
                              local_bytes, blocks_per_sm)
                : kernel_info(mixfir_kernel<D>, FirShape<D>::kThreads, smem, regs, local_bytes,
                              blocks_per_sm);
  });
}
