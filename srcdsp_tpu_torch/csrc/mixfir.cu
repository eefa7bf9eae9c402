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
// The design (fir_ring.cuh): a block owns kOutputs = threads*R consecutive
// outputs of one channel (several rows of OT: the hist overlap is staged
// once per block), stages their window mixed (stage_window<true>: each
// sample mixed once by its exact u32 word, kStageBatch loads in flight a
// thread), then each thread computes R consecutive outputs from a register
// ring per residue of the tap index mod decim (FirShape: R = 8 at decim 1
// and 2 in blocks of 128 threads, 4 at decim 4 in blocks of 256), at most 64
// registers so that 32 warps fit an SM. Every output is one fmaf chain per
// plane over a = 0..T-1, the order of the earlier one-output-per-thread
// form: K20 == K1, chunked == one launch and sharded == unsharded hold bit
// for bit, and so do K1's bits across the redesign.
//
// kernels/mixfir.py mirrors the ownership and index map (fir_*), and
// tests/test_torch_mixfir.py checks it: every output reads u[J*decim + hist
// - a], every warp's window loads hit 32 banks, the blocks tile the output.
#include "fir_ring.cuh"

using namespace srcdsp;

namespace {

constexpr int kMaxWordChannels = 32;   // channels per launch: words travel by value

struct Words {
  uint32_t w0[kMaxWordChannels];
  uint32_t dw[kMaxWordChannels];
};

// Shared memory of a K1 block: the taps, then the two window planes.
__host__ __device__ inline size_t mixfir_smem(const RingGeometry& g) {
  return (size_t)(g.tq + 2 * g.plane) * sizeof(float);
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
  const RingGeometry g = ring_geometry<S>(d, T, hist);
  float* sh = smem;
  float* sr = sh + g.tq;
  float* si = sr + g.plane;
  const long long j0 = (long long)blockIdx.x * S::kOutputs;  // the block's first output

  stage_taps(taps, T, g.tp, sh);
  stage_window<true, Src, PaddedIndex, kStageBatch>(src, c, j0 * d - g.lead, g.span, w0, dw, sr,
                                                    si, PaddedIndex{S::kLog2Stride});
  __syncthreads();

  float ar[R], ai[R];
  ring_block<S, false>(sh, nullptr, sr, si, threadIdx.x * R * d + hist + g.lead, g.tp, T, ar, ai);
  store_outputs<R>(yr, yi, j0 + (long long)threadIdx.x * R, total, ar, ai);
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
  const size_t smem = mixfir_smem(ring_geometry<S>(decim, T, hist));
  cudaError_t err = allow_smem(mixfir_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((total + S::kOutputs - 1) / S::kOutputs), channels);
  mixfir_kernel<D><<<grid, S::kThreads, smem, stream>>>(x, words, taps, taps_stride, yr, yi,
                                                          L, total, decim, T, hist);
  return (int)cudaGetLastError();
}

template <int D>
int launch_halo_fused(const Split<float>& src, uint32_t w0, uint32_t dw, const float* taps,
                      float* yr, float* yi, long long total, int decim, int T, int hist,
                      cudaStream_t stream) {
  using S = FirShape<D>;
  const size_t smem = mixfir_smem(ring_geometry<S>(decim, T, hist));
  cudaError_t err = allow_smem(halo_fused_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((total + S::kOutputs - 1) / S::kOutputs), 1);
  halo_fused_kernel<D><<<grid, S::kThreads, smem, stream>>>(src, w0, dw, taps, yr, yi, total,
                                                              decim, T, hist);
  return (int)cudaGetLastError();
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
    const size_t smem = mixfir_smem(ring_geometry<FirShape<D>>(decim, T, hist));
    return halo ? kernel_info(halo_fused_kernel<D>, FirShape<D>::kThreads, smem, regs,
                              local_bytes, blocks_per_sm)
                : kernel_info(mixfir_kernel<D>, FirShape<D>::kThreads, smem, regs, local_bytes,
                              blocks_per_sm);
  });
}
