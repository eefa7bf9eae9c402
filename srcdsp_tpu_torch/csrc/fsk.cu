// Fused FSK front end: mix + FIR + decimate -> discriminator -> O&M sums.
//
// Kernels from one template body, fsk_kernel<CTAPS, D, Src>:
//  * K2, fsk_fused (CTAPS = false, raw f32 planes), replaces
//    srcdsp_tpu/kernels/fsk_fused.py make_fsk_mc_kernel (_compute): runtime
//    u32 phase words, real taps. Its FIR is K1's: the ring of fir_ring.cuh
//    over a window staged mixed (stage_window<true>), FirShape, the same
//    words and the same fmaf chain.
//  * K3, fsk_ctaps (CTAPS = true, raw planes, f32 or bf16), replaces
//    srcdsp_tpu/kernels/fsk_ctaps.py make_fsk_ctaps_kernel (_compute, both
//    in_dtype): per-channel complex taps g = h * e^{-j a dtheta} built on the
//    host, no phasor at all, and the mix restored as d += deltas[c] with a
//    wrap into (-0.5, 0.5]. Its FIR is ctaps.cu's complex ring (FskCtapsShape).
//  * K7, fsk_preframed (CTAPS = true, producer frames [C, NT, span], f32 or
//    bf16), replaces srcdsp_tpu/kernels/fsk_preframed.py
//    make_fsk_preframed_kernel (_kernel). Only the window source differs
//    from K3, so K7 gives K3's bits on the same stream.
//
// Ownership. A block (blockIdx.y = channel) owns rows_b = max(1, kOutputs /
// OT) whole rows of OT outputs, so that each row's O&M sums come from one
// block; it runs them in tiles of kOutputs = threads*R outputs (one tile
// unless OT > kOutputs). Per tile it stages the window once, each thread
// computes R consecutive outputs from the register ring, and the
// discriminator needs y[J-1] for every output J: inside a thread it is the
// previous register, across threads it goes through shared memory (each
// thread's last output), and for the tile's first output thread 0 computes
// output J-1 itself, the same fmaf chain over taps 0..T-1 (chain_output).
// The TPU kernels carry the last filtered sample of a row to the next grid
// step in SMEM, which relies on the grid running in order; GPU blocks do not.
// The per-call seam stays as the TPU kernels define it: output 0 of each
// channel has a previous sample at rest, so d = 0 there (and K3/K7 add no
// delta there; atan2f(+-0, -0) would be +-pi).
//
// The discriminator is atan2f (the TPU kernel's polynomial _atan2 exists only
// because the TPU lowering lacks atan2). class_major is a store-index
// permutation, lane = (j % sps) * (OT / sps) + j / sps, which is exact. The
// O&M terms (st column 0: d^2 cos(2 pi (J mod sps)/sps), column 1: the same
// with -sin; J is the call-local output index) take cosf and sinf from a
// per-block table of the sps values, computed by the same calls; each row's
// terms are summed by one warp in a fixed order (lane l takes the row's
// outputs l, l + 32, ..., then a butterfly), tiles in order, so st is
// deterministic.
//
// bf16 ingest converts each sample to f32 once, at staging (two samples a
// load where the host finds them aligned: Paired); taps stay f32 (the TPU
// variant rounds its packed taps to bf16 only to keep its matrix unit's
// passes homogeneous).
//
// Registers: every instantiation keeps 4 blocks an SM within 64 registers
// and spills nothing. For that the ring's geometry comes from the host as a
// parameter, and K2, bf16 and the generic instantiation stage half the
// batch of samples in flight (bench_torch/ab_ctaps.py measures the rest).
//
// kernels/fsk_fused.py mirrors the ownership and index map (fsk_*), and
// tests/test_torch_fsk_kernels.py checks it.
#include "fir_ring.cuh"

using namespace srcdsp;

namespace {

constexpr int kPad = 128;  // columns of the O&M partial-sum output st

// K3 and K7: the complex ring at 4 outputs a thread in blocks of 256 (at 8
// outputs and 64 registers the ring spills). K2: K1's ring and shape.
template <int D>
using FskCtapsShape = RingShape<D, 4, 256>;
template <bool CTAPS, int D>
using FskShape = std::conditional_t<CTAPS, FskCtapsShape<D>, FirShape<D>>;

// K2's predecessor chain as a call: inlined, its registers make the decim-4
// body (256 threads, 64 registers) spill.
__device__ __noinline__ void real_chain_call(const float* hr, const float* sr, const float* si,
                                             int e, int T, int log2s, float* yr, float* yi) {
  chain_output<false>(hr, nullptr, sr, si, e, T, log2s, yr, yi);
}

template <class S>
__host__ __device__ inline int fsk_rows(int OT) {
  return OT < S::kOutputs ? S::kOutputs / OT : 1;
}

// Shared memory of a block: the taps (1 or 2 planes), the window planes, the
// last output of each thread (and output -1 in slot 0), the O&M table and
// the row sums.
template <bool CTAPS, class S>
__host__ __device__ inline size_t fsk_smem(const RingGeometry& g, int OT, int sps) {
  return (size_t)((CTAPS ? 2 : 1) * g.tq + 2 * g.plane + 2 * (S::kThreads + 1) + 2 * sps +
                  2 * fsk_rows<S>(OT)) *
         sizeof(float);
}

template <bool CTAPS, int D, class Src>
__global__ void __launch_bounds__(FskShape<CTAPS, D>::kThreads, FskShape<CTAPS, D>::kMinBlocks)
    fsk_kernel(Src src, const int32_t* __restrict__ words0, const int32_t* __restrict__ dwords,
               const float* __restrict__ taps_re, const float* __restrict__ taps_im,
               const float* __restrict__ deltas, float* __restrict__ d, float* __restrict__ st,
               int NT, int OT, int decim, int T, int hist, int sps, int class_major,
               RingGeometry g, int rows_b) {
  using S = FskShape<CTAPS, D>;
  constexpr int R = S::kR, L2S = S::kLog2Stride, kWarps = S::kThreads / 32;
  extern __shared__ __align__(16) float smem[];
  const int dm = D ? D : decim;
  const int c = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* hr = smem;
  float* hi = hr + g.tq;                 // complex taps only
  float* sr = hi + (CTAPS ? g.tq : 0);
  float* si = sr + g.plane;
  float* lr = si + g.plane;              // [threads + 1]: slot t + 1 = thread t's last output
  float* li = lr + S::kThreads + 1;
  float* tab_c = li + S::kThreads + 1;   // [sps]
  float* tab_s = tab_c + sps;
  float* sum_c = tab_s + sps;            // [rows_b]
  float* sum_s = sum_c + rows_b;

  stage_taps(taps_re + (CTAPS ? (long long)c * T : 0), T, g.tp, hr);
  if constexpr (CTAPS) stage_taps(taps_im + (long long)c * T, T, g.tp, hi);
  const float tone_step = (float)(6.283185307179586 / sps);
  for (int k = tid; k < sps; k += S::kThreads) {
    const float ang = (float)k * tone_step;
    tab_c[k] = cosf(ang);
    tab_s[k] = -sinf(ang);
  }
  for (int k = tid; k < rows_b; k += S::kThreads) sum_c[k] = sum_s[k] = 0.f;

  // what stays live across the ring is the loop's state alone: the rest is
  // read or computed where it is used (64 registers hold the ring)
  const int r0 = blockIdx.x * rows_b;                 // the block's first row
  const int rows = NT - r0 < rows_b ? NT - r0 : rows_b;
  const int bo = rows * OT;                           // the block's outputs
  for (int t0 = 0; t0 < bo; t0 += S::kOutputs) {
    const long long J0 = (long long)r0 * OT;          // channel-local index of its first
    const uint32_t w0 = CTAPS ? 0u : (uint32_t)words0[c];
    const uint32_t dw = CTAPS ? 0u : (uint32_t)dwords[c];
    // K2 (a phasor a sample), bf16 and the generic instantiation stage half
    // the batch: 64 registers hold no more beside the loop's state
    constexpr int kBatch = CTAPS && D && Src::kBytes == 4 ? kStageBatch : kStageBatch / 2;
    stage_window<!CTAPS, Src, PaddedIndex, kBatch>(
        src, c, (J0 + t0) * dm - g.lead, g.span, w0, dw, sr, si, PaddedIndex{L2S});
    __syncthreads();
    // output J-1 of the tile's first: a serial chain, begun before the ring
    // so that the other warps' rings hide its latency
    if (tid == 0) {
      if constexpr (CTAPS)
        chain_output<true>(hr, hi, sr, si, hist + g.lead - dm, T, L2S, lr, li);
      else
        real_chain_call(hr, sr, si, hist + g.lead - dm, T, L2S, lr, li);
    }
    float ar[R], ai[R];
    ring_block<S, CTAPS>(hr, hi, sr, si, tid * R * dm + hist + g.lead, g.tp, T, ar, ai);
    lr[tid + 1] = ar[R - 1];
    li[tid + 1] = ai[R - 1];
    __syncthreads();  // the window is free: its planes take the O&M terms

    const float delta = CTAPS ? deltas[c] : 0.f;
    const float inv_two_pi = 0.15915494309189535f;
    const int spr = OT / sps;                         // symbols a row
    float* drow = d + ((long long)c * NT + r0) * OT;
    const int l0 = t0 + tid * R;  // block-local index of the thread's output 0
    int row = l0 / OT, col = l0 - row * OT;
    int ph = col % sps, q = col / sps;  // J % sps == col % sps: OT % sps == 0
    float pr = lr[tid], pi = li[tid];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float yr = ar[k], yi = ai[k];
      const float zr = yr * pr + yi * pi;  // y[J] * conj(y[J-1])
      const float zi = yi * pr - yr * pi;
      float dv = 0.f;                      // the per-call seam: prev at rest
      if (J0 + l0 + k > 0) {
        dv = atan2f(zi, zr) * inv_two_pi;
        if (CTAPS) {
          dv += delta;
          if (dv > 0.5f) dv -= 1.f;
        }
      }
      const float m = dv * dv;
      sr[tid * R + k] = m * tab_c[ph];
      si[tid * R + k] = m * tab_s[ph];
      if (l0 + k < bo) drow[(long long)row * OT + (class_major ? ph * spr + q : col)] = dv;
      pr = yr;
      pi = yi;
      if (++ph == sps) {
        ph = 0;
        ++q;
      }
      if (++col == OT) {
        col = ph = q = 0;
        ++row;
      }
    }
    __syncthreads();

    // each row of the tile: one warp, lane l takes outputs l, l + 32, ...
    const int tn = bo - t0 < S::kOutputs ? bo - t0 : S::kOutputs;
    for (int rr = t0 / OT + warp; rr <= (t0 + tn - 1) / OT; rr += kWarps) {
      const int lo = rr * OT - t0 > 0 ? rr * OT - t0 : 0;
      const int end = (rr + 1) * OT - t0 < tn ? (rr + 1) * OT - t0 : tn;
      float sc = 0.f, ss = 0.f;
      for (int i = lo + lane; i < end; i += 32) {
        sc += sr[i];
        ss += si[i];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sc += __shfl_xor_sync(0xffffffffu, sc, o);
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
      }
      if (lane == 0) {
        sum_c[rr] += sc;
        sum_s[rr] += ss;
      }
    }
    __syncthreads();
  }

  float* strow = st + ((long long)c * NT + r0) * kPad;
  for (int i = tid; i < rows * kPad; i += S::kThreads) {
    const int rr = i / kPad, k = i - rr * kPad;
    strow[i] = k == 0 ? sum_c[rr] : (k == 1 ? sum_s[rr] : 0.f);
  }
}

template <bool CTAPS, int D, class Src>
int launch(const Src& src, const void* words0, const void* dwords, const void* taps_re,
           const void* taps_im, const void* deltas, void* d, void* st, int C, int NT, int OT,
           int decim, int T, int hist, int sps, int class_major, cudaStream_t stream) {
  using S = FskShape<CTAPS, D>;
  // the geometry travels as a parameter, in the constant bank: computed in
  // the kernel it takes registers that the ring needs
  const RingGeometry g = ring_geometry<S>(decim, T, hist, decim);
  const size_t smem = fsk_smem<CTAPS, S>(g, OT, sps);
  cudaError_t err = allow_smem(fsk_kernel<CTAPS, D, Src>, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows_b = fsk_rows<S>(OT);
  const dim3 grid((unsigned)((NT + rows_b - 1) / rows_b), (unsigned)C);
  fsk_kernel<CTAPS, D, Src><<<grid, S::kThreads, smem, stream>>>(
      src, (const int32_t*)words0, (const int32_t*)dwords, (const float*)taps_re,
      (const float*)taps_im, (const float*)deltas, (float*)d, (float*)st, NT, OT, decim, T, hist,
      sps, class_major, g, rows_b);
  return (int)cudaGetLastError();
}

// The instantiation that runs `decim`; cudaErrorInvalidValue for a shape the
// kernels do not take (OT a multiple of sps, NT*OT outputs a channel below 2^31).
template <bool CTAPS, class Src>
int dispatch(const Src& src, const void* words0, const void* dwords, const void* taps_re,
             const void* taps_im, const void* deltas, void* d, void* st, int C, int NT, int OT,
             int decim, int T, int hist, int sps, int class_major, void* stream) {
  if (C <= 0 || NT <= 0 || OT <= 0 || decim <= 0 || T <= 0 || hist < 0 || sps <= 0 ||
      OT % sps != 0 || C > 65535 || (long long)NT * OT >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  return by_decim(decim, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    return launch<CTAPS, D>(src, words0, dwords, taps_re, taps_im, deltas, d, st, C, NT, OT,
                            decim, T, hist, sps, class_major, (cudaStream_t)stream);
  });
}

}  // namespace

// K2: x [C, 2, L] f32, words0/dwords i32 [C] (u32 bits), taps f32 [T] shared.
extern "C" int srcdsp_fsk_fused(const void* x, const void* words0, const void* dwords,
                                const void* taps, void* d, void* st, int C, int L, int NT,
                                int OT, int decim, int T, int hist, int sps,
                                int class_major, void* stream) {
  return dispatch<false>(Planes<float>{(const float*)x, L}, words0, dwords, taps, nullptr,
                         nullptr, d, st, C, NT, OT, decim, T, hist, sps, class_major, stream);
}

// K3: x [C, 2, L] (f32, or bf16 when bf16 != 0), taps_re/taps_im f32 [C, T],
// deltas f32 [C].
extern "C" int srcdsp_fsk_ctaps(const void* x, const void* taps_re, const void* taps_im,
                                const void* deltas, void* d, void* st, int C, int L,
                                int NT, int OT, int decim, int T, int hist, int sps,
                                int class_major, int bf16, void* stream) {
  if (bf16) {  // windows start on even samples when OT*decim is even
    const Planes<__nv_bfloat16> src{(const __nv_bfloat16*)x, L};
    if (pairs_fit({x}, {L, (long long)OT * decim}))
      return dispatch<true>(Paired<Planes<__nv_bfloat16>>{src}, nullptr, nullptr, taps_re,
                            taps_im, deltas, d, st, C, NT, OT, decim, T, hist, sps, class_major,
                            stream);
    return dispatch<true>(src, nullptr, nullptr, taps_re, taps_im, deltas, d, st, C, NT, OT,
                          decim, T, hist, sps, class_major, stream);
  }
  return dispatch<true>(Planes<float>{(const float*)x, L}, nullptr, nullptr, taps_re,
                        taps_im, deltas, d, st, C, NT, OT, decim, T, hist, sps,
                        class_major, stream);
}

// K7: frames xr_f, xi_f [C, NT, span] (f32, or bf16 when bf16 != 0) with
// span = OT*decim + hist; taps and deltas as K3.
extern "C" int srcdsp_fsk_preframed(const void* xr_f, const void* xi_f,
                                    const void* taps_re, const void* taps_im,
                                    const void* deltas, void* d, void* st, int C, int NT,
                                    int span, int OT, int decim, int T, int hist, int sps,
                                    int class_major, int bf16, void* stream) {
  const int stride = OT * decim;
  if (bf16) {
    const Frames<__nv_bfloat16> src{(const __nv_bfloat16*)xr_f, (const __nv_bfloat16*)xi_f, NT,
                                    stride, span};
    if (pairs_fit({xr_f, xi_f}, {stride, span}))
      return dispatch<true>(Paired<Frames<__nv_bfloat16>>{src}, nullptr, nullptr, taps_re,
                            taps_im, deltas, d, st, C, NT, OT, decim, T, hist, sps, class_major,
                            stream);
    return dispatch<true>(src, nullptr, nullptr, taps_re, taps_im, deltas, d, st, C, NT, OT,
                          decim, T, hist, sps, class_major, stream);
  }
  return dispatch<true>(Frames<float>{(const float*)xr_f, (const float*)xi_f, NT, stride,
                                      span},
                        nullptr, nullptr, taps_re, taps_im, deltas, d, st, C, NT, OT, decim,
                        T, hist, sps, class_major, stream);
}

// Registers, local-memory bytes (spills) and resident blocks per SM of the
// instantiation that runs `decim` at T taps, `hist`, OT and sps: kernel 0 is
// K2 (f32), 1 K3 and 2 K7 (f32, or bf16 read in pairs when bf16 != 0).
// Returns the cudaError_t, or 0.
extern "C" int srcdsp_fsk_info(int kernel, int bf16, int decim, int T, int hist, int OT,
                               int sps, int* regs, int* local_bytes, int* blocks_per_sm) {
  if (decim <= 0 || T <= 0 || hist < 0 || OT <= 0 || sps <= 0 || kernel < 0 || kernel > 2 ||
      (bf16 && kernel == 0))
    return (int)cudaErrorInvalidValue;
  return by_decim(decim, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    if (kernel == 0) {
      using S = FskShape<false, D>;
      const size_t smem = fsk_smem<false, S>(ring_geometry<S>(decim, T, hist, decim), OT, sps);
      return kernel_info(fsk_kernel<false, D, Planes<float>>, S::kThreads, smem, regs,
                         local_bytes, blocks_per_sm);
    }
    using S = FskShape<true, D>;
    const size_t smem = fsk_smem<true, S>(ring_geometry<S>(decim, T, hist, decim), OT, sps);
    if (kernel == 2)
      return bf16 ? kernel_info(fsk_kernel<true, D, Paired<Frames<__nv_bfloat16>>>, S::kThreads,
                                smem, regs, local_bytes, blocks_per_sm)
                  : kernel_info(fsk_kernel<true, D, Frames<float>>, S::kThreads, smem, regs,
                                local_bytes, blocks_per_sm);
    return bf16 ? kernel_info(fsk_kernel<true, D, Paired<Planes<__nv_bfloat16>>>, S::kThreads,
                              smem, regs, local_bytes, blocks_per_sm)
                : kernel_info(fsk_kernel<true, D, Planes<float>>, S::kThreads, smem, regs,
                              local_bytes, blocks_per_sm);
  });
}
