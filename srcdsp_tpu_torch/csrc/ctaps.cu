// Complex-taps FIR + decimate with one phasor per output (K4, K5, K17).
//
// Three kernels from one template body, ctaps_kernel<D, Src>:
//  * K4, mixfir_ctaps (raw planes [2, L]), replaces
//    srcdsp_tpu/kernels/mixfir_ctaps.py make_mix_fir_ctaps_kernel (_compute);
//  * K5, ctaps_preframed (producer frames [NT, span]), replaces
//    srcdsp_tpu/kernels/mixfir_preframed.py make_ctaps_preframed_kernel
//    (_kernel). Each sample is read from the frame row deframe takes it from
//    (Frames in fsk_common.cuh), so K5 gives K4's bits on the same stream;
//  * K17, ctaps_aligned (history [2, hist] and body [2, N] as two operands,
//    the Split source), replaces srcdsp_tpu/kernels/ctaps_aligned.py
//    make_ctaps_aligned_kernel (_kernel). Launched with K4's word
//    w0 = word0 - hist*dword it reads the same stream K4 reads from the
//    concatenation, so it gives K4's bits in every column block; the caller
//    carries the history instead of prepending it, and nothing is copied.
// K4 and K5 take f32 or bf16 input (bf16 ingest: converted once at staging, taps
// and sums f32; the TPU variant rounds its packed taps to bf16 only to keep
// its matrix unit's passes homogeneous).
//
// The NCO is folded into the taps on the host, g[a] = h[a] e^{-j a dtheta}:
//   y[J] = e^{j 2 pi w(J) / 2^32} * sum_a g[a] x[J*decim + hist - a],
//   w(J) = w0 + (J*decim + hist) * dword  (mod 2^32),
// so the only per-sample work left is the complex FIR; the phasor runs once
// per output. The TPU kernel runs the FIR as banded-Toeplitz matmuls in a
// 3-matmul Gauss form and factors w(J) into column and row words with int32
// wrap; here the FIR is a direct convolution and w(J) is the exact u32 word,
// the same number.
//
// The body is the register ring of fir_ring.cuh with complex taps
// (CtapsShape: R = 8 outputs a thread in blocks of 128 at decim 1 and 2, 4 in
// blocks of 256 at decim 4): a block owns 1024 consecutive outputs of the
// [NT, OT] output (several rows), stages their window once, unmixed (bf16
// two samples a load where the host finds the planes or frames aligned:
// Paired), and each thread keeps a ring of R samples per residue of the tap
// index mod decim and plane, so a shared load feeds R outputs x 2 FMAs; gr
// and gi arrive as broadcast float4. Every output keeps the fmaf chain of the
// one-output-per-thread form this replaced, so y's bits did not move.
// kernels/mixfir_ctaps.py mirrors the ownership and index map (ctaps_*, with
// kernels/mixfir.py's ring), tests/test_torch_ctaps.py checks it.
#include "fir_ring.cuh"

using namespace srcdsp;

namespace {

// Shared memory of a block: gr, gi, then the two window planes.
__host__ __device__ inline size_t ctaps_smem(const RingGeometry& g) {
  return (size_t)(2 * g.tq + 2 * g.plane) * sizeof(float);
}

template <int D, class Src>
__global__ void __launch_bounds__(CtapsShape<D>::kThreads, CtapsShape<D>::kMinBlocks)
    ctaps_kernel(Src src, const float* __restrict__ taps_re, const float* __restrict__ taps_im,
                 float* __restrict__ yr, float* __restrict__ yi, uint32_t w0, uint32_t dw,
                 long long total, int decim, int T, int hist) {
  using S = CtapsShape<D>;
  constexpr int R = S::kR;
  extern __shared__ __align__(16) float smem[];
  const int d = D ? D : decim;
  const RingGeometry g = ring_geometry<S>(d, T, hist);
  float* hr = smem;
  float* hi = hr + g.tq;
  float* sr = hi + g.tq;
  float* si = sr + g.plane;
  const long long j0 = (long long)blockIdx.x * S::kOutputs;  // the block's first output

  stage_taps(taps_re, T, g.tp, hr);
  stage_taps(taps_im, T, g.tp, hi);
  stage_window<false, Src, PaddedIndex, kStageBatch>(src, 0, j0 * d - g.lead, g.span, 0u, 0u,
                                                     sr, si, PaddedIndex{S::kLog2Stride});
  __syncthreads();

  float ar[R], ai[R];
  ring_block<S, true>(hr, hi, sr, si, threadIdx.x * R * d + hist + g.lead, g.tp, T, ar, ai);
  const long long j = j0 + (long long)threadIdx.x * R;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    float c, s;
    phasor(w0 + (uint32_t)((j + k) * d + hist) * dw, &c, &s);
    // explicit roundings: no contraction to tell the instantiations apart
    const float vr = __fsub_rn(__fmul_rn(ar[k], c), __fmul_rn(ai[k], s));
    const float vi = __fadd_rn(__fmul_rn(ar[k], s), __fmul_rn(ai[k], c));
    ar[k] = vr;
    ai[k] = vi;
  }
  store_outputs<R>(yr, yi, j, total, ar, ai);
}

template <int D, class Src>
int launch(const Src& src, const void* taps_re, const void* taps_im, void* yr, void* yi,
           uint32_t w0, uint32_t dw, long long total, int decim, int T, int hist,
           cudaStream_t stream) {
  using S = CtapsShape<D>;
  const size_t smem = ctaps_smem(ring_geometry<S>(decim, T, hist));
  cudaError_t err = allow_smem(ctaps_kernel<D, Src>, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((total + S::kOutputs - 1) / S::kOutputs);
  ctaps_kernel<D, Src><<<blocks, S::kThreads, smem, stream>>>(
      src, (const float*)taps_re, (const float*)taps_im, (float*)yr, (float*)yi, w0, dw, total,
      decim, T, hist);
  return (int)cudaGetLastError();
}

// The instantiation that runs `decim`; cudaErrorInvalidValue for a shape the
// kernels do not take (the grid's extent, total / 1024, fits 2^31).
template <class Src>
int dispatch(const Src& src, const void* taps_re, const void* taps_im, void* yr, void* yi,
             uint32_t w0, uint32_t dw, int NT, int OT, int decim, int T, int hist,
             void* stream) {
  const long long total = (long long)NT * OT;
  if (NT <= 0 || OT <= 0 || decim <= 0 || T <= 0 || hist < 0 || total > (1LL << 40))
    return (int)cudaErrorInvalidValue;
  return by_decim(decim, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    return launch<D>(src, taps_re, taps_im, yr, yi, w0, dw, total, decim, T, hist,
                     (cudaStream_t)stream);
  });
}

}  // namespace

// K4: x [2, L] (f32, or bf16 when bf16 != 0), taps_re/taps_im f32 [T],
// w0/dw u32 words; yr, yi f32 [NT, OT].
extern "C" int srcdsp_mixfir_ctaps(const void* x, const void* taps_re,
                                   const void* taps_im, void* yr, void* yi,
                                   unsigned int w0, unsigned int dw, int L, int NT,
                                   int OT, int decim, int T, int hist, int bf16,
                                   void* stream) {
  if (bf16) {  // windows start on even samples (blocks of 1024 outputs, even lead)
    const Planes<__nv_bfloat16> src{(const __nv_bfloat16*)x, L};
    if (pairs_fit({x}, {L}))
      return dispatch(Paired<Planes<__nv_bfloat16>>{src}, taps_re, taps_im, yr, yi, w0, dw, NT,
                      OT, decim, T, hist, stream);
    return dispatch(src, taps_re, taps_im, yr, yi, w0, dw, NT, OT, decim, T, hist, stream);
  }
  return dispatch(Planes<float>{(const float*)x, L}, taps_re, taps_im, yr, yi, w0, dw, NT, OT,
                  decim, T, hist, stream);
}

// K5: frames xr_f, xi_f [NT, span] with span = OT*decim + hist; else as K4.
extern "C" int srcdsp_ctaps_preframed(const void* xr_f, const void* xi_f,
                                      const void* taps_re, const void* taps_im, void* yr,
                                      void* yi, unsigned int w0, unsigned int dw, int NT,
                                      int span, int OT, int decim, int T, int hist,
                                      int bf16, void* stream) {
  const int stride = OT * decim;
  if (bf16) {
    const Frames<__nv_bfloat16> src{(const __nv_bfloat16*)xr_f, (const __nv_bfloat16*)xi_f, NT,
                                    stride, span};
    if (pairs_fit({xr_f, xi_f}, {stride, span}))
      return dispatch(Paired<Frames<__nv_bfloat16>>{src}, taps_re, taps_im, yr, yi, w0, dw, NT,
                      OT, decim, T, hist, stream);
    return dispatch(src, taps_re, taps_im, yr, yi, w0, dw, NT, OT, decim, T, hist, stream);
  }
  return dispatch(Frames<float>{(const float*)xr_f, (const float*)xi_f, NT, stride, span},
                  taps_re, taps_im, yr, yi, w0, dw, NT, OT, decim, T, hist, stream);
}

// K17: x_hist [2, hist] and x_body [2, N] f32, each plane contiguous, plane
// strides hist_stride and body_stride; w0 is K4's word for the concatenated
// stream (word0 - hist*dword); else as K4.
extern "C" int srcdsp_ctaps_aligned(const void* x_hist, const void* x_body, const void* taps_re,
                                    const void* taps_im, void* yr, void* yi, unsigned int w0,
                                    unsigned int dw, long long hist_stride,
                                    long long body_stride, int N, int NT, int OT, int decim,
                                    int T, int hist, void* stream) {
  return dispatch(Split<float>{(const float*)x_hist, (const float*)x_body, hist, N, hist_stride,
                               body_stride},
                  taps_re, taps_im, yr, yi, w0, dw, NT, OT, decim, T, hist, stream);
}

// Registers, local-memory bytes (spills) and resident blocks per SM of the
// instantiation that runs `decim` at T taps and `hist`, over source 0 (raw
// planes, K4), 1 (frames, K5) or 2 (history and body, K17), f32 or (bf16 !=
// 0, sources 0 and 1) bf16 read in pairs. Returns the cudaError_t, or 0.
extern "C" int srcdsp_ctaps_info(int source, int bf16, int decim, int T, int hist, int* regs,
                                 int* local_bytes, int* blocks_per_sm) {
  if (decim <= 0 || T <= 0 || hist < 0 || source < 0 || source > 2 || (bf16 && source == 2))
    return (int)cudaErrorInvalidValue;
  return by_decim(decim, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    const size_t smem = ctaps_smem(ring_geometry<CtapsShape<D>>(decim, T, hist));
    constexpr int kThreads = CtapsShape<D>::kThreads;
    if (source == 2)
      return kernel_info(ctaps_kernel<D, Split<float>>, kThreads, smem, regs, local_bytes,
                         blocks_per_sm);
    if (source == 1)
      return bf16 ? kernel_info(ctaps_kernel<D, Paired<Frames<__nv_bfloat16>>>, kThreads, smem,
                                regs, local_bytes, blocks_per_sm)
                  : kernel_info(ctaps_kernel<D, Frames<float>>, kThreads, smem, regs,
                                local_bytes, blocks_per_sm);
    return bf16 ? kernel_info(ctaps_kernel<D, Paired<Planes<__nv_bfloat16>>>, kThreads, smem,
                              regs, local_bytes, blocks_per_sm)
                : kernel_info(ctaps_kernel<D, Planes<float>>, kThreads, smem, regs,
                              local_bytes, blocks_per_sm);
  });
}
