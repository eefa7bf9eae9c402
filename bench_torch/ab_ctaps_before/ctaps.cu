// Complex-taps FIR + decimate with one phasor per output (K4, K5, K17).
//
// Three kernels from one template body, ctaps_kernel<Src>:
//  * K4, mixfir_ctaps (raw planes [2, L]), replaces
//    srcdsp_tpu/kernels/mixfir_ctaps.py make_mix_fir_ctaps_kernel (_compute);
//  * K5, ctaps_preframed (producer frames [NT, span]), replaces
//    srcdsp_tpu/kernels/mixfir_preframed.py make_ctaps_preframed_kernel
//    (_kernel). Row r's window is exactly frame row r, so K5 gives K4's bits
//    on the same stream;
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
// wrap; here the FIR is a direct convolution from shared memory and w(J) is
// the exact u32 word, the same number.
//
// One block per output row of OT outputs: it stages the row's OT*decim + hist
// input samples, then each thread convolves T complex taps for its outputs
// (four FMAs per tap). What bounds it is as mixfir.cu: shared-memory loads in
// the tap loop, not device-memory bytes.
#include "fsk_common.cuh"

using namespace srcdsp;

template <class Src>
__global__ void ctaps_kernel(Src src, const float* __restrict__ taps_re,
                             const float* __restrict__ taps_im, float* __restrict__ yr,
                             float* __restrict__ yi, uint32_t w0, uint32_t dw, int OT,
                             int decim, int T, int hist) {
  extern __shared__ float smem[];
  const int r = blockIdx.x;
  const int span = OT * decim + hist;
  float* sr = smem;
  float* si = sr + span;
  float* hr = si + span;
  float* hi = hr + T;
  for (int a = threadIdx.x; a < T; a += blockDim.x) {
    hr[a] = taps_re[a];
    hi[a] = taps_im[a];
  }
  stage_window<false>(src, 0, r, (long long)r * OT * decim, span, 0u, 0u, sr, si);
  __syncthreads();

  const long long out = (long long)r * OT;
  for (int j = threadIdx.x; j < OT; j += blockDim.x) {
    float ar, ai;
    ctaps_dot(sr, si, hr, hi, j * decim + hist, T, &ar, &ai);
    float c, s;
    phasor(w0 + (uint32_t)((out + j) * decim + hist) * dw, &c, &s);
    // explicit roundings: no contraction to tell the instantiations apart
    yr[out + j] = __fsub_rn(__fmul_rn(ar, c), __fmul_rn(ai, s));
    yi[out + j] = __fadd_rn(__fmul_rn(ar, s), __fmul_rn(ai, c));
  }
}

template <class Src>
static int launch(Src src, const void* taps_re, const void* taps_im, void* yr, void* yi,
                  unsigned int w0, unsigned int dw, int NT, int OT, int decim, int T,
                  int hist, void* stream) {
  const size_t smem = (size_t)(2 * (OT * decim + hist) + 2 * T) * sizeof(float);
  cudaError_t err = allow_smem(ctaps_kernel<Src>, smem);
  if (err != cudaSuccess) return (int)err;
  ctaps_kernel<Src><<<NT, kThreads, smem, (cudaStream_t)stream>>>(
      src, (const float*)taps_re, (const float*)taps_im, (float*)yr, (float*)yi, w0, dw,
      OT, decim, T, hist);
  return (int)cudaGetLastError();
}

// K4: x [2, L] (f32, or bf16 when bf16 != 0), taps_re/taps_im f32 [T],
// w0/dw u32 words; yr, yi f32 [NT, OT].
extern "C" int srcdsp_mixfir_ctaps(const void* x, const void* taps_re,
                                   const void* taps_im, void* yr, void* yi,
                                   unsigned int w0, unsigned int dw, int L, int NT,
                                   int OT, int decim, int T, int hist, int bf16,
                                   void* stream) {
  if (bf16)
    return launch(Planes<__nv_bfloat16>{(const __nv_bfloat16*)x, L}, taps_re, taps_im,
                  yr, yi, w0, dw, NT, OT, decim, T, hist, stream);
  return launch(Planes<float>{(const float*)x, L}, taps_re, taps_im, yr, yi, w0, dw, NT,
                OT, decim, T, hist, stream);
}

// K5: frames xr_f, xi_f [NT, span] with span = OT*decim + hist; else as K4.
extern "C" int srcdsp_ctaps_preframed(const void* xr_f, const void* xi_f,
                                      const void* taps_re, const void* taps_im, void* yr,
                                      void* yi, unsigned int w0, unsigned int dw, int NT,
                                      int span, int OT, int decim, int T, int hist,
                                      int bf16, void* stream) {
  const int stride = OT * decim;
  if (bf16)
    return launch(Frames<__nv_bfloat16>{(const __nv_bfloat16*)xr_f,
                                        (const __nv_bfloat16*)xi_f, NT, stride, span},
                  taps_re, taps_im, yr, yi, w0, dw, NT, OT, decim, T, hist, stream);
  return launch(Frames<float>{(const float*)xr_f, (const float*)xi_f, NT, stride, span},
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
  return launch(Split<float>{(const float*)x_hist, (const float*)x_body, hist, N, hist_stride,
                             body_stride},
                taps_re, taps_im, yr, yi, w0, dw, NT, OT, decim, T, hist, stream);
}
