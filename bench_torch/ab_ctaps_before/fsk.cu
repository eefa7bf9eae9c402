// Fused FSK front end: mix + FIR + decimate -> discriminator -> O&M sums.
//
// Kernels from one template body, fsk_kernel<CTAPS, Src>:
//  * K2, fsk_fused (CTAPS = false, raw f32 planes), replaces
//    srcdsp_tpu/kernels/fsk_fused.py make_fsk_mc_kernel (_compute): runtime
//    u32 phase words, real taps.
//  * K3, fsk_ctaps (CTAPS = true, raw planes, f32 or bf16), replaces
//    srcdsp_tpu/kernels/fsk_ctaps.py make_fsk_ctaps_kernel (_compute, both
//    in_dtype): per-channel complex taps g = h * e^{-j a dtheta} built on the
//    host, no phasor at all, and the mix restored as d += deltas[c] with a
//    wrap into (-0.5, 0.5].
//  * K7, fsk_preframed (CTAPS = true, producer frames [C, NT, span], f32 or
//    bf16), replaces srcdsp_tpu/kernels/fsk_preframed.py
//    make_fsk_preframed_kernel (_kernel). Only the window source differs
//    from K3, so K7 gives K3's bits on the same stream.
//
// One block per (output row of OT outputs, channel), as in mixfir.cu. The TPU
// kernels carry the last filtered sample of a row to the next grid step in
// SMEM, which relies on the grid running in order; GPU blocks do not, so each
// block also computes output J-1, one output left of its row (T extra MACs).
// Over frames, the samples of output J-1 come from the previous frame row
// (Frames in fsk_common.cuh). The per-call seam stays as the TPU kernels
// define it: output 0 of each channel has a previous sample at rest, so d = 0
// there (and K3/K7 add no delta there).
//
// The discriminator is atan2f (the TPU kernel's polynomial _atan2 exists only
// because the TPU lowering lacks atan2). class_major is a store-index
// permutation, lane = (j % sps) * (OT / sps) + j / sps, which is exact. The
// O&M partial sums of a row (st column 0: sum d^2 cos(2 pi (J mod sps)/sps),
// column 1: the same with -sin; J is the call-local output index) are a
// fixed-order shared-memory tree sum, so they are deterministic.
//
// bf16 ingest converts each sample to f32 once, at staging; taps stay f32
// (the TPU variant rounds its packed taps to bf16 only to keep its matrix
// unit's passes homogeneous).
//
// What bounds it: as mixfir.cu, shared-memory loads in the tap loop (K3 does
// four FMAs per tap for the complex product); the discriminator adds one
// atan2f and one sincos per output, at 1/decim of the input rate.
#include "fsk_common.cuh"

using namespace srcdsp;

template <bool CTAPS, class Src>
__global__ void fsk_kernel(Src src, const int32_t* __restrict__ words0,
                           const int32_t* __restrict__ dwords,
                           const float* __restrict__ taps_re,
                           const float* __restrict__ taps_im,
                           const float* __restrict__ deltas,
                           float* __restrict__ d, float* __restrict__ st,
                           int NT, int OT, int decim, int T, int hist, int sps,
                           int class_major) {
  extern __shared__ float smem[];
  const int r = blockIdx.x;
  const int c = blockIdx.y;
  // the window starts `decim` samples left of the row, for output J-1
  const int win = OT * decim + hist + decim;
  float* sr = smem;
  float* si = sr + win;
  float* hr = si + win;
  float* hi = hr + T;                  // used by CTAPS only
  float* ur = hi + (CTAPS ? T : 0);    // outputs J-1 .. J+OT-1 of the row
  float* ui = ur + OT + 1;
  float* red = ui + OT + 1;

  const float* tr = taps_re + (CTAPS ? (long long)c * T : 0);
  for (int a = threadIdx.x; a < T; a += blockDim.x) {
    hr[a] = tr[a];
    if (CTAPS) hi[a] = taps_im[(long long)c * T + a];
  }
  const uint32_t w0 = CTAPS ? 0u : (uint32_t)words0[c];
  const uint32_t dw = CTAPS ? 0u : (uint32_t)dwords[c];
  stage_window<!CTAPS>(src, c, r, (long long)r * OT * decim - decim, win, w0, dw, sr, si);
  __syncthreads();

  for (int q = threadIdx.x; q <= OT; q += blockDim.x) {
    const int e = q * decim + hist;  // window index of output (q - 1)'s newest sample
    float ar = 0.f, ai = 0.f;
    if (CTAPS) {
      ctaps_dot(sr, si, hr, hi, e, T, &ar, &ai);
    } else {
      for (int a = 0; a < T; ++a) {
        const float h = hr[a];
        ar = fmaf(h, sr[e - a], ar);
        ai = fmaf(h, si[e - a], ai);
      }
    }
    ur[q] = ar;
    ui[q] = ai;
  }
  __syncthreads();

  const float inv_two_pi = 0.15915494309189535f;
  const float tone_step = (float)(6.283185307179586 / sps);
  const float delta = CTAPS ? deltas[c] : 0.f;
  const long long row0 = (long long)r * OT;
  float* drow = d + ((long long)c * NT + r) * OT;
  float pc = 0.f, ps = 0.f;
  for (int j = threadIdx.x; j < OT; j += blockDim.x) {
    const float yr = ur[j + 1], yi = ui[j + 1];
    const float pr = ur[j], pi = ui[j];
    const float zr = yr * pr + yi * pi;  // y[J] * conj(y[J-1])
    const float zi = yi * pr - yr * pi;
    const long long g = row0 + j;
    float dv = 0.f;                      // the per-call seam: prev at rest
    if (g > 0) {
      dv = atan2f(zi, zr) * inv_two_pi;
      if (CTAPS) {
        dv += delta;
        if (dv > 0.5f) dv -= 1.f;
      }
    }
    const float ang = (float)(int)(g % sps) * tone_step;
    const float m = dv * dv;
    pc += m * cosf(ang);
    ps += m * -sinf(ang);
    drow[class_major ? (j % sps) * (OT / sps) + j / sps : j] = dv;
  }
  const float sc = block_sum(pc, red);
  const float ss = block_sum(ps, red);
  float* strow = st + ((long long)c * NT + r) * kPad;
  for (int k = threadIdx.x; k < kPad; k += blockDim.x)
    strow[k] = k == 0 ? sc : (k == 1 ? ss : 0.f);
}

template <bool CTAPS, class Src>
static int launch(Src src, const void* words0, const void* dwords, const void* taps_re,
                  const void* taps_im, const void* deltas, void* d, void* st, int C,
                  int NT, int OT, int decim, int T, int hist, int sps, int class_major,
                  void* stream) {
  const int win = OT * decim + hist + decim;
  const size_t smem =
      (size_t)(2 * win + (CTAPS ? 2 : 1) * T + 2 * (OT + 1) + kThreads) * sizeof(float);
  cudaError_t err = allow_smem(fsk_kernel<CTAPS, Src>, smem);
  if (err != cudaSuccess) return (int)err;
  fsk_kernel<CTAPS, Src><<<dim3(NT, C), kThreads, smem, (cudaStream_t)stream>>>(
      src, (const int32_t*)words0, (const int32_t*)dwords, (const float*)taps_re,
      (const float*)taps_im, (const float*)deltas, (float*)d, (float*)st, NT, OT, decim,
      T, hist, sps, class_major);
  return (int)cudaGetLastError();
}

// K2: x [C, 2, L] f32, words0/dwords i32 [C] (u32 bits), taps f32 [T] shared.
extern "C" int srcdsp_fsk_fused(const void* x, const void* words0, const void* dwords,
                                const void* taps, void* d, void* st, int C, int L, int NT,
                                int OT, int decim, int T, int hist, int sps,
                                int class_major, void* stream) {
  return launch<false>(Planes<float>{(const float*)x, L}, words0, dwords, taps, nullptr,
                       nullptr, d, st, C, NT, OT, decim, T, hist, sps, class_major,
                       stream);
}

// K3: x [C, 2, L] (f32, or bf16 when bf16 != 0), taps_re/taps_im f32 [C, T],
// deltas f32 [C].
extern "C" int srcdsp_fsk_ctaps(const void* x, const void* taps_re, const void* taps_im,
                                const void* deltas, void* d, void* st, int C, int L,
                                int NT, int OT, int decim, int T, int hist, int sps,
                                int class_major, int bf16, void* stream) {
  if (bf16)
    return launch<true>(Planes<__nv_bfloat16>{(const __nv_bfloat16*)x, L}, nullptr,
                        nullptr, taps_re, taps_im, deltas, d, st, C, NT, OT, decim, T,
                        hist, sps, class_major, stream);
  return launch<true>(Planes<float>{(const float*)x, L}, nullptr, nullptr, taps_re,
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
  if (bf16)
    return launch<true>(Frames<__nv_bfloat16>{(const __nv_bfloat16*)xr_f,
                                              (const __nv_bfloat16*)xi_f, NT, stride, span},
                        nullptr, nullptr, taps_re, taps_im, deltas, d, st, C, NT, OT,
                        decim, T, hist, sps, class_major, stream);
  return launch<true>(Frames<float>{(const float*)xr_f, (const float*)xi_f, NT, stride,
                                    span},
                      nullptr, nullptr, taps_re, taps_im, deltas, d, st, C, NT, OT, decim,
                      T, hist, sps, class_major, stream);
}
