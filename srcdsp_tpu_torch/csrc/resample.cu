// Fused NCO mix + rational L/M resampler (K8, K9).
//
// Two kernels from one template body, resample_kernel<Src>:
//  * K8, mix_resample (raw planes [C, 2, L]), replaces
//    srcdsp_tpu/kernels/resample_pallas.py make_mix_resample_kernel and
//    make_mix_resample_kernel_mc (both through mixfir._compute);
//  * K9, resample_preframed (producer frames [NT, span], f32 or bf16),
//    replaces srcdsp_tpu/kernels/resample_preframed.py
//    make_resample_preframed_kernel (_kernel). Row r's window is exactly frame
//    row r, so K9 gives K8's bits on the same stream.
//
// The TPU kernels run the resampler as a stride-L banded Toeplitz matmul,
// H[a, j] = h[j*M + hist*L - a*L], whose band is mostly structural zeros; K9
// also folds the NCO into complex bands to keep the per-sample mix off the TPU
// vector unit. Here the sum is polyphase. For output j of a row whose window
// starts at stream sample r*OT*M/L,
//   e = j*M + hist*L,  phi = e mod L,  top = floor(e / L),
//   y = sum_{q < Q} h[phi + q*L] * m[top - q],   Q = ceil(T / L),
// with the window index top - q >= 0 for every q because hist >= ceil((T-1)/L).
// The taps come regrouped by phase ([L, Q], zero past the end of h), so the
// dot reads them in order, and the mixed window m is staged once per row:
// each sample times the phasor of its exact u32 word w0 + g*dw (g counted from
// the first history sample), one sincospif per staged sample, no fold. The
// window-relative e stays small; it is formed in 64-bit all the same.
//
// One block per (output row, channel). What bounds it: at the config-2
// combined taps (T = 429, L/M = 3/4) an output costs 143 taps x 4 flop, and an
// input sample (8 bytes in, 0.75 outputs = 6 bytes out) 429 flop: about 31
// flop per byte, above the H100's 67 TFLOP/s / 3.35 TB/s = 20, so f32
// arithmetic bounds it. This simple form does not reach that roof: every FMA pair issues
// a tap load and two window loads from shared memory, and those loads set its
// time, as in the other staged-window kernels (mixfir.cu, ctaps.cu).
#include "fsk_common.cuh"

using namespace srcdsp;

namespace {

constexpr int kResampleThreads = 128;
constexpr int kMaxWordChannels = 32;  // channels per launch: words travel by value

struct Words {
  uint32_t w0[kMaxWordChannels];
  uint32_t dw[kMaxWordChannels];
};

template <class Src>
__global__ void __launch_bounds__(kResampleThreads)
    resample_kernel(Src src, Words words, const float* __restrict__ taps_ph,
                    float* __restrict__ yr, float* __restrict__ yi, int NT, int OT, int up,
                    int down, int Q, int hist) {
  extern __shared__ float smem[];
  const int r = blockIdx.x;
  const int c = blockIdx.y;
  const int row_stride = (OT * down) / up;
  const int span = row_stride + hist;
  float* sr = smem;
  float* si = sr + span;
  float* sh = si + span;

  for (int k = threadIdx.x; k < up * Q; k += blockDim.x) sh[k] = taps_ph[k];
  stage_window<true>(src, c, r, (long long)r * row_stride, span, words.w0[c], words.dw[c],
                     sr, si);
  __syncthreads();

  const long long out = ((long long)c * NT + r) * OT;
  for (int j = threadIdx.x; j < OT; j += blockDim.x) {
    const long long e = (long long)j * down + (long long)hist * up;
    const float* h = sh + (int)(e % up) * Q;
    const int top = (int)(e / up);
    float ar = 0.f, ai = 0.f;
    for (int q = 0; q < Q; ++q) {
      const float hq = h[q];
      ar = fmaf(hq, sr[top - q], ar);
      ai = fmaf(hq, si[top - q], ai);
    }
    yr[out + j] = ar;
    yi[out + j] = ai;
  }
}

template <class Src>
int launch(Src src, const Words& words, int channels, const void* taps_ph, float* yr,
           float* yi, int NT, int OT, int up, int down, int Q, int hist, void* stream) {
  const int span = (OT * down) / up + hist;
  const size_t smem = (size_t)(2 * span + up * Q) * sizeof(float);
  cudaError_t err = allow_smem(resample_kernel<Src>, smem);
  if (err != cudaSuccess) return (int)err;
  resample_kernel<Src><<<dim3(NT, channels), kResampleThreads, smem, (cudaStream_t)stream>>>(
      src, words, (const float*)taps_ph, yr, yi, NT, OT, up, down, Q, hist);
  return (int)cudaGetLastError();
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
  const uint32_t* w0 = (const uint32_t*)words0;
  const uint32_t* dw = (const uint32_t*)dwords;
  for (int c0 = 0; c0 < C; c0 += kMaxWordChannels) {
    const int n = C - c0 < kMaxWordChannels ? C - c0 : kMaxWordChannels;
    Words words{};
    for (int c = 0; c < n; ++c) {
      words.w0[c] = w0[c0 + c];
      words.dw[c] = dw[c0 + c];
    }
    const long long out = (long long)c0 * NT * OT;
    const int rc = launch(Planes<float>{(const float*)x + (long long)c0 * 2 * L, L}, words, n,
                          taps_ph, (float*)yr + out, (float*)yi + out, NT, OT, up, down, Q,
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
  Words words{};
  words.w0[0] = w0;
  words.dw[0] = dw;
  const int stride = (OT * down) / up;
  if (bf16)
    return launch(Frames<__nv_bfloat16>{(const __nv_bfloat16*)xr_f,
                                        (const __nv_bfloat16*)xi_f, NT, stride, span},
                  words, 1, taps_ph, (float*)yr, (float*)yi, NT, OT, up, down, Q, hist,
                  stream);
  return launch(Frames<float>{(const float*)xr_f, (const float*)xi_f, NT, stride, span},
                words, 1, taps_ph, (float*)yr, (float*)yi, NT, OT, up, down, Q, hist, stream);
}
