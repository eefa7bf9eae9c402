// Row-form fused NCO mix + FIR + decimate (K18).
//
// Replaces srcdsp_tpu/kernels/mixfir_rows.py make_mix_fir_rows_kernel
// (_kernel): the input is a [2, R, 128] row view of the history-prepended
// planes, each sample is mixed once by a factored phasor
//   e^{j 2 pi (w0 + (row*128 + lane)*dw) / 2^32}
//     = e^{j 2 pi (w0 + row*128*dw) / 2^32} * e^{j 2 pi lane*dw / 2^32},
// and the FIR is K1's real-tap convolution. The TPU kernel's chunked
// [B, 128] x [128, BC] matmuls are a matrix-unit lowering with no
// counterpart here.
//
// What bounds it is what bounds K1 (csrc/mixfir.cu): device-memory bytes
// (0.240 ms at config 1); the one-output-a-thread form it had before ran
// three shared loads per two FMAs and was set by shared-load issue. So K18
// runs K1's body over fir_ring.cuh: the view is the flat stream [2, R*128],
// and its [NT, OT] output NT*OT consecutive outputs, y[J] = sum_a h[a] *
// u[J*decim + hist - a]. A block owns FirShape<D>::kOutputs consecutive
// outputs (not one OT row), stages their window once (stage_window with
// RowMix, kStageBatch loads in flight a thread), then runs ring_block and
// store_outputs. Per sample the mix costs a few multiplies in place of K1's
// sincospif: the block makes the 128 lane phasors and one phasor per view
// row its window touches (span/128 + 2 rows) into shared memory first.
// Samples outside [0, R*128) stage as zero (Planes). The phasor product and
// the mix are explicit __fmul_rn / __fadd_rn / __fsub_rn in the order of
// mix_fir_rows_plain (kernels/mixfir_rows.py), so no contraction moves them;
// every output is one fmaf chain over a = 0 .. T-1, the order the earlier
// body used. The output equals K1's to float32 rounding of the phasor
// product (and of sincospif against the plain version's cos and sin).
//
// kernels/mixfir_rows.py rows_window mirrors the staging in numpy and
// tests/test_torch_mixfir_rows.py checks every block's words and zeros.
#include "fir_ring.cuh"

using namespace srcdsp;

namespace {

constexpr int kLane = 128;

// K18's mix: sample g times row phasor (g >> 7) (rows counted from row0, the
// block window's first) times lane phasor (g & 127), all in shared memory.
struct RowMix {
  const float* lc;  // lane phasors [128]
  const float* ls;
  const float* rc;  // row phasors of rows row0 ..
  const float* rs;
  long long row0;
  __device__ __forceinline__ void operator()(float& a, float& b, uint32_t, uint32_t,
                                             long long g) const {
    const int k = (int)((g >> 7) - row0), l = (int)(g & (kLane - 1));
    const float cr = rc[k], sr = rs[k], cl = lc[l], sl = ls[l];
    const float c = __fsub_rn(__fmul_rn(cr, cl), __fmul_rn(sr, sl));
    const float s = __fadd_rn(__fmul_rn(cr, sl), __fmul_rn(sr, cl));
    const float mr = __fsub_rn(__fmul_rn(a, c), __fmul_rn(b, s));
    const float mi = __fadd_rn(__fmul_rn(a, s), __fmul_rn(b, c));
    a = mr;
    b = mi;
  }
};

// Rows of the view a window of `span` samples touches, at most.
__host__ __device__ inline int rows_count(int span) { return span / kLane + 2; }

// Shared memory of a K18 block: K1's (taps, two window planes), then the
// lane phasors and the row phasors.
__host__ __device__ inline size_t rows_smem(const RingGeometry& g) {
  return (size_t)(g.tq + 2 * g.plane + 2 * kLane + 2 * rows_count(g.span)) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(FirShape<D>::kThreads, FirShape<D>::kMinBlocks)
    rows_kernel(const float* __restrict__ x, const float* __restrict__ taps,
                float* __restrict__ yr, float* __restrict__ yi, uint32_t w0, uint32_t dw,
                long long L, long long total, int decim, int T, int hist) {
  using S = FirShape<D>;
  constexpr int R = S::kR;
  extern __shared__ __align__(16) float smem[];
  const int d = D ? D : decim;
  const RingGeometry g = ring_geometry<S>(d, T, hist);
  const int nrows = rows_count(g.span);
  float* sh = smem;
  float* sr = sh + g.tq;
  float* si = sr + g.plane;
  float* lc = si + g.plane;
  float* ls = lc + kLane;
  float* rc = ls + kLane;
  float* rs = rc + nrows;
  const long long j0 = (long long)blockIdx.x * S::kOutputs;  // the block's first output
  const long long base = j0 * d - g.lead;                     // its window's first sample
  const long long row0 = base >> 7;                           // floor(base / 128)

  stage_taps(taps, T, g.tp, sh);
  for (int l = threadIdx.x; l < kLane; l += blockDim.x) phasor((uint32_t)l * dw, &lc[l], &ls[l]);
  for (int k = threadIdx.x; k < nrows; k += blockDim.x)
    phasor(w0 + (uint32_t)((row0 + k) * kLane) * dw, &rc[k], &rs[k]);
  __syncthreads();
  stage_window<true, Planes<float>, PaddedIndex, kStageBatch, RowMix>(
      Planes<float>{x, L}, 0, base, g.span, w0, dw, sr, si, PaddedIndex{S::kLog2Stride},
      RowMix{lc, ls, rc, rs, row0});
  __syncthreads();

  float ar[R], ai[R];
  ring_block<S, false>(sh, nullptr, sr, si, threadIdx.x * R * d + hist + g.lead, g.tp, T, ar, ai);
  store_outputs<R>(yr, yi, j0 + (long long)threadIdx.x * R, total, ar, ai);
}

template <int D>
int launch_rows(const float* x, const float* taps, float* yr, float* yi, uint32_t w0,
                uint32_t dw, long long L, long long total, int decim, int T, int hist,
                cudaStream_t stream) {
  using S = FirShape<D>;
  const size_t smem = rows_smem(ring_geometry<S>(decim, T, hist));
  cudaError_t err = allow_smem(rows_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((total + S::kOutputs - 1) / S::kOutputs);
  rows_kernel<D><<<grid, S::kThreads, smem, stream>>>(x, taps, yr, yi, w0, dw, L, total, decim,
                                                      T, hist);
  return (int)cudaGetLastError();
}

}  // namespace

// x [2, L] f32 with L = R*128 (the [2, R, 128] view, contiguous), taps f32
// [T], w0/dw u32 words (w0 the word of x sample 0); yr, yi f32 [NT, OT], the
// NT*OT outputs y[J] = sum_a h[a] * u[J*decim + hist - a] (samples past L
// read as zero). Returns the launch's cudaError_t (cudaErrorInvalidValue
// for a shape the kernel does not take), or 0.
extern "C" int srcdsp_mixfir_rows(const void* x, const void* taps, void* yr, void* yi,
                                  unsigned int w0, unsigned int dw, long long L, int NT, int OT,
                                  int decim, int T, int hist, void* stream) {
  const long long total = (long long)NT * OT;
  if (total <= 0 || decim <= 0 || T <= 0 || hist < 0 || L <= 0 || total > (1LL << 40))
    return (int)cudaErrorInvalidValue;
  return by_decim(decim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return launch_rows<D>((const float*)x, (const float*)taps, (float*)yr, (float*)yi, w0, dw, L,
                          total, decim, T, hist, (cudaStream_t)stream);
  });
}

// Registers, local-memory bytes (spills) and resident blocks per SM of the
// K18 instantiation that runs `decim`, at T taps and `hist`. Returns the
// cudaError_t, or 0.
extern "C" int srcdsp_mixfir_rows_info(int decim, int T, int hist, int* regs, int* local_bytes,
                                       int* blocks_per_sm) {
  if (decim <= 0 || T <= 0 || hist < 0) return (int)cudaErrorInvalidValue;
  return by_decim(decim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return kernel_info(rows_kernel<D>, FirShape<D>::kThreads,
                       rows_smem(ring_geometry<FirShape<D>>(decim, T, hist)), regs, local_bytes,
                       blocks_per_sm);
  });
}
