// M-channel polyphase analysis bank (K12) and the bank with the PSK timing
// and carrier statistics (K13): replaces srcdsp_tpu/kernels/bank_pallas.py
// make_bank_kernel.fn (_bank_kernel, _bank_kernel_pipelined) and
// make_bank_psk_kernel.fn (_bank_psk_kernel, _bank_psk_kernel_pipelined).
//
// Input: phase-major planes x [2, M, hc + K] (column j holds frame j - hc,
// row c phase c; the first hc columns are history). Output: channel-major
// Y [2M, K] = [Yr; Yi], and for K13 the stats [K/b_k, M, 128].
//
// The TPU kernel multiplies E_comb^T [2M, 2(P+1)M] by the staged shifted
// copies SS^T: 2 * 2(P+1)M * 2M flop per frame (294,912 at M = 64, P = 8),
// which its matrix unit absorbs. On CUDA cores that dense form is 8.5x the
// work of the factorization that make_channelizer_mats bakes into E, so this
// kernel computes that factorization directly:
//
//   fold: v[k, 0] = sum_l h[lM]     X[0,     hc + k - l]
//         v[k, p] = sum_l h[lM + p] X[M - p, hc + k - l - 1]   (p >= 1)
//   DFT:  Y[k, m] = sum_p v[k, p] e^{+j 2 pi m p / M}
//
// (X = xr + j xi; x[(k-l)M - p] lies in column k-l-1, row M-p for p >= 1, in
// column k-l, row 0 for p = 0.) The fold is 4PM flop per frame, the direct
// DFT from a twiddle table (made in float64 on the host, rounded to float32)
// 8M^2: 34,816 at M = 64, P = 8.
//
// One block owns b_k frames and walks them in tiles of kTile = 64 frames
// (the TPU kernel's sequential grid becomes this loop): stage the tile's
// [2, M, kTile + P] window of x in shared memory (each phase row contiguous
// over frames, so the loads coalesce), fold into v [kTile, M + 1], run the
// DFT (a thread holds 2 frames x up to 8 channels; a warp shares its
// channels, so twiddle reads broadcast), put the tile of Y in shared memory,
// store it (standard or class-major lane order: the order is only the store
// index), and for K13 add the tile's O&M and V&V sums per channel, reduced
// across the warp in a fixed tree order. Sums run in a fixed order with
// explicit fmaf / __fmul_rn, so K13's Y equals K12's bit for bit, and a
// launch over part of the frames (with its hc history columns) gives the
// same bits as one launch over all of them.
//
// What bounds it: per frame 8M bytes in and 8M out (K13 adds 512 bytes per
// channel per b_k frames) against about 35 K flop at M = 64, ~68 flop per
// byte: above the card's 20 (67 TFLOP/s over 3.35 TB/s), so at this form the
// DFT's multiply-adds bound it, not device memory. The least work (an M-point
// FFT in place of the direct DFT) is under 4 K flop per frame and would be
// bytes-bound; that is later work.
#include "fsk_common.cuh"

using namespace srcdsp;

namespace {

constexpr int kBankThreads = 256;     // 8 warps
constexpr int kTile = 64;             // frames per tile: 2 per lane
constexpr int kMaxChannels = 64;      // 8 warps x up to 8 channels each
constexpr int kMaxJ = kMaxChannels / 8;   // channels per warp (m = warp + 8 j)
constexpr int kStatsLanes = 128;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <bool STATS>
__global__ void __launch_bounds__(kBankThreads)
    bank_kernel(const float* __restrict__ x, const float* __restrict__ h,
                const float* __restrict__ tw, float* __restrict__ y, float* __restrict__ st,
                int M, int P, long long Lc, int hc, int K, int b_k, int sps, int order,
                float ang_step, int class_major) {
  extern __shared__ float smem[];
  const int W = kTile + P;                       // staged columns per tile
  const int YS = kTile + 1;                      // row stride of the Y tile
  const int VS = M + 1;                          // row stride of v
  const int a_floats = 2 * M * (W > YS ? W : YS);
  float* A = smem;                                          // staged x, then the Y tile
  float2* v_s = reinterpret_cast<float2*>(A + a_floats);    // v [kTile, M + 1]
  float2* tw_s = v_s + kTile * VS;                          // twiddles [M]
  float* st_s = reinterpret_cast<float*>(tw_s + M);         // stats [M, nst] (K13)
  const int nst = 2 + 2 * sps;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long blk = blockIdx.x;
  for (int i = tid; i < M; i += kBankThreads) tw_s[i] = make_float2(tw[i], tw[M + i]);
  if (STATS)
    for (int i = tid; i < M * nst; i += kBankThreads) st_s[i] = 0.f;

  const int tiles = (b_k + kTile - 1) / kTile;
  for (int s = 0; s < tiles; ++s) {
    const long long f0 = blk * b_k + (long long)s * kTile;   // first frame of the tile
    const int nvalid = min(kTile, b_k - s * kTile);

    // 1. stage columns hc + f0 - P .. hc + f0 + kTile - 1 of both planes
    const long long g0 = hc + f0 - P;
    for (int i = tid; i < 2 * M * W; i += kBankThreads) {
      const int rc = i / W, j = i - rc * W;
      const long long g = g0 + j;
      A[i] = g < Lc ? __ldg(x + rc * Lc + g) : 0.f;
    }
    __syncthreads();

    // 2. fold: consecutive threads take consecutive frames of one phase
    for (int i = tid; i < kTile * M; i += kBankThreads) {
      const int k = i % kTile, p = i / kTile;
      const int row = p == 0 ? 0 : M - p;
      const int c0 = P + k - (p == 0 ? 0 : 1);
      const float* ar = A + row * W + c0;
      const float* ai = A + (M + row) * W + c0;
      float hv = __ldg(h + p);
      float accr = __fmul_rn(hv, ar[0]);
      float acci = __fmul_rn(hv, ai[0]);
      for (int l = 1; l < P; ++l) {
        hv = __ldg(h + l * M + p);
        accr = fmaf(hv, ar[-l], accr);
        acci = fmaf(hv, ai[-l], acci);
      }
      v_s[k * VS + p] = make_float2(accr, acci);
    }
    __syncthreads();

    // 3. DFT: lane owns frames lane and lane + 32, warp owns channels
    //    warp + 8 j; the Y tile goes to A (the staged x is no longer read)
    float yr[2][kMaxJ], yi[2][kMaxJ];
    int ti[kMaxJ];
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      yr[0][j] = yr[1][j] = yi[0][j] = yi[1][j] = 0.f;
      ti[j] = 0;
    }
    for (int p = 0; p < M; ++p) {
      const float2 v0 = v_s[lane * VS + p], v1 = v_s[(lane + 32) * VS + p];
      const float v0r = v0.x, v0i = v0.y, v1r = v1.x, v1i = v1.y;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        const int m = warp + 8 * j;
        if (m < M) {
          const float2 w = tw_s[ti[j]];
          const float wr = w.x, wi = w.y;
          yr[0][j] = fmaf(-v0i, wi, fmaf(v0r, wr, yr[0][j]));
          yi[0][j] = fmaf(v0i, wr, fmaf(v0r, wi, yi[0][j]));
          yr[1][j] = fmaf(-v1i, wi, fmaf(v1r, wr, yr[1][j]));
          yi[1][j] = fmaf(v1i, wr, fmaf(v1r, wi, yi[1][j]));
          ti[j] += m;
          if (ti[j] >= M) ti[j] -= M;
        }
      }
    }
    float* ysr = A;
    float* ysi = A + M * YS;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      const int m = warp + 8 * j;
      if (m < M) {
        ysr[m * YS + lane] = yr[0][j];
        ysi[m * YS + lane] = yi[0][j];
        ysr[m * YS + lane + 32] = yr[1][j];
        ysi[m * YS + lane + 32] = yi[1][j];
      }
    }
    __syncthreads();

    // 4. store the tile; class-major lane n of a b_k block holds frame k with
    //    n = (k % sps) * (b_k / sps) + k / sps. Where sps divides the tile,
    //    consecutive threads take consecutive output lanes of one class.
    const bool runs = class_major && b_k % kTile == 0 && kTile % sps == 0;
    const int spt = runs ? kTile / sps : 1;
    for (int i = tid; i < M * kTile; i += kBankThreads) {
      const int m = i / kTile, q = i - m * kTile;
      int k;
      long long pos;
      if (runs) {
        const int o = q / spt, jj = q - o * spt;
        k = jj * sps + o;
        pos = (long long)o * (b_k / sps) + (s * kTile) / sps + jj;
      } else {
        k = q;
        if (k >= nvalid) continue;
        const int kin = s * kTile + k;
        pos = class_major ? (long long)(kin % sps) * (b_k / sps) + kin / sps : kin;
      }
      const long long col = blk * b_k + pos;
      y[(long long)m * K + col] = ysr[m * YS + k];
      y[(long long)(M + m) * K + col] = ysi[m * YS + k];
    }

    // 5. K13: per channel, sum |y|^2 against the O&M tone and y^order per
    //    offset class over the tile's frames
    if (STATS) {
      for (int j = 0; j < kMaxJ; ++j) {
        const int m = warp + 8 * j;
        if (m >= M) break;
        float tc[2], ts[2], pr[2], pim[2];
        int koff[2];
        bool ok[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int k = lane + 32 * u;
          ok[u] = k < nvalid;
          const float a = ysr[m * YS + k], b = ysi[m * YS + k];
          koff[u] = (int)((blk * b_k + s * kTile + k) % sps);
          const float power = __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
          const float ang = __fmul_rn((float)koff[u], ang_step);
          tc[u] = __fmul_rn(power, cosf(ang));
          ts[u] = __fmul_rn(power, -sinf(ang));
          float qr = a, qi = b;
          for (int o = order; o > 1; o >>= 1) {
            const float nr = __fsub_rn(__fmul_rn(qr, qr), __fmul_rn(qi, qi));
            qi = __fmul_rn(__fmul_rn(2.f, qr), qi);
            qr = nr;
          }
          pr[u] = qr;
          pim[u] = qi;
        }
        for (int q = 0; q < nst; ++q) {
          float v = 0.f;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (!ok[u]) continue;
            float c;
            if (q == 0) c = tc[u];
            else if (q == 1) c = ts[u];
            else if (q < 2 + sps) c = koff[u] == q - 2 ? pr[u] : 0.f;
            else c = koff[u] == q - 2 - sps ? pim[u] : 0.f;
            v = __fadd_rn(v, c);
          }
          v = warp_sum(v);
          if (lane == 0) st_s[m * nst + q] = __fadd_rn(st_s[m * nst + q], v);
        }
      }
    }
    __syncthreads();   // A is restaged by the next tile
  }

  if (STATS) {
    float* out = st + blk * M * kStatsLanes;
    for (int i = tid; i < M * kStatsLanes; i += kBankThreads) {
      const int m = i / kStatsLanes, q = i - m * kStatsLanes;
      out[i] = q < nst ? st_s[m * nst + q] : 0.f;
    }
  }
}

size_t bank_smem(int M, int P, int sps) {
  const int W = kTile + P, YS = kTile + 1;
  const size_t a = 2 * (size_t)M * (W > YS ? W : YS);
  return (a + 2 * (size_t)kTile * (M + 1) + 2 * (size_t)M + (size_t)M * (2 + 2 * sps)) *
         sizeof(float);
}

template <bool STATS>
int launch(const float* x, const float* h, const float* tw, float* y, float* st, int M, int P,
           long long Lc, int hc, int K, int b_k, int sps, int order, float ang_step,
           int class_major, cudaStream_t stream) {
  const size_t smem = bank_smem(M, P, STATS ? sps : 0);
  cudaError_t err = allow_smem(bank_kernel<STATS>, smem);
  if (err != cudaSuccess) return (int)err;
  bank_kernel<STATS><<<K / b_k, kBankThreads, smem, stream>>>(
      x, h, tw, y, st, M, P, Lc, hc, K, b_k, sps, order, ang_step, class_major);
  return (int)cudaGetLastError();
}

}  // namespace

// x [2, M, Lc] f32 phase-major, Lc = hc + K, P <= hc; h [P*M] f32 (the
// prototype zero-padded to a multiple of M); tw [2, M] f32, tw[q] =
// e^{+2 pi i q / M}; y [2M, K] f32. stats != 0 (K13): st [K/b_k, M, 128] f32,
// sps and order (a power of two) set the sums, ang_step = float32(2 pi / sps),
// class_major != 0 permutes each b_k block's lanes; stats == 0 (K12): st, sps,
// order, ang_step and class_major are unused. K % b_k == 0, 1 <= M <= 64.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for a size the
// kernel does not take), or 0.
extern "C" int srcdsp_bank(const void* x, const void* h, const void* tw, void* y, void* st,
                           int M, int P, long long Lc, int hc, int K, int b_k, int sps,
                           int order, float ang_step, int class_major, int stats,
                           void* stream) {
  if (M < 1 || M > kMaxChannels || P < 1 || P > hc || K <= 0 || b_k <= 0 || K % b_k != 0 ||
      Lc != (long long)hc + K)
    return (int)cudaErrorInvalidValue;
  const float* xf = (const float*)x;
  const float* hf = (const float*)h;
  const float* twf = (const float*)tw;
  const cudaStream_t s = (cudaStream_t)stream;
  if (stats) {
    if (sps < 1 || 2 + 2 * sps > kStatsLanes || b_k % sps != 0 || order < 2 ||
        (order & (order - 1)) != 0)
      return (int)cudaErrorInvalidValue;
    return launch<true>(xf, hf, twf, (float*)y, (float*)st, M, P, Lc, hc, K, b_k, sps, order,
                        ang_step, class_major, s);
  }
  return launch<false>(xf, hf, twf, (float*)y, nullptr, M, P, Lc, hc, K, b_k, 1, 2, 0.f, 0, s);
}
