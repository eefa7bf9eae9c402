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
// which its matrix unit absorbs. On CUDA cores that dense form is far more
// work than the factorization make_channelizer_mats bakes into E, so this
// kernel computes the factorization directly:
//
//   fold: v[k, 0] = sum_l h[lM]     X[0,     hc + k - l]
//         v[k, p] = sum_l h[lM + p] X[M - p, hc + k - l - 1]   (p >= 1)
//   DFT:  Y[k, m] = sum_p v[k, p] e^{+j 2 pi m p / M}
//
// (X = xr + j xi; x[(k-l)M - p] lies in column k-l-1, row M-p for p >= 1, in
// column k-l, row 0 for p = 0.) The fold is 4PM flop per frame; for a power
// of two M the DFT is an M-point Stockham FFT (radix-8 passes, then one of
// radix 2 or 4: 5 M log2 M flop, 1,920 at M = 64), any other M a direct DFT
// (8 M^2), both from one twiddle table made in float64 on the host and
// rounded to float32 once.
//
// One block owns b_k frames and walks them in tiles of F frames (F a power of
// two, the largest up to 64 whose shared memory fits the budget; the TPU
// kernel's sequential grid becomes this loop). A tile: stage columns
// [hc + f0 - P, hc + f0 + F) of the 2M phase rows (each row contiguous over
// frames, so the loads coalesce); fold into buffer A [F][M + 1] (complex, one
// frame a row, the prototype taps broadcast from shared memory); the FFT's
// passes ping-pong A and B (B reuses the staged columns); store Y channel-
// major from the last buffer (standard or class-major lane order: the order
// is the store index, and for class-major runs the buffer rows, which the
// fold writes in class-major order so that the store reads consecutive
// rows). F divides the block, so a thread keeps one frame (row) in every
// phase and consecutive lanes hold consecutive frames: the 8-byte accesses
// of the frame-row buffers (stride M + 1, odd) are conflict-free, but for
// the class-major fold's stores, and the stores run along a channel's row
// of Y; index math is done once a thread, not once a unit. K13
// adds, per channel m and offset class o = frame mod sps, the sum of |y|^2,
// Re y^order and Im y^order over the class's frames: one thread owns each
// (m, o) for the whole block, adds a tile's frames in order into its sums in
// shared memory, and the block writes the stats once, lane 0 sum_o
// cos(o*2pi/sps) * P[m][o] and lane 1 sum_o -sin(...) * P[m][o] in o order
// (cos and sin from a table of sps entries). Sums run in a fixed order with
// explicit fmaf / __fmul_rn, so K13's Y equals K12's bit for bit, the
// stats do not depend on the lane order, and a launch over part of the frames
// (with its hc history columns) gives the same bits as one launch over all.
//
// What bounds it: per frame 8M bytes in and 8M out (K13 adds 512 bytes per
// channel per b_k frames) against about 4PM + 5 M log2 M = 3,968 flop at
// M = 64, P = 8: 7.8 flop per byte, under the card's 20 (67 TFLOP/s over
// 3.35 TB/s), so device-memory bytes bound it (0.160 ms at config 5). The
// form this replaced ran a direct DFT (8M^2 = 32,768 flop a frame) and was
// bound by its multiply-adds.
//
// kernels/bank_pallas.py mirrors the FFT's index map and twiddle table, the
// buffer rows and the tile size (fft_*, bank_rows, bank_tile), and
// tests/test_torch_bank.py checks them (the FFT against np.fft).
#include "fir_ring.cuh"

using namespace srcdsp;

namespace {

constexpr int kBankThreads = 256;
constexpr int kMaxTile = 64;                // frames a tile at most
constexpr int kRadix = 8;                   // the largest radix of a pass
constexpr int kMaxPasses = 16;
constexpr int kStatsLanes = 128;
constexpr size_t kBankBudget = 96 * 1024;   // the tile halves until a block fits
constexpr size_t kMaxSmem = 227 * 1024;     // a block's most dynamic shared memory

// The block geometry, computed on the host and passed by value. Offsets are
// floats into shared memory, each a multiple of 4.
struct BankGeometry {
  int F, log2f;   // frames a tile
  int W;          // staged columns a tile: F + P
  int vs;         // float2 stride of a frame row in A and B: M + 1
  int npass;      // FFT passes; -1: M is not a power of two, a direct DFT
  int radix[kMaxPasses];
  int tw, cs, acc, a, b;
  int floats;     // shared memory a block uses, in floats
};

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

BankGeometry bank_geometry(int M, int P, int b_k, int sps, bool stats, int F) {
  BankGeometry g;
  g.F = F;
  g.log2f = 0;
  while ((1 << g.log2f) < F) ++g.log2f;
  g.W = F + P;
  g.vs = M + 1;
  g.npass = -1;
  if ((M & (M - 1)) == 0) {  // kRadix while it divides what is left, then 4 or 2
    g.npass = 0;
    for (int m = M; m > 1 && g.npass < kMaxPasses; ++g.npass) {
      const int r = m % kRadix == 0 ? kRadix : m >= 4 ? 4 : 2;
      g.radix[g.npass] = r;
      m /= r;
    }
  }
  g.tw = round4(P * M);
  g.cs = g.tw + round4(2 * M);
  g.acc = g.cs + (stats ? round4(2 * sps) : 0);
  g.a = g.acc + (stats ? round4(3 * M * sps) : 0);
  g.b = g.a + round4(2 * F * g.vs);
  const int stage = 2 * M * g.W, buf = 2 * F * g.vs;
  g.floats = g.b + round4(stage > buf ? stage : buf);
  return g;
}

// The largest tile up to kMaxTile (and not above the first power of two at
// or past b_k) within the budget, else the largest that fits a block at
// all; F = 0: none does.
BankGeometry bank_tile(int M, int P, int b_k, int sps, bool stats) {
  int F = kMaxTile;
  while (F > 1 && F / 2 >= b_k) F /= 2;
  BankGeometry fit{};
  for (; F >= 1; F /= 2) {
    const BankGeometry g = bank_geometry(M, P, b_k, sps, stats, F);
    const size_t bytes = (size_t)g.floats * sizeof(float);
    if (bytes <= kBankBudget) return g;
    if (bytes <= kMaxSmem && fit.F == 0) fit = g;
  }
  return fit;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
}
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(fmaf(a.x, w.x, -__fmul_rn(a.y, w.y)), fmaf(a.x, w.y, __fmul_rn(a.y, w.x)));
}
__device__ __forceinline__ float2 mul_i(float2 a) { return make_float2(-a.y, a.x); }

// In-register R-point DFTs with the bank's sign, y[k] = sum_n v[n] e^{+2 pi i nk/R}.
__device__ __forceinline__ void dft2(float2& a, float2& b) {
  const float2 t = a;
  a = cadd(t, b);
  b = csub(t, b);
}
__device__ __forceinline__ void dft4(float2& v0, float2& v1, float2& v2, float2& v3) {
  const float2 a = cadd(v0, v2), b = csub(v0, v2), c = cadd(v1, v3), d = mul_i(csub(v1, v3));
  v0 = cadd(a, c);
  v2 = csub(a, c);
  v1 = cadd(b, d);
  v3 = csub(b, d);
}
template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R]) {
  if constexpr (R == 2) {
    dft2(v[0], v[1]);
  } else if constexpr (R == 4) {
    dft4(v[0], v[1], v[2], v[3]);
  } else {  // R == 8: two 4-point DFTs over even and odd n, then e^{+i pi k/4}
    constexpr float kC = 0.70710678118654752440f;
    dft4(v[0], v[2], v[4], v[6]);
    dft4(v[1], v[3], v[5], v[7]);
    const float2 o1 = v[3], o2 = v[5], o3 = v[7];
    const float2 w1 = make_float2(__fmul_rn(kC, __fsub_rn(o1.x, o1.y)),
                                  __fmul_rn(kC, __fadd_rn(o1.x, o1.y)));
    const float2 w2 = mul_i(o2);
    const float2 w3 = make_float2(-__fmul_rn(kC, __fadd_rn(o3.x, o3.y)),
                                  __fmul_rn(kC, __fsub_rn(o3.x, o3.y)));
    const float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6], o0 = v[1];
    v[0] = cadd(e0, o0);
    v[4] = csub(e0, o0);
    v[1] = cadd(e1, w1);
    v[5] = csub(e1, w1);
    v[2] = cadd(e2, w2);
    v[6] = csub(e2, w2);
    v[3] = cadd(e3, w3);
    v[7] = csub(e3, w3);
  }
}

// The buffer row that holds frame f of a tile. In class-major runs (b_k a
// multiple of F, F of sps; both powers of two) frame f = jj*sps + o sits in
// row q = o*spt + jj (spt = F/sps), its class-major position: the store
// reads consecutive rows, and a class's frames are consecutive rows. Else
// row f.
struct RowMap {
  bool runs;
  int log2sps, log2spt;
  __device__ __forceinline__ int of_frame(int f) const {
    return runs ? ((f & ((1 << log2sps) - 1)) << log2spt) + (f >> log2sps) : f;
  }
};

__device__ __forceinline__ RowMap row_map(bool class_major, int b_k, int F, int sps) {
  RowMap r{class_major && b_k % F == 0 && F % sps == 0, 0, 0};
  if (r.runs) {
    r.log2sps = 31 - __clz(sps);
    r.log2spt = 31 - __clz(F / sps);
  }
  return r;
}

// One Stockham pass of radix R over the tile's F frames (rows of X and Y,
// stride vs; the thread's row f is threadIdx.x mod F, F dividing the
// block): after the passes before it, of ns points in all, unit (f, j)
// reads X[f][j + q*M/R] (q < R), twiddles q by e^{+2 pi i q k/(ns R)}, k =
// j mod ns (table entry q*k*M/(ns R)), runs the R-point DFT and writes
// Y[f][(j - k)*R + k + q*ns].
template <int R>
__device__ __forceinline__ void fft_pass(const float2* __restrict__ X, float2* __restrict__ Y,
                                         const float2* __restrict__ tw, int M, int ns,
                                         const BankGeometry& g) {
  const int mr = M / R, tws = M / (ns * R), f = threadIdx.x & (g.F - 1);
  for (int j = threadIdx.x >> g.log2f; j < mr; j += blockDim.x >> g.log2f) {
    const int k = j & (ns - 1);
    const float2* xf = X + f * g.vs + j;
    float2 v[R];
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] = xf[q * mr];
#pragma unroll
    for (int q = 1; q < R; ++q) v[q] = cmul(v[q], tw[q * k * tws]);
    dft<R>(v);
    float2* yf = Y + f * g.vs + (j - k) * R + k;
#pragma unroll
    for (int q = 0; q < R; ++q) yf[q * ns] = v[q];
  }
}

template <bool STATS>
__global__ void __launch_bounds__(kBankThreads)
    bank_kernel(const float* __restrict__ x, const float* __restrict__ h,
                const float* __restrict__ twg, float* __restrict__ y, float* __restrict__ st,
                int M, int P, long long Lc, int hc, int K, int b_k, int sps, int order,
                float ang_step, int class_major, BankGeometry g) {
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                                             // taps [P*M]
  float2* tw = reinterpret_cast<float2*>(smem + g.tw);          // e^{+2 pi i q/M}
  float2* cs = reinterpret_cast<float2*>(smem + g.cs);          // (cos, -sin) [sps] (K13)
  float* acc = smem + g.acc;                                    // [M][sps][3] (K13)
  float2* A = reinterpret_cast<float2*>(smem + g.a);            // [F][M + 1]
  float* S = smem + g.b;                                        // staged [2M][W]
  float2* B = reinterpret_cast<float2*>(S);                     // [F][M + 1]
  const int F = g.F;
  const long long blk = blockIdx.x;

  for (int i = threadIdx.x; i < P * M; i += blockDim.x) hs[i] = h[i];
  for (int i = threadIdx.x; i < M; i += blockDim.x) tw[i] = make_float2(twg[i], twg[M + i]);
  if (STATS) {
    for (int o = threadIdx.x; o < sps; o += blockDim.x) {
      const float ang = __fmul_rn((float)o, ang_step);
      cs[o] = make_float2(cosf(ang), -sinf(ang));
    }
    for (int i = threadIdx.x; i < 3 * M * sps; i += blockDim.x) acc[i] = 0.f;
  }

  const int tiles = (b_k + F - 1) / F;
  const int n = 2 * M * g.W;
  const int drow = blockDim.x / g.W, dcol = blockDim.x - drow * g.W;
  const long long step = drow * Lc + dcol, wrap = step + Lc - g.W;  // element i to i + blockDim
  const RowMap rows = row_map(class_major, b_k, F, sps);
  // F divides the block: a thread keeps frame (row, output lane) fl =
  // threadIdx.x mod F in every phase, and steps its units by pstep
  const int fl = threadIdx.x & (F - 1), pstep = blockDim.x >> g.log2f;
  const int frow = rows.of_frame(fl);  // the fold's row for frame fl
  for (int s = 0; s < tiles; ++s) {
    const long long f0 = blk * b_k + (long long)s * F;  // first frame of the tile
    const int nvalid = min(F, b_k - s * F);

    // 1. stage columns hc + f0 - P .. hc + f0 + F - 1 of the 2M phase rows:
    //    element i = row*W + col, its column and address carried by adds,
    //    kStageBatch loads in flight a thread; only the last block's last
    //    tile can reach past the stream
    {
      const long long g0 = hc + f0 - P;
      const bool tail = g0 + g.W > Lc;
      const int row = threadIdx.x / g.W;
      int col = threadIdx.x - row * g.W;
      const float* src = x + row * Lc + g0 + col;
      for (int i0 = threadIdx.x; i0 < n; i0 += kStageBatch * blockDim.x) {
        float v[kStageBatch];
#pragma unroll
        for (int q = 0; q < kStageBatch; ++q) {
          v[q] = i0 + q * (int)blockDim.x < n && (!tail || g0 + col < Lc) ? __ldg(src) : 0.f;
          col += dcol;
          if (col >= g.W) {
            col -= g.W;
            src += wrap;
          } else {
            src += step;
          }
        }
#pragma unroll
        for (int q = 0; q < kStageBatch; ++q)
          if (i0 + q * (int)blockDim.x < n) S[i0 + q * blockDim.x] = v[q];
      }
    }
    __syncthreads();

    // 2. fold: unit (fl, p), consecutive lanes on consecutive frames
    for (int p = threadIdx.x >> g.log2f; p < M; p += pstep) {
      const int row = p == 0 ? 0 : M - p;
      const int c0 = P + fl - (p == 0 ? 0 : 1);
      const float* ar = S + row * g.W + c0;
      const float* ai = S + (M + row) * g.W + c0;
      float hv = hs[p];
      float accr = __fmul_rn(hv, ar[0]);
      float acci = __fmul_rn(hv, ai[0]);
#pragma unroll 4
      for (int l = 1; l < P; ++l) {
        hv = hs[l * M + p];
        accr = fmaf(hv, ar[-l], accr);
        acci = fmaf(hv, ai[-l], acci);
      }
      A[frow * g.vs + p] = make_float2(accr, acci);
    }
    __syncthreads();

    // 3. the DFT over each frame row: A -> B -> A ... (B reuses the staged
    //    columns, no longer read)
    const float2* Yb = A;
    if (g.npass < 0) {  // a direct DFT, twiddle index m*p mod M carried by adds
      for (int m = threadIdx.x >> g.log2f; m < M; m += pstep) {
        const float2* vf = A + fl * g.vs;
        float2 a = make_float2(0.f, 0.f);
        int ti = 0;
        for (int p = 0; p < M; ++p) {
          const float2 v = vf[p], w = tw[ti];
          a.x = fmaf(-v.y, w.y, fmaf(v.x, w.x, a.x));
          a.y = fmaf(v.y, w.x, fmaf(v.x, w.y, a.y));
          ti += m;
          if (ti >= M) ti -= M;
        }
        B[fl * g.vs + m] = a;
      }
      __syncthreads();
      Yb = B;
    } else {
      float2* src = A;
      float2* dst = B;
      int ns = 1;
      for (int pass = 0; pass < g.npass; ++pass) {
        const int r = g.radix[pass];
        if (r == 8) fft_pass<8>(src, dst, tw, M, ns, g);
        else if (r == 4) fft_pass<4>(src, dst, tw, M, ns, g);
        else fft_pass<2>(src, dst, tw, M, ns, g);
        ns *= r;
        __syncthreads();
        float2* t = src;
        src = dst;
        dst = t;
      }
      Yb = src;
    }

    // 4. store the tile; class-major lane n of a b_k block holds frame k with
    //    n = (k % sps) * (b_k / sps) + k / sps. In runs, consecutive threads
    //    take consecutive output lanes of one class (F/sps of them): the
    //    thread's lane fl is position fl of the tile, row fl.
    if (rows.runs || fl < nvalid) {
      long long pos;
      if (rows.runs) {
        pos = (long long)(fl >> rows.log2spt) * (b_k / sps) + (s * F) / sps +
              (fl & ((1 << rows.log2spt) - 1));
      } else {
        const int kin = s * F + fl;
        pos = class_major ? (long long)(kin % sps) * (b_k / sps) + kin / sps : kin;
      }
      const long long col = blk * b_k + pos;
      for (int m = threadIdx.x >> g.log2f; m < M; m += pstep) {
        const float2 v = Yb[fl * g.vs + m];
        y[(long long)m * K + col] = v.x;
        y[(long long)(M + m) * K + col] = v.y;
      }
    }

    // 5. K13: the owner of (m, o) adds |y|^2, Re y^order and Im y^order over
    //    the tile's frames of class o (frame mod sps, b_k a multiple of sps)
    //    in frame order: rows o*spt .. in runs, else frames off_o, off_o + sps ..
    if (STATS) {
      const int off = (s * F) % sps;  // class of the tile's frame 0
      for (int u = threadIdx.x; u < M * sps; u += blockDim.x) {
        const int o = u / M, m = u - o * M;
        const int r0 = rows.runs ? o << rows.log2spt : (o - off + sps) % sps;
        const int dr = rows.runs ? 1 : sps;
        const int rend = rows.runs ? r0 + (1 << rows.log2spt) : nvalid;
        float lp = 0.f, lr = 0.f, li = 0.f;
        for (int r = r0; r < rend; r += dr) {
          const float2 v = Yb[r * g.vs + m];
          lp = __fadd_rn(lp, __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)));
          float qr = v.x, qi = v.y;
          for (int e = order; e > 1; e >>= 1) {
            const float nr = __fsub_rn(__fmul_rn(qr, qr), __fmul_rn(qi, qi));
            qi = __fmul_rn(__fmul_rn(2.f, qr), qi);
            qr = nr;
          }
          lr = __fadd_rn(lr, qr);
          li = __fadd_rn(li, qi);
        }
        float* a = acc + 3 * (m * sps + o);
        a[0] = __fadd_rn(a[0], lp);
        a[1] = __fadd_rn(a[1], lr);
        a[2] = __fadd_rn(a[2], li);
      }
    }
    __syncthreads();  // S, A and B are restaged and rewritten by the next tile
  }

  if (STATS) {
    float* out = st + blk * M * kStatsLanes;
    for (int i = threadIdx.x; i < M * kStatsLanes; i += blockDim.x) {
      const int m = i / kStatsLanes, q = i - m * kStatsLanes;
      const float* a = acc + 3 * m * sps;
      float v = 0.f;
      if (q < 2) {
        for (int o = 0; o < sps; ++o) v = fmaf(q == 0 ? cs[o].x : cs[o].y, a[3 * o], v);
      } else if (q < 2 + sps) {
        v = a[3 * (q - 2) + 1];
      } else if (q < 2 + 2 * sps) {
        v = a[3 * (q - 2 - sps) + 2];
      }
      out[i] = v;
    }
  }
}

template <bool STATS>
int launch(const float* x, const float* h, const float* tw, float* y, float* st, int M, int P,
           long long Lc, int hc, int K, int b_k, int sps, int order, float ang_step,
           int class_major, cudaStream_t stream) {
  const BankGeometry g = bank_tile(M, P, b_k, sps, STATS);
  if (g.F == 0 || g.npass >= kMaxPasses) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)g.floats * sizeof(float);
  cudaError_t err = allow_smem(bank_kernel<STATS>, smem);
  if (err != cudaSuccess) return (int)err;
  bank_kernel<STATS><<<K / b_k, kBankThreads, smem, stream>>>(
      x, h, tw, y, st, M, P, Lc, hc, K, b_k, sps, order, ang_step, class_major, g);
  return (int)cudaGetLastError();
}

}  // namespace

// x [2, M, Lc] f32 phase-major, Lc = hc + K, P <= hc; h [P*M] f32 (the
// prototype zero-padded to a multiple of M); tw [2, M] f32, tw[q] =
// e^{+2 pi i q / M}; y [2M, K] f32. stats != 0 (K13): st [K/b_k, M, 128] f32,
// sps and order (a power of two) set the sums, ang_step = float32(2 pi / sps),
// class_major != 0 permutes each b_k block's lanes; stats == 0 (K12): st, sps,
// order, ang_step and class_major are unused. K % b_k == 0, any M >= 1 whose
// tile of one frame fits a block's shared memory (M up to about 1,500 at P = 8).
// Returns the launch's cudaError_t (cudaErrorInvalidValue for a size the
// kernel does not take), or 0.
extern "C" int srcdsp_bank(const void* x, const void* h, const void* tw, void* y, void* st,
                           int M, int P, long long Lc, int hc, int K, int b_k, int sps,
                           int order, float ang_step, int class_major, int stats,
                           void* stream) {
  if (M < 1 || P < 1 || P > hc || K <= 0 || b_k <= 0 || K % b_k != 0 ||
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

// The tile (frames), registers, local-memory bytes (spills) and resident
// blocks per SM of K12 (stats == 0) or K13 at M channels, P taps a phase,
// b_k and sps. Returns the cudaError_t (cudaErrorInvalidValue where no tile
// fits), or 0.
extern "C" int srcdsp_bank_info(int M, int P, int b_k, int sps, int stats, int* frames,
                                int* regs, int* local_bytes, int* blocks_per_sm) {
  if (M < 1 || P < 1 || b_k < 1 || sps < 1) return (int)cudaErrorInvalidValue;
  const BankGeometry g = bank_tile(M, P, b_k, stats ? sps : 1, stats != 0);
  if (g.F == 0) return (int)cudaErrorInvalidValue;
  *frames = g.F;
  const size_t smem = (size_t)g.floats * sizeof(float);
  return stats ? kernel_info(bank_kernel<true>, kBankThreads, smem, regs, local_bytes,
                             blocks_per_sm)
               : kernel_info(bank_kernel<false>, kBankThreads, smem, regs, local_bytes,
                             blocks_per_sm);
}
