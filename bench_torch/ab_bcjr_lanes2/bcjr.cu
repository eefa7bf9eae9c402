// K16 with two lanes a codeword, 4 states each (an A/B variant of
// srcdsp_tpu_torch/csrc/bcjr.cu, built only by bench_torch/ab_bcjr.py).
//
// Lane 2c + t holds codeword c's states {0, 1, 2, 3} (t = 0) or {7, 6, 5,
// 4} (t = 1) in slots 0 .. 3: slot pairs A = (0, 1) and B = (2, 3) are the
// trellis pairs 0, 1 (t = 0) or 3, 2 (t = 1). A forward step makes each
// pair's two targets, keeps the ones the lane holds next (t = 0 the low
// targets j, t = 1 the high ones 4 | j) and sends the other two to its
// partner, together with the max of its four: one round of three
// __shfl_xor_sync a step, whatever the code. The labels of the slots come
// back the same each step, so the masks are per lane and static. A
// backward step sends its slots 2 and 3 and its max the same way; the
// posterior reads its four successors' betas from the history (the forward
// warp) or from the partner (the backward warp) and combines the two lanes'
// maxima with one more round. Every value is the one-codeword-a-thread
// body's, computed by the same operations: the bits do not move.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kWarp = 32;    // lanes a warp; a block: one warp forward, one backward
constexpr int kCw = kWarp / 2;  // codewords a block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sel(uint32_t m, float a, float b) {
  return __int_as_float((int)((m & (uint32_t)__float_as_int(a)) |
                              (~m & (uint32_t)__float_as_int(b))));
}

__device__ __forceinline__ float max4(const float (&v)[4]) {
  return fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
}

__device__ __forceinline__ float xor1(float v) { return __shfl_xor_sync(kFull, v, 1); }

// The lane's masks: c[P] = f(2j) of its slot pair P's trellis pair j, p[i] =
// par[label(i), 0].
struct Lane {
  uint32_t c[2];
  uint32_t p[4];
};

// state held in slot i by lane half t
__device__ __forceinline__ int label(int t, int i) { return t ? 7 - i : i; }

__device__ __forceinline__ void gammas(const Lane& m, float l_s, float l_p, float (&gr)[4]) {
  const float hs = __fmul_rn(0.5f, l_s), hp = __fmul_rn(0.5f, l_p);
  const float gp = __fadd_rn(hs, hp), gm = __fadd_rn(hs, -hp);
#pragma unroll
  for (int i = 0; i < 4; ++i) gr[i] = sel(m.p[i], gm, gp);
}

// the forward step: an (normalized) -> au (un-normalized), an
__device__ __forceinline__ void alpha_step(const Lane& m, const float (&gr)[4], float (&an)[4],
                                           float (&au)[4]) {
  float av[4], bv[4], tg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    av[i] = __fadd_rn(an[i], gr[i]);
    bv[i] = __fadd_rn(an[i], -gr[i]);
  }
  float kept[2], sent[2];
#pragma unroll
  for (int P = 0; P < 2; ++P) {
    const float x = fmaxf(av[2 * P], bv[2 * P + 1]);
    const float y = fmaxf(av[2 * P + 1], bv[2 * P]);
    tg[2 * P] = x;
    tg[2 * P + 1] = y;
    kept[P] = sel(m.c[P], y, x);
    sent[P] = sel(m.c[P], x, y);
  }
  const float mo = max4(tg);
  const float r0 = xor1(sent[0]), r1 = xor1(sent[1]), mp = xor1(mo);
  const float mx = fmaxf(mo, mp);
  au[0] = kept[0];
  au[1] = kept[1];
  au[2] = r1;
  au[3] = r0;
#pragma unroll
  for (int i = 0; i < 4; ++i) an[i] = __fsub_rn(au[i], mx);
}

// the backward step: bn (normalized, own) and on2, on3 (the partner's slots
// 2 and 3, normalized) -> bu (un-normalized), bn, and the partner's new
// un-normalized slots 2, 3 (r2, r3) and normalized ones (on2, on3)
__device__ __forceinline__ void beta_step(const Lane& m, const float (&gr)[4], float (&bn)[4],
                                          float& on2, float& on3, float (&bu)[4], float& r2,
                                          float& r3) {
#pragma unroll
  for (int P = 0; P < 2; ++P) {
    const float own = bn[P], other = P == 0 ? on3 : on2;
    const float p = sel(m.c[P], other, own), q = sel(m.c[P], own, other);
    bu[2 * P] = fmaxf(__fadd_rn(gr[2 * P], p), __fadd_rn(-gr[2 * P], q));
    bu[2 * P + 1] = fmaxf(__fadd_rn(gr[2 * P + 1], q), __fadd_rn(-gr[2 * P + 1], p));
  }
  const float mo = max4(bu);
  r2 = xor1(bu[2]);
  r3 = xor1(bu[3]);
  const float mx = fmaxf(mo, xor1(mo));
#pragma unroll
  for (int i = 0; i < 4; ++i) bn[i] = __fsub_rn(bu[i], mx);
  on2 = __fsub_rn(r2, mx);
  on3 = __fsub_rn(r3, mx);
}

// max over the codeword's states of (au + gr) + b[next0] minus the same over
// input 1; own0, own1: the successor betas in this lane's slots 0, 1; o3, o2:
// the partner's slots 3, 2 (pairs A, B).
__device__ __forceinline__ float posterior(const Lane& m, const float (&au)[4],
                                           const float (&gr)[4], float own0, float own1,
                                           float o3, float o2) {
  float v0[4], v1[4];
#pragma unroll
  for (int P = 0; P < 2; ++P) {
    const float own = P == 0 ? own0 : own1, other = P == 0 ? o3 : o2;
    const float p = sel(m.c[P], other, own), q = sel(m.c[P], own, other);
    v0[2 * P] = __fadd_rn(__fadd_rn(au[2 * P], gr[2 * P]), p);
    v1[2 * P] = __fadd_rn(__fadd_rn(au[2 * P], -gr[2 * P]), q);
    v0[2 * P + 1] = __fadd_rn(__fadd_rn(au[2 * P + 1], gr[2 * P + 1]), q);
    v1[2 * P + 1] = __fadd_rn(__fadd_rn(au[2 * P + 1], -gr[2 * P + 1]), p);
  }
  const float m0 = max4(v0), m1 = max4(v1);
  return __fsub_rn(fmaxf(m0, xor1(m0)), fmaxf(m1, xor1(m1)));
}

template <bool H>
struct StepIn {
  float s, p, h[H ? 4 : 1];
};

// as bcjr.cu's pass, one step ahead; with H the four history values this
// lane reads: own slots 0, 1 and the partner's 3, 2 (fwd, hp = hs's lane
// pair) or own slots 0 .. 3 (bwd)
template <bool H, class Step>
__device__ __forceinline__ void pass(int n, const float* ql, const float* qp, float* hs,
                                     const int (&off)[4], float* po, long long dl, long long dh,
                                     Step step) {
  const float* qh = hs;
  auto load = [&](StepIn<H>& v) {
    v.s = *ql;
    v.p = *qp;
    if constexpr (H) {
#pragma unroll
      for (int i = 0; i < 4; ++i) v.h[i] = qh[off[i]];
    }
    ql += dl;
    qp += dl;
    qh += dh;
  };
  StepIn<H> q;
  load(q);
  for (int k = 0; k < n; ++k) {
    const StepIn<H> in = q;
    if (k + 1 < n) load(q);
    step(in, hs, po);
    hs += dh;
    po += dl;
  }
}

// hist [T, G, 4, 32] scratch, G = gridDim.x: slot i of lane l at i*32 + l.
__global__ void __launch_bounds__(2 * kWarp) bcjr_kernel(const float* __restrict__ ls,
                                                         const float* __restrict__ lp,
                                                         float* __restrict__ post, float* hist,
                                                         int T, int B, int terminated,
                                                         uint32_t c_mask, uint32_t par_mask) {
  const bool fwd = threadIdx.x < kWarp;
  const int lane = threadIdx.x & (kWarp - 1), t = lane & 1;
  const long long b = (long long)blockIdx.x * kCw + (lane >> 1);
  const bool live = b < B;
  const long long bl = live ? b : B - 1;
  const long long tile = (long long)gridDim.x * 4 * kWarp;
  Lane m;
#pragma unroll
  for (int P = 0; P < 2; ++P) {
    const int j = t ? 3 - P : P;
    m.c[P] = (c_mask >> j) & 1 ? ~0u : 0u;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) m.p[i] = (par_mask >> label(t, i)) & 1 ? ~0u : 0u;
  ls += bl;
  lp += bl;
  post += bl;
  hist += (long long)blockIdx.x * 4 * kWarp + lane;
  const int h = T / 2;
  const bool from_zero = fwd || terminated;
  float gr[4], an[4], au[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) an[i] = au[i] = label(t, i) == 0 || !from_zero ? 0.f : kNeg;
  // the partner's slots 2, 3 (backward): un-normalized and normalized
  float r2 = label(1 - t, 2) == 0 || !from_zero ? 0.f : kNeg;
  float r3 = label(1 - t, 3) == 0 || !from_zero ? 0.f : kNeg;
  float on2 = r2, on3 = r3;
  const int partner = (lane ^ 1) - lane;
  const int off_f[4] = {0, kWarp, 3 * kWarp + partner, 2 * kWarp + partner};
  const int off_b[4] = {0, kWarp, 2 * kWarp, 3 * kWarp};
  auto keep = [&](float* hs) {
#pragma unroll
    for (int i = 0; i < 4; ++i) hs[i * kWarp] = au[i];
  };
  if (fwd) {
    if (h > 0)
      pass<false>(h, ls, lp, hist, off_b, post, B, tile,
                  [&](const StepIn<false>& in, float* hs, float*) {
                    gammas(m, in.s, in.p, gr);
                    keep(hs);
                    alpha_step(m, gr, an, au);
                  });
  } else {
    const long long u = T - 1;
    pass<false>(T - h, ls + u * B, lp + u * B, hist + u * tile, off_b, post, -(long long)B,
                -tile, [&](const StepIn<false>& in, float* hs, float*) {
                  gammas(m, in.s, in.p, gr);
                  keep(hs);
                  beta_step(m, gr, an, on2, on3, au, r2, r3);
                });
  }
  __syncthreads();
  if (fwd) {
    const long long u = h;
    pass<true>(T - h, ls + u * B, lp + u * B, hist + u * tile, off_f, post + u * B, B, tile,
               [&](const StepIn<true>& in, float*, float* po) {
                 gammas(m, in.s, in.p, gr);
                 const float v = posterior(m, au, gr, in.h[0], in.h[1], in.h[2], in.h[3]);
                 if (live && t == 0) *po = v;
                 alpha_step(m, gr, an, au);
               });
  } else if (h > 0) {
    const long long u = h - 1;
    pass<true>(h, ls + u * B, lp + u * B, hist + u * tile, off_b, post + u * B, -(long long)B,
               -tile, [&](const StepIn<true>& in, float*, float* po) {
                 gammas(m, in.s, in.p, gr);
                 const float av[4] = {in.h[0], in.h[1], in.h[2], in.h[3]};
                 const float v = posterior(m, av, gr, au[0], au[1], r3, r2);
                 if (live && t == 0) *po = v;
                 beta_step(m, gr, an, on2, on3, au, r2, r3);
               });
  }
}

}  // namespace

extern "C" int srcdsp_bcjr(const void* ls, const void* lp, void* post, void* hist, int T,
                           int B, int terminated, unsigned int c_mask, unsigned int par_mask,
                           void* stream) {
  if (T <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  bcjr_kernel<<<(B + kCw - 1) / kCw, 2 * kWarp, 0, (cudaStream_t)stream>>>(
      (const float*)ls, (const float*)lp, (float*)post, (float*)hist, T, B, terminated, c_mask,
      par_mask);
  return (int)cudaGetLastError();
}
