// Max-log BCJR for an 8-state RSC code (K16), meeting in the middle: an A/B
// variant of srcdsp_tpu_torch/csrc/bcjr.cu, built only by
// bench_torch/ab_bcjr.py (scratch: T * ceil(B / 32) * 256 floats).
//
// Replaces srcdsp_tpu/kernels/bcjr_pallas.py make_bcjr_kernel (the
// pallas_call at :175), which keeps [8, 128] state tiles of 128 codewords in
// VMEM and their beta history in scratch VMEM.
//
// What bounds it: about 16 operations per state and step against 12 bytes
// per step and codeword, so bytes; but each codeword's two recursions are a
// serial chain over its t steps, so the time of one step, times the steps on
// the chain, sets its time: the bytes bound is out of reach of any serial
// form. The design shortens the chain and the step:
//
// - One codeword a thread, its 8 state metrics in registers. Every code that
//   make_bcjr_kernel accepts has the trellis of make_rsc (turbo.py:49-84):
//   next[s, u] = ((u ^ f(s)) << 2) | (s >> 1), with f(2j + 1) = 1 - f(2j).
//   So the pair of states 2j, 2j + 1 feeds the pair j, 4 | j, and which edge
//   is which is one bit c_j = f(2j); the code shows only in c (4 bits) and in
//   par[s, 0] (8 bits), passed by value as select masks. Gathers are static
//   register indices and selects, the max over states a depth-3 fmaxf tree:
//   no shuffle, no local memory, one instantiation for every such code.
// - Meet in the middle. A block holds 32 codewords in two warps: warp 0 runs
//   the forward recursion, warp 1 the backward one. Phase 1: the forward warp
//   runs steps 0 .. h-1 and stores each step's un-normalized alpha, the
//   backward warp runs t-1 .. h and stores each step's un-normalized beta
//   (beta after the step), h = t/2. Phase 2, after one __syncthreads: the
//   forward warp runs h .. t-1 and writes post[u] from its own alpha and the
//   stored beta; the backward warp runs h-1 .. 0 and writes post[u] from the
//   stored alpha and its own beta. t steps on the chain instead of 2t.
// - No load on the chain. The block's ls and lp (2 x T x 32 floats) are
//   staged into shared memory first (cp.async, 16 bytes a copy where the
//   block's codewords are whole and aligned), where they fit kStageBytes
//   (T <= 800); a longer block reads them from device memory. The history
//   is tiles [t, G, 8, 32] (G blocks): a warp stores and loads 128
//   contiguous bytes a state at immediate offsets from one pointer. Every
//   pointer moves by a fixed step and every load is issued kQueue steps
//   before its use into a register queue: the addresses do not depend on
//   the recursion. Phase 2 runs a step's recursion before its posterior, so
//   the history load has the recursion's time to arrive. One step ahead is
//   enough; a deeper queue ran slower on the H100 (bench_torch/ab_bcjr.py:
//   q2, q4; nostage and postfirst for the other two choices).
//
// Bits: each recursion runs the operations of the one-state-a-lane body it
// replaced in the same order (gamma = 0.5*ls + (0.5*lp)*sg with sg = +-1,
// the second branch its exact negation; the recurrences carry the
// normalized metric, the posterior reads the un-normalized one and
// associates as (alpha + gamma) + beta[next]), every add, subtract and
// multiply an explicit __fadd_rn / __fsub_rn / __fmul_rn, and a max is exact
// in any order. So the kernel is bit for bit turbo.bcjr_decode_batch. The
// -1e30 sentinel stays finite. A lane past B runs codeword B-1, stores only
// into its own history tile and writes no posterior.
//
// kernels/bcjr_pallas.py bcjr_schedule mirrors this schedule in torch, and
// tests/test_torch_bcjr_kernel.py holds it to bcjr_decode_batch.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kWarp = 32;   // codewords a block: one warp forward, one backward
constexpr int kQueue = 1;   // steps a load is issued ahead of its use
constexpr size_t kStageBytes = 200 * 1024;  // ls and lp staged in shared memory up to this

// Select masks, ~0u where the bit is set: c[j] = f(2j), the successor bit
// of input 0 from state 2j; p[s] = par[s, 0], the sign of state s's gamma.
struct Masks {
  uint32_t c[4];
  uint32_t p[8];
};

// m ? a : b for a mask m of 0 or ~0u: one LOP3.
__device__ __forceinline__ float sel(uint32_t m, float a, float b) {
  return __int_as_float((int)((m & (uint32_t)__float_as_int(a)) |
                              (~m & (uint32_t)__float_as_int(b))));
}

__device__ __forceinline__ float max8(const float (&v)[8]) {
  return fmaxf(fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3])),
               fmaxf(fmaxf(v[4], v[5]), fmaxf(v[6], v[7])));
}

// gr[s] = 0.5*ls + (0.5*lp)*sg[s], sg[s] = 1 - 2*par[s, 0] = +-1.
__device__ __forceinline__ void gammas(const Masks& m, float l_s, float l_p, float (&gr)[8]) {
  const float hs = __fmul_rn(0.5f, l_s), hp = __fmul_rn(0.5f, l_p);
  const float gp = __fadd_rn(hs, hp), gm = __fadd_rn(hs, -hp);
#pragma unroll
  for (int s = 0; s < 8; ++s) gr[s] = sel(m.p[s], gm, gp);
}

// alpha'[s'] = max(alpha[prev0] + gr[prev0], alpha[prev1] - gr[prev1]):
// target j (a = 0) takes input 0 from 2j when c_j = 0, else from 2j + 1;
// target 4 | j the other way round. au: un-normalized, an: normalized.
__device__ __forceinline__ void alpha_step(const Masks& m, const float (&gr)[8], float (&an)[8],
                                           float (&au)[8]) {
  float av[8], bv[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    av[s] = __fadd_rn(an[s], gr[s]);
    bv[s] = __fadd_rn(an[s], -gr[s]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float x = fmaxf(av[2 * j], bv[2 * j + 1]);
    const float y = fmaxf(av[2 * j + 1], bv[2 * j]);
    au[j] = sel(m.c[j], y, x);
    au[4 + j] = sel(m.c[j], x, y);
  }
  const float mx = max8(au);
#pragma unroll
  for (int s = 0; s < 8; ++s) an[s] = __fsub_rn(au[s], mx);
}

// beta'[s] = max(gr[s] + beta[next0(s)], -gr[s] + beta[next1(s)]): next0(2j)
// = next1(2j + 1) = c_j ? 4 | j : j, the other successor the other way.
__device__ __forceinline__ void beta_step(const Masks& m, const float (&gr)[8], float (&bn)[8],
                                          float (&bu)[8]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float p = sel(m.c[j], bn[4 + j], bn[j]);
    const float q = sel(m.c[j], bn[j], bn[4 + j]);
    bu[2 * j] = fmaxf(__fadd_rn(gr[2 * j], p), __fadd_rn(-gr[2 * j], q));
    bu[2 * j + 1] = fmaxf(__fadd_rn(gr[2 * j + 1], q), __fadd_rn(-gr[2 * j + 1], p));
  }
  const float mx = max8(bu);
#pragma unroll
  for (int s = 0; s < 8; ++s) bn[s] = __fsub_rn(bu[s], mx);
}

// max_s (au + gr) + bt[next0] - max_s (au - gr) + bt[next1].
__device__ __forceinline__ float posterior(const Masks& m, const float (&au)[8],
                                           const float (&gr)[8], const float (&bt)[8]) {
  float v0[8], v1[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float p = sel(m.c[j], bt[4 + j], bt[j]);
    const float q = sel(m.c[j], bt[j], bt[4 + j]);
    v0[2 * j] = __fadd_rn(__fadd_rn(au[2 * j], gr[2 * j]), p);
    v1[2 * j] = __fadd_rn(__fadd_rn(au[2 * j], -gr[2 * j]), q);
    v0[2 * j + 1] = __fadd_rn(__fadd_rn(au[2 * j + 1], gr[2 * j + 1]), q);
    v1[2 * j + 1] = __fadd_rn(__fadd_rn(au[2 * j + 1], -gr[2 * j + 1]), p);
  }
  return __fsub_rn(max8(v0), max8(v1));
}

// One step's inputs: ls and lp, and with H the 8 stored metrics of the other
// recursion.
template <bool H>
struct StepIn {
  float s, p, h[H ? 8 : 1];
};

// One pass of n >= 1 steps k = 0 .. n-1: step(in, hs, po) with in = the
// step's inputs, hs its history tile and po its posterior. The pointers
// start at the pass's first step and move by dq (ls, lp), dh (the history)
// and dp (post) a step. Each load is issued kQueue steps ahead into a
// register queue (static slots: the inner loop unrolls).
template <bool H, class Step>
__device__ __forceinline__ void pass(int n, const float* ql, const float* qp, long long dq,
                                     float* hs, long long dh, float* po, long long dp,
                                     Step step) {
  const float* qh = hs;
  auto load = [&](StepIn<H>& v) {
    v.s = *ql;
    v.p = *qp;
    if constexpr (H) {
#pragma unroll
      for (int s = 0; s < 8; ++s) v.h[s] = qh[s * kWarp];
    }
    ql += dq;
    qp += dq;
    qh += dh;
  };
  StepIn<H> q[kQueue];
#pragma unroll
  for (int d = 0; d < kQueue; ++d)
    if (d < n) load(q[d]);
  for (int k0 = 0; k0 < n; k0 += kQueue) {
#pragma unroll
    for (int d = 0; d < kQueue; ++d) {
      const int k = k0 + d;
      if (k < n) {
        const StepIn<H> in = q[d];
        if (k + kQueue < n) load(q[d]);
        step(in, hs, po);
        hs += dh;
        po += dp;
      }
    }
  }
}

__device__ __forceinline__ void cp_async(float* dst, const float* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src));
}

// The block's ls and lp, [T][32] each, into shared memory: 16-byte copies
// where the block's 32 codewords are whole and 16-byte aligned, else one
// float a copy (a lane past B copies codeword B-1).
__device__ __forceinline__ void stage_inputs(const float* ls, const float* lp, int T, int B,
                                             float* st) {
  const long long c0 = (long long)blockIdx.x * kWarp;
  const uintptr_t at = reinterpret_cast<uintptr_t>(ls) | reinterpret_cast<uintptr_t>(lp);
  const bool wide = c0 + kWarp <= B && (B & 3) == 0 && (at & 15) == 0;
  for (int a = 0; a < 2; ++a) {
    const float* x = (a ? lp : ls) + c0;
    float* s = st + (long long)a * T * kWarp;
    if (wide) {
      for (int i = threadIdx.x; i < T * (kWarp / 4); i += blockDim.x) {
        const int u = i / (kWarp / 4), q = i % (kWarp / 4);
        cp_async(s + u * kWarp + 4 * q, x + (long long)u * B + 4 * q, 16);
      }
    } else {
      const int l = threadIdx.x & (kWarp - 1);
      const long long c = c0 + l < B ? l : B - 1 - c0;
      for (int u = threadIdx.x / kWarp; u < T; u += blockDim.x / kWarp)
        cp_async(s + u * kWarp + l, x + (long long)u * B + c, 4);
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
}

// ls, lp, post [T, B]; hist [T, G, 8, 32] scratch, G = gridDim.x (alpha of
// steps < h, beta of steps >= h; the tile of step u and block g at (u*G +
// g)*256, state s of lane l at s*32 + l, so a warp stores and loads 128
// contiguous bytes a state at immediate offsets). Blocks of 2 warps, 32
// codewords; a lane past B reads codeword B-1 and stores only into its tile.
// STAGE: ls and lp read from shared memory, staged by stage_inputs.
template <bool STAGE>
__global__ void __launch_bounds__(2 * kWarp) bcjr_kernel(const float* __restrict__ ls,
                                                         const float* __restrict__ lp,
                                                         float* __restrict__ post, float* hist,
                                                         int T, int B, int terminated, Masks m) {
  const bool fwd = threadIdx.x < kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  const long long b = (long long)blockIdx.x * kWarp + lane;
  const bool live = b < B;
  const long long bl = live ? b : B - 1;
  const long long tile = (long long)gridDim.x * 8 * kWarp;
  const float* xs;  // this lane's ls and lp of step 0, dq apart a step
  const float* xp;
  long long dq;
  if constexpr (STAGE) {
    extern __shared__ float staged[];
    stage_inputs(ls, lp, T, B, staged);
    xs = staged + lane;
    xp = xs + (long long)T * kWarp;
    dq = kWarp;
  } else {
    xs = ls + bl;
    xp = lp + bl;
    dq = B;
  }
  post += bl;
  hist += (long long)blockIdx.x * 8 * kWarp + lane;
  const long long dp = B;
  const int h = T / 2;
  // the metric carried (an, normalized) and the step's output (au); forward
  // alpha from state 0, backward beta from state 0 when terminated, else 0
  float gr[8], an[8], au[8];
  const bool from_zero = fwd || terminated;
#pragma unroll
  for (int s = 0; s < 8; ++s) an[s] = au[s] = s == 0 || !from_zero ? 0.f : kNeg;
  auto keep = [&](float* hs) {
#pragma unroll
    for (int s = 0; s < 8; ++s) hs[s * kWarp] = au[s];
  };
  // phase 1: alpha of steps 0 .. h-1 / beta of steps T-1 .. h into hist
  if (fwd) {
    if (h > 0)
      pass<false>(h, xs, xp, dq, hist, tile, post, dp,
                  [&](const StepIn<false>& in, float* hs, float*) {
                    gammas(m, in.s, in.p, gr);
                    keep(hs);
                    alpha_step(m, gr, an, au);
                  });
  } else {
    const long long u = T - 1;
    pass<false>(T - h, xs + u * dq, xp + u * dq, -dq, hist + u * tile, -tile, post, -dp,
                [&](const StepIn<false>& in, float* hs, float*) {
                  gammas(m, in.s, in.p, gr);
                  keep(hs);
                  beta_step(m, gr, an, au);
                });
  }
  __syncthreads();
  // phase 2: the posteriors of steps h .. T-1 / h-1 .. 0, each after its
  // step's recursion (from a copy of the metric it started from)
  float prev[8];
  if (fwd) {
    const long long u = h;
    pass<true>(T - h, xs + u * dq, xp + u * dq, dq, hist + u * tile, tile, post + u * dp, dp,
               [&](const StepIn<true>& in, float*, float* po) {
                 gammas(m, in.s, in.p, gr);
#pragma unroll
                 for (int s = 0; s < 8; ++s) prev[s] = au[s];
                 alpha_step(m, gr, an, au);
                 const float v = posterior(m, prev, gr, in.h);
                 if (live) *po = v;
               });
  } else if (h > 0) {
    const long long u = h - 1;
    pass<true>(h, xs + u * dq, xp + u * dq, -dq, hist + u * tile, -tile, post + u * dp, -dp,
               [&](const StepIn<true>& in, float*, float* po) {
                 gammas(m, in.s, in.p, gr);
#pragma unroll
                 for (int s = 0; s < 8; ++s) prev[s] = au[s];
                 beta_step(m, gr, an, au);
                 const float v = posterior(m, in.h, gr, prev);
                 if (live) *po = v;
               });
  }
}

}  // namespace

// c_mask: bit j = f(2j) (j < 4); par_mask: bit s = par[s, 0] (s < 8). hist:
// scratch of T * ceil(B / 32) * 256 f32. Returns the launch's cudaError_t as
// an int (0 on success).
extern "C" int srcdsp_bcjr(const void* ls, const void* lp, void* post, void* hist, int T,
                           int B, int terminated, unsigned int c_mask, unsigned int par_mask,
                           void* stream) {
  if (T <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  Masks m;
  for (int j = 0; j < 4; ++j) m.c[j] = (c_mask >> j) & 1 ? ~0u : 0u;
  for (int s = 0; s < 8; ++s) m.p[s] = (par_mask >> s) & 1 ? ~0u : 0u;
  const unsigned grid = (unsigned)((B + kWarp - 1) / kWarp);
  const size_t smem = (size_t)2 * T * kWarp * sizeof(float);
  if (smem <= kStageBytes) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          bcjr_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    bcjr_kernel<true><<<grid, 2 * kWarp, smem, (cudaStream_t)stream>>>(
        (const float*)ls, (const float*)lp, (float*)post, (float*)hist, T, B, terminated, m);
  } else {
    bcjr_kernel<false><<<grid, 2 * kWarp, 0, (cudaStream_t)stream>>>(
        (const float*)ls, (const float*)lp, (float*)post, (float*)hist, T, B, terminated, m);
  }
  return (int)cudaGetLastError();
}
