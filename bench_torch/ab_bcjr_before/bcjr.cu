// Max-log BCJR for an 8-state RSC code (K16).
//
// Replaces srcdsp_tpu/kernels/bcjr_pallas.py make_bcjr_kernel (the
// pallas_call at :175), which keeps [8, 128] state tiles of 128 codewords in
// VMEM and their beta history in scratch VMEM. Here 8 lanes of a warp hold
// one codeword, lane s its state s: a trellis step reads the predecessor or
// successor states with __shfl_sync inside the 8-lane group and takes the
// max over states with three xor-shuffles. One block of 32 threads holds 4
// codewords, so B = 256 spreads over 64 SMs. The backward pass writes the
// UN-normalized beta of every step to a scratch [t, B, 8] (8 lanes of a
// codeword store 32 contiguous bytes) and carries the normalized one; the
// forward pass carries alpha both normalized (recurrence) and un-normalized
// (posterior), exactly as the reference does. gamma = 0.5*ls + (0.5*lp)*sg
// and the second branch is its exact negation; the posterior associates as
// (alpha + gamma) + beta[next]; every add is an explicit __fadd_rn, so the
// kernel is bit for bit turbo.bcjr_decode_batch. The -1e30 sentinel stays
// finite. A t that is not a multiple of 8 needs no padding.
//
// What bounds it: about 16 operations per state and step against 12 bytes
// per step and codeword, so bytes; but the two passes are a serial chain of
// dependent shuffles and loads over t, so the latency of one step, times 2t,
// sets its time.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e30f;

struct Trellis {
  int nxt0[8], nxt1[8], prev0[8], prev1[8];
  float sg[8];  // 1 - 2*par[s, 0]
};

__device__ __forceinline__ float max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1, 8));
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 2, 8));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 4, 8));
}

// ls, lp, post [T, B]; betas [T, B, 8] scratch.
__global__ void bcjr_kernel(const float* __restrict__ ls, const float* __restrict__ lp,
                            float* __restrict__ post, float* __restrict__ betas, int T, int B,
                            int terminated, Trellis tr) {
  const int s = threadIdx.x & 7;
  const long long b = (long long)blockIdx.x * (blockDim.x >> 3) + (threadIdx.x >> 3);
  const bool live = b < B;
  const float sg = tr.sg[s];
  const int n0 = tr.nxt0[s], n1 = tr.nxt1[s], p0 = tr.prev0[s], p1 = tr.prev1[s];
  const float start = s == 0 ? 0.f : kNeg;

  // backward: betas[u] = beta after step u (bN at u = T-1)
  float beta_store = terminated ? start : 0.f;
  float beta_n = beta_store;
  for (int u = T - 1; u >= 0; --u) {
    const long long i = (long long)u * B + b;
    if (live) betas[i * 8 + s] = beta_store;
    const float l_s = live ? ls[i] : 0.f, l_p = live ? lp[i] : 0.f;
    const float gr = __fadd_rn(__fmul_rn(0.5f, l_s), __fmul_rn(__fmul_rn(0.5f, l_p), sg));
    const float x0 = __shfl_sync(kFull, beta_n, n0, 8);
    const float x1 = __shfl_sync(kFull, beta_n, n1, 8);
    const float nb = fmaxf(__fadd_rn(gr, x0), __fadd_rn(-gr, x1));
    beta_store = nb;
    beta_n = __fsub_rn(nb, max8(nb));
  }

  // forward + posterior
  float alpha_u = start, alpha_n = start;
  for (int u = 0; u < T; ++u) {
    const long long i = (long long)u * B + b;
    const float bt = live ? betas[i * 8 + s] : 0.f;
    const float l_s = live ? ls[i] : 0.f, l_p = live ? lp[i] : 0.f;
    const float gr = __fadd_rn(__fmul_rn(0.5f, l_s), __fmul_rn(__fmul_rn(0.5f, l_p), sg));
    const float b0 = __shfl_sync(kFull, bt, n0, 8);
    const float b1 = __shfl_sync(kFull, bt, n1, 8);
    const float m0 = max8(__fadd_rn(__fadd_rn(alpha_u, gr), b0));
    const float m1 = max8(__fadd_rn(__fadd_rn(alpha_u, -gr), b1));
    if (live && s == 0) post[i] = __fsub_rn(m0, m1);
    const float av = __fadd_rn(alpha_n, gr), bv = __fadd_rn(alpha_n, -gr);
    const float na = fmaxf(__shfl_sync(kFull, av, p0, 8), __shfl_sync(kFull, bv, p1, 8));
    alpha_u = na;
    alpha_n = __fsub_rn(na, max8(na));
  }
}

}  // namespace

// tables: host int32 [32] = next0, next1, prev0, prev1 (8 each); sg: host
// float [8]. Returns the launch's cudaError_t as an int (0 on success).
extern "C" int srcdsp_bcjr(const void* ls, const void* lp, void* post, void* betas, int T,
                           int B, int terminated, const void* tables, const void* sg,
                           void* stream) {
  Trellis tr;
  const int32_t* tab = (const int32_t*)tables;
  for (int s = 0; s < 8; ++s) {
    tr.nxt0[s] = tab[s];
    tr.nxt1[s] = tab[8 + s];
    tr.prev0[s] = tab[16 + s];
    tr.prev1[s] = tab[24 + s];
    tr.sg[s] = ((const float*)sg)[s];
  }
  const int per_block = 4;  // codewords per 32-thread block
  bcjr_kernel<<<(B + per_block - 1) / per_block, 8 * per_block, 0, (cudaStream_t)stream>>>(
      (const float*)ls, (const float*)lp, (float*)post, (float*)betas, T, B, terminated, tr);
  return (int)cudaGetLastError();
}
