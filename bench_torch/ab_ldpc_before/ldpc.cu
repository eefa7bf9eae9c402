// LDPC normalized min-sum decoders: K14 (edge-form flooding on the bf16 grid)
// and K15 (quasi-cyclic layered).
//
// K14 replaces srcdsp_tpu/kernels/ldpc_pallas.py make_ldpc_kernel /
// make_ldpc_decoder (the pallas_call sites at :297 and :358). The TPU kernel
// keeps the edge messages of 128 codewords in VMEM as [slot, lane] planes and
// moves them between row and column order with a 0/1 permutation matmul.
// Here one block decodes one codeword: its dv*N_pad column-slot and dc*M_pad
// row-slot messages and the plan's index tables sit in shared memory (27 kB
// at n = 504), the permutation is a gather through the tables, and the
// iterations run inside the kernel with a barrier between the variable and
// the check phase. Every message is rounded to the bf16 grid
// (__float2bfloat16_rn, round to nearest even) exactly where the reference
// rounds, and every product and sum is an explicit __fmul_rn/__fadd_rn/
// __fsub_rn, so nvcc cannot contract them and the posterior is bit for bit
// the plain ldpc_decode_edges_ref. What bounds it: about 12 operations per
// edge and iteration against 8 bytes in and out per bit, so operations; this
// simple form is set by its shared-memory gathers and two barriers per
// iteration, not by either bound.
//
// K15 replaces make_qc_kernel / make_qc_decoder / make_qc_decoder_t (:527,
// :568, :611). The TPU kernel rolls [z, 128] slabs along sublanes. Here a
// block holds the posteriors [n][cw] and the c2v messages [n_blocks*z][cw]
// of cw codewords in shared memory (cw = 4 at z = 128: 108.5 kB); one thread
// per (check row r, codeword) walks the layers serially, one barrier per
// layer. Within a layer the z rows touch disjoint columns: row r reads
// block-column j at row (r + s) mod z and adds its delta back there, so no
// two threads meet. The min/sign exclusion is a two-pass min1/min2/parity
// selection (exact, like the reference's prefix/suffix trees); every
// product and difference is an explicit __fmul_rn/__fsub_rn/__fadd_rn, so
// the kernel is bit for bit the plain qc_decode_layered_ref. What bounds
// it: about 12 operations per edge and iteration, so operations; this form
// spends its time on shared-memory traffic and the per-layer barriers.
#include "fsk_common.cuh"

using namespace srcdsp;

namespace {

constexpr float kBig = 1e30f;

__device__ __forceinline__ float kInf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float q_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// llr [n, B] column-major; post [n, B]. Shared memory: lf [n_pad], V [dv*n_pad]
// (quantized v2c per column slot), R [dc*m_pad] (c2v per row slot), then the
// int tables row_src [dc*m_pad] and col_src [dv*n_pad].
__global__ void ldpc_edges_kernel(const float* __restrict__ llr,
                                  const int32_t* __restrict__ row_src,
                                  const int32_t* __restrict__ col_src,
                                  float* __restrict__ post, int n, int n_pad, int m_pad,
                                  int dv, int dc, int B, int iters, float alpha) {
  extern __shared__ float smem[];
  float* lf = smem;
  float* V = lf + n_pad;
  float* R = V + dv * n_pad;
  int32_t* rs = reinterpret_cast<int32_t*>(R + dc * m_pad);
  int32_t* cs = rs + dc * m_pad;
  const int b = blockIdx.x;
  const int e_row = dc * m_pad, e_col = dv * n_pad;

  for (int i = threadIdx.x; i < n_pad; i += blockDim.x)
    lf[i] = i < n ? q_bf16(llr[(long long)i * B + b]) : 0.f;
  for (int e = threadIdx.x; e < e_row; e += blockDim.x) {
    R[e] = 0.f;
    rs[e] = row_src[e];
  }
  for (int e = threadIdx.x; e < e_col; e += blockDim.x) cs[e] = col_src[e];
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    // variable phase: post = lf + c_0 + ... + c_{dv-1}; v_j = q(post - c_j)
    for (int i = threadIdx.x; i < n_pad; i += blockDim.x) {
      float p = lf[i];
      for (int j = 0; j < dv; ++j) {
        const int src = cs[j * n_pad + i];
        p = __fadd_rn(p, src >= 0 ? R[src] : 0.f);
      }
      for (int j = 0; j < dv; ++j) {
        const int src = cs[j * n_pad + i];
        V[j * n_pad + i] = q_bf16(__fsub_rn(p, src >= 0 ? R[src] : 0.f));
      }
    }
    __syncthreads();
    // check phase: exclusive min / sign over the row's dc slots (empty slots
    // count as magnitude BIG and sign +1), c = q((alpha*es)*em)
    for (int r = threadIdx.x; r < m_pad; r += blockDim.x) {
      float min1 = kInf(), min2 = kInf();
      int arg1 = -1;
      bool parity = false;
      for (int d = 0; d < dc; ++d) {
        const int src = rs[d * m_pad + r];
        const float v = src >= 0 ? V[src] : 0.f;
        const float mag = src >= 0 ? fabsf(v) : kBig;
        if (mag < min1) {
          min2 = min1;
          min1 = mag;
          arg1 = d;
        } else if (mag < min2) {
          min2 = mag;
        }
        parity ^= (src >= 0 && v < 0.f);
      }
      for (int d = 0; d < dc; ++d) {
        const int e = d * m_pad + r;
        const int src = rs[e];
        float c = 0.f;
        if (src >= 0) {
          const bool neg = V[src] < 0.f;
          const float es = (parity != neg) ? -1.f : 1.f;
          const float em = d == arg1 ? min2 : min1;
          c = em >= kBig ? 0.f : q_bf16(__fmul_rn(__fmul_rn(alpha, es), em));
        }
        R[e] = c;
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float p = lf[i];
    for (int j = 0; j < dv; ++j) {
      const int src = cs[j * n_pad + i];
      p = __fadd_rn(p, src >= 0 ? R[src] : 0.f);
    }
    post[(long long)i * B + b] = p;
  }
}

// llr [n, B] column-major with n = nb*z; post [n, B]. Layer l covers slabs
// starts[l] .. starts[l+1]-1, slab e being block-column cols[e] at shift
// shifts[e]. Shared memory: posteriors [n][cw], messages [n_blocks*z][cw].
__global__ void ldpc_qc_kernel(const float* __restrict__ llr, const int32_t* __restrict__ starts,
                               const int32_t* __restrict__ cols,
                               const int32_t* __restrict__ shifts, float* __restrict__ post,
                               int n_layers, int z, int nb, int n_blocks, int B, int iters,
                               int cw, float alpha) {
  extern __shared__ float smem[];
  const int n = nb * z;
  float* ps = smem;
  float* msg = smem + n * cw;
  const int b0 = blockIdx.x * cw;

  for (int e = threadIdx.x; e < n * cw; e += blockDim.x) {
    const int row = e / cw, b = b0 + e % cw;
    ps[e] = b < B ? llr[(long long)row * B + b] : 0.f;
  }
  for (int e = threadIdx.x; e < n_blocks * z * cw; e += blockDim.x) msg[e] = 0.f;
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    for (int l = 0; l < n_layers; ++l) {
      const int s0 = starts[l], s1 = starts[l + 1];
      for (int t = threadIdx.x; t < z * cw; t += blockDim.x) {
        const int b = t % cw, r = t / cw;
        float min1 = kInf(), min2 = kInf();
        int arg1 = -1;
        bool parity = false;
        for (int e = s0; e < s1; ++e) {
          const int rr = r + shifts[e];
          const int col = cols[e] * z + (rr >= z ? rr - z : rr);
          const float v = __fsub_rn(ps[col * cw + b], msg[(e * z + r) * cw + b]);
          const float mag = fabsf(v);
          if (mag < min1) {
            min2 = min1;
            min1 = mag;
            arg1 = e;
          } else if (mag < min2) {
            min2 = mag;
          }
          parity ^= v < 0.f;
        }
        for (int e = s0; e < s1; ++e) {
          const int rr = r + shifts[e];
          const int col = cols[e] * z + (rr >= z ? rr - z : rr);
          const int mi = (e * z + r) * cw + b;
          const float p = ps[col * cw + b];
          const float old = msg[mi];
          const bool neg = __fsub_rn(p, old) < 0.f;
          const float es = (parity != neg) ? -1.f : 1.f;
          const float nw = __fmul_rn(__fmul_rn(alpha, es), e == arg1 ? min2 : min1);
          ps[col * cw + b] = __fadd_rn(p, __fsub_rn(nw, old));
          msg[mi] = nw;
        }
      }
      __syncthreads();
    }
  }
  for (int e = threadIdx.x; e < n * cw; e += blockDim.x) {
    const int row = e / cw, b = b0 + e % cw;
    if (b < B) post[(long long)row * B + b] = ps[e];
  }
}

}  // namespace

// Each entry point returns the launch's cudaError_t as an int (0 on success).
extern "C" int srcdsp_ldpc_edges(const void* llr, const void* row_src, const void* col_src,
                                 void* post, int n, int n_pad, int m_pad, int dv, int dc,
                                 int B, int iters, float alpha, void* stream) {
  const size_t smem = (size_t)(n_pad + 2 * dv * n_pad + 2 * dc * m_pad) * sizeof(float);
  cudaError_t err = allow_smem(ldpc_edges_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ldpc_edges_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)llr, (const int32_t*)row_src, (const int32_t*)col_src, (float*)post, n,
      n_pad, m_pad, dv, dc, B, iters, alpha);
  return (int)cudaGetLastError();
}

extern "C" int srcdsp_ldpc_qc(const void* llr, const void* starts, const void* cols,
                              const void* shifts, void* post, int n_layers, int z, int nb,
                              int n_blocks, int B, int iters, int cw, float alpha,
                              void* stream) {
  const size_t smem = (size_t)(nb + n_blocks) * z * cw * sizeof(float);
  cudaError_t err = allow_smem(ldpc_qc_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int threads = z * cw < 1024 ? z * cw : 1024;
  threads = (threads + 31) / 32 * 32;
  ldpc_qc_kernel<<<(B + cw - 1) / cw, threads, smem, (cudaStream_t)stream>>>(
      (const float*)llr, (const int32_t*)starts, (const int32_t*)cols, (const int32_t*)shifts,
      (float*)post, n_layers, z, nb, n_blocks, B, iters, cw, alpha);
  return (int)cudaGetLastError();
}
