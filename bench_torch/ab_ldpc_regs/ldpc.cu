// An A/B variant of srcdsp_tpu_torch/csrc/ldpc.cu, built only by
// bench_torch/ab_ldpc.py: the same file, with K15's check state kept in
// registers as well (State::kRegisters: at most kRegLayers layers of degree
// <= 16, a row a thread, the layer loop unrolled), dispatched for state 2.
// Bits equal to the shipped body; it ran no faster on the phase-3 code, and
// spills at 4 codewords a thread.
//
// LDPC normalized min-sum decoders: K14 (edge-form flooding on the bf16 grid)
// and K15 (quasi-cyclic layered).
//
// K14 replaces srcdsp_tpu/kernels/ldpc_pallas.py make_ldpc_kernel /
// make_ldpc_decoder (the pallas_call sites at :297 and :358). The TPU kernel
// keeps the edge messages of 128 codewords in VMEM as [slot, lane] planes and
// moves them between row and column order with a 0/1 permutation matmul.
// Here a block decodes CW codewords, the codeword the fastest index of every
// shared array: lf and the posteriors [N_pad][CW] and the check-to-variable
// messages by column slot Rc [dv][N_pad][CW] (10 kB a codeword at n = 504,
// dv = 3). A thread owns CPT codewords of one check row at a time: it reads
// the posterior of each of the row's columns and its own old message in that
// column's slot, forms v = q(post - c_old), which is exactly the reference's
// v2c message in that slot (so no V array and no row-slot copy exist), runs
// the min/sign exclusion and writes each new message back to its column slot,
// as +-q(alpha*em) from the signs of v kept in a mask (a row of degree over
// 32 forms v again). The variable phase then sums lf + Rc[0] + ... +
// Rc[dv-1] a column. The row tables are read from device memory ([dc][M_pad]
// pairs, L1-resident), not copied into each block. Every message is rounded
// to the bf16 grid (__float2bfloat16_rn, round to nearest even) exactly where
// the reference rounds, and every product and sum is an explicit
// __fmul_rn/__fadd_rn/__fsub_rn, so nvcc cannot contract them and the
// posterior is bit for bit the plain ldpc_decode_edges_ref. What bounds it:
// about 12 operations per edge and iteration against 8 bytes in and out per
// bit, so operations; its time is the instructions of the check phase (about
// 15 an edge and codeword) and the two barriers an iteration.
//
// K15 replaces make_qc_kernel / make_qc_decoder / make_qc_decoder_t (:527,
// :568, :611). The TPU kernel rolls [z, 128] slabs along sublanes. Here a
// block holds the posteriors [n][cw] of cw codewords in shared memory; a
// thread owns CPT codewords of check row r and walks the layers serially, one
// barrier a layer. Within a layer the z rows touch disjoint columns: row r
// reads block-column j at row (r + s) mod z and adds its delta back there, so
// no two threads meet. The old messages of a row are never stored: min-sum
// rebuilds all of them from a compressed check state, a1 = alpha*min1 and
// a2 = alpha*min2 (__fmul_rn), the index of the first minimum and the sign
// bits of the row's messages, old_d = +-(d == arg ? a2 : a1). That is bit for
// bit __fmul_rn(__fmul_rn(alpha, es), em), since alpha*(+-1) is exact and
// rounding to nearest is symmetric (also for -0.0). The state is 12 bytes a
// (layer, row, codeword) for layer degrees up to 16 (4 more per further 16
// edges), against 4 bytes an edge for the messages; it lives in shared
// memory, or in device memory where a codeword's does not fit. Each layer's
// slabs are staged once a block as byte offsets (column base, shift), read
// at a warp-uniform index, and the next edge's posteriors are loaded before
// the current edge's math. The min/sign exclusion is a two-pass
// min1/min2/parity selection (exact, like the reference's prefix/suffix
// trees); every product and difference is an explicit
// __fmul_rn/__fsub_rn/__fadd_rn, so the kernel is bit for bit the plain
// qc_decode_layered_ref. What bounds it: about 12 operations per edge and
// iteration, so operations; this form issues about 30 instructions an edge
// and codeword (rebuilding each old message twice, addressing, the sign
// masks) at 16 warps an SM, as many as the 12 kB of shared memory a codeword
// allows.
#include "fsk_common.cuh"

using namespace srcdsp;

namespace {

constexpr float kBig = 1e30f;
constexpr int kChunk = 16;      // edges of a row whose sign bits share a state word
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float kInf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float q_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// N consecutive 32-bit values (float or uint32_t) as one shared or global
// access; p aligned to 4N bytes.
template <typename T, int N> struct VecOf;
template <> struct VecOf<float, 2> { using type = float2; };
template <> struct VecOf<float, 4> { using type = float4; };
template <> struct VecOf<uint32_t, 2> { using type = uint2; };
template <> struct VecOf<uint32_t, 4> { using type = uint4; };

template <int N, typename T>
__device__ __forceinline__ void ld(const T* p, T (&v)[N]) {
  if constexpr (N == 1) {
    v[0] = p[0];
  } else {
    const auto w = *reinterpret_cast<const typename VecOf<T, N>::type*>(p);
    v[0] = w.x;
    v[1] = w.y;
    if constexpr (N == 4) {
      v[2] = w.z;
      v[3] = w.w;
    }
  }
}

template <int N, typename T>
__device__ __forceinline__ void st(T* p, const T (&v)[N]) {
  using V = typename VecOf<T, N == 1 ? 2 : N>::type;
  if constexpr (N == 1) {
    p[0] = v[0];
  } else if constexpr (N == 2) {
    *reinterpret_cast<V*>(p) = V{v[0], v[1]};
  } else {
    *reinterpret_cast<V*>(p) = V{v[0], v[1], v[2], v[3]};
  }
}

// The strict-< first/second minimum and its index over a row's slots, in
// slot order (ties keep the first), as the reference's prefix/suffix
// selections give; selects, not branches.
__device__ __forceinline__ void take_min(float mag, int d, float& min1, float& min2, int& arg) {
  const bool lt1 = mag < min1, lt2 = mag < min2;
  min2 = lt1 ? min1 : lt2 ? mag : min2;
  min1 = lt1 ? mag : min1;
  arg = lt1 ? d : arg;
}

// mag with its sign bit flipped where bit dd of word is set (exact: a
// negation).
__device__ __forceinline__ float with_sign(float mag, uint32_t word, int dd) {
  return __uint_as_float(__float_as_uint(mag) ^ ((word << (31 - dd)) & 0x80000000u));
}

// A block's tile [rows][cw] of a column-major [rows, B] array (codewords b0
// .. b0+cw-1) to and from shared memory, 2^v_log2 floats an access (the
// launch picks the widest that B and the pointers allow); rows from
// rows_in on, and codewords from B on, read as 0 and are not written.
template <bool kQuant>
__device__ __forceinline__ void tile_in(float* t, const float* __restrict__ x, int rows,
                                        int rows_in, int cw_log2, int v_log2, int b0, int B) {
  const int per_log2 = cw_log2 - v_log2, total = rows << per_log2;
#pragma unroll 4
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int row = e >> per_log2, o = (e & ((1 << per_log2) - 1)) << v_log2;
    const bool in = row < rows_in && b0 + o < B;
    const float* src = x + (long long)row * B + b0 + o;
    float* dst = t + (row << cw_log2) + o;
    if (v_log2 == 2) {
      float4 v = in ? *reinterpret_cast<const float4*>(src) : make_float4(0.f, 0.f, 0.f, 0.f);
      if (kQuant) v = make_float4(q_bf16(v.x), q_bf16(v.y), q_bf16(v.z), q_bf16(v.w));
      *reinterpret_cast<float4*>(dst) = v;
    } else if (v_log2 == 1) {
      float2 v = in ? *reinterpret_cast<const float2*>(src) : make_float2(0.f, 0.f);
      if (kQuant) v = make_float2(q_bf16(v.x), q_bf16(v.y));
      *reinterpret_cast<float2*>(dst) = v;
    } else {
      const float v = in ? src[0] : 0.f;
      dst[0] = kQuant ? q_bf16(v) : v;
    }
  }
}

__device__ __forceinline__ void tile_out(float* __restrict__ y, const float* t, int rows,
                                         int cw_log2, int v_log2, int b0, int B) {
  const int per_log2 = cw_log2 - v_log2, total = rows << per_log2;
#pragma unroll 4
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int row = e >> per_log2, o = (e & ((1 << per_log2) - 1)) << v_log2;
    if (b0 + o >= B) continue;
    float* dst = y + (long long)row * B + b0 + o;
    const float* src = t + (row << cw_log2) + o;
    if (v_log2 == 2)
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    else if (v_log2 == 1)
      *reinterpret_cast<float2*>(dst) = *reinterpret_cast<const float2*>(src);
    else
      dst[0] = src[0];
  }
}

// The widest access (log2 floats, up to 4 and cw) that B and both pointers
// allow.
inline int tile_vec_log2(const void* x, const void* y, int B, int cw) {
  const uintptr_t a = (uintptr_t)x | (uintptr_t)y;
  if (cw >= 4 && B % 4 == 0 && a % 16 == 0) return 2;
  if (cw >= 2 && B % 2 == 0 && a % 8 == 0) return 1;
  return 0;
}

// llr [n, B] column-major; post [n, B]. row_edges [dc][m_pad]: slot d of row
// r as (column, column slot j*n_pad + column), (-1, -1) where the row has no
// d-th edge. Shared memory: lf [n_pad][CW], posteriors [n_pad][CW], Rc
// [dv][n_pad][CW]. Threads: G = CW / CPT a row or column, the rows and then
// the columns spread over the block.
template <int CW, int CPT>
__global__ void __launch_bounds__(kMaxThreads, 1)
    ldpc_edges_kernel(const float* __restrict__ llr, const int2* __restrict__ row_edges,
                      float* __restrict__ post, int n, int n_pad, int m, int m_pad, int dv,
                      int dc, int B, int iters, float alpha, int v_log2) {
  static_assert(CW % CPT == 0, "a thread's codewords divide the block's");
  constexpr int G = CW / CPT;
  constexpr int kCwLog2 = CW == 8 ? 3 : CW == 4 ? 2 : CW == 2 ? 1 : 0;
  extern __shared__ __align__(16) float smem[];
  float* lf = smem;
  float* ps = lf + n_pad * CW;
  float* rc = ps + n_pad * CW;
  const int tid = threadIdx.x, b0 = blockIdx.x * CW;
  const int g = tid % G, u0 = tid / G, stride = blockDim.x / G;

  tile_in<true>(lf, llr, n_pad, n, kCwLog2, v_log2, b0, B);
  for (int e = tid; e < dv * n_pad * CW; e += blockDim.x) rc[e] = 0.f;
  __syncthreads();

  for (int it = 0;; ++it) {
    // variable phase: post = lf + c_0 + ... + c_{dv-1} (an empty slot holds 0)
    for (int i = u0; i < n; i += stride) {
      const int o = i * CW + g * CPT;
      float p[CPT];
      ld(lf + o, p);
      for (int j = 0; j < dv; ++j) {
        float c[CPT];
        ld(rc + j * n_pad * CW + o, c);
#pragma unroll
        for (int k = 0; k < CPT; ++k) p[k] = __fadd_rn(p[k], c[k]);
      }
      st(ps + o, p);
    }
    __syncthreads();
    if (it == iters) break;
    // check phase: v_d = q(post[col_d] - c_old_d); exclusive min / sign over
    // the row's dc slots (empty slots count as magnitude BIG and sign +1);
    // c = em >= BIG ? 0 : q((alpha*es)*em), written to the column slot
    for (int r = u0; r < m; r += stride) {
      float min1[CPT], min2[CPT];
      int arg[CPT];
      uint32_t negs[CPT];  // the signs of v_d, d < 32
      bool par[CPT];
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        min1[k] = min2[k] = kInf();
        arg[k] = -1;
        negs[k] = 0u;
        par[k] = false;
      }
      for (int d = 0; d < dc; ++d) {
        const int2 e = row_edges[d * m_pad + r];
        const bool on = e.x >= 0;
        const uint32_t bit = d < 32 ? 1u << d : 0u;
        float p[CPT], c[CPT];
        ld(ps + (on ? e.x : 0) * CW + g * CPT, p);
        ld(rc + (on ? e.y : 0) * CW + g * CPT, c);
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
          const float v = q_bf16(__fsub_rn(p[k], c[k]));
          take_min(on ? fabsf(v) : kBig, d, min1[k], min2[k], arg[k]);
          if (on && v < 0.f) {
            par[k] = !par[k];
            negs[k] |= bit;
          }
        }
      }
      // c = em >= BIG ? 0 : q((alpha*es)*em) = +-q(alpha*em): alpha*es is
      // exact and both roundings are symmetric, so each row rounds twice
      float m1[CPT], m2[CPT];
      uint32_t f1[CPT], f2[CPT], sg[CPT];
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        m1[k] = min1[k] >= kBig ? 0.f : q_bf16(__fmul_rn(alpha, min1[k]));
        m2[k] = min2[k] >= kBig ? 0.f : q_bf16(__fmul_rn(alpha, min2[k]));
        f1[k] = min1[k] >= kBig ? 0u : 0x80000000u;
        f2[k] = min2[k] >= kBig ? 0u : 0x80000000u;
        sg[k] = par[k] ? ~negs[k] : negs[k];  // bit d: es_d = -1
      }
      for (int d = 0; d < dc; ++d) {
        const int2 e = row_edges[d * m_pad + r];
        if (e.x < 0) continue;
        float c[CPT];
        if (d >= 32) {  // a row of degree > 32 forms v again for its sign
          float p[CPT];
          ld(ps + e.x * CW + g * CPT, p);
          ld(rc + e.y * CW + g * CPT, c);
#pragma unroll
          for (int k = 0; k < CPT; ++k)
            sg[k] = (q_bf16(__fsub_rn(p[k], c[k])) < 0.f) != par[k] ? 1u << 31 : 0u;
        }
        const int sh = d < 32 ? 31 - d : 0;
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
          const bool at_arg = d == arg[k];
          const uint32_t flip = (sg[k] << sh) & (at_arg ? f2[k] : f1[k]);
          c[k] = __uint_as_float(__float_as_uint(at_arg ? m2[k] : m1[k]) ^ flip);
        }
        st(rc + e.y * CW + g * CPT, c);
      }
    }
    __syncthreads();
  }
  tile_out(post, ps, n, kCwLog2, v_log2, b0, B);
}

// The old message of slot dd of a 16-edge chunk: +-(is the first minimum ?
// a2 : a1), the sign bit dd of the chunk's state word.
__device__ __forceinline__ float rebuild(uint32_t word, int dd, bool is_arg, float a1,
                                         float a2) {
  return with_sign(is_arg ? a2 : a1, word, dd);
}

// Row r's first posterior in a slab: the slab's byte offset plus, by the
// circulant, block row (r + shift) mod z, all in bytes of the [n][cw] layout
// (rofs = the thread's own offset in a block row, zb = a block column).
__device__ __forceinline__ float* at(float* ps, int2 slab, int rofs, int zb) {
  const int t = rofs + slab.y;
  return reinterpret_cast<float*>(reinterpret_cast<char*>(ps) + slab.x + (t >= zb ? t - zb : t));
}

// Where K15 keeps its check state.
enum class State { kShared, kGlobal, kRegisters };
constexpr int kRegLayers = 4;  // layers whose state a thread keeps in registers

// llr [n, B] column-major with n = nb*z; post [n, B]. Layer l covers slabs
// starts[l] .. starts[l+1]-1, slab e being block-column cols[e] at shift
// shifts[e]. Shared memory: posteriors [n][cw], then (kShared) the check
// state a1, a2 [L][z][cw] and words [L][W][z][cw] (word c: the sign bits of
// edges 16c .. 16c+15 in its low half; word 0 also the first minimum's index
// in its high half), then the slabs as byte offsets (block column, shift)
// and the layer starts. kGlobal keeps the state in gstate, a region a
// block; kRegisters in registers (L <= kRegLayers, degrees <= 16, a row a
// thread). A thread: CPT codewords g*CPT.. of rows r0, r0 + stride, ...
// Between the two passes a chunk's word carries the signs of its v in its
// high half (in a register for kRegisters).
template <int CPT, State kState>
__global__ void __launch_bounds__(kMaxThreads, 1)
    ldpc_qc_kernel(const float* __restrict__ llr, const int32_t* __restrict__ starts,
                   const int32_t* __restrict__ cols, const int32_t* __restrict__ shifts,
                   float* __restrict__ post, float* __restrict__ gstate, int n_layers, int z,
                   int nb, int n_blocks, int words, int B, int iters, int cw_log2, int v_log2,
                   float alpha) {
  constexpr bool kRegs = kState == State::kRegisters;
  constexpr int kL = kRegs ? kRegLayers : 1;  // register state: layers
  extern __shared__ __align__(16) float smem[];
  const int cw = 1 << cw_log2, n = nb * z;
  const int g_log2 = cw_log2 - (CPT == 4 ? 2 : CPT == 2 ? 1 : 0);
  const int plane = kRegs ? 0 : n_layers * z * cw;
  const long long state_floats = (long long)plane * (2 + words);
  float* ps = smem;
  float* a1s = kState == State::kGlobal ? gstate + blockIdx.x * state_floats : ps + n * cw;
  float* a2s = a1s + plane;
  uint32_t* ws = reinterpret_cast<uint32_t*>(a2s + plane);
  int2* tab = reinterpret_cast<int2*>(kState == State::kGlobal ? ps + n * cw
                                                                : a1s + state_floats);
  int* lstart = reinterpret_cast<int*>(tab + n_blocks);
  const int tid = threadIdx.x, b0 = blockIdx.x * cw;
  const int g = tid & ((1 << g_log2) - 1), r0 = tid >> g_log2;
  const int stride = blockDim.x >> g_log2;
  const int zb = (z << cw_log2) * 4;

  tile_in<false>(ps, llr, n, n, cw_log2, v_log2, b0, B);
  for (long long e = tid; e < state_floats; e += blockDim.x) a1s[e] = 0.f;
  for (int e = tid; e < n_blocks; e += blockDim.x)
    tab[e] = make_int2(cols[e] * zb, (shifts[e] << cw_log2) * 4);
  for (int e = tid; e <= n_layers; e += blockDim.x) lstart[e] = starts[e];
  __syncthreads();

  float ra1[kL][CPT] = {}, ra2[kL][CPT] = {};
  uint32_t rw[kL][CPT] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int l = 0; l < (kRegs ? kL : n_layers); ++l) {
      if (kRegs && l >= n_layers) break;
      const int s0 = lstart[l], deg = lstart[l + 1] - s0;
      for (int r = r0; r < z; r += stride) {
        const int so = (l * z + r) * cw + g * CPT;  // this thread's a1 / a2
        const int rofs = ((r << cw_log2) + g * CPT) * 4;
        uint32_t* wr = ws + (l * words * z + r) * cw + g * CPT;  // its word 0
        float oa1[CPT], oa2[CPT], min1[CPT], min2[CPT];
        uint32_t w[CPT], negs[CPT];
        int oarg[CPT], arg[CPT], par[CPT];
        if (kRegs) {
#pragma unroll
          for (int k = 0; k < CPT; ++k) {
            oa1[k] = ra1[l][k];
            oa2[k] = ra2[l][k];
            w[k] = rw[l][k];
          }
        } else {
          ld(a1s + so, oa1);
          ld(a2s + so, oa2);
          ld(wr, w);
        }
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
          oarg[k] = (int)(w[k] >> 16);
          min1[k] = min2[k] = kInf();
          arg[k] = -1;
          par[k] = 0;
        }
        // pass 1: v = p - old; min1 / min2 / arg in slab order; the signs of
        // v, kept in the high half of the chunk's word. The next edge's slab
        // and posteriors are loaded before this one's math.
        for (int c0 = 0, c = 0; c0 < deg; c0 += kChunk, ++c) {
          const int c1 = min(deg, c0 + kChunk);
          float p[CPT];
          if (!kRegs) ld(wr + c * z * cw, w);
          ld(at(ps, tab[s0 + c0], rofs, zb), p);
#pragma unroll
          for (int k = 0; k < CPT; ++k) negs[k] = 0u;
          for (int d = c0; d < c1; ++d) {
            float pn[CPT];
            ld(at(ps, tab[s0 + min(d + 1, c1 - 1)], rofs, zb), pn);
            const uint32_t bit = 1u << (d - c0);
#pragma unroll
            for (int k = 0; k < CPT; ++k) {
              const float v =
                  __fsub_rn(p[k], rebuild(w[k], d - c0, d == oarg[k], oa1[k], oa2[k]));
              take_min(fabsf(v), d, min1[k], min2[k], arg[k]);
              if (v < 0.f) negs[k] |= bit;
              p[k] = pn[k];
            }
          }
#pragma unroll
          for (int k = 0; k < CPT; ++k) {
            par[k] ^= __popc(negs[k]);
            w[k] = (w[k] & 0xffffu) | negs[k] << 16;
          }
          if (!kRegs) st(wr + c * z * cw, w);
        }
        float na1[CPT], na2[CPT];
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
          na1[k] = __fmul_rn(alpha, min1[k]);
          na2[k] = __fmul_rn(alpha, min2[k]);
        }
        if (!kRegs) {
          st(a1s + so, na1);
          st(a2s + so, na2);
        }
        // pass 2: new = +-(d == arg ? a2 : a1), negative where the sign of v
        // differs from the parity; p' = p + (new - old). The next edge's
        // posteriors are loaded before this edge's store: the edges of a row
        // touch distinct columns.
        for (int c0 = 0, c = 0; c0 < deg; c0 += kChunk, ++c) {
          const int c1 = min(deg, c0 + kChunk);
          uint32_t nsg[CPT];
          float p[CPT];
          if (!kRegs) ld(wr + c * z * cw, w);
#pragma unroll
          for (int k = 0; k < CPT; ++k)
            nsg[k] = ((w[k] >> 16) ^ (par[k] & 1 ? 0xffffu : 0u)) & ((2u << (c1 - c0 - 1)) - 1);
          float* pp = at(ps, tab[s0 + c0], rofs, zb);
          ld(pp, p);
          for (int d = c0; d < c1; ++d) {
            float* pq = at(ps, tab[s0 + min(d + 1, c1 - 1)], rofs, zb);
            float pn[CPT];
            ld(pq, pn);
#pragma unroll
            for (int k = 0; k < CPT; ++k) {
              const float old = rebuild(w[k], d - c0, d == oarg[k], oa1[k], oa2[k]);
              const float nm = with_sign(d == arg[k] ? na2[k] : na1[k], nsg[k], d - c0);
              p[k] = __fadd_rn(p[k], __fsub_rn(nm, old));
            }
            st(pp, p);
#pragma unroll
            for (int k = 0; k < CPT; ++k) p[k] = pn[k];
            pp = pq;
          }
#pragma unroll
          for (int k = 0; k < CPT; ++k) w[k] = nsg[k] | (c ? 0u : (uint32_t)arg[k] << 16);
          if (!kRegs) st(wr + c * z * cw, w);
        }
        if (kRegs) {
#pragma unroll
          for (int k = 0; k < CPT; ++k) {
            ra1[l][k] = na1[k];
            ra2[l][k] = na2[k];
            rw[l][k] = w[k];
          }
        }
      }
      __syncthreads();
    }
  }
  tile_out(post, ps, n, cw_log2, v_log2, b0, B);
}

template <int CW, int CPT>
int launch_edges(const float* llr, const int2* row_edges, float* post, int n, int n_pad, int m,
                 int m_pad, int dv, int dc, int B, int iters, float alpha, int threads,
                 cudaStream_t stream) {
  const size_t smem = (size_t)(2 + dv) * n_pad * CW * sizeof(float);
  cudaError_t err = allow_smem(ldpc_edges_kernel<CW, CPT>, smem);
  if (err != cudaSuccess) return (int)err;
  ldpc_edges_kernel<CW, CPT><<<(B + CW - 1) / CW, threads, smem, stream>>>(
      llr, row_edges, post, n, n_pad, m, m_pad, dv, dc, B, iters, alpha,
      tile_vec_log2(llr, post, B, CW));
  return (int)cudaGetLastError();
}

template <int CPT, State kState>
int launch_qc(const float* llr, const int32_t* starts, const int32_t* cols, const int32_t* shifts,
              float* post, float* gstate, int n_layers, int z, int nb, int n_blocks, int words,
              int B, int iters, int cw_log2, float alpha, int threads, size_t smem,
              cudaStream_t stream) {
  cudaError_t err = allow_smem(ldpc_qc_kernel<CPT, kState>, smem);
  if (err != cudaSuccess) return (int)err;
  const int cw = 1 << cw_log2;
  ldpc_qc_kernel<CPT, kState><<<(B + cw - 1) / cw, threads, smem, stream>>>(
      llr, starts, cols, shifts, post, gstate, n_layers, z, nb, n_blocks, words, B, iters,
      cw_log2, tile_vec_log2(llr, post, B, cw), alpha);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point returns the launch's cudaError_t as an int (0 on success);
// the geometry (codewords a block and a thread, threads, shared bytes) is the
// wrapper's (kernels/ldpc_pallas.py edges_geometry / qc_geometry).
extern "C" int srcdsp_ldpc_edges(const void* llr, const void* row_edges, void* post, int n,
                                 int n_pad, int m, int m_pad, int dv, int dc, int B, int iters,
                                 float alpha, int cw, int cpt, int threads, void* stream) {
  const auto* x = (const float*)llr;
  const auto* re = (const int2*)row_edges;
  auto* y = (float*)post;
  auto s = (cudaStream_t)stream;
#define SRCDSP_EDGES(CW, CPT)                                                                 \
  if (cw == CW && cpt == CPT)                                                                 \
    return launch_edges<CW, CPT>(x, re, y, n, n_pad, m, m_pad, dv, dc, B, iters, alpha, threads, \
                                 s);
  SRCDSP_EDGES(1, 1)
  SRCDSP_EDGES(2, 1)
  SRCDSP_EDGES(2, 2)
  SRCDSP_EDGES(4, 1)
  SRCDSP_EDGES(4, 2)
  SRCDSP_EDGES(4, 4)
  SRCDSP_EDGES(8, 2)
  SRCDSP_EDGES(8, 4)
#undef SRCDSP_EDGES
  return (int)cudaErrorInvalidValue;
}

// state: 0 shared memory, 1 device memory (gstate, cpt 1), 2 registers (at
// most kRegLayers layers of degree <= 16, and threads >= z * cw / cpt).
extern "C" int srcdsp_ldpc_qc(const void* llr, const void* starts, const void* cols,
                              const void* shifts, void* post, void* gstate, int n_layers, int z,
                              int nb, int n_blocks, int words, int B, int iters, int cw_log2,
                              int cpt, int state, float alpha, int threads, long long smem,
                              void* stream) {
  const auto* x = (const float*)llr;
  const auto *sts = (const int32_t*)starts, *co = (const int32_t*)cols,
             *sh = (const int32_t*)shifts;
  auto *y = (float*)post, *gs = (float*)gstate;
  auto s = (cudaStream_t)stream;
  if (state == 1) {
    if (cpt != 1 || !gs) return (int)cudaErrorInvalidValue;
    return launch_qc<1, State::kGlobal>(x, sts, co, sh, y, gs, n_layers, z, nb, n_blocks, words,
                                        B, iters, cw_log2, alpha, threads, (size_t)smem, s);
  }
  if (state == 2 && (words != 1 || n_layers > kRegLayers || threads * cpt < (z << cw_log2)))
    return (int)cudaErrorInvalidValue;
#define SRCDSP_QC(CPT, STATE)                                                                  \
  if (cpt == CPT && state == (STATE == State::kRegisters ? 2 : 0))                             \
    return launch_qc<CPT, STATE>(x, sts, co, sh, y, nullptr, n_layers, z, nb, n_blocks, words, B, \
                                 iters, cw_log2, alpha, threads, (size_t)smem, s);
  SRCDSP_QC(1, State::kShared)
  SRCDSP_QC(2, State::kShared)
  SRCDSP_QC(4, State::kShared)
  SRCDSP_QC(1, State::kRegisters)
  SRCDSP_QC(2, State::kRegisters)
  SRCDSP_QC(4, State::kRegisters)
#undef SRCDSP_QC
  return (int)cudaErrorInvalidValue;
}
