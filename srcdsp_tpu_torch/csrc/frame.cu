// On-device framer (K6): planes [B, 2, L] -> frames xr_f, xi_f [B, NT, span],
// row r of each plane = x[r*stride, r*stride + span).
//
// Replaces srcdsp_tpu/kernels/mixfir_preframed.py make_frame_kernel
// (_frame_kernel), which assembles each block's rows from a pipelined slab in
// VMEM and runs once per plane. Here one launch covers every plane of the
// batch: one block per (frame row, batch entry) copies the row's span samples
// of both planes, neighbouring threads on neighbouring addresses. A copy moves
// bits, so the element is 4 bytes (f32) or 2 bytes (bf16) and nothing is
// converted.
//
// What bounds it: device-memory bytes, L*(span/stride) read and written per
// plane (hist/stride more than the stream itself); one scalar load and store
// per element per thread leaves it short of the copy roof.
#include "fsk_common.cuh"

using namespace srcdsp;

template <typename E>
__global__ void frame_kernel(const E* __restrict__ x, E* __restrict__ xr_f,
                             E* __restrict__ xi_f, long long L, int NT, int stride,
                             int span) {
  const int r = blockIdx.x;
  const int b = blockIdx.y;
  const E* xr = x + (long long)b * 2 * L + (long long)r * stride;
  const E* xi = xr + L;
  const long long dst = ((long long)b * NT + r) * span;
  for (int k = threadIdx.x; k < span; k += blockDim.x) {
    xr_f[dst + k] = xr[k];
    xi_f[dst + k] = xi[k];
  }
}

template <typename E>
static int launch(const void* x, void* xr_f, void* xi_f, int B, int L, int NT, int stride,
                  int span, void* stream) {
  frame_kernel<E><<<dim3(NT, B), kThreads, 0, (cudaStream_t)stream>>>(
      (const E*)x, (E*)xr_f, (E*)xi_f, L, NT, stride, span);
  return (int)cudaGetLastError();
}

// x [B, 2, L] with L = NT*stride + (span - stride); elem_bytes 4 or 2.
extern "C" int srcdsp_frame(const void* x, void* xr_f, void* xi_f, int B, int L, int NT,
                            int stride, int span, int elem_bytes, void* stream) {
  if (elem_bytes == 2)
    return launch<uint16_t>(x, xr_f, xi_f, B, L, NT, stride, span, stream);
  if (elem_bytes == 4)
    return launch<uint32_t>(x, xr_f, xi_f, B, L, NT, stride, span, stream);
  return (int)cudaErrorInvalidValue;
}
