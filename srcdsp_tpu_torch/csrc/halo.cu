// Halo exchange between time shards (K19), and peer access between cards.
//
// Replaces srcdsp_tpu/kernels/halo_dma.py halo_from_left_pallas (_halo_kernel):
// there each shard pushes its trailing `halo` columns to its right neighbour by
// a remote DMA over a closed ring, and shard 0 then overwrites what it received
// with zeros. Here the destination pulls: one launch per destination shard p,
// on p's device and stream,
//   out_p[r, j] = (p == 0) ? 0 : x_{p-1}[r, S_{p-1} - halo + j],
// reading through the left shard's pointer with its row stride, so a slice of
// a wider array serves without a copy. Across cards the read is a peer read
// over NVLink (peer access enabled by srcdsp_enable_peer); on one card it is a
// device-local read. The ring's semaphore balancing has no counterpart: the
// left shard's data is complete before the launch, ordered by stream events in
// the wrapper (srcdsp_tpu_torch/kernels/halo_dma.py).
//
// What bounds it: R * halo floats in and out, nanoseconds of bandwidth; the
// launch itself (a few microseconds) sets its time.
#include "fsk_common.cuh"

using namespace srcdsp;

__global__ void halo_kernel(const float* __restrict__ src, long long src_stride,
                            float* __restrict__ out, int R, int halo) {
  const long long n = (long long)R * halo;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / halo;
    const long long j = i - r * halo;
    out[i] = src ? src[r * src_stride + j] : 0.f;
  }
}

// src: the left shard's first halo column (null for shard 0: zeros), rows
// src_stride floats apart; out [R, halo] contiguous on `device`. Returns the
// launch's cudaError_t as an int (0 on success); the caller's current device
// is restored on return.
extern "C" int srcdsp_halo(const void* src, long long src_stride, void* out, int R, int halo,
                           int device, void* stream) {
  DeviceScope on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  const int threads = 256;
  const long long want = ((long long)R * halo + threads - 1) / threads;
  const int blocks = (int)(want < 1 ? 1 : (want > 1024 ? 1024 : want));
  halo_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>((const float*)src, src_stride,
                                                           (float*)out, R, halo);
  return (int)cudaGetLastError();
}

// Let `device` read `peer`'s memory. Returns 0 when access is on (enabled now
// or before), -1 when the pair cannot have it, else the cudaError_t. The
// caller's current device is restored on return.
extern "C" int srcdsp_enable_peer(int device, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return -1;
  DeviceScope on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the error the call recorded
    return 0;
  }
  return (int)err;
}
