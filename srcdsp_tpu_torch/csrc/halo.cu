// Halo exchange between time shards (K19), and peer access between cards.
//
// Replaces srcdsp_tpu/kernels/halo_dma.py halo_from_left_pallas (_halo_kernel):
// there each shard pushes its trailing `halo` columns to its right neighbour by
// a remote DMA over a closed ring, and shard 0 then overwrites what it received
// with zeros. Here the destination pulls: one launch per device serves every
// destination shard on it, entry p of a table passed by value,
//   out_p[r, j] = (p == 0) ? 0 : x_{p-1}[r, S_{p-1} - halo + j],
// reading through the left shard's pointer with its row stride, so a slice of
// a wider array serves without a copy. Across cards the read is a peer read
// over NVLink (peer access enabled by srcdsp_enable_peer); on one card it is a
// device-local read. The ring's semaphore balancing has no counterpart: the
// left shard's data is complete before the launch, ordered by stream events in
// the wrapper (srcdsp_tpu_torch/kernels/halo_dma.py).
//
// What bounds it: R * halo floats in and out per shard, nanoseconds of
// bandwidth; the launch and the host work around it set its time, so a call
// makes one launch per device (one on one card, whatever the shard count).
//
// Across processes of one host the left rank pushes, as the TPU kernel does:
// its table gets one more entry whose `out` is the right rank's receive
// buffer, mapped into this process by CUDA IPC (srcdsp_ipc_open), so the
// launch writes the tail straight into memory the other process owns (over
// NVLink between two cards, device-local when both ranks share a card). The
// buffers are plain cudaMalloc allocations exported once (srcdsp_ipc_alloc):
// a handle to the caching allocator's memory would cover its whole segment,
// and its expandable segments cannot be exported at all. The order between
// the processes is kept outside the kernel (srcdsp_tpu_torch/dist/ipc.py).
#include <cstring>

#include "fsk_common.cuh"

using namespace srcdsp;

namespace {

constexpr int kHaloMaxEntries = 64;  // destination shards of one device in one launch

// One destination shard: its left neighbour's first halo column (null: zeros),
// that shard's row stride in floats, and the [R, halo] output.
struct HaloEntry {
  const float* src;
  long long src_stride;
  float* out;
};

struct HaloTable {
  HaloEntry e[kHaloMaxEntries];  // 1536 bytes of kernel parameters
};

// blockIdx.y selects the entry; the blocks along x stride over its R * halo.
__global__ void halo_kernel(const __grid_constant__ HaloTable table, int R, int halo) {
  const HaloEntry& e = table.e[blockIdx.y];
  const long long n = (long long)R * halo;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / halo;
    const long long j = i - r * halo;
    e.out[i] = e.src ? e.src[r * e.src_stride + j] : 0.f;
  }
}

}  // namespace

// entries: `count` HaloEntry records in host memory ({src, src_stride, out}
// as three 8-byte words each), every out on `device`; R rows of halo columns.
// Returns the launch's cudaError_t as an int (0 on success;
// cudaErrorInvalidValue for more than kHaloMaxEntries entries); the caller's
// current device is restored on return.
extern "C" int srcdsp_halo(const void* entries, int count, int R, int halo, int device,
                           void* stream) {
  if (count < 1 || count > kHaloMaxEntries || R < 0 || halo < 0)
    return (int)cudaErrorInvalidValue;
  DeviceScope on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  HaloTable table{};
  std::memcpy(table.e, entries, (size_t)count * sizeof(HaloEntry));
  const int threads = 256;
  const long long want = ((long long)R * halo + threads - 1) / threads;
  const int blocks = (int)(want < 1 ? 1 : (want > 1024 ? 1024 : want));
  halo_kernel<<<dim3(blocks, count), threads, 0, (cudaStream_t)stream>>>(table, R, halo);
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

// CUDA IPC for the receive buffers of srcdsp_tpu_torch/dist/ipc.py. Each entry
// returns its cudaError_t as an int and restores the caller's current device.

// Allocate `bytes` on `device` (zeroed) and export it: *ptr the allocation,
// `handle` the 64 bytes of its cudaIpcMemHandle_t.
extern "C" int srcdsp_ipc_alloc(long long bytes, int device, void** ptr, void* handle) {
  *ptr = nullptr;
  DeviceScope on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  cudaError_t err = cudaMalloc(ptr, (size_t)bytes);
  if (err == cudaSuccess) err = cudaMemset(*ptr, 0, (size_t)bytes);
  if (err == cudaSuccess) err = cudaStreamSynchronize(0);  // zeros before any import
  cudaIpcMemHandle_t h;
  if (err == cudaSuccess) err = cudaIpcGetMemHandle(&h, *ptr);
  if (err != cudaSuccess) {
    if (*ptr) cudaFree(*ptr);
    *ptr = nullptr;
    return (int)err;
  }
  std::memcpy(handle, &h, sizeof(h));
  return 0;
}

// Map another process's exported allocation into this one, on `device` (the
// card whose kernels write it), with peer access enabled as needed. A handle
// opens once per process, and never in the process that exported it.
extern "C" int srcdsp_ipc_open(const void* handle, int device, void** ptr) {
  *ptr = nullptr;
  DeviceScope on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

// Unmap what srcdsp_ipc_open mapped.
extern "C" int srcdsp_ipc_close(void* ptr, int device) {
  DeviceScope on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  return (int)cudaIpcCloseMemHandle(ptr);
}

// Free what srcdsp_ipc_alloc allocated, once every importer has closed it.
extern "C" int srcdsp_ipc_free(void* ptr, int device) {
  DeviceScope on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  return (int)cudaFree(ptr);
}

// The name of a cudaError_t (cudaGetErrorName) into out[0..n), NUL-ended.
extern "C" int srcdsp_error_name(int err, char* out, int n) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  std::strncpy(out, cudaGetErrorName((cudaError_t)err), (size_t)n - 1);
  out[n - 1] = '\0';
  return 0;
}
