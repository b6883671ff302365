// ipc: the exchange buffers of the one-process-per-card executor
// (parallel/peer.py), mapped into every rank's address space by CUDA IPC.
//
// Each rank allocates its buffers with cudaMalloc (a base pointer of its
// own, so an IPC handle names the buffer and nothing around it), hands
// the handles to the other ranks (torch.distributed all_gather_object),
// and opens theirs with cudaIpcMemLazyEnablePeerAccess. The a2a and
// xstage kernels then read and write the peers' buffers through these
// pointers (shards.cuh), whether the ranks share one card or hold one
// each on a host. A process cannot open its own handle: a rank uses its
// own pointer for its own buffer.
#include <cuda_runtime.h>

#include <cstring>

constexpr int kHandleBytes = sizeof(cudaIpcMemHandle_t);
static_assert(kHandleBytes == 64, "CUDA IPC handles are 64 bytes");

// A zeroed buffer of `bytes` on `device`; *ptr its base.
extern "C" int xfb_ipc_alloc(size_t bytes, int device, void** ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaMalloc(ptr, bytes);
  if (err == cudaSuccess) err = cudaMemset(*ptr, 0, bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return err;
}

// The IPC handle of a buffer from xfb_ipc_alloc, into handle[64].
extern "C" int xfb_ipc_handle(void* ptr, char* handle) {
  cudaIpcMemHandle_t h;
  const cudaError_t err = cudaIpcGetMemHandle(&h, ptr);
  if (err == cudaSuccess) std::memcpy(handle, &h, kHandleBytes);
  return err;
}

// Map a peer's buffer, named by its 64-byte handle, on `device`.
extern "C" int xfb_ipc_open(const char* handle, int device, void** ptr) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, kHandleBytes);
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  }
  return err;
}

// Unmap a peer's buffer.
extern "C" int xfb_ipc_close(void* ptr) { return cudaIpcCloseMemHandle(ptr); }

// Free a buffer of xfb_ipc_alloc (after every peer has unmapped it).
extern "C" int xfb_ipc_free(void* ptr, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaFree(ptr);
  return err;
}
