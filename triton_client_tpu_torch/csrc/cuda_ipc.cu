// Host-side CUDA calls of the device shared-memory path (no kernels).
//
// Counterpart of the cudaIPC calls the original Triton client makes in
// tritonclient/utils/cuda_shared_memory (cudaMalloc + cudaIpcGetMemHandle at
// create, cudaIpcOpenMemHandle in the server at register).  The JAX package
// cannot do this on a TPU (PjRt has no cross-process buffer import), so its
// utils/xla_shared_memory stages through host shm; on a CUDA card one device
// allocation is mapped by both processes.
//
// A region is its own cudaMalloc, outside PyTorch's caching allocator, so
// the IPC handle names exactly the region's bytes (a handle taken from a
// cached tensor names the whole cached segment).  Every entry point keeps
// the calling thread's current device as it found it and returns a
// cudaError_t; cuda_ipc_error_string names it.

#include <cuda_runtime.h>

#include <cstring>

namespace {

// Runs fn with `device` current, then restores the caller's device.
template <typename F>
int on_device(int device, F fn) {
  int prev = 0;
  cudaError_t rc = cudaGetDevice(&prev);
  if (rc != cudaSuccess) return (int)rc;
  if (prev != device && (rc = cudaSetDevice(device)) != cudaSuccess)
    return (int)rc;
  rc = fn();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (rc == cudaSuccess) rc = back;
  }
  return (int)rc;
}

}  // namespace

extern "C" int cuda_ipc_malloc(int device, size_t bytes, void** ptr) {
  return on_device(device, [&] { return cudaMalloc(ptr, bytes); });
}

extern "C" int cuda_ipc_free(int device, void* ptr) {
  return on_device(device, [&] { return cudaFree(ptr); });
}

// Writes the CUDA_IPC_HANDLE_SIZE (64) bytes of ptr's handle into out.
extern "C" int cuda_ipc_get_handle(int device, void* ptr, char* out) {
  return on_device(device, [&] {
    cudaIpcMemHandle_t h;
    const cudaError_t rc = cudaIpcGetMemHandle(&h, ptr);
    if (rc == cudaSuccess) std::memcpy(out, h.reserved, sizeof(h.reserved));
    return rc;
  });
}

// Maps another process's allocation from its 64-byte handle.  Refused
// (cudaErrorInvalidContext / DeviceUninitialized) for a handle made in this
// process: the in-process path resolves regions by uuid instead.
extern "C" int cuda_ipc_open(int device, const char* handle, void** ptr) {
  return on_device(device, [&] {
    cudaIpcMemHandle_t h;
    std::memcpy(h.reserved, handle, sizeof(h.reserved));
    return cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  });
}

extern "C" int cuda_ipc_close(int device, void* ptr) {
  return on_device(device, [&] { return cudaIpcCloseMemHandle(ptr); });
}

extern "C" int cuda_ipc_handle_size() { return (int)sizeof(cudaIpcMemHandle_t); }

extern "C" const char* cuda_ipc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
