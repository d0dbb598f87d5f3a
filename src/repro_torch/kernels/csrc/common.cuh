// Shared C entry points of every kernel library of the port.
//
// Each csrc/<name>.cu is built into its own shared library with a plain C
// interface and loaded with ctypes (repro_torch/kernels/_build.py). Every
// library exports the two helpers below; each is defined against the
// kernel its source includes this header for (SPK_KERNEL) and, where the
// library has more kernels that take dynamic shared memory, SPK_KERNEL_2
// and SPK_KERNEL_3 as well.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#ifndef SPK_KERNEL
#error "define SPK_KERNEL (the library's __global__ function) before including common.cuh"
#endif

extern "C" const char* spk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Static shared memory of `kernel`, added to `bytes` (max over kernels).
template <typename K>
static inline cudaError_t spk_static_smem(K kernel, int* bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess && static_cast<int>(attr.sharedSizeBytes) > *bytes)
    *bytes = static_cast<int>(attr.sharedSizeBytes);
  return err;
}

// Dynamic shared memory one block of the library's kernels may opt in to
// on `device`: the per-block opt-in limit
// (cudaDevAttrMaxSharedMemoryPerBlockOptin, 232,448 B on H100) less the
// largest static shared memory among them.
extern "C" int spk_max_dynamic_smem(int device, int* out) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int fixed = 0;
  err = spk_static_smem(SPK_KERNEL, &fixed);
  if (err != cudaSuccess) return static_cast<int>(err);
#ifdef SPK_KERNEL_2
  err = spk_static_smem(SPK_KERNEL_2, &fixed);
  if (err != cudaSuccess) return static_cast<int>(err);
#endif
#ifdef SPK_KERNEL_3
  err = spk_static_smem(SPK_KERNEL_3, &fixed);
  if (err != cudaSuccess) return static_cast<int>(err);
#endif
  *out = optin - fixed;
  return 0;
}

#define SPK_MAX_DEVICES 64

static std::once_flag spk_optin_once[SPK_MAX_DEVICES];
static cudaError_t spk_optin_err[SPK_MAX_DEVICES];

// Opt the library's kernels in to all the dynamic shared memory they may
// use on the current device (needed above 48 KB). The attribute is per
// device, so it is set once per device, not per launch.
static inline cudaError_t spk_opt_in(int device) {
  auto set = [device]() -> cudaError_t {
    int bytes = 0;
    const int err = spk_max_dynamic_smem(device, &bytes);
    if (err != 0) return static_cast<cudaError_t>(err);
    cudaError_t e = cudaFuncSetAttribute(
        SPK_KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
#ifdef SPK_KERNEL_2
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          SPK_KERNEL_2, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
#endif
#ifdef SPK_KERNEL_3
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          SPK_KERNEL_3, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
#endif
    return e;
  };
  if (device < 0 || device >= SPK_MAX_DEVICES) return set();
  std::call_once(spk_optin_once[device],
                 [&]() { spk_optin_err[device] = set(); });
  return spk_optin_err[device];
}

// Scope of one launch: makes `device` current, opts the kernel in to its
// shared memory, and gives the calling thread its own current device back
// when it ends, so a launch never moves the device PyTorch expects.
class SpkLaunchScope {
 public:
  explicit SpkLaunchScope(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ != cudaSuccess) return;
    if (prev_ != device) {
      err_ = cudaSetDevice(device);
      if (err_ != cudaSuccess) return;
      restore_ = true;
    }
    err_ = spk_opt_in(device);
  }
  ~SpkLaunchScope() {
    if (restore_) cudaSetDevice(prev_);
  }
  SpkLaunchScope(const SpkLaunchScope&) = delete;
  SpkLaunchScope& operator=(const SpkLaunchScope&) = delete;
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool restore_ = false;
  cudaError_t err_ = cudaSuccess;
};
