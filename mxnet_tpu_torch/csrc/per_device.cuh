// Launch settings the CUDA runtime keeps per device, cached for each
// device a process launches on: a kernel's dynamic shared-memory opt-in
// (cudaFuncSetAttribute applies to the current device only) and the SM
// count.  A kernel run first on one card and then on another sets its
// opt-in on each.
#pragma once

#include <atomic>

#include <cuda_runtime.h>

namespace mxt {

constexpr int kMaxDevices = 64;

// Lets ``kernel`` use up to ``total`` bytes of shared memory a CTA (its
// static bytes included) on the current device, once a device.  ``done``
// is the kernel's own record; two threads that race both set the same
// attribute.
template <class Kernel>
cudaError_t opt_in_smem(Kernel kernel, int total,
                        std::atomic<bool> (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool cached = dev < kMaxDevices;
  if (cached && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             total - static_cast<int>(fa.sharedSizeBytes));
  if (e == cudaSuccess && cached)
    done[dev].store(true, std::memory_order_release);
  return e;
}

// The current device's SM count.
inline cudaError_t sm_count(int* sms) {
  static std::atomic<int> counts[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && (*sms = counts[dev].load()) > 0) return e;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && dev < kMaxDevices) counts[dev].store(*sms);
  return e;
}

}  // namespace mxt
