// The error-text entry every kernel library exports, so the Python
// wrappers can name the CUDA error a launch returned.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* mxt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
