// Included by every kernel library.
#pragma once

#include <cuda_runtime.h>

// The Python wrappers turn a launcher's non-zero return code into a message.
extern "C" const char* mgt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
