// Error text for the cudaError_t codes the launch entry points return.
#include <cuda_runtime.h>

extern "C" const char* dst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
