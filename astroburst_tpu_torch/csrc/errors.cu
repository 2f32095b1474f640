// Error text for the cudaError_t codes the kernel entry points return
// (runtime/kernels.py:launch raises with it).
#include <cuda_runtime.h>

extern "C" const char* abt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
