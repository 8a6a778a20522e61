// Readable text for the cudaError_t codes the kernels' C entry points return.
#include <cuda_runtime.h>

extern "C" const char* aicity_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
