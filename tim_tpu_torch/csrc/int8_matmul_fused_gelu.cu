// Kernel 3's instances with the GELU (int8_matmul_fused.cuh), in a source
// of their own so that nvcc builds them beside the others.

#include "int8_matmul_fused.cuh"

namespace tim_i8 {

int launch_gelu(const Args& a, const void* w, int kw, cudaStream_t stream) {
  return launch_any<true>(a, w, kw, stream);
}

}  // namespace tim_i8
