// Fused DDIM update for Hopper (sm_90a), with a plain C interface (built by
// s1s2_torch/ops/_build.py with nvcc, loaded with ctypes).
//
// Replaces the Pallas kernel fused_ddim_update
// (s1s2/ops/fused_elementwise.py): in one pass over f32 tensors,
//   x0 = (x - s1m * eps) / sabg
//   xn = sabn * x0 + s1mn * eps
// with the four coefficients computed on the host. It divides, as the
// sampler does (s1s2/sampling/samplers.py:127), and uses no FMA contraction,
// so it matches the plain PyTorch version bit for bit. It is bounded by its
// 16 bytes of device-memory traffic per element: a grid-stride loop of
// coalesced loads and stores, nothing kept on chip.

#include <cuda_runtime.h>

namespace {

__global__ void ddim_update_kernel(const float* __restrict__ x,
                                   const float* __restrict__ eps,
                                   float* __restrict__ x0,
                                   float* __restrict__ xn,
                                   long long n, float s1m, float sabg,
                                   float sabn, float s1mn) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float e = eps[i];
    const float a = __fdiv_rn(__fsub_rn(x[i], __fmul_rn(s1m, e)), sabg);
    x0[i] = a;
    xn[i] = __fadd_rn(__fmul_rn(sabn, a), __fmul_rn(s1mn, e));
  }
}

}  // namespace

extern "C" {

int s1s2k_ddim_update(const void* x, const void* eps, void* x0, void* xn,
                      long long n, float s1m, float sabg, float sabn,
                      float s1mn, int device, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long want = (n + 255) / 256;
  const int blocks = (int)(want < 4096 ? want : 4096);
  ddim_update_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)eps, (float*)x0, (float*)xn, n, s1m, sabg,
      sabn, s1mn);
  return (int)cudaGetLastError();
}

}  // extern "C"
