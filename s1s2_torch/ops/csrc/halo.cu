// Row-halo load into shared memory for Hopper (sm_90a), with a plain C
// interface (built by s1s2_torch/ops/_build.py with nvcc, loaded with
// ctypes).
//
// Replaces the Pallas probe kernel of probe_dma (_dma_kernel) of
// tools/probe_pallas_int8.py: for row tile i of an (H, W, C) f32 array,
// copy rows [i*TH, i*TH + TH + 2) to fast memory, then write rows 1..TH of
// that window times 2.0, so out (H-2, W, C) has out[r] = 2 * x[r + 1]. The
// Pallas grid (H-2)//TH never writes the rows past its last whole tile; here
// the last row tile may be short and every output row is written.
//
// What bounds it on an H100: 4 bytes read and 4 written per element and one
// multiplication, so device memory. A row tile with its halo at the probe's
// shape (34 x 128 x 128 f32, 2.2 MB) does not fit in shared memory, so a
// block takes the (TH+2)-row window over a chunk of columns with all C; each
// row of that chunk is contiguous in memory. One thread starts one bulk
// asynchronous copy per window row (cp.async.bulk, the TMA's 1-D form)
// against an mbarrier that counts the bytes; all threads wait on the
// barrier, then write rows 1..TH times 2 with 16-byte stores. The window
// rows are read by two neighbouring row tiles, which the bound does not
// count.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() as an int (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int WINDOW_BYTES = 64 * 1024;   // target shared memory per block
constexpr int MAX_SMEM = 227 * 1024;      // what one block may have on sm_90

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned phase) {
  unsigned ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.b32 %0, 1, 0, p;\n\t}\n"
      : "=r"(ok)
      : "r"(bar), "r"(phase)
      : "memory");
  return ok != 0;
}

__global__ void __launch_bounds__(NT)
halo_rows_x2_kernel(const float* __restrict__ x, float* __restrict__ y, int H,
                    int W, int C, int TH, int WC) {
  extern __shared__ __align__(128) float win[];
  __shared__ __align__(8) uint64_t bar;

  const int r0 = blockIdx.x * TH;              // first window row = first out row
  const int w0 = blockIdx.y * WC;
  const int wc = min(WC, W - w0);
  const int rows = min(TH + 2, H - r0);        // window rows (>= 3)
  const int row_floats = wc * C;               // one window row, contiguous
  const unsigned row_bytes = (unsigned)row_floats * 4u;
  const unsigned b = smem_addr(&bar);

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                 "r"(row_bytes * (unsigned)rows)
                 : "memory");
    for (int r = 0; r < rows; ++r) {
      const float* src = x + ((size_t)(r0 + r) * W + w0) * C;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(win + (size_t)r * row_floats)),
          "l"(src), "r"(row_bytes), "r"(b)
          : "memory");
    }
  }
  while (!mbar_try_wait(b, 0)) {
  }

  const int q4 = row_floats / 4;               // float4s per window row
  const int n = (rows - 2) * q4;
  const float4* w4 = reinterpret_cast<const float4*>(win);
  for (int i = threadIdx.x; i < n; i += NT) {
    const int r = i / q4, q = i % q4;
    float4 v = w4[(r + 1) * q4 + q];
    v.x *= 2.0f;
    v.y *= 2.0f;
    v.z *= 2.0f;
    v.w *= 2.0f;
    reinterpret_cast<float4*>(y + ((size_t)(r0 + r) * W + w0) * C)[q] = v;
  }
}

}  // namespace

extern "C" {

// x (H, W, C) f32 -> y (H-2, W, C) f32, y[r] = 2 x[r+1]. C must be a
// multiple of 4 and both pointers 16-byte aligned (16-byte bulk copies).
int s1s2k_halo_rows_x2(const void* x, void* y, int H, int W, int C, int TH,
                       int device, void* stream) {
  if (H < 3 || W <= 0 || C <= 0 || C % 4 || TH <= 0 ||
      ((uintptr_t)x | (uintptr_t)y) % 16)
    return (int)cudaErrorInvalidValue;
  const long long col_bytes = (long long)(TH + 2) * C * 4;  // one column of a window
  if (col_bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  long long wc = WINDOW_BYTES / col_bytes;
  if (wc < 1) wc = 1;
  if (wc > W) wc = W;
  const int tiles = (H - 2 + TH - 1) / TH;
  const int chunks = (int)((W + wc - 1) / wc);
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int smem = (int)(col_bytes * wc);
  err = cudaFuncSetAttribute(halo_rows_x2_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  halo_rows_x2_kernel<<<dim3(tiles, chunks), NT, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, H, W, C, TH, (int)wc);
  return (int)cudaGetLastError();
}

}  // extern "C"
