// The inference stem's input for Hopper (sm_90a), with a plain C interface
// (built by s1s2_torch/ops/_build.py with nvcc, loaded with ctypes).
//
// Replaces no TPU kernel. The JAX package builds the stem's input
// (s1s2/models/unet.py: input_map) with plain jnp ops, which XLA fuses into
// one pass; PyTorch runs the same composition as separate kernels (the
// [x_t | cond] cat, the space-to-depth copy, the t cast, the zero fill, the
// cat of the four parts, the bf16 cast), each reading and writing the whole
// tensor in f32. This kernel writes inc's padded bf16 input straight from
// x_t, cond and t:
//
//   y[b, i, j, (di*s + dj)*C + c] = bf16(c < Cx ? x[b, i*s+di, j*s+dj, c]
//                                               : cond[b, i*s+di, j*s+dj, c-Cx])
//   y[b, i, j, s*s*C]             = bf16(float(t[b]))
//   y[b, i, j, k > s*s*C]         = 0
//
// with C = Cx + Cc and P (y's channels) a multiple of 8. Each value rounds
// once, f32 to bf16 to nearest even (__float2bfloat16_rn, what PyTorch's
// .to(torch.bfloat16) does on the card), so y is bit-equal to the
// composition.
//
// It is bounded by its bytes: x and cond read once, y written once. One
// thread writes one 16-byte chunk (8 channels) of y, neighbouring threads
// neighbouring chunks, so the stores are whole and coalesced; where C is a
// multiple of 8 and x and cond hold whole float4s, a chunk's 8 values are
// two 16-byte loads from one source pixel (x's and cond's halves for
// C = 4 + 4), and the chunk after the data holds t and seven zeros. A block
// takes 128 chunks of one output row, so its index math is a few 32-bit
// divisions and no 64-bit one. Other channel counts take a scalar path, one
// output value a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// t as the composition reads it: t.float(), then the bf16 cast
__device__ __forceinline__ float t_value(const void* t, int t_kind, int b) {
  if (t_kind == 0) return __int2float_rn(static_cast<const int*>(t)[b]);
  if (t_kind == 1) return __ll2float_rn(static_cast<const long long*>(t)[b]);
  return static_cast<const float*>(t)[b];
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

// the source pixel of output pixel (b, i, j) at block offset blk
__device__ __forceinline__ long long src_pixel(int b, int i, int j, int blk, int s, int H,
                                               int W) {
  const int di = blk / s, dj = blk - di * s;
  return ((long long)b * H + (long long)i * s + di) * W + (long long)j * s + dj;
}

// One thread per 16-byte chunk. Needs C % 8 == 0, Cx % 4 == 0 and P == s*s*C + 8.
__global__ void __launch_bounds__(kThreads) stem_pack_vec_kernel(
    const float* __restrict__ x, const float* __restrict__ cond,
    const void* __restrict__ t, int t_kind, uint4* __restrict__ y, int H, int W,
    int Cx, int Cc, int s, int Ho, int Wo, int segs) {
  const int row = blockIdx.x / segs;  // b * Ho + i
  const int nchunk = s * s * (Cx + Cc) / 8 + 1;
  const int u = (blockIdx.x - row * segs) * kThreads + threadIdx.x;
  if (u >= Wo * nchunk) return;
  const int j = u / nchunk, q = u - j * nchunk;
  const int b = row / Ho, i = row - b * Ho;
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if (q < nchunk - 1) {
    const int C = Cx + Cc;
    const int blk = (q * 8) / C, c0 = q * 8 - blk * C;
    const long long pix = src_pixel(b, i, j, blk, s, H, W);
    float4 v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 4 * h;
      v[h] = c < Cx ? *reinterpret_cast<const float4*>(x + pix * Cx + c)
                    : *reinterpret_cast<const float4*>(cond + pix * Cc + (c - Cx));
    }
    out = make_uint4(pack2(v[0].x, v[0].y), pack2(v[0].z, v[0].w), pack2(v[1].x, v[1].y),
                     pack2(v[1].z, v[1].w));
  } else {
    out.x = bf16_bits(t_value(t, t_kind, b));
  }
  y[(long long)row * Wo * nchunk + u] = out;
}

// One thread per output value: any Cx, Cc and P >= s*s*C + 1.
__global__ void __launch_bounds__(kThreads) stem_pack_scalar_kernel(
    const float* __restrict__ x, const float* __restrict__ cond,
    const void* __restrict__ t, int t_kind, __nv_bfloat16* __restrict__ y, int H, int W,
    int Cx, int Cc, int s, int Ho, int Wo, int P, int segs) {
  const int row = blockIdx.x / segs;
  const int u = (blockIdx.x - row * segs) * kThreads + threadIdx.x;
  if (u >= Wo * P) return;
  const int j = u / P, k = u - j * P;
  const int b = row / Ho, i = row - b * Ho;
  const int C = Cx + Cc;
  float v = 0.0f;
  if (k < s * s * C) {
    const int blk = k / C, c = k - blk * C;
    const long long pix = src_pixel(b, i, j, blk, s, H, W);
    v = c < Cx ? x[pix * Cx + c] : cond[pix * Cc + (c - Cx)];
  } else if (k == s * s * C) {
    v = t_value(t, t_kind, b);
  }
  y[(long long)row * Wo * P + u] = __float2bfloat16_rn(v);
}

}  // namespace

extern "C" {

// x (B,H,W,Cx) f32, cond (B,H,W,Cc) f32 or null with Cc = 0, t (B,) int32
// (t_kind 0), int64 (1) or f32 (2), y (B,H/s,W/s,P) bf16; all contiguous.
// Returns a cudaError_t.
int s1s2k_stem_pack(const void* x, const void* cond, const void* t, int t_kind, void* y,
                    int B, int H, int W, int Cx, int Cc, int s, int P, int device,
                    void* stream) {
  const long long C = (long long)Cx + Cc;
  if (B <= 0 || H <= 0 || W <= 0 || Cx <= 0 || Cc < 0 || s <= 0 || H % s || W % s ||
      (Cc > 0 && cond == nullptr) || t_kind < 0 || t_kind > 2 || P < s * s * C + 1 ||
      P % 8)
    return (int)cudaErrorInvalidValue;
  const int Ho = H / s, Wo = W / s;
  const bool vec = C % 8 == 0 && Cx % 4 == 0 && P == s * s * C + 8 &&
                   (uintptr_t)x % 16 == 0 && (Cc == 0 || (uintptr_t)cond % 16 == 0) &&
                   (uintptr_t)y % 16 == 0;
  const long long per_row = vec ? (long long)Wo * (P / 8) : (long long)Wo * P;
  const long long segs = (per_row + kThreads - 1) / kThreads;
  const long long blocks = (long long)B * Ho * segs;
  if (per_row >= (1LL << 31) || blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec) {
    stem_pack_vec_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        (const float*)x, (const float*)cond, t, t_kind, (uint4*)y, H, W, Cx, Cc, s, Ho, Wo,
        (int)segs);
  } else {
    stem_pack_scalar_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        (const float*)x, (const float*)cond, t, t_kind, (__nv_bfloat16*)y, H, W, Cx, Cc, s,
        Ho, Wo, P, (int)segs);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
