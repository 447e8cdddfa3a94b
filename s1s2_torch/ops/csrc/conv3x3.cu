// conv3x3 + bias + ReLU for Hopper (sm_90a), NHWC activations, HWIO
// weights, SAME padding, with a plain C interface (built by
// s1s2_torch/ops/_build.py with nvcc, loaded with ctypes).
//
// Replaces the Pallas kernels conv3x3_relu and conv3x3_relu_bs
// (s1s2/ops/conv3x3.py): nine shifted (H*W, Cin) x (Cin, Cout) products with
// f32 accumulation and a fused bias/ReLU epilogue. One implicit-GEMM direct
// convolution, in two instances:
//   - bf16 mode: bf16 in, f32 accumulation, epilogue acc + b, ReLU, bf16.
//   - int8 mode: the bf16 activations are quantized as they are loaded,
//     q = clip(rint(x / sx), -127, 127) with an IEEE division; int8 x int8
//     products accumulate exactly in int32 (__dp4a); epilogue
//     acc * deq[co] + b[co], ReLU, bf16, with no FMA contraction, so it
//     matches the plain PyTorch version bit for bit. This is the int8 conv
//     of s1s2/models/quant.py:159-168.
//
// What bounds it on an H100: at the main path's shapes (B=128, body 64^2,
// Cin/Cout 24..192) the work is 1.4 GOP per patch against a few MB of
// activations per patch, so a tensor-core kernel would be held by memory.
// This first kernel runs on the CUDA cores (FMA and dp4a) and is held by
// their rate instead; wgmma and TMA are later work. Its design: each block
// keeps an 8x16 output tile with its 1-pixel halo (zero-masked at the image
// edge, no padded copy) and a 32-wide slice of the weights in shared memory,
// one Cin chunk at a time; each thread owns 4 pixels x 4 output channels in
// registers. Loads are scalar, so an odd Cin (129 for the 4x space-to-depth
// stem) needs no special case.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() as an int (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;                     // output rows per block
constexpr int TW = 16;                    // output columns per block
constexpr int TCO = 32;                   // output channels per block
constexpr int NT = 256;                   // threads per block
constexpr int PX = 4;                     // output pixels per thread
constexpr int CX = 4;                     // output channels per thread
constexpr int NCG = TCO / CX;             // channel groups per block (8)
constexpr int NPG = NT / NCG;             // pixel groups per block (32)
static_assert(NPG * PX == TH * TW, "each output pixel has one owner");
constexpr int PH = TH + 2;                // haloed tile rows
constexpr int PW = TW + 2;                // haloed tile columns
constexpr int NPIX = PH * PW;

constexpr int CK_BF = 16;                 // bf16 mode: Cin values per chunk
constexpr int XS_BF = CK_BF + 1;          // padded pixel stride (floats)
constexpr int CK_I8 = 32;                 // int8 mode: Cin values per chunk
constexpr int CW_I8 = CK_I8 / 4;          // ... packed 4 to a 32-bit word
constexpr int XS_I8 = CW_I8 + 1;          // padded pixel stride (words)

__device__ __forceinline__ int quantize_act(__nv_bfloat16 v, float sx) {
  float q = rintf(__fdiv_rn(__bfloat162float(v), sx));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int>(q);
}

__global__ void __launch_bounds__(NT)
conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ y,
                    int H, int W, int Cin, int Cout, int relu) {
  __shared__ float xs[NPIX * XS_BF];
  __shared__ __align__(16) float ws[9 * CK_BF * TCO];

  const int tid = threadIdx.x;
  const int cg = tid % NCG;
  const int pg = tid / NCG;
  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * TCO;
  const __nv_bfloat16* xb = x + (size_t)blockIdx.z * H * W * Cin;

  float acc[PX][CX];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int j = 0; j < CX; ++j) acc[p][j] = 0.0f;

  for (int c0 = 0; c0 < Cin; c0 += CK_BF) {
    for (int i = tid; i < NPIX * CK_BF; i += NT) {
      const int pix = i / CK_BF, c = i % CK_BF;
      const int gh = h0 - 1 + pix / PW, gw = w0 - 1 + pix % PW, ci = c0 + c;
      float v = 0.0f;
      if (gh >= 0 && gh < H && gw >= 0 && gw < W && ci < Cin)
        v = __bfloat162float(xb[((size_t)gh * W + gw) * Cin + ci]);
      xs[pix * XS_BF + c] = v;
    }
    for (int i = tid; i < 9 * CK_BF * TCO; i += NT) {
      const int col = i % TCO, c = (i / TCO) % CK_BF, k = i / (TCO * CK_BF);
      const int ci = c0 + c, co = co0 + col;
      float v = 0.0f;
      if (ci < Cin && co < Cout)
        v = __bfloat162float(w[((size_t)k * Cin + ci) * Cout + co]);
      ws[i] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int ky = k / 3, kx = k % 3;
#pragma unroll 4
      for (int c = 0; c < CK_BF; ++c) {
        const float4 wv =
            *reinterpret_cast<const float4*>(&ws[(k * CK_BF + c) * TCO + cg * CX]);
#pragma unroll
        for (int p = 0; p < PX; ++p) {
          const int op = pg + p * NPG;
          const int r = op / TW + ky, q = op % TW + kx;
          const float xv = xs[(r * PW + q) * XS_BF + c];
          acc[p][0] = fmaf(xv, wv.x, acc[p][0]);
          acc[p][1] = fmaf(xv, wv.y, acc[p][1]);
          acc[p][2] = fmaf(xv, wv.z, acc[p][2]);
          acc[p][3] = fmaf(xv, wv.w, acc[p][3]);
        }
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* yb = y + (size_t)blockIdx.z * H * W * Cout;
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int op = pg + p * NPG;
    const int oh = h0 + op / TW, ow = w0 + op % TW;
    if (oh >= H || ow >= W) continue;
#pragma unroll
    for (int j = 0; j < CX; ++j) {
      const int co = co0 + cg * CX + j;
      if (co >= Cout) continue;
      float v = __fadd_rn(acc[p][j], bias[co]);
      if (relu) v = fmaxf(v, 0.0f);
      yb[((size_t)oh * W + ow) * Cout + co] = __float2bfloat16_rn(v);
    }
  }
}

__global__ void __launch_bounds__(NT)
conv3x3_int8_kernel(const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ w8,
                    const float* __restrict__ deq,
                    const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ y,
                    int H, int W, int Cin, int Cout, float sx, int relu) {
  __shared__ int xs[NPIX * XS_I8];
  __shared__ __align__(16) int ws[9 * CW_I8 * TCO];

  const int tid = threadIdx.x;
  const int cg = tid % NCG;
  const int pg = tid / NCG;
  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * TCO;
  const __nv_bfloat16* xb = x + (size_t)blockIdx.z * H * W * Cin;

  int acc[PX][CX];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int j = 0; j < CX; ++j) acc[p][j] = 0;

  for (int c0 = 0; c0 < Cin; c0 += CK_I8) {
    for (int i = tid; i < NPIX * CW_I8; i += NT) {
      const int pix = i / CW_I8, cw = i % CW_I8;
      const int gh = h0 - 1 + pix / PW, gw = w0 - 1 + pix % PW;
      const bool inside = gh >= 0 && gh < H && gw >= 0 && gw < W;
      const __nv_bfloat16* src = inside ? xb + ((size_t)gh * W + gw) * Cin : xb;
      unsigned int packed = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ci = c0 + cw * 4 + j;
        const int q = (inside && ci < Cin) ? quantize_act(src[ci], sx) : 0;
        packed |= (static_cast<unsigned int>(q) & 0xFFu) << (8 * j);
      }
      xs[pix * XS_I8 + cw] = static_cast<int>(packed);
    }
    for (int i = tid; i < 9 * CW_I8 * TCO; i += NT) {
      const int col = i % TCO, cw = (i / TCO) % CW_I8, k = i / (TCO * CW_I8);
      const int co = co0 + col;
      unsigned int packed = 0u;
      if (co < Cout) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ci = c0 + cw * 4 + j;
          if (ci < Cin) {
            const unsigned int b = static_cast<unsigned char>(
                w8[((size_t)k * Cin + ci) * Cout + co]);
            packed |= b << (8 * j);
          }
        }
      }
      ws[i] = static_cast<int>(packed);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int ky = k / 3, kx = k % 3;
#pragma unroll
      for (int cw = 0; cw < CW_I8; ++cw) {
        const int4 wv =
            *reinterpret_cast<const int4*>(&ws[(k * CW_I8 + cw) * TCO + cg * CX]);
#pragma unroll
        for (int p = 0; p < PX; ++p) {
          const int op = pg + p * NPG;
          const int r = op / TW + ky, q = op % TW + kx;
          const int xv = xs[(r * PW + q) * XS_I8 + cw];
          acc[p][0] = __dp4a(xv, wv.x, acc[p][0]);
          acc[p][1] = __dp4a(xv, wv.y, acc[p][1]);
          acc[p][2] = __dp4a(xv, wv.z, acc[p][2]);
          acc[p][3] = __dp4a(xv, wv.w, acc[p][3]);
        }
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* yb = y + (size_t)blockIdx.z * H * W * Cout;
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int op = pg + p * NPG;
    const int oh = h0 + op / TW, ow = w0 + op % TW;
    if (oh >= H || ow >= W) continue;
#pragma unroll
    for (int j = 0; j < CX; ++j) {
      const int co = co0 + cg * CX + j;
      if (co >= Cout) continue;
      float v = __fadd_rn(__fmul_rn(__int2float_rn(acc[p][j]), deq[co]), bias[co]);
      if (relu) v = fmaxf(v, 0.0f);
      yb[((size_t)oh * W + ow) * Cout + co] = __float2bfloat16_rn(v);
    }
  }
}

bool conv_args_ok(int B, int H, int W, int Cin, int Cout) {
  return B > 0 && B <= 65535 && H > 0 && W > 0 && Cin > 0 && Cout > 0 &&
         (Cout + TCO - 1) / TCO <= 65535;
}

dim3 conv_grid(int B, int H, int W, int Cout) {
  const unsigned tiles = ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  return dim3(tiles, (Cout + TCO - 1) / TCO, B);
}

}  // namespace

extern "C" {

int s1s2k_conv3x3_bf16(const void* x, const void* w, const void* bias, void* y,
                       int B, int H, int W, int Cin, int Cout, int relu,
                       int device, void* stream) {
  if (!conv_args_ok(B, H, W, Cin, Cout)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  conv3x3_bf16_kernel<<<conv_grid(B, H, W, Cout), NT, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const float*)bias,
      (__nv_bfloat16*)y, H, W, Cin, Cout, relu);
  return (int)cudaGetLastError();
}

int s1s2k_conv3x3_int8(const void* x, const void* w8, const void* deq,
                       const void* bias, void* y, int B, int H, int W, int Cin,
                       int Cout, float sx, int relu, int device, void* stream) {
  if (!conv_args_ok(B, H, W, Cin, Cout)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  conv3x3_int8_kernel<<<conv_grid(B, H, W, Cout), NT, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)w8, (const float*)deq,
      (const float*)bias, (__nv_bfloat16*)y, H, W, Cin, Cout, sx, relu);
  return (int)cudaGetLastError();
}

}  // extern "C"
