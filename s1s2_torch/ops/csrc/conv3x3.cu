// conv3x3 + bias + ReLU for Hopper (sm_90a), NHWC activations, SAME
// padding, on the tensor cores, with a plain C interface (built by
// s1s2_torch/ops/_build.py with nvcc, loaded with ctypes).
//
// Replaces the Pallas kernels conv3x3_relu and conv3x3_relu_bs
// (s1s2/ops/conv3x3.py): nine shifted (H*W, Cin) x (Cin, Cout) products with
// f32 accumulation and a fused bias/ReLU epilogue. One implicit-GEMM
// convolution on mma.sync, in two modes:
//   - bf16 mode: bf16 in, HWIO bf16 weights, m16n8k16 bf16 x bf16 -> f32;
//     epilogue acc + b, ReLU, one rounding to bf16.
//   - int8 mode (the int8 conv of s1s2/models/quant.py:157-168): a first
//     kernel quantizes the bf16 activations once, q = clip(rint(x / sx),
//     -127, 127), rounded as the IEEE quotient rounds, with one scale sx
//     for the tensor or one per input channel, into an int8 copy
//     whose channels are zero-padded to 32; the conv then runs m16n8k32
//     s8 x s8 -> s32 on weights repacked once to (9, Cout_pad, Cin_pad)
//     (ops/conv3x3.py:packed_int8_weight). The int32 sums are exact in any
//     order, and the epilogue acc * deq[co] + b[co] uses __fmul_rn and
//     __fadd_rn (no FMA), ReLU, bf16, so the mode is bit-equal to its plain
//     PyTorch version.
//
// What bounds it on an H100: at the base-96 shapes a conv does 2.8-5.6
// TFLOP (bf16, B=128) on a few GB, hundreds of operations a byte, so the
// tensor cores are the limit; the 24x4's narrow convs (Cout 24-48) waste
// part of each 64-wide channel tile. The design: a block owns an 8x16 tile
// of output pixels (GEMM M = 128) and 64 output channels (N); four warps
// each hold 2 pixel rows x 64 channels of f32/s32 sums in registers. K =
// 9 * Cin is walked as Cin chunks (16 bf16 or 32 int8 channels, 32 bytes a
// pixel) x 9 taps: for each chunk the haloed 10x18-pixel input tile and
// the chunk's weights for all nine taps come into shared memory once, with
// 16-byte cp.async that zero-fills outside the image and past Cin/Cout,
// double-buffered, and the nine taps read the same tile: for tap (ky, kx)
// the A row of output pixel (r, q) is tile pixel (r+ky, q+kx), an address
// that ldmatrix takes per lane at no cost. The 32-byte pixel rows and the
// 128-byte weight rows are XOR-swizzled so that the eight rows of every
// ldmatrix hit eight different bank groups. Activations whose rows are not
// 16-byte multiples (Cin % 8 != 0: the stems' `inc` convs, Cin 129, 33, 9)
// and weights with Cout % 8 != 0 (the 12's Cout 12) are loaded element by
// element into the same layout (template flags), not sent elsewhere.
// wgmma, TMA and a [up || skip] two-pointer loader are later work.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() as an int (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TH = 8;                   // output pixel rows per block
constexpr int TW = 16;                  // output pixel columns per block (M = 128)
constexpr int PW = TW + 2;              // haloed tile columns
constexpr int NPIX = (TH + 2) * PW;     // haloed tile pixels (180)
constexpr int BN = 64;                  // output channels per block
constexpr int NT = 128;                 // 4 warps; warp w owns tile rows 2w, 2w+1
constexpr int KB = 32;                  // bytes of K per pixel per chunk
constexpr int CK_BF = KB / 2;           // bf16 channels per chunk (16)
constexpr int CK_I8 = KB;               // int8 channels per chunk (32)
constexpr int A_BYTES = NPIX * KB;      // 5,760
constexpr int B_TAP = BN * KB;          // 2,048: bf16 [16 k][64 n], int8 [64 n][32 k]
constexpr int STAGE = A_BYTES + 9 * B_TAP;  // 24,192; two stages fit 48 KiB static

// A tile (both modes) and int8 B tile: 32-byte rows; the 16-byte half h of
// row r sits at h ^ bit 2 of r, so 8 consecutive rows cover all 8 groups.
__device__ __forceinline__ int sw32(int r, int h) {
  return r * 32 + ((h ^ ((r >> 2) & 1)) << 4);
}

// bf16 B tile: rows k of 64 channels (128 bytes); 16-byte chunk c at c ^ (k & 7).
__device__ __forceinline__ int sw128(int k, int c) {
  return k * 128 + ((c ^ (k & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; reads nothing and writes zeros when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// q = clip(rint(x / sx), -127, 127) with x / sx the IEEE quotient, bit for
// bit, without the conversion units (a quarter of the FP32 rate on Hopper):
// t = x * RN(1/sx) lies within 1.53e-5 of x / sx when |t| < 128, so rint(t)
// is rint(RN(x / sx)) unless t is within 3.1e-5 of a half-integer, and there
// the quotient is recomputed with __fdiv_rn. Adding and subtracting 1.5 * 2^23
// rounds |t| <= 128 to the nearest integer, ties to even, and leaves that
// integer in the low mantissa bits.
__device__ __forceinline__ int quantize_act(float x, float sx, float inv) {
  constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23, bits 0x4B400000
  float t = __fmul_rn(x, inv);
  const float h = fabsf(t);
  const float dist = fabsf(__fsub_rn(h, __fsub_rn(__fadd_rn(h, kMagic), kMagic)));
  if (h < 128.0f && dist > 0.5f - 3.1e-5f) t = __fdiv_rn(x, sx);
  t = fminf(fmaxf(t, -128.0f), 128.0f);
  const int q = __float_as_int(__fadd_rn(t, kMagic)) - 0x4B400000;
  return min(max(q, -127), 127);
}

// int8 mode, first kernel: x (P pixels, Cin) bf16 -> q (P, Cs) int8, Cs a
// multiple of 32, channels past Cin zero. One thread per 16 output bytes.
// PC: one scale per input channel, sxv[c] (Cin floats on the device), each
// channel quantized with its own scale and reciprocal; else the one scale
// sx for every channel. Pad channels read no scale.
template <bool PC>
__global__ void __launch_bounds__(256)
quantize_pad_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ q,
                    long long npix, int Cin, int Cs, float sx,
                    const float* __restrict__ sxv) {
  const int groups = Cs / 16;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npix * groups) return;
  const long long p = i / groups;
  const int c0 = (int)(i % groups) * 16;
  const __nv_bfloat16* src = x + p * Cin + c0;
  __align__(16) __nv_bfloat16 v[16];
  if ((Cin & 7) == 0 && c0 + 16 <= Cin) {
    const uint4 lo = reinterpret_cast<const uint4*>(src)[0];
    const uint4 hi = reinterpret_cast<const uint4*>(src)[1];
    *reinterpret_cast<uint4*>(v) = lo;
    *reinterpret_cast<uint4*>(v + 8) = hi;
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      v[j] = c0 + j < Cin ? src[j] : __float2bfloat16_rn(0.0f);
  }
  // per tensor: one scale and one reciprocal; per channel: 16 of each
  const float inv = PC ? 0.0f : __frcp_rn(sx);
  float s[PC ? 16 : 1], r[PC ? 16 : 1];
  if constexpr (PC) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s[j] = c0 + j < Cin ? sxv[c0 + j] : 1.0f;
      r[j] = __frcp_rn(s[j]);
    }
  }
  uint32_t words[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    uint32_t packed = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * w + j;
      int qv = 0;
      if (c0 + c < Cin) {
        if constexpr (PC)
          qv = quantize_act(__bfloat162float(v[c]), s[c], r[c]);
        else
          qv = quantize_act(__bfloat162float(v[c]), sx, inv);
      }
      packed |= (static_cast<uint32_t>(qv) & 0xFFu) << (8 * j);
    }
    words[w] = packed;
  }
  *reinterpret_cast<uint4*>(q + p * Cs + c0) = make_uint4(words[0], words[1], words[2], words[3]);
}

// The body of both kernels. I8: int8 mode (x int8 (B,H,W,Cs), w packed
// (9, Cop, Cs)); else bf16 mode (x bf16 (B,H,W,Cin), Cs == Cin, w HWIO
// bf16). AVEC: activation rows are loaded 16 bytes at a time (Cin % 8 == 0
// in bf16; always in int8); BVEC: the same for bf16 weights (Cout % 8 == 0).
template <bool I8, bool AVEC, bool BVEC>
__device__ __forceinline__ void conv3x3_mma(const void* __restrict__ xv,
                                            const void* __restrict__ wv,
                                            const float* __restrict__ deq,
                                            const float* __restrict__ bias,
                                            __nv_bfloat16* __restrict__ y, int H, int W,
                                            int Cin, int Cs, int Cout, int Cop, int ntn,
                                            int tiles_w, int relu) {
  using Acc = typename std::conditional<I8, int, float>::type;
  constexpr int E = I8 ? 1 : 2;           // bytes per element
  constexpr int CK = I8 ? CK_I8 : CK_BF;  // channels per chunk
  constexpr int HC = CK / 2;              // channels per 16-byte half row

  __shared__ __align__(128) unsigned char smem[2 * STAGE];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nt = blockIdx.x % ntn, sp = blockIdx.x / ntn;
  const int h0 = (sp / tiles_w) * TH, w0 = (sp % tiles_w) * TW, n0 = nt * BN;
  const size_t img = (size_t)blockIdx.y * H * W;  // first pixel of this image
  const unsigned char* xb = static_cast<const unsigned char*>(xv);
  const unsigned char* wb = static_cast<const unsigned char*>(wv);
  const int nchunks = (Cs + CK - 1) / CK;

  auto load = [&](int chunk, int stage) {
    unsigned char* sA = smem + stage * STAGE;
    unsigned char* sB = sA + A_BYTES;
    const int c0 = chunk * CK;
    if constexpr (AVEC) {
      for (int i = tid; i < NPIX * 2; i += NT) {
        const int p = i >> 1, h = i & 1;
        const int gh = h0 - 1 + p / PW, gw = w0 - 1 + p % PW, c = c0 + h * HC;
        const bool ok = gh >= 0 && gh < H && gw >= 0 && gw < W && c < Cs;
        const unsigned char* src =
            ok ? xb + ((img + (size_t)gh * W + gw) * Cs + c) * E : xb;
        cp_async16(smem_u32(sA + sw32(p, h)), src, ok);
      }
    } else {  // bf16, Cin % 8 != 0: element by element
      const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(xb);
#pragma unroll 4  // several loads in flight: a lone 2-byte load waits ~0.5 us
      for (int i = tid; i < NPIX * CK; i += NT) {
        const int p = i / CK, c = i % CK;
        const int gh = h0 - 1 + p / PW, gw = w0 - 1 + p % PW;
        const bool ok = gh >= 0 && gh < H && gw >= 0 && gw < W && c0 + c < Cin;
        const __nv_bfloat16 v =
            ok ? x[(img + (size_t)gh * W + gw) * Cin + c0 + c] : __float2bfloat16_rn(0.0f);
        *reinterpret_cast<__nv_bfloat16*>(sA + sw32(p, c / HC) + (c % HC) * 2) = v;
      }
    }
    if constexpr (I8) {  // packed (9, Cop, Cs): rows n of 32 bytes, no edge
      for (int i = tid; i < 9 * BN * 2; i += NT) {
        const int h = i & 1, n = (i >> 1) % BN, tap = i / (2 * BN);
        const unsigned char* src = wb + ((size_t)tap * Cop + n0 + n) * Cs + c0 + h * 16;
        cp_async16(smem_u32(sB + tap * B_TAP + sw32(n, h)), src, true);
      }
    } else if constexpr (BVEC) {  // HWIO: rows k of 64 channels, 8 chunks of 8
      for (int i = tid; i < 9 * CK * 8; i += NT) {
        const int c = i & 7, k = (i >> 3) % CK, tap = i / (8 * CK);
        const int ci = c0 + k, co = n0 + 8 * c;
        const bool ok = ci < Cin && co < Cout;
        const unsigned char* src = ok ? wb + (((size_t)tap * Cin + ci) * Cout + co) * 2 : wb;
        cp_async16(smem_u32(sB + tap * B_TAP + sw128(k, c)), src, ok);
      }
    } else {  // HWIO with Cout % 8 != 0: element by element
      const __nv_bfloat16* w = reinterpret_cast<const __nv_bfloat16*>(wb);
#pragma unroll 4
      for (int i = tid; i < 9 * CK * BN; i += NT) {
        const int n = i % BN, k = (i / BN) % CK, tap = i / (BN * CK);
        const int ci = c0 + k, co = n0 + n;
        const __nv_bfloat16 v = ci < Cin && co < Cout
                                    ? w[((size_t)tap * Cin + ci) * Cout + co]
                                    : __float2bfloat16_rn(0.0f);
        *reinterpret_cast<__nv_bfloat16*>(sB + tap * B_TAP + sw128(k, n >> 3) + (n & 7) * 2) =
            v;
      }
    }
  };

  Acc acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0;

  const uint32_t s0 = smem_u32(smem);
  load(0, 0);
  cp_async_commit();
  for (int ch = 0; ch < nchunks; ++ch) {
    if (ch + 1 < nchunks) load(ch + 1, (ch + 1) & 1);
    cp_async_commit();  // possibly empty: keeps the group count
    cp_async_wait_1();  // chunk ch has landed
    __syncthreads();
    const uint32_t sA = s0 + (ch & 1) * STAGE, sB = sA + A_BYTES;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // lanes 0-15 give rows 0-15 (bytes 0-15), lanes 16-31 rows 0-15 (16-31)
        const int p = (2 * warp + i + ky) * PW + (lane & 15) + kx;
        ldsm_x4(sA + sw32(p, lane >> 4), a[i]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // channel tiles 2j and 2j+1
        uint32_t b[4];
        if constexpr (I8) {
          const int n = 16 * j + (lane & 7) + ((lane >> 4) << 3);
          ldsm_x4(sB + tap * B_TAP + sw32(n, (lane >> 3) & 1), b);
        } else {
          const int k = (lane & 7) + (((lane >> 3) & 1) << 3);
          ldsm_x4_trans(sB + tap * B_TAP + sw128(k, 2 * j + (lane >> 4)), b);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma(acc[i][2 * j], a[i], b[0], b[1]);
          mma(acc[i][2 * j + 1], a[i], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // stage ch & 1 may be refilled
  }

  // acc[i][j]: c0, c1 at (pixel column g, channels 2t, 2t+1); c2, c3 at column g + 8
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int oh = h0 + 2 * warp + i;
    if (oh >= H) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = n0 + 8 * j + 2 * t;
      if (co >= Cout) continue;
      const bool two = co + 1 < Cout;
      const float b0 = bias[co], b1 = two ? bias[co + 1] : 0.0f;
      float d0 = 0.0f, d1 = 0.0f;
      if constexpr (I8) {
        d0 = deq[co];
        d1 = two ? deq[co + 1] : 0.0f;
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int ow = w0 + g + 8 * hh;
        if (ow >= W) continue;
        float v0, v1;
        if constexpr (I8) {
          v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * hh]), d0), b0);
          v1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * hh + 1]), d1), b1);
        } else {
          v0 = __fadd_rn(acc[i][j][2 * hh], b0);
          v1 = __fadd_rn(acc[i][j][2 * hh + 1], b1);
        }
        if (relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        __nv_bfloat16* out = y + (img + (size_t)oh * W + ow) * Cout + co;
        if (two && (Cout & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v0, v1);
        } else {
          out[0] = __float2bfloat16_rn(v0);
          if (two) out[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

#define CONV_ARGS                                                                  \
  const void *__restrict__ x, const void *__restrict__ w, const float *__restrict__ deq, \
      const float *__restrict__ bias, __nv_bfloat16 *__restrict__ y, int H, int W,      \
      int Cin, int Cs, int Cout, int Cop, int ntn, int tiles_w, int relu

template <bool AVEC, bool BVEC>
__global__ void __launch_bounds__(NT, 4) conv3x3_bf16_kernel(CONV_ARGS) {
  conv3x3_mma<false, AVEC, BVEC>(x, w, deq, bias, y, H, W, Cin, Cs, Cout, Cop, ntn, tiles_w,
                                 relu);
}

__global__ void __launch_bounds__(NT, 4) conv3x3_int8_kernel(CONV_ARGS) {
  conv3x3_mma<true, true, true>(x, w, deq, bias, y, H, W, Cin, Cs, Cout, Cop, ntn, tiles_w,
                                relu);
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

bool conv_args_ok(int B, int H, int W, int Cin, int Cout) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0) return false;
  const long long tiles = (long long)((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  return tiles * ((Cout + BN - 1) / BN) <= 0x7FFFFFFFLL;
}

template <bool I8, bool AVEC, bool BVEC>
void launch(const void* x, const void* w, const float* deq, const float* bias,
            __nv_bfloat16* y, int B, int H, int W, int Cin, int Cs, int Cout, int relu,
            cudaStream_t s) {
  const int tiles_w = (W + TW - 1) / TW, ntn = (Cout + BN - 1) / BN;
  const dim3 grid((unsigned)(((H + TH - 1) / TH) * tiles_w * ntn), (unsigned)B);
  if constexpr (I8)
    conv3x3_int8_kernel<<<grid, NT, 0, s>>>(x, w, deq, bias, y, H, W, Cin, Cs, Cout,
                                            ntn * BN, ntn, tiles_w, relu);
  else
    conv3x3_bf16_kernel<AVEC, BVEC><<<grid, NT, 0, s>>>(x, w, deq, bias, y, H, W, Cin, Cs,
                                                        Cout, ntn * BN, ntn, tiles_w, relu);
}

}  // namespace

extern "C" {

int s1s2k_conv3x3_bf16(const void* x, const void* w, const void* bias, void* y,
                       int B, int H, int W, int Cin, int Cout, int relu,
                       int device, void* stream) {
  if (!conv_args_ok(B, H, W, Cin, Cout)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* b = static_cast<const float*>(bias);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(y);
  cudaStream_t s = (cudaStream_t)stream;
  const bool av = Cin % 8 == 0, bv = Cout % 8 == 0;
  if (av && bv)
    launch<false, true, true>(x, w, nullptr, b, o, B, H, W, Cin, Cin, Cout, relu, s);
  else if (bv)
    launch<false, false, true>(x, w, nullptr, b, o, B, H, W, Cin, Cin, Cout, relu, s);
  else if (av)
    launch<false, true, false>(x, w, nullptr, b, o, B, H, W, Cin, Cin, Cout, relu, s);
  else
    launch<false, false, false>(x, w, nullptr, b, o, B, H, W, Cin, Cin, Cout, relu, s);
  return (int)cudaGetLastError();
}

// x8: scratch of B*H*W*round_up(Cin, 32) bytes; w8p: (9, round_up(Cout, 64),
// round_up(Cin, 32)) int8, zero-padded (ops/conv3x3.py:packed_int8_weight).
// sxv: null for the one activation scale sx, or Cin f32 scales on the
// device, one per input channel (sx is then ignored).
int s1s2k_conv3x3_int8(const void* x, void* x8, const void* w8p, const void* deq,
                       const void* bias, void* y, int B, int H, int W, int Cin,
                       int Cout, float sx, const void* sxv, int relu, int device,
                       void* stream) {
  if (!conv_args_ok(B, H, W, Cin, Cout)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int Cs = round_up(Cin, CK_I8);
  const long long npix = (long long)B * H * W;
  const long long threads = npix * (Cs / 16);
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  int8_t* q = static_cast<int8_t*>(x8);
  if (sxv)
    quantize_pad_kernel<true><<<blocks, 256, 0, s>>>(xb, q, npix, Cin, Cs, 0.0f,
                                                     static_cast<const float*>(sxv));
  else
    quantize_pad_kernel<false><<<blocks, 256, 0, s>>>(xb, q, npix, Cin, Cs, sx, nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launch<true, true, true>(x8, w8p, static_cast<const float*>(deq),
                           static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y),
                           B, H, W, Cin, Cs, Cout, relu, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
