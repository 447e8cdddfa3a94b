// conv3x3 + bias + ReLU for Hopper (sm_90a), NHWC activations, SAME
// padding, on the warpgroup tensor-core path (wgmma) fed by TMA, with a
// plain C interface (built by s1s2_torch/ops/_build.py with nvcc, loaded
// with ctypes).
//
// Replaces the Pallas kernels conv3x3_relu and conv3x3_relu_bs
// (s1s2/ops/conv3x3.py): nine shifted (H*W, Cin) x (Cin, Cout) products with
// f32 accumulation and a fused bias/ReLU epilogue. One implicit-GEMM
// convolution in two modes:
//   - bf16 mode: bf16 in, wgmma m64nNk16 bf16 x bf16 -> f32; epilogue
//     acc + b, ReLU, one rounding to bf16.
//   - int8 mode (the int8 conv of s1s2/models/quant.py:157-168): a first
//     kernel quantizes the bf16 activations once, q = clip(rint(x / sx),
//     -127, 127), rounded as the IEEE quotient rounds, with one scale sx
//     for the tensor or one per input channel, into an int8 copy
//     whose channels are zero-padded to 32; the conv then runs wgmma
//     m64nNk32 s8 x s8 -> s32. The int32 sums are exact in any order, and
//     the epilogue acc * deq[co] + b[co] uses __fmul_rn and __fadd_rn (no
//     FMA), ReLU, bf16, so the mode is bit-equal to its plain PyTorch
//     version.
// Both modes read their weights K-major, (9, Cout, Cs) with Cs the
// activations' channel count, repacked once per weight tensor from HWIO
// (ops/conv3x3.py:packed_weight). TMA reads the rows of an N tile past Cout
// as zeros.
//
// What bounds it on an H100: at the base-96 shapes a conv does 2.8-5.6
// TFLOP (bf16, B=128) on a few GB, hundreds of operations a byte, so the
// tensor cores are the limit, and only wgmma reaches their dense rate; the
// narrow convs of the distilled students (Cout 24-192, 16-64 pixels a side)
// are bound by their bytes. The design:
// - a block owns 16 x 16 output pixels and an N tile of output channels
//   chosen per launch from Cout (16, 24, 32, 48, 64, 96 or 128: the whole
//   of a narrow Cout, 128 or an even split of a wide one), so the haloed
//   input tile is read once per N tile and a narrow Cout wastes no column;
// - warpgroup 0 is the producer: one thread issues every TMA copy and the
//   warpgroup gives up registers (setmaxnreg). K = 9 * Cs is walked as
//   chunks of KB bytes of each pixel x 9 taps: KB = 32 or 64 where a
//   pixel's channels fit (the students' narrow convs: 24 int8 channels fill
//   32 bytes), else 128 (64 bf16 or 128 int8 channels), so a chunk holds
//   no more zeros than the channel tail. For each chunk one 4-D tensor copy
//   over (C, W, H, B) brings the haloed 18 x 18-pixel tile (324 KB bytes;
//   two buffers when there are two chunks or more); TMA fills whatever lies
//   outside the image or past the channels with zeros, which is the SAME
//   padding, the ragged edge and the channel tail, so there is no edge
//   code. For each (chunk, tap) a 3-D copy over (Cs, Cout, 9) brings the N
//   tile's weights (N rows of KB bytes) into a ring of up to 8 stages. Full
//   and empty mbarriers pace both rings;
// - warpgroups 1 and 2 each own 8 output rows (two 64-pixel halves, one
//   output row of 16 pixels per warp). A tap (ky, kx) reads the haloed tile
//   shifted by a row or a column, a window that a wgmma shared-memory
//   descriptor cannot describe (its 8-row core matrices sit at uniform
//   strides), so A comes from registers: ldmatrix takes an address per lane
//   and loads each warp's 16 x 32-byte slice of the shifted window straight
//   into the m16 A fragment wgmma reads, and one tile load serves all nine
//   taps. B comes from the swizzled stage through a K-major descriptor.
//   A chunk's k-steps (32 bytes of each pixel) that lie wholly past Cs are
//   neither loaded nor multiplied. Each (chunk, tap) step is one wgmma group, waited for before the
//   step's weight stage (and, after a chunk's last tap, its tile) goes back
//   to the producer; the other warpgroup's group keeps the tensor cores
//   busy meanwhile (A fragments double-buffered in registers, one group in
//   flight a warpgroup, measured no faster: PERF.md, PR 14);
// - TMA writes every tile with the swizzle of its row width (32, 64 or 128
//   bytes: 16-byte piece c of the row at byte offset o at c ^ ((o >> 7) &
//   (KB/16 - 1))), the ldmatrix addresses apply the same XOR, so the eight
//   rows of every ldmatrix hit eight different bank groups, and the B
//   descriptors name the same swizzle;
// - the epilogue writes the output from the accumulators as the m16n8 C
//   layout lays them out (8 columns of channels at a time).
// The tensor maps are encoded on the host with cuTensorMapEncodeTiled,
// fetched through cudaGetDriverEntryPoint (nothing is linked beyond the
// runtime), and kept in a small cache keyed by everything they encode, so a
// call on the same tensors does not encode them again. Inputs whose
// channels are not a multiple of 8 bf16 (a global stride TMA cannot take)
// are zero-padded before the call (ops/conv3x3.py), the stems' upstream
// (models/unet.py:input_map).
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns a cudaError_t as an int (0 = success).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace {

constexpr int TH = 16;                    // output pixel rows per block (8 a warpgroup)
constexpr int TW = 16;                    // output pixel columns per block
constexpr int PH = TH + 2, PW = TW + 2;   // the haloed tile
constexpr int NT = 384;                   // producer + two consumer warpgroups
constexpr int MAX_STAGES = 8;
constexpr int SMEM_DYN = 231424;          // dynamic shared memory ceiling (226 KB of 227)
constexpr int N_MAX = 128;                // N tile of a wide Cout

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok = 0;
  while (!ok) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.b32 %0, 1, 0, p;\n\t}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// A chunk of KB bytes of each pixel's channels (32, 64 or 128: one row of
// the swizzle of that width), its haloed tile's bytes and the tile buffer's
// stride (1024-aligned, as the 128-byte swizzle's pattern needs).
__host__ __device__ constexpr int a_bytes(int kb) { return PH * PW * kb; }
__host__ __device__ constexpr int a_stride(int kb) { return (a_bytes(kb) + 1023) / 1024 * 1024; }

// The TMA swizzle of KB-byte rows: 16-byte piece c of the row at byte
// offset off (from a 1024-aligned base) lands at c ^ ((off >> 7) & (KB/16 - 1)).
template <int KB>
__device__ __forceinline__ uint32_t swizzled(uint32_t row_off, int piece) {
  return row_off + ((piece ^ ((row_off >> 7) & (KB / 16 - 1))) << 4);
}

// wgmma shared-memory descriptor of a K-major tile with KB-byte rows under
// the matching swizzle: start address, leading and stride byte offsets (8
// rows of KB bytes), in 16-byte units, and the swizzle mode (1: 128 bytes,
// 2: 64, 3: 32).
template <int KB>
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr) {
  constexpr uint64_t mode = KB == 128 ? 1 : KB == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(8 * KB >> 4) << 32) |
         (mode << 62);
}

// D (64 x N) += A (64 x 16 bf16 or 64 x 32 s8, from registers: warp w
// holds rows 16w..16w+15 as mma.sync's m16 A fragment) x B (K-major in
// shared memory, through the descriptor). One overload per N tile: N/2
// accumulators a thread.
#define CV_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define CV_R12 CV_R8 ", %8, %9, %10, %11"
#define CV_R16 CV_R12 ", %12, %13, %14, %15"
#define CV_R24 CV_R16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define CV_R32 CV_R24 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define CV_R48 \
  CV_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define CV_R64 \
  CV_R48 ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define CV_D4(C, i) C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3])
#define CV_D8(C) CV_D4(C, 0), CV_D4(C, 4)
#define CV_D12(C) CV_D8(C), CV_D4(C, 8)
#define CV_D16(C) CV_D12(C), CV_D4(C, 12)
#define CV_D24(C) CV_D16(C), CV_D4(C, 16), CV_D4(C, 20)
#define CV_D32(C) CV_D24(C), CV_D4(C, 24), CV_D4(C, 28)
#define CV_D48(C) CV_D32(C), CV_D4(C, 32), CV_D4(C, 36), CV_D4(C, 40), CV_D4(C, 44)
#define CV_D64(C) CV_D48(C), CV_D4(C, 48), CV_D4(C, 52), CV_D4(C, 56), CV_D4(C, 60)
// R accumulators (N = 2R); IA: the A registers' operand numbers, IB the
// descriptor's, IP the scale-d flag's
#define CV_WGMMA_RS(R, N, IA, IB, IP)                                                      \
  __device__ __forceinline__ void wgmma_rs(float (&d)[R], const uint32_t (&a)[4],          \
                                           uint64_t db) {                                  \
    asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %" IP ", 0;\n\t"                    \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" CV_R##R      \
                 "}, {" IA "}, %" IB ", p, 1, 1, 0;\n\t}\n"                                \
                 : CV_D##R("+f")                                                           \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));           \
  }                                                                                        \
  __device__ __forceinline__ void wgmma_rs(int (&d)[R], const uint32_t (&a)[4],            \
                                           uint64_t db) {                                  \
    asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %" IP ", 0;\n\t"                    \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8.s8 {" CV_R##R          \
                 "}, {" IA "}, %" IB ", p;\n\t}\n"                                         \
                 : CV_D##R("+r")                                                           \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));           \
  }
CV_WGMMA_RS(8, 16, "%8, %9, %10, %11", "12", "13")
CV_WGMMA_RS(12, 24, "%12, %13, %14, %15", "16", "17")
CV_WGMMA_RS(16, 32, "%16, %17, %18, %19", "20", "21")
CV_WGMMA_RS(24, 48, "%24, %25, %26, %27", "28", "29")
CV_WGMMA_RS(32, 64, "%32, %33, %34, %35", "36", "37")
CV_WGMMA_RS(48, 96, "%48, %49, %50, %51", "52", "53")
CV_WGMMA_RS(64, 128, "%64, %65, %66, %67", "68", "69")

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (the registers are in use until its group completes).
template <typename T, int R>
__device__ __forceinline__ void fence_acc(T (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if constexpr (std::is_same<T, float>::value)
      asm volatile("" : "+f"(d[i])::"memory");
    else
      asm volatile("" : "+r"(d[i])::"memory");
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
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

// The body of both kernels. I8: int8 mode (x int8 (B,H,W,Cs), w (9, Cout,
// Cs) int8), else bf16 mode (x bf16 (B,H,W,Cs), w (9, Cout, Cs) bf16); BN
// the N tile, KB the chunk's bytes of each pixel. na: A buffers (1 or 2),
// nst: weight stages (<= MAX_STAGES).
template <int BN, int KB, bool I8>
__device__ __forceinline__ void conv3x3_wgmma(const CUtensorMap* map_x,
                                              const CUtensorMap* map_w,
                                              const float* __restrict__ deq,
                                              const float* __restrict__ bias,
                                              __nv_bfloat16* __restrict__ y, int H, int W,
                                              int Cs, int Cout, int ntn, int tiles_w, int na,
                                              int nst, int relu) {
  using Acc = typename std::conditional<I8, int, float>::type;
  constexpr int E = I8 ? 1 : 2;           // bytes per element
  constexpr int CK = KB / E;              // channels per chunk
  constexpr int KS = 32 / E;              // channels per k-step (one wgmma)
  constexpr int NK = KB / 32;             // k-steps per chunk
  constexpr int A_BYTES = a_bytes(KB), A_STRIDE = a_stride(KB);
  constexpr int R = BN / 2;               // accumulators a thread per 64-pixel half
  constexpr int B_BYTES = BN * KB;        // one weight stage

  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t a_full[2], a_empty[2], b_full[MAX_STAGES],
      b_empty[MAX_STAGES];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sB = smem + na * A_STRIDE;

  const int wg = threadIdx.x / 128;
  const int nt = blockIdx.x % ntn, sp = blockIdx.x / ntn;
  const int h0 = (sp / tiles_w) * TH, w0 = (sp % tiles_w) * TW, n0 = nt * BN;
  const int img = blockIdx.y;
  const int nchunks = (Cs + CK - 1) / CK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < na; ++i) {
      mbar_init(smem_u32(&a_full[i]), 1);
      mbar_init(smem_u32(&a_empty[i]), 8);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < nst; ++s) {
      mbar_init(smem_u32(&b_full[s]), 1);
      mbar_init(smem_u32(&b_empty[s]), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int s = 0, ph = 0, k = 0;  // weight stage, its pass parity, (chunk, tap) count
      for (int c = 0; c < nchunks; ++c) {
        const int ab = na == 2 ? (c & 1) : 0;
        if (c >= na) mbar_wait(smem_u32(&a_empty[ab]), ((c / na) - 1) & 1);
        const uint32_t abar = smem_u32(&a_full[ab]);
        mbar_expect_tx(abar, A_BYTES);
        tma_load_4d(smem_u32(smem + ab * A_STRIDE), map_x, abar, c * CK, w0 - 1, h0 - 1, img);
        for (int tap = 0; tap < 9; ++tap, ++k) {
          if (k >= nst) mbar_wait(smem_u32(&b_empty[s]), ph ^ 1);
          const uint32_t bbar = smem_u32(&b_full[s]);
          mbar_expect_tx(bbar, B_BYTES);
          tma_load_3d(smem_u32(sB + s * B_BYTES), map_w, bbar, c * CK, n0, tap);
          if (++s == nst) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1;  // output rows 8 cw .. 8 cw + 7 of the block
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    Acc d[2][R];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) d[i][j] = 0;

    int s = 0, ph = 0;  // weight stage and its pass parity
    for (int c = 0; c < nchunks; ++c) {
      const int ab = na == 2 ? (c & 1) : 0;
      mbar_wait(smem_u32(&a_full[ab]), (c / na) & 1);
      const uint32_t sa = smem_u32(smem + ab * A_STRIDE);
      const int nk = min(NK, (Cs - c * CK + KS - 1) / KS);  // k-steps holding channels
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap - 3 * ky;
        // half i, warp w: output row 8 cw + 4 i + w, pixel columns lane & 15;
        // lanes 0-15 give the rows' first 16 bytes of the k-step, 16-31 the next
        uint32_t a[2][NK][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int p = (8 * cw + 4 * i + warp + ky) * PW + (lane & 15) + kx;
#pragma unroll
          for (int kk = 0; kk < NK; ++kk)
            if (kk < nk) ldsm_x4(sa + swizzled<KB>(p * KB, 2 * kk + (lane >> 4)), a[i][kk]);
        }
        mbar_wait(smem_u32(&b_full[s]), ph);
        const uint32_t sb = smem_u32(sB + s * B_BYTES);
        fence_acc(d[0]);
        fence_acc(d[1]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          if (kk < nk) {
            const uint64_t db = sw_desc<KB>(sb + kk * 32);
            wgmma_rs(d[0], a[0][kk], db);
            wgmma_rs(d[1], a[1][kk], db);
          }
        }
        wgmma_commit();
        fence_acc(d[0]);
        fence_acc(d[1]);
        wgmma_wait0();
        fence_acc(d[0]);
        fence_acc(d[1]);
        if (lane == 0) {
          mbar_arrive(smem_u32(&b_empty[s]));
          if (tap == 8) mbar_arrive(smem_u32(&a_empty[ab]));  // the tile is read
        }
        if (++s == nst) {
          s = 0;
          ph ^= 1;
        }
      }
    }

    // d[i][4j + 0, 1]: pixel column g, channels 8j + 2t, + 1; d[i][4j + 2, 3]:
    // column g + 8
    const int g = lane >> 2, tq = lane & 3;
    const size_t img_px = (size_t)img * H * W;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int oh = h0 + 8 * cw + 4 * i + warp;
      if (oh >= H) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int co = n0 + 8 * j + 2 * tq;
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
            v0 = __fadd_rn(__fmul_rn(__int2float_rn(d[i][4 * j + 2 * hh]), d0), b0);
            v1 = __fadd_rn(__fmul_rn(__int2float_rn(d[i][4 * j + 2 * hh + 1]), d1), b1);
          } else {
            v0 = __fadd_rn(d[i][4 * j + 2 * hh], b0);
            v1 = __fadd_rn(d[i][4 * j + 2 * hh + 1], b1);
          }
          if (relu) {
            v0 = fmaxf(v0, 0.0f);
            v1 = fmaxf(v1, 0.0f);
          }
          __nv_bfloat16* out = y + (img_px + (size_t)oh * W + ow) * Cout + co;
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
}

#define CONV_ARGS                                                                         \
  const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,   \
      const float *__restrict__ deq, const float *__restrict__ bias,                      \
      __nv_bfloat16 *__restrict__ y, int H, int W, int Cs, int Cout, int ntn, int tiles_w, \
      int na, int nst, int relu

template <int BN, int KB>
__global__ void __launch_bounds__(NT, 1) conv3x3_bf16_kernel(CONV_ARGS) {
  conv3x3_wgmma<BN, KB, false>(&map_x, &map_w, deq, bias, y, H, W, Cs, Cout, ntn, tiles_w, na,
                               nst, relu);
}

template <int BN, int KB>
__global__ void __launch_bounds__(NT, 1) conv3x3_int8_kernel(CONV_ARGS) {
  conv3x3_wgmma<BN, KB, true>(&map_x, &map_w, deq, bias, y, H, W, Cs, Cout, ntn, tiles_w, na,
                              nst, relu);
}

// The launch plan (mirrored by ops/conv3x3.py:conv_plan): the N tile, the
// number of N tiles, the chunk's bytes of each pixel, A buffers, weight
// stages and dynamic shared memory.
struct Plan {
  int bn, ntn, kb, na, nst, smem;
};

Plan plan(bool i8, int Cs, int Cout) {
  static const int widths[] = {16, 24, 32, 48, 64, 96, N_MAX};
  const int ntn = (Cout + N_MAX - 1) / N_MAX;
  const int need = (Cout + ntn - 1) / ntn;
  int bn = N_MAX;
  for (int w : widths)
    if (w >= need) {
      bn = w;
      break;
    }
  // a pixel's channels in one chunk of 32 or 64 bytes where they fit, else
  // in chunks of 128
  const int row = Cs * (i8 ? 1 : 2);
  const int kb = row <= 32 ? 32 : row <= 64 ? 64 : 128;
  const int nchunks = (row + kb - 1) / kb;
  const int na = nchunks > 1 ? 2 : 1;
  int nst = (SMEM_DYN - 1024 - na * a_stride(kb)) / (bn * kb);
  if (nst > MAX_STAGES) nst = MAX_STAGES;
  return {bn, (Cout + bn - 1) / bn, kb, na, nst, 1024 + na * a_stride(kb) + nst * bn * kb};
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A tensor of `rank` dims (innermost first, `esize`-byte elements, densely
// packed) as a tiled map whose swizzle is the width of the box's rows (32,
// 64 or 128 bytes); out-of-bounds elements of a box read as zero.
struct MapKey {
  const void* ptr;
  uint64_t dims[4];
  uint32_t box[4];
  int rank, esize;
  bool operator==(const MapKey& o) const {
    if (ptr != o.ptr || rank != o.rank || esize != o.esize) return false;
    for (int i = 0; i < rank; ++i)
      if (dims[i] != o.dims[i] || box[i] != o.box[i]) return false;
    return true;
  }
};

constexpr int CACHE = 64;
std::mutex cache_mu;
MapKey cache_key[CACHE];
CUtensorMap cache_map[CACHE];
int cache_n = 0, cache_next = 0;

cudaError_t tensor_map(const MapKey& k, CUtensorMap* out) {
  std::lock_guard<std::mutex> lock(cache_mu);
  for (int i = 0; i < cache_n; ++i)
    if (cache_key[i] == k) {
      *out = cache_map[i];
      return cudaSuccess;
    }
  const EncodeTiled enc = encoder();
  if (!enc) return cudaErrorNotSupported;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], estr[4] = {1, 1, 1, 1};
  uint64_t stride = k.esize;
  for (int i = 0; i < k.rank; ++i) {
    dims[i] = k.dims[i];
    box[i] = k.box[i];
    stride *= k.dims[i];
    if (i + 1 < k.rank) strides[i] = stride;
  }
  const uint32_t row = k.box[0] * k.esize;
  CUtensorMap map;
  const CUresult rc = enc(
      &map, k.esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      k.rank, const_cast<void*>(k.ptr), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      row == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                : row == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (rc != CUDA_SUCCESS) return cudaErrorInvalidValue;
  const int slot = cache_n < CACHE ? cache_n++ : (cache_next++ % CACHE);
  cache_key[slot] = k;
  cache_map[slot] = map;
  *out = map;
  return cudaSuccess;
}

// The kernel of one N tile and chunk: its shared-memory ceiling, raised once
// per device, then the launch.
template <int BN, int KB, bool I8>
cudaError_t launch_bn(const CUtensorMap& mx, const CUtensorMap& mw, const float* deq,
                      const float* bias, __nv_bfloat16* y, int B, int H, int W, int Cs,
                      int Cout, const Plan& p, int relu, int device, cudaStream_t s) {
  static uint64_t raised = 0;  // a bit per device
  {
    std::lock_guard<std::mutex> lock(cache_mu);
    if (!(raised & (1ull << device))) {
      const cudaError_t err =
          I8 ? cudaFuncSetAttribute(conv3x3_int8_kernel<BN, KB>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DYN)
             : cudaFuncSetAttribute(conv3x3_bf16_kernel<BN, KB>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DYN);
      if (err != cudaSuccess) return err;
      raised |= 1ull << device;
    }
  }
  const int tiles_w = (W + TW - 1) / TW;
  const dim3 grid((unsigned)(((H + TH - 1) / TH) * tiles_w * p.ntn), (unsigned)B);
  if constexpr (I8)
    conv3x3_int8_kernel<BN, KB><<<grid, NT, p.smem, s>>>(mx, mw, deq, bias, y, H, W, Cs, Cout,
                                                     p.ntn, tiles_w, p.na, p.nst, relu);
  else
    conv3x3_bf16_kernel<BN, KB><<<grid, NT, p.smem, s>>>(mx, mw, deq, bias, y, H, W, Cs, Cout,
                                                     p.ntn, tiles_w, p.na, p.nst, relu);
  return cudaGetLastError();
}

// The plan's N tile, for a chunk of KB bytes.
template <int KB, bool I8>
cudaError_t launch_kb(const CUtensorMap& mx, const CUtensorMap& mw, const float* deq,
                      const float* bias, __nv_bfloat16* y, int B, int H, int W, int Cs,
                      int Cout, const Plan& p, int relu, int device, cudaStream_t s) {
  switch (p.bn) {
    case 16: return launch_bn<16, KB, I8>(mx, mw, deq, bias, y, B, H, W, Cs, Cout, p, relu, device, s);
    case 24: return launch_bn<24, KB, I8>(mx, mw, deq, bias, y, B, H, W, Cs, Cout, p, relu, device, s);
    case 32: return launch_bn<32, KB, I8>(mx, mw, deq, bias, y, B, H, W, Cs, Cout, p, relu, device, s);
    case 48: return launch_bn<48, KB, I8>(mx, mw, deq, bias, y, B, H, W, Cs, Cout, p, relu, device, s);
    case 64: return launch_bn<64, KB, I8>(mx, mw, deq, bias, y, B, H, W, Cs, Cout, p, relu, device, s);
    case 96: return launch_bn<96, KB, I8>(mx, mw, deq, bias, y, B, H, W, Cs, Cout, p, relu, device, s);
    default:
      return launch_bn<N_MAX, KB, I8>(mx, mw, deq, bias, y, B, H, W, Cs, Cout, p, relu, device, s);
  }
}

bool conv_args_ok(int B, int H, int W, int Cin, int Cout, int device) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || device < 0 ||
      device >= 64)
    return false;
  const long long tiles = (long long)((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  return tiles * ((Cout + 15) / 16) <= 0x7FFFFFFFLL;
}

cudaError_t set_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  return err;
}

// x (B, H, W, Cs) bf16 or int8, w (9, Cout, Cs) K-major: both maps, then
// the launch of the plan's kernel.
template <bool I8>
cudaError_t launch(const void* x, const void* w, const float* deq,
                   const float* bias, __nv_bfloat16* y, int B, int H, int W, int Cs, int Cout,
                   int relu, int device, cudaStream_t s) {
  constexpr int E = I8 ? 1 : 2;
  const Plan p = plan(I8, Cs, Cout);
  if (p.smem > SMEM_DYN || p.nst < 2 || (Cs * E) % 16 ||
      ((uintptr_t)x | (uintptr_t)w) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap mx, mw;
  cudaError_t err = tensor_map(
      {x, {(uint64_t)Cs, (uint64_t)W, (uint64_t)H, (uint64_t)B},
       {(uint32_t)(p.kb / E), (uint32_t)PW, (uint32_t)PH, 1u}, 4, E}, &mx);
  if (err != cudaSuccess) return err;
  err = tensor_map({w, {(uint64_t)Cs, (uint64_t)Cout, 9u, 0u},
                    {(uint32_t)(p.kb / E), (uint32_t)p.bn, 1u, 0u}, 3, E}, &mw);
  if (err != cudaSuccess) return err;
  switch (p.kb) {
    case 32: return launch_kb<32, I8>(mx, mw, deq, bias, y, B, H, W, Cs, Cout, p, relu, device, s);
    case 64: return launch_kb<64, I8>(mx, mw, deq, bias, y, B, H, W, Cs, Cout, p, relu, device, s);
    default:
      return launch_kb<128, I8>(mx, mw, deq, bias, y, B, H, W, Cs, Cout, p, relu, device, s);
  }
}

}  // namespace

extern "C" {

// x (B, H, W, Cin) bf16 with Cin a multiple of 8 (ops/conv3x3.py pads the
// channels of any other input with zeros first); w (9, Cout, Cin) bf16,
// K-major (ops/conv3x3.py:packed_weight); bias (Cout,) f32; y (B, H,
// W, Cout) bf16. x and w start on 16-byte boundaries.
int s1s2k_conv3x3_bf16(const void* x, const void* w, const void* bias, void* y,
                       int B, int H, int W, int Cin, int Cout, int relu,
                       int device, void* stream) {
  if (!conv_args_ok(B, H, W, Cin, Cout, device) || Cin % 8) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_device(device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch<false>(x, w, nullptr, static_cast<const float*>(bias),
                            static_cast<__nv_bfloat16*>(y), B, H, W, Cin, Cout, relu, device,
                            (cudaStream_t)stream);
}

// x8: scratch of B*H*W*round_up(Cin, 32) bytes; w8p: (9, Cout, round_up(Cin,
// 32)) int8, zero-padded (ops/conv3x3.py:packed_weight).
// sxv: null for the one activation scale sx, or Cin f32 scales on the
// device, one per input channel (sx is then ignored).
int s1s2k_conv3x3_int8(const void* x, void* x8, const void* w8p, const void* deq,
                       const void* bias, void* y, int B, int H, int W, int Cin,
                       int Cout, float sx, const void* sxv, int relu, int device,
                       void* stream) {
  if (!conv_args_ok(B, H, W, Cin, Cout, device)) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int Cs = (Cin + 31) / 32 * 32;
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
  return (int)launch<true>(x8, w8p, static_cast<const float*>(deq),
                           static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y),
                           B, H, W, Cs, Cout, relu, device, s);
}

// The plan a conv of Cs input channels as the kernel reads them (bf16: a
// multiple of 8; int8: of 32) and Cout output channels launches with:
// out[0..5] = N tile, N tiles, chunk bytes, input-tile buffers, weight
// stages, dynamic shared-memory bytes (ops/conv3x3.py:conv_plan mirrors it).
int s1s2k_conv3x3_plan(int i8, int Cs, int Cout, int* out) {
  if (Cs <= 0 || Cout <= 0 || !out) return (int)cudaErrorInvalidValue;
  const Plan p = plan(i8 != 0, Cs, Cout);
  const int v[6] = {p.bn, p.ntn, p.kb, p.na, p.nst, p.smem};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

}  // extern "C"
