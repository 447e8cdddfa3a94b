// Tiled matrix product on the tensor cores for Hopper (sm_90a), with a
// plain C interface (built by s1s2_torch/ops/_build.py with nvcc, loaded
// with ctypes).
//
// Replaces the Pallas probe kernel pallas_matmul (_mm_kernel) of
// tools/probe_pallas_int8.py: C = A x B for row-major A (M, K) and B (K, N),
// in three modes:
//   0: bf16 x bf16, f32 accumulation, f32 out;
//   1: bf16 x bf16, f32 accumulation, bf16 out (round to nearest even);
//   2: int8 x int8, exact int32 accumulation, int32 out.
// The Pallas grid (M/bm, N/bn, K/bk) drops any remainder silently; here the
// caller guarantees tile multiples (the wrapper raises otherwise) and the
// entry point refuses anything else.
//
// What bounds it on an H100: at the probe's 8192 x 2048 x 2048 the product
// does 69 GOP on 75 MB (bf16), about 900 operations a byte, so the tensor
// cores and not the memory are the limit. The design: each block owns a
// 128 x 128 tile of C; eight warps (2 along M, 4 along N) each hold a
// 64 x 32 sub-tile in registers and feed the tensor cores with mma.sync
// (m16n8k16 bf16 -> f32, m16n8k32 s8 -> s32). A and B tiles of 64 bytes of
// K come into shared memory with 16-byte cp.async, two stages deep, so the
// next tile loads while this one is multiplied. Fragments are read from
// shared memory with plain 32-bit (A) and 8/16-bit (B) loads in the layouts
// the PTX ISA gives for these mma shapes; ldmatrix, swizzles, wgmma and TMA
// are later work, which is why this kernel stays well below the card's peak.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() as an int (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;                 // rows of C per block
constexpr int BN = 128;                 // columns of C per block
constexpr int BKB = 64;                 // bytes of K per tile (32 bf16, 64 int8)
constexpr int NT = 256;                 // 8 warps
constexpr int WM = 64;                  // warp tile rows (2 warps along M)
constexpr int WN = 32;                  // warp tile columns (4 warps along N)
constexpr int MI = WM / 16;             // m16 tiles per warp
constexpr int NI = WN / 8;              // n8 tiles per warp
constexpr int A_STRIDE = BKB + 16;      // padded A row in shared memory (bytes)
constexpr int A_BYTES = BM * A_STRIDE;
constexpr int B_BYTES = 64 * (BN + 16);  // >= 32 rows x (256 + 16) bytes (bf16)
constexpr int STAGE = A_BYTES + B_BYTES;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t lds16(const unsigned char* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// MODE 0/1: bf16 in, f32 accumulators; MODE 2: int8 in, int32 accumulators.
template <int MODE>
__global__ void __launch_bounds__(NT)
matmul_kernel(const unsigned char* __restrict__ a,
              const unsigned char* __restrict__ b, void* __restrict__ c,
              int M, int N, int K) {
  constexpr bool I8 = MODE == 2;
  constexpr int E = I8 ? 1 : 2;           // bytes per input element
  constexpr int BK = BKB / E;             // K values per tile
  constexpr int B_STRIDE = BN * E + 16;   // padded B row (bytes)
  constexpr int B_CPR = BN * E / 16;      // 16-byte chunks per B row
  constexpr int KSTEP = I8 ? 32 : 16;     // K of one mma
  using Acc = typename std::conditional<I8, int, float>::type;

  __shared__ __align__(128) unsigned char smem[2 * STAGE];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const size_t a_row = (size_t)K * E, b_row = (size_t)N * E;

  auto load_tile = [&](int kt, int stage) {
    unsigned char* sA = smem + stage * STAGE;
    unsigned char* sB = sA + A_BYTES;
#pragma unroll
    for (int i = 0; i < 2; ++i) {          // A: 128 rows x 4 chunks
      const int ch = tid + i * NT;
      const int r = ch / 4, q = ch % 4;
      cp_async16(sA + r * A_STRIDE + q * 16,
                 a + (size_t)(m0 + r) * a_row + (size_t)kt * BKB + q * 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {          // B: BK rows x B_CPR chunks
      const int ch = tid + i * NT;
      const int r = ch / B_CPR, q = ch % B_CPR;
      cp_async16(sB + r * B_STRIDE + q * 16,
                 b + (size_t)(kt * BK + r) * b_row + (size_t)n0 * E + q * 16);
    }
  };

  Acc acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0;

  const int KT = K / BK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) load_tile(kt + 1, (kt + 1) & 1);
    cp_async_commit();                      // possibly empty: keeps the count
    cp_async_wait_1();                      // tile kt has landed
    __syncthreads();
    const unsigned char* sA = smem + (kt & 1) * STAGE;
    const unsigned char* sB = sA + A_BYTES;
#pragma unroll
    for (int ks = 0; ks < BK; ks += KSTEP) {
      uint32_t af[MI][4], bfr[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const unsigned char* r0 = sA + (wm * WM + i * 16 + g) * A_STRIDE;
        const unsigned char* r8 = r0 + 8 * A_STRIDE;
        const int k0 = (ks + (I8 ? 4 * t : 2 * t)) * E;   // byte offset
        const int k1 = k0 + (I8 ? 16 : 8) * E;
        af[i][0] = lds32(r0 + k0);
        af[i][1] = lds32(r8 + k0);
        af[i][2] = lds32(r0 + k1);
        af[i][3] = lds32(r8 + k1);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int col = (wn * WN + j * 8 + g) * E;
        if (I8) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = ks + 4 * t + 16 * h;
            uint32_t v = 0;
#pragma unroll
            for (int q = 0; q < 4; ++q)
              v |= (uint32_t)sB[(k + q) * B_STRIDE + col] << (8 * q);
            bfr[j][h] = v;
          }
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = ks + 2 * t + 8 * h;
            bfr[j][h] = lds16(sB + k * B_STRIDE + col) |
                        (lds16(sB + (k + 1) * B_STRIDE + col) << 16);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          if constexpr (I8) {
            asm volatile(
                "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
                "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                : "+r"(acc[i][j][0]), "+r"(acc[i][j][1]), "+r"(acc[i][j][2]),
                  "+r"(acc[i][j][3])
                : "r"(af[i][0]), "r"(af[i][1]), "r"(af[i][2]), "r"(af[i][3]),
                  "r"(bfr[j][0]), "r"(bfr[j][1]));
          } else {
            asm volatile(
                "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                : "+f"(acc[i][j][0]), "+f"(acc[i][j][1]), "+f"(acc[i][j][2]),
                  "+f"(acc[i][j][3])
                : "r"(af[i][0]), "r"(af[i][1]), "r"(af[i][2]), "r"(af[i][3]),
                  "r"(bfr[j][0]), "r"(bfr[j][1]));
          }
        }
    }
    __syncthreads();                        // stage kt & 1 may be refilled
  }

  // c0, c1 at (row g, columns 2t, 2t+1); c2, c3 at row g + 8
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * WM + i * 16 + g + 8 * h;
        const int col = n0 + wn * WN + j * 8 + 2 * t;
        const size_t off = (size_t)row * N + col;
        if constexpr (MODE == 0) {
          *reinterpret_cast<float2*>(static_cast<float*>(c) + off) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else if constexpr (MODE == 1) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(c) + off) =
              __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          *reinterpret_cast<int2*>(static_cast<int*>(c) + off) =
              make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
}

}  // namespace

extern "C" {

// mode 0: bf16 -> f32, 1: bf16 -> bf16, 2: int8 -> int32. M and N must be
// multiples of 128, K of 32 (bf16) or 64 (int8).
int s1s2k_matmul(const void* a, const void* b, void* c, int M, int N, int K,
                 int mode, int device, void* stream) {
  const int bk = mode == 2 ? BKB : BKB / 2;
  if (mode < 0 || mode > 2 || M <= 0 || N <= 0 || K <= 0 || M % BM || N % BN ||
      K % bk || M / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / BN, M / BM);
  const auto* pa = static_cast<const unsigned char*>(a);
  const auto* pb = static_cast<const unsigned char*>(b);
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0)
    matmul_kernel<0><<<grid, NT, 0, s>>>(pa, pb, c, M, N, K);
  else if (mode == 1)
    matmul_kernel<1><<<grid, NT, 0, s>>>(pa, pb, c, M, N, K);
  else
    matmul_kernel<2><<<grid, NT, 0, s>>>(pa, pb, c, M, N, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
