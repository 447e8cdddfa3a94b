// Tiled matrix product on Hopper's warpgroup tensor-core path (sm_90a), with
// a plain C interface (built by s1s2_torch/ops/_build.py with nvcc, loaded
// with ctypes).
//
// Replaces the Pallas probe kernel pallas_matmul (_mm_kernel) of
// tools/probe_pallas_int8.py: C = A x B for row-major A (M, K) and B (K, N),
// in three modes:
//   0: bf16 x bf16, f32 accumulation, f32 out;
//   1: bf16 x bf16, f32 accumulation, bf16 out (round to nearest even);
//   2: int8 x int8, exact int32 accumulation, int32 out.
// The Pallas grid (M/bm, N/bn, K/bk) drops any remainder silently; here the
// caller guarantees M, N multiples of 128 and K of 32 (bf16) or 64 (int8)
// (the wrapper raises otherwise) and the entry point refuses anything else.
//
// What bounds it on an H100: at the probe's 8192 x 2048 x 2048 the product
// does 69 GOP on 75 MB (bf16), about 900 operations a byte, so the tensor
// cores and not the memory are the limit, and only wgmma reaches their
// dense rate. The design is the one Hopper's GEMMs share:
// - each block owns a 128 x 256 tile of C (a ragged last column tile of 128
//   is computed at full width and masked at the store);
// - warpgroup 0 is the producer: one thread keeps a ring of 4 stages full
//   with TMA tensor copies (cp.async.bulk.tensor.2d) of 128 bytes of K of A
//   (128 rows) and of B (256 columns), 48 KB a stage, against a "full"
//   mbarrier per stage that counts the bytes; it gives up registers with
//   setmaxnreg;
// - warpgroups 1 and 2 each own 64 rows of the tile and run
//   wgmma.mma_async m64n256k16 (bf16, f32 accumulators) or m64n256k32
//   (s8, s32 accumulators) straight from the swizzled shared memory, 128
//   accumulators a thread; one wgmma group stays in flight, and when the
//   previous group has finished its stage goes back to the producer through
//   an "empty" mbarrier;
// - the epilogue writes C from the registers.
// TMA writes every tile with the 128-byte swizzle, and every wgmma
// descriptor names the same swizzle. A is K-major (128-byte rows, 8-row
// atoms 1024 bytes apart). B arrives N-major: bf16 reads it so through
// wgmma's transpose flag (64-column chunks of 64 K rows, 8192 bytes apart);
// s8 operands must be K-major, so the int8 mode first transposes B into a
// K-major (N, K) scratch the caller allocates (transpose_i8_kernel, one pass
// over B), unless the caller hands B over already K-major (a constant
// operand such as the int8 up-convs' weights, packed once). Out-of-bounds rows and K columns of a box are zero-filled by the
// TMA, so a K that is not a multiple of the stage depth needs no special
// case.
//
// The tensor-map descriptors are made on the host with
// cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint (nothing
// is linked beyond the runtime), and kept in a small cache keyed by
// (pointer, shape, type), so a repeated call does not encode them again.
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

constexpr int BM = 128;                        // rows of C per block
constexpr int BN = 256;                        // columns of C per block
constexpr int BKB = 128;                       // bytes of K per stage (one swizzle row)
constexpr int STAGES = 4;
constexpr int NT = 384;                        // producer + two consumer warpgroups
constexpr int A_BYTES = BM * BKB;              // 16 KB
constexpr int B_BYTES = BN * BKB;              // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + room to align to 1024
constexpr int B_CHUNK = 64 * BKB;              // bf16 B: one 64-column x 64-K-row box

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

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

#define S1S2K_D8(C, i)                                                                \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), C(d[i + 6]), \
      C(d[i + 7])
#define S1S2K_D32(C, i) \
  S1S2K_D8(C, i), S1S2K_D8(C, i + 8), S1S2K_D8(C, i + 16), S1S2K_D8(C, i + 24)
#define S1S2K_D128(C) S1S2K_D32(C, 0), S1S2K_D32(C, 32), S1S2K_D32(C, 64), S1S2K_D32(C, 96)
#define S1S2K_REGS                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "             \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "     \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "     \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "     \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "     \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "     \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "    \
  "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
  "%124, %125, %126, %127}"

// D (64 x 256, f32) += A (64 x 16, K-major) x B (16 x 256, N-major: trans-b).
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %130, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " S1S2K_REGS
      ", %128, %129, p, 1, 1, 0, 1;\n\t}\n"
      : S1S2K_D128("+f")
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 256, s32) += A (64 x 32, K-major) x B (32 x 256, K-major).
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %130, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " S1S2K_REGS
      ", %128, %129, p;\n\t}\n"
      : S1S2K_D128("+r")
      : "l"(da), "l"(db), "r"(1));
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (the registers are in use until its group completes).
template <typename T>
__device__ __forceinline__ void fence_acc(T (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) {
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
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// MODE 0/1: bf16 in, f32 accumulators; MODE 2: int8 in (B transposed to
// (N, K)), int32 accumulators.
template <int MODE>
__global__ void __launch_bounds__(NT, 1)
matmul_kernel(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_b, void* __restrict__ c, int M,
              int N, int K) {
  constexpr bool I8 = MODE == 2;
  constexpr int E = I8 ? 1 : 2;                // bytes per input element
  using Acc = typename std::conditional<I8, int, float>::type;

  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = (K * E + BKB - 1) / BKB;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 8);         // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      // bf16 B: the 64-column chunks inside N (a 128-wide last tile loads 2)
      const int chunks = I8 ? 0 : min(BN, N - n0) / 64;
      const uint32_t bytes = I8 ? STAGE_BYTES : A_BYTES + chunks * B_CHUNK;
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(smem_u32(&empty[s]), ((kt / STAGES) - 1) & 1);
        const uint32_t bar = smem_u32(&full[s]);
        const uint32_t sa = smem_u32(smem + s * STAGE_BYTES), sb = sa + A_BYTES;
        mbar_expect_tx(bar, bytes);
        tma_load_2d(sa, &map_a, bar, kt * (BKB / E), m0);
        if (I8) {
          tma_load_2d(sb, &map_b, bar, kt * BKB, n0);
        } else {
          for (int j = 0; j < chunks; ++j)
            tma_load_2d(sb + j * B_CHUNK, &map_b, bar, n0 + 64 * j, kt * (BKB / E));
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1;                     // rows 64 cw .. 64 cw + 63 of the tile
    const int t = threadIdx.x % 128, lane = t % 32, warp = t / 32;
    Acc d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0;

    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(smem_u32(&full[s]), (kt / STAGES) & 1);
      const uint32_t sa = smem_u32(smem + s * STAGE_BYTES) + cw * 64 * BKB;
      const uint32_t sb = smem_u32(smem + s * STAGE_BYTES) + A_BYTES;
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {         // 32 bytes of K per wgmma
        const uint64_t da = sw128_desc(sa + kk * 32, 16, 1024);
        if constexpr (I8) {
          wgmma_s8(d, da, sw128_desc(sb + kk * 32, 16, 1024));
        } else {
          // MN-major B: 16 K rows of 128 bytes per step; 64-column chunks
          // B_CHUNK apart (leading offset), 8-row atoms 1024 apart (stride)
          wgmma_bf16(d, da, sw128_desc(sb + kk * 16 * BKB, B_CHUNK, 1024));
        }
      }
      wgmma_commit();
      fence_acc(d);
      wgmma_wait<1>();                         // the group of stage kt - 1 is done
      if (kt > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(kt - 1) % STAGES]));
    }
    wgmma_wait<0>();
    fence_acc(d);

    // d[4j + 0, 1] at (row r, columns 8j + 2 (lane % 4) + 0, 1); d[4j + 2, 3]
    // at row r + 8
    const int r = m0 + cw * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t off = (size_t)(r + 8 * h) * N + col;
        if constexpr (MODE == 0) {
          *reinterpret_cast<float2*>(static_cast<float*>(c) + off) =
              make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
        } else if constexpr (MODE == 1) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(c) + off) =
              __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
        } else {
          *reinterpret_cast<int2*>(static_cast<int*>(c) + off) =
              make_int2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// bt (N, K) = b (K, N)ᵀ for int8, in 64 x 64 tiles: 16-byte loads along N,
// 16-byte stores along K.
__global__ void __launch_bounds__(256)
transpose_i8_kernel(const unsigned char* __restrict__ b, unsigned char* __restrict__ bt,
                    int K, int N) {
  __shared__ uint32_t tile[64][17];            // 64 K rows of 64 N bytes, padded
  const int t = threadIdx.x, r = t / 4, q = t % 4;
  const int n0 = blockIdx.x * 64, k0 = blockIdx.y * 64;
  const uint4 v = *reinterpret_cast<const uint4*>(b + (size_t)(k0 + r) * N + n0 + 16 * q);
  tile[r][4 * q] = v.x;
  tile[r][4 * q + 1] = v.y;
  tile[r][4 * q + 2] = v.z;
  tile[r][4 * q + 3] = v.w;
  __syncthreads();
  uint32_t w[4] = {0, 0, 0, 0};                // row n = r of bt, K from 16 q
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint32_t byte = (tile[16 * q + i][r / 4] >> (8 * (r % 4))) & 0xFFu;
    w[i / 4] |= byte << (8 * (i % 4));
  }
  *reinterpret_cast<uint4*>(bt + (size_t)(n0 + r) * K + k0 + 16 * q) =
      make_uint4(w[0], w[1], w[2], w[3]);
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

struct MapKey {
  const void* ptr;
  uint64_t inner, outer;                       // elements of the contiguous dim, rows
  uint32_t box_inner, box_outer;
  int esize;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && inner == o.inner && outer == o.outer &&
           box_inner == o.box_inner && box_outer == o.box_outer && esize == o.esize;
  }
};

constexpr int CACHE = 32;
std::mutex cache_mu;
MapKey cache_key[CACHE];
CUtensorMap cache_map[CACHE];
int cache_n = 0, cache_next = 0;
uint64_t smem_attr_set[3];                     // per mode, a bit per device

// A row-major (outer, inner) matrix as a 2-D tensor map with 128-byte
// swizzle; out-of-bounds elements of a box read as zero.
cudaError_t tensor_map(const MapKey& k, CUtensorMap* out) {
  std::lock_guard<std::mutex> lock(cache_mu);
  for (int i = 0; i < cache_n; ++i)
    if (cache_key[i] == k) {
      *out = cache_map[i];
      return cudaSuccess;
    }
  const EncodeTiled enc = encoder();
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {k.inner, k.outer};
  const cuuint64_t strides[1] = {k.inner * k.esize};
  const cuuint32_t box[2] = {k.box_inner, k.box_outer};
  const cuuint32_t estr[2] = {1, 1};
  CUtensorMap map;
  const CUresult rc = enc(
      &map, k.esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      2, const_cast<void*>(k.ptr), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (rc != CUDA_SUCCESS) return cudaErrorInvalidValue;
  const int slot = cache_n < CACHE ? cache_n++ : (cache_next++ % CACHE);
  cache_key[slot] = k;
  cache_map[slot] = map;
  *out = map;
  return cudaSuccess;
}

template <int MODE>
cudaError_t launch(const CUtensorMap& ma, const CUtensorMap& mb, void* c, int M, int N,
                   int K, int device, cudaStream_t s) {
  {
    std::lock_guard<std::mutex> lock(cache_mu);
    const uint64_t bit = 1ull << device;
    if (!(smem_attr_set[MODE] & bit)) {
      const cudaError_t err = cudaFuncSetAttribute(
          matmul_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
      if (err != cudaSuccess) return err;
      smem_attr_set[MODE] |= bit;
    }
  }
  const dim3 grid((N + BN - 1) / BN, M / BM);
  matmul_kernel<MODE><<<grid, NT, SMEM_BYTES, s>>>(ma, mb, c, M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// mode 0: bf16 -> f32, 1: bf16 -> bf16, 2: int8 -> int32. M and N must be
// multiples of 128, K of 32 (bf16) or 64 (int8); every pointer 16-byte
// aligned. b_t is the int8 mode's (N, K) scratch for the transposed B (N*K
// bytes, unused for bf16). In mode 2 a null b means that b_t already holds
// B K-major (a constant operand packed once by the caller): the transpose
// is skipped.
int s1s2k_matmul(const void* a, const void* b, void* b_t, void* c, int M, int N, int K,
                 int mode, int device, void* stream) {
  const bool i8 = mode == 2;
  if (mode < 0 || mode > 2 || M <= 0 || N <= 0 || K <= 0 || M % BM || N % 128 ||
      K % (i8 ? 64 : 32) || M / BM > 65535 || device < 0 || device >= 64 ||
      (i8 && !b_t) || (!i8 && !b) ||
      ((uintptr_t)a | (uintptr_t)b | (uintptr_t)b_t | (uintptr_t)c) % 16)
    return (int)cudaErrorInvalidValue;
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int e = i8 ? 1 : 2;
  CUtensorMap ma, mb;
  err = tensor_map({a, (uint64_t)K, (uint64_t)M, (uint32_t)(BKB / e), (uint32_t)BM, e}, &ma);
  if (err != cudaSuccess) return (int)err;
  if (i8) {
    if (b) {
      transpose_i8_kernel<<<dim3(N / 64, K / 64), 256, 0, s>>>(
          static_cast<const unsigned char*>(b), static_cast<unsigned char*>(b_t), K, N);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    err = tensor_map({b_t, (uint64_t)K, (uint64_t)N, (uint32_t)BKB, (uint32_t)BN, 1}, &mb);
  } else {
    err = tensor_map({b, (uint64_t)N, (uint64_t)K, 64u, (uint32_t)(BKB / e), 2}, &mb);
  }
  if (err != cudaSuccess) return (int)err;
  if (mode == 0) return (int)launch<0>(ma, mb, c, M, N, K, device, s);
  if (mode == 1) return (int)launch<1>(ma, mb, c, M, N, K, device, s);
  return (int)launch<2>(ma, mb, c, M, N, K, device, s);
}

}  // extern "C"
