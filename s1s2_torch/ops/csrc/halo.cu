// Row-halo load through shared memory for Hopper (sm_90a), with a plain C
// interface (built by s1s2_torch/ops/_build.py with nvcc, loaded with
// ctypes).
//
// Replaces the Pallas probe kernel of probe_dma (_dma_kernel) of
// tools/probe_pallas_int8.py: for row tile i of an (H, W, C) f32 array,
// copy rows [i*TH, i*TH + TH + 2) to fast memory, then write rows 1..TH of
// that window times 2.0, so out (H-2, W, C) has out[r] = 2 * x[r + 1]. The
// Pallas grid (H-2)//TH never writes the rows past its last whole tile; here
// every output row is written.
//
// What bounds it on an H100: 4 bytes read and 4 written per element and one
// multiplication, so device memory; the kernel has to keep loads and stores
// in flight together for the whole run. The design is a pipelined stream of
// bulk copies (cp.async.bulk, the TMA's 1-D form):
// - a row of x is contiguous (W*C floats), so the work is cut into pieces of
//   one output row over one column chunk of at most 4 KB (a ragged row is
//   split into equal 16-byte multiples);
// - four persistent blocks per SM (a grid of 4 x the SMs, fewer if there are
//   fewer pieces) each take a contiguous run of pieces in (column chunk, row)
//   order, so a block walks its chunk down the rows and every row of x is
//   read once: the halo rows that the reference's windows read twice are
//   shared by neighbouring pieces, and the output does not depend on TH;
// - each block keeps a ring of 8 slots (32 KB): one thread starts the bulk
//   load of a piece into a slot against that slot's mbarrier, all threads
//   scale the slot in place once it has landed, and the same thread then
//   starts its bulk store (bulk_group) and refills the slot of the piece
//   before, whose store has finished reading shared memory by then
//   (cp.async.bulk.wait_group.read 1). Up to seven loads and two stores of
//   a block are in flight at once, and four blocks share an SM, so loads
//   and stores overlap over the whole run. The slot size, the ring depth
//   and the blocks per SM were chosen by timing variants on an H100: more
//   blocks per SM helped up to four, smaller pieces hurt.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns a cudaError_t as an int (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int SLOT_BYTES = 4096;               // one piece: one row of a column chunk
constexpr int SLOTS = 8;
constexpr int BLOCKS_PER_SM = 4;
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__global__ void __launch_bounds__(NT)
halo_rows_x2_kernel(const float* __restrict__ x, float* __restrict__ y, int rows,
                    long long row_floats, int chunk_floats, long long pieces) {
  __shared__ __align__(128) float4 ring[SLOTS][SLOT_BYTES / 16];
  __shared__ __align__(8) uint64_t full[SLOTS];

  const long long p0 = blockIdx.x * pieces / gridDim.x;
  const int n = (int)((blockIdx.x + 1) * pieces / gridDim.x - p0);

  // piece i of this block: out row r over column chunk j
  auto piece = [&](int i, long long& x_off, long long& y_off, uint32_t& bytes) {
    const long long p = p0 + i;
    const long long j = p / rows, r = p % rows;
    const long long col = j * chunk_floats;
    const long long len = row_floats - col < chunk_floats ? row_floats - col : chunk_floats;
    x_off = (r + 1) * row_floats + col;
    y_off = r * row_floats + col;
    bytes = (uint32_t)(len * 4);
  };
  auto load = [&](int i) {                     // thread 0 only
    long long xo, yo;
    uint32_t bytes;
    piece(i, xo, yo, bytes);
    const uint32_t bar = smem_u32(&full[i % SLOTS]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(ring[i % SLOTS])),
        "l"(x + xo), "r"(bytes), "r"(bar)
        : "memory");
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < SLOTS; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&full[s]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < n && i < SLOTS; ++i) load(i);
  }
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    const int s = i % SLOTS;
    long long xo, yo;
    uint32_t bytes;
    piece(i, xo, yo, bytes);
    mbar_wait(smem_u32(&full[s]), (i / SLOTS) & 1);
    for (int v = threadIdx.x; v < (int)(bytes / 16); v += NT) {
      float4 q = ring[s][v];
      q.x *= 2.0f;
      q.y *= 2.0f;
      q.z *= 2.0f;
      q.w *= 2.0f;
      ring[s][v] = q;
    }
    // the scaled slot is read next by the async proxy (the bulk store)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                       y + yo),
                   "r"(smem_u32(ring[s])), "r"(bytes)
                   : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      if (i >= 1 && i - 1 + SLOTS < n) {
        // the store of piece i - 1 has read its slot: refill it
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        load(i - 1 + SLOTS);
      }
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

int sm_count[MAX_DEVICES];                     // 0 until read

}  // namespace

extern "C" {

// x (H, W, C) f32 -> y (H-2, W, C) f32, y[r] = 2 x[r+1]. C must be a
// multiple of 4 and both pointers 16-byte aligned (16-byte bulk copies). TH,
// the reference's row-tile height, must be positive; the output does not
// depend on it.
int s1s2k_halo_rows_x2(const void* x, void* y, int H, int W, int C, int TH,
                       int device, void* stream) {
  if (H < 3 || W <= 0 || C <= 0 || C % 4 || TH <= 0 || device < 0 ||
      device >= MAX_DEVICES || ((uintptr_t)x | (uintptr_t)y) % 16)
    return (int)cudaErrorInvalidValue;
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!sm_count[device]) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    sm_count[device] = sms;
  }
  const long long row_floats = (long long)W * C;
  const long long slot_floats = SLOT_BYTES / 4;
  const long long chunks = (row_floats + slot_floats - 1) / slot_floats;
  const long long chunk = ((row_floats + chunks - 1) / chunks + 3) / 4 * 4;
  const long long pieces = (long long)(H - 2) * ((row_floats + chunk - 1) / chunk);
  long long grid = (long long)sm_count[device] * BLOCKS_PER_SM;
  if (grid > pieces) grid = pieces;
  halo_rows_x2_kernel<<<(unsigned)grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, H - 2, row_floats, (int)chunk, pieces);
  return (int)cudaGetLastError();
}

}  // extern "C"
