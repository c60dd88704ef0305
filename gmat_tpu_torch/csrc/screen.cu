// Epistasis effect screen on Hopper (sm_90a), plain C interface for ctypes.
//
// Computes, for the strict upper triangle of S = (A ⊙ py)ᵀ A with A the
// (n, m) row-major float32 coded genotype panel, the pairs (i, j), j > i,
// with |S[i, j]| > cut.
//
// Replaces the TPU kernels in gmat_tpu/scan/kernels.py:
//   gmat_screen_count   <- _count_kernel (phase 1: per-tile hit counts)
//   gmat_screen_extract <- _screen_extract_factory + _compact_column
//                          (phase 2: recompute hot tiles, compact hits)
//
// Bound: FP32 FMA throughput.  The screen performs n·m²/2 FMAs and, since
// hits are rare at production cuts, writes almost nothing; the genotype
// panel is re-read from L2 once per output tile.  This first version keeps
// to CUDA cores: a shared-memory tiled float32 FMA with 8x8 register
// micro-tiles (128 registers, two blocks per SM), two shared-memory stages
// fed by float4 global loads one slice ahead, and py folded into the A
// operand as it is staged.  Later work moves the product to tensor cores
// (wgmma with TMA-fed shared memory) once a precision scheme that keeps the
// f64-oracle hit set is chosen; TF32 alone does not keep it.
//
// Both entry points call the same tile_product routine over the same tile
// grid, so phase 2 recomputes bit-identical S values: the per-tile counts of
// phase 1 size the hit buffer exactly, which replaces the K-doubling retry
// of gmat_tpu/scan/kernels.py::pallas_screen.  Each output element sums
// over n in one fixed order (one fmaf per k, k ascending), so a hit set
// does not depend on the launch.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;               // output tile edge (rows i, cols j)
constexpr int kDepth = 8;                // n-slice staged per iteration
constexpr int kMicro = 8;                // micro-tile edge per thread
constexpr int kThreads = (kTile / kMicro) * (kTile / kMicro);  // 256
constexpr int kMinBlocks = 2;  // blocks per SM: caps registers at 128
static_assert(kDepth * kTile == 4 * kThreads, "one float4 per operand per thread");

// Row (or column) offset inside the tile of micro-tile index a of thread
// coordinate t: two groups of four, 64 apart, so that each thread reads its
// operands as two float4 words.
__device__ __forceinline__ int micro_off(int a, int t) {
  return (a & 3) + t * 4 + (a >> 2) * 64;
}

// Thread coordinates (ty, tx) in 0..15: a warp covers 4 x 8 of them, so its
// float4 operand reads touch 4 (A) and 8 (B) distinct addresses.
__device__ __forceinline__ int thread_ty() {
  return (threadIdx.x / 64) * 4 + (threadIdx.x % 32) / 8;
}
__device__ __forceinline__ int thread_tx() {
  return ((threadIdx.x / 32) % 2) * 8 + threadIdx.x % 8;
}

// Shared-memory staging: two slices of A ⊙ py and of B, used in turn.
struct Stage {
  float a[2][kDepth][kTile];
  float b[2][kDepth][kTile];
};

// Global -> registers: row k0 + threadIdx.x / 32 of the anchor (A ⊙ py)
// and partner (B) tiles, four columns per thread, zero past n and m.  The
// columns load as one float4 when the panel's rows are 16-byte aligned
// (`vec`).  Element offsets into the panel are int64: n·ld exceeds 2^31 at
// production widths.
__device__ __forceinline__ float4 load4(const float* __restrict__ p,
                                        int col, int m, bool vec) {
  if (vec && col + 3 < m) return *reinterpret_cast<const float4*>(p + col);
  float4 v;
  v.x = col < m ? p[col] : 0.0f;
  v.y = col + 1 < m ? p[col + 1] : 0.0f;
  v.z = col + 2 < m ? p[col + 2] : 0.0f;
  v.w = col + 3 < m ? p[col + 3] : 0.0f;
  return v;
}

__device__ __forceinline__ void load_slice(
    const float* __restrict__ mat, const float* __restrict__ py, int n,
    int64_t ld, int m, int i0, int j0, int k0, bool vec, float4& ra,
    float4& rb) {
  const int k = k0 + threadIdx.x / 32;
  const int c = (threadIdx.x % 32) * 4;
  ra = rb = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (k < n) {
    const float* row = mat + static_cast<int64_t>(k) * ld;
    const float pk = py[k];
    ra = load4(row, i0 + c, m, vec);
    rb = load4(row, j0 + c, m, vec);
    ra.x *= pk; ra.y *= pk; ra.z *= pk; ra.w *= pk;
  }
}

__device__ __forceinline__ void store_slice(Stage& st, int s, float4 ra,
                                            float4 rb) {
  const int kk = threadIdx.x / 32;
  const int c = (threadIdx.x % 32) * 4;
  *reinterpret_cast<float4*>(&st.a[s][kk][c]) = ra;
  *reinterpret_cast<float4*>(&st.b[s][kk][c]) = rb;
}

// acc[a][b] = S[i0 + micro_off(a, ty), j0 + micro_off(b, tx)].  The next
// slice's global loads are in flight while the current one is multiplied;
// one barrier per slice.
__device__ __forceinline__ void tile_product(
    const float* __restrict__ mat, const float* __restrict__ py, int n,
    int64_t ld, int m, int i0, int j0, bool vec,
    float (&acc)[kMicro][kMicro], Stage& st) {
  const int ty = thread_ty();
  const int tx = thread_tx();
#pragma unroll
  for (int a = 0; a < kMicro; ++a)
#pragma unroll
    for (int b = 0; b < kMicro; ++b) acc[a][b] = 0.0f;

  float4 ra, rb;
  load_slice(mat, py, n, ld, m, i0, j0, 0, vec, ra, rb);
  store_slice(st, 0, ra, rb);
  __syncthreads();
  int s = 0;
  for (int k0 = 0; k0 < n; k0 += kDepth) {
    const bool more = k0 + kDepth < n;
    if (more) load_slice(mat, py, n, ld, m, i0, j0, k0 + kDepth, vec, ra, rb);
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float av[kMicro], bv[kMicro];
      const float4 a0 = *reinterpret_cast<const float4*>(&st.a[s][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&st.a[s][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&st.b[s][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&st.b[s][kk][64 + tx * 4]);
      av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
      av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
      for (int a = 0; a < kMicro; ++a)
#pragma unroll
        for (int b = 0; b < kMicro; ++b)
          acc[a][b] = __fmaf_rn(av[a], bv[b], acc[a][b]);
    }
    // the other stage was last read before the previous barrier
    if (more) store_slice(st, s ^ 1, ra, rb);
    __syncthreads();
    s ^= 1;
  }
}

__device__ __forceinline__ bool is_hit(float s, int i, int j, int m,
                                       float cut) {
  return j > i && j < m && fabsf(s) > cut;  // NaN is never a hit
}

// One block per upper-triangle tile (ti <= tj), enumerated column by
// column: block b = tj(tj+1)/2 + ti.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
screen_count_kernel(const float* __restrict__ mat,
                    const float* __restrict__ py, int n, int64_t ld, int m,
                    bool vec, float cut, int n_tiles,
                    int* __restrict__ counts) {
  __shared__ __align__(16) Stage st;
  __shared__ int block_sum;
  const int64_t blk = blockIdx.x;
  int tj = static_cast<int>((sqrt(8.0 * static_cast<double>(blk) + 1.0) - 1.0) / 2.0);
  while (static_cast<int64_t>(tj + 1) * (tj + 2) / 2 <= blk) ++tj;
  while (static_cast<int64_t>(tj) * (tj + 1) / 2 > blk) --tj;
  const int ti = static_cast<int>(blk - static_cast<int64_t>(tj) * (tj + 1) / 2);
  const int i0 = ti * kTile, j0 = tj * kTile;

  if (threadIdx.x == 0) block_sum = 0;  // ordered by tile_product's barriers
  float acc[kMicro][kMicro];
  tile_product(mat, py, n, ld, m, i0, j0, vec, acc, st);

  const int ty = thread_ty();
  const int tx = thread_tx();
  int c = 0;
#pragma unroll
  for (int a = 0; a < kMicro; ++a)
#pragma unroll
    for (int b = 0; b < kMicro; ++b)
      c += is_hit(acc[a][b], i0 + micro_off(a, ty), j0 + micro_off(b, tx), m,
                  cut);
  c = __reduce_add_sync(0xffffffffu, c);
  if ((threadIdx.x & 31) == 0 && c) atomicAdd(&block_sum, c);
  __syncthreads();
  if (threadIdx.x == 0 && block_sum)
    atomicAdd(&counts[static_cast<int64_t>(ti) * n_tiles + tj], block_sum);
}

// One block per hot tile; hits append to the global (i, j, eff) buffers
// through one warp-aggregated atomicAdd on `state[0]` per ballot.  A slot
// past `capacity` is not written and raises `state[1]`.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
screen_extract_kernel(const float* __restrict__ mat,
                      const float* __restrict__ py, int n, int64_t ld, int m,
                      bool vec, float cut, const int* __restrict__ tiles,
                      int* __restrict__ out_i, int* __restrict__ out_j,
                      float* __restrict__ out_e, int capacity,
                      int* __restrict__ state) {
  __shared__ __align__(16) Stage st;
  const int i0 = tiles[2 * blockIdx.x] * kTile;
  const int j0 = tiles[2 * blockIdx.x + 1] * kTile;
  float acc[kMicro][kMicro];
  tile_product(mat, py, n, ld, m, i0, j0, vec, acc, st);

  const int ty = thread_ty();
  const int tx = thread_tx();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int a = 0; a < kMicro; ++a) {
#pragma unroll
    for (int b = 0; b < kMicro; ++b) {
      const int i = i0 + micro_off(a, ty);
      const int j = j0 + micro_off(b, tx);
      const bool hit = is_hit(acc[a][b], i, j, m, cut);
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (mask == 0u) continue;
      const int leader = __ffs(mask) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(&state[0], __popc(mask));
      base = __shfl_sync(0xffffffffu, base, leader);
      if (hit) {
        const int slot = base + __popc(mask & ((1u << lane) - 1u));
        if (slot < capacity) {
          out_i[slot] = i;
          out_j[slot] = j;
          out_e[slot] = acc[a][b];
        } else {
          atomicAdd(&state[1], 1);
        }
      }
    }
  }
}

// Every row of the panel starts on a 16-byte boundary: float4 loads apply.
bool rows_aligned(const float* mat, int64_t ld) {
  return ld % 4 == 0 && reinterpret_cast<uintptr_t>(mat) % 16 == 0;
}

}  // namespace

extern "C" {

int gmat_screen_tile_edge() { return kTile; }

// counts: (n_tiles, n_tiles) int32, zeroed by the caller.  Returns the
// CUDA error code of the launch (0 on success).
int gmat_screen_count(const float* mat, const float* py, int n, int64_t ld,
                      int m, float cut, int* counts, int n_tiles, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = static_cast<int64_t>(n_tiles) * (n_tiles + 1) / 2;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  screen_count_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      mat, py, n, ld, m, rows_aligned(mat, ld), cut, n_tiles, counts);
  return static_cast<int>(cudaGetLastError());
}

// tiles: (n_hot, 2) int32 tile coordinates (ti, tj); state: 2 int32
// (cursor, overflow), zeroed by the caller.  Returns the CUDA error code.
int gmat_screen_extract(const float* mat, const float* py, int n, int64_t ld,
                        int m, float cut, const int* tiles, int n_hot,
                        int* out_i, int* out_j, float* out_e, int capacity,
                        int* state, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_hot == 0) return 0;
  screen_extract_kernel<<<n_hot, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      mat, py, n, ld, m, rows_aligned(mat, ld), cut, tiles, out_i, out_j,
      out_e, capacity, state);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
