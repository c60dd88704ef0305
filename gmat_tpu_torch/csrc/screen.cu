// Epistasis effect screen on Hopper (sm_90a), plain C interface for ctypes.
//
// Computes, for S = (A ⊙ py)ᵀ B with A the (n, ·) row-major float32 anchor
// panel and B the (n, m) partner panel, the pairs (anchor i, partner j),
// j > i, j < m, with |S| above the cut.  Two instantiations share one tile
// product:
//   - the identity screen (gmat_screen_count / gmat_screen_extract): B = A,
//     column i of A is anchor i, one flat cut, the upper-triangle tiles;
//   - the general screen (gmat_screen_count_general / _extract_general):
//     column p of A is anchor position p with SNP id ids[p] (identity when
//     ids is null), a second panel B, and the cut
//     table[bins_a[id]*10 + bins_b[j]] of the reference's MAF/het-binned
//     screens (a flat cut when the table is null), over a work list of
//     (anchor tile, partner tile) pairs.
//
// Replaces the TPU kernels in gmat_tpu/scan/kernels.py:
//   gmat_screen_count[_general]   <- _count_kernel (phase 1: per-tile hit
//                                    counts)
//   gmat_screen_extract[_general] <- _screen_extract_factory + _compact_column
//                                    (phase 2: recompute hot tiles, compact
//                                    hits)
// and serves the general screen that the JAX package runs on its XLA engine
// (gmat_tpu/scan/screen.py::_fused_visit).
//
// Bound: FP32 FMA throughput.  The screen performs n FMAs per tested pair
// and, since hits are rare at production cuts, writes almost nothing; the
// panels are re-read from L2 once per output tile.  This first version keeps
// to CUDA cores: a shared-memory tiled float32 FMA with 8x8 register
// micro-tiles (128 registers, two blocks per SM), two shared-memory stages
// fed by float4 global loads one slice ahead, and py folded into the A
// operand as it is staged.  Later work moves the product to tensor cores
// (wgmma with TMA-fed shared memory) once a precision scheme that keeps the
// f64-oracle hit set is chosen; TF32 alone does not keep it.
//
// The general screen's per-pair cut is looked up in the epilogue, after the
// product loop: the anchor ids, bins and table are staged into shared memory
// before the loop, so they hold no registers under the 128-register cap.
//
// Both phases call the same tile_product routine over the same tile grid,
// so phase 2 recomputes bit-identical S values: the per-tile counts of
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
constexpr int kTableSize = 111;  // the reference's bin-pair cut table
static_assert(kDepth * kTile == 4 * kThreads, "one float4 per operand per thread");
static_assert(kThreads == 2 * kTile, "one thread per anchor row and partner column");

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
// and partner (B) tiles, four columns per thread, zero past n and past the
// panels' widths ma and mb.  The columns load as one float4 when both
// panels' rows are 16-byte aligned (`vec`).  Element offsets into a panel
// are int64: n·ld exceeds 2^31 at production widths.  The identity screen
// passes one panel twice, so its loads are those of a single panel.
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

struct Panels {
  const float* __restrict__ a;  // anchor panel (n, lda), ma columns read
  const float* __restrict__ b;  // partner panel (n, ldb), mb columns read
  int64_t lda, ldb;
  int ma, mb;
};

__device__ __forceinline__ void load_slice(
    const Panels& pn, const float* __restrict__ py, int n, int i0, int j0,
    int k0, bool vec, float4& ra, float4& rb) {
  const int k = k0 + threadIdx.x / 32;
  const int c = (threadIdx.x % 32) * 4;
  ra = rb = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (k < n) {
    const float pk = py[k];
    ra = load4(pn.a + static_cast<int64_t>(k) * pn.lda, i0 + c, pn.ma, vec);
    rb = load4(pn.b + static_cast<int64_t>(k) * pn.ldb, j0 + c, pn.mb, vec);
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
    const Panels& pn, const float* __restrict__ py, int n, int i0, int j0,
    bool vec, float (&acc)[kMicro][kMicro], Stage& st) {
  const int ty = thread_ty();
  const int tx = thread_tx();
#pragma unroll
  for (int a = 0; a < kMicro; ++a)
#pragma unroll
    for (int b = 0; b < kMicro; ++b) acc[a][b] = 0.0f;

  float4 ra, rb;
  load_slice(pn, py, n, i0, j0, 0, vec, ra, rb);
  store_slice(st, 0, ra, rb);
  __syncthreads();
  int s = 0;
  for (int k0 = 0; k0 < n; k0 += kDepth) {
    const bool more = k0 + kDepth < n;
    if (more) load_slice(pn, py, n, i0, j0, k0 + kDepth, vec, ra, rb);
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

// The general screen's view of one output tile, staged into shared memory
// before the product loop (ordered by its first barrier): each row's anchor
// id (m for positions past the list, so that no j > id), each row's table
// row bins_a[id]*10, each column's bins_b[j], and the table (every entry
// `cut` when the table is null).
struct CutTile {
  int id[kTile];
  int row[kTile];
  int col[kTile];
  float table[kTableSize];
};

__device__ __forceinline__ void stage_cut_tile(
    CutTile& ct, const int* __restrict__ ids, int n_a, int i0, int j0, int m,
    const int* __restrict__ bins_a, const int* __restrict__ bins_b,
    const float* __restrict__ table, float cut) {
  const int t = threadIdx.x;
  if (t < kTile) {
    const int p = i0 + t;
    const int id = p < n_a ? (ids ? ids[p] : p) : m;
    ct.id[t] = id;
    ct.row[t] = (bins_a && id < m) ? bins_a[id] * 10 : 0;
  } else {
    const int j = j0 + t - kTile;
    ct.col[t - kTile] = (bins_b && j < m) ? bins_b[j] : 0;
  }
  if (t < kTableSize) ct.table[t] = table ? table[t] : cut;
}

__device__ __forceinline__ bool is_general_hit(float s, const CutTile& ct,
                                               int r, int c, int j0, int m) {
  const int j = j0 + c;
  return j > ct.id[r] && j < m &&
         fabsf(s) > ct.table[ct.row[r] + ct.col[c]];  // NaN is never a hit
}

// Phase-1 epilogue: the block's hit count, added to *dst when nonzero.
// hit(s, r, c) tests S at row r, column c of the tile.
template <class Hit>
__device__ __forceinline__ void count_tile(const float (&acc)[kMicro][kMicro],
                                           Hit hit, int* block_sum,
                                           int* __restrict__ dst) {
  const int ty = thread_ty();
  const int tx = thread_tx();
  int c = 0;
#pragma unroll
  for (int a = 0; a < kMicro; ++a)
#pragma unroll
    for (int b = 0; b < kMicro; ++b)
      c += hit(acc[a][b], micro_off(a, ty), micro_off(b, tx));
  c = __reduce_add_sync(0xffffffffu, c);
  if ((threadIdx.x & 31) == 0 && c) atomicAdd(block_sum, c);
  __syncthreads();
  if (threadIdx.x == 0 && *block_sum) atomicAdd(dst, *block_sum);
}

// Phase-2 epilogue: the tile's hits append to the global (row, j, eff)
// buffers through one warp-aggregated atomicAdd on `state[0]` per ballot,
// the row written as i0 + r.  A slot past `capacity` is not written and
// raises `state[1]`.
template <class Hit>
__device__ __forceinline__ void extract_tile(
    const float (&acc)[kMicro][kMicro], Hit hit, int i0, int j0,
    int* __restrict__ out_i, int* __restrict__ out_j,
    float* __restrict__ out_e, int capacity, int* __restrict__ state) {
  const int ty = thread_ty();
  const int tx = thread_tx();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int a = 0; a < kMicro; ++a) {
#pragma unroll
    for (int b = 0; b < kMicro; ++b) {
      const int r = micro_off(a, ty);
      const int c = micro_off(b, tx);
      const bool h = hit(acc[a][b], r, c);
      const unsigned mask = __ballot_sync(0xffffffffu, h);
      if (mask == 0u) continue;
      const int leader = __ffs(mask) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(&state[0], __popc(mask));
      base = __shfl_sync(0xffffffffu, base, leader);
      if (h) {
        const int slot = base + __popc(mask & ((1u << lane) - 1u));
        if (slot < capacity) {
          out_i[slot] = i0 + r;
          out_j[slot] = j0 + c;
          out_e[slot] = acc[a][b];
        } else {
          atomicAdd(&state[1], 1);
        }
      }
    }
  }
}

// Identity screen, phase 1: one block per upper-triangle tile (ti <= tj),
// enumerated column by column: block b = tj(tj+1)/2 + ti.
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
  tile_product(Panels{mat, mat, ld, ld, m, m}, py, n, i0, j0, vec, acc, st);
  count_tile(acc,
             [&](float s, int r, int c) {
               return is_hit(s, i0 + r, j0 + c, m, cut);
             },
             &block_sum, &counts[static_cast<int64_t>(ti) * n_tiles + tj]);
}

// Identity screen, phase 2: one block per hot tile (ti, tj).
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
  tile_product(Panels{mat, mat, ld, ld, m, m}, py, n, i0, j0, vec, acc, st);
  extract_tile(acc,
               [&](float s, int r, int c) {
                 return is_hit(s, i0 + r, j0 + c, m, cut);
               },
               i0, j0, out_i, out_j, out_e, capacity, state);
}

// What the general screen's kernels share beyond the panels.
struct General {
  const float* __restrict__ py;
  const int* __restrict__ ids;     // (n_a,) anchor ids, or null: id = position
  const int* __restrict__ bins_a;  // (m,), or null: all 0
  const int* __restrict__ bins_b;  // (m,), or null: all 0
  const float* __restrict__ table; // (111,), or null: `cut` everywhere
  float cut;
  int n, m, n_a;
  bool vec;
};

// General screen, phase 1: one block per work-list entry (anchor tile ta,
// partner tile tb); counts is (., n_tb).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
screen_count_general_kernel(Panels pn, General g,
                            const int* __restrict__ work,
                            int* __restrict__ counts, int n_tb) {
  __shared__ __align__(16) Stage st;
  __shared__ CutTile ct;
  __shared__ int block_sum;
  const int ta = work[2 * blockIdx.x], tb = work[2 * blockIdx.x + 1];
  const int i0 = ta * kTile, j0 = tb * kTile;
  if (threadIdx.x == 0) block_sum = 0;
  stage_cut_tile(ct, g.ids, g.n_a, i0, j0, g.m, g.bins_a, g.bins_b, g.table,
                 g.cut);
  float acc[kMicro][kMicro];
  tile_product(pn, g.py, g.n, i0, j0, g.vec, acc, st);
  const int m = g.m;
  count_tile(acc,
             [&](float s, int r, int c) {
               return is_general_hit(s, ct, r, c, j0, m);
             },
             &block_sum, &counts[static_cast<int64_t>(ta) * n_tb + tb]);
}

// General screen, phase 2: one block per hot tile (ta, tb); the rows are
// anchor positions.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
screen_extract_general_kernel(Panels pn, General g,
                              const int* __restrict__ tiles,
                              int* __restrict__ out_p, int* __restrict__ out_j,
                              float* __restrict__ out_e, int capacity,
                              int* __restrict__ state) {
  __shared__ __align__(16) Stage st;
  __shared__ CutTile ct;
  const int i0 = tiles[2 * blockIdx.x] * kTile;
  const int j0 = tiles[2 * blockIdx.x + 1] * kTile;
  stage_cut_tile(ct, g.ids, g.n_a, i0, j0, g.m, g.bins_a, g.bins_b, g.table,
                 g.cut);
  float acc[kMicro][kMicro];
  tile_product(pn, g.py, g.n, i0, j0, g.vec, acc, st);
  const int m = g.m;
  extract_tile(acc,
               [&](float s, int r, int c) {
                 return is_general_hit(s, ct, r, c, j0, m);
               },
               i0, j0, out_p, out_j, out_e, capacity, state);
}

// Every row of the panel starts on a 16-byte boundary: float4 loads apply.
bool rows_aligned(const float* mat, int64_t ld) {
  return ld % 4 == 0 && reinterpret_cast<uintptr_t>(mat) % 16 == 0;
}

General general_args(const float* a, int64_t lda, const float* b,
                     int64_t ldb, const float* py, int n, int m,
                     const int* ids, int n_a, const int* bins_a,
                     const int* bins_b, const float* table, float cut) {
  return General{py, ids, bins_a, bins_b, table, cut, n, m, n_a,
                 rows_aligned(a, lda) && rows_aligned(b, ldb)};
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

// The general screen.  a: (n, lda) anchor panel whose first ma columns are
// read, column p holding anchor position p; b: (n, ldb) partner panel of m
// columns; ids: (n_a,) int32 anchor ids in [0, m), or null for ids = 0..n_a-1;
// bins_a, bins_b: (m,) int32 in [0, 10], or null; table: (111,) float32, or
// null for the flat `cut`.  work: (n_work, 2) int32 (anchor tile, partner
// tile); counts: (ceil(n_a / 128), n_tb) int32, zeroed by the caller.
int gmat_screen_count_general(const float* a, int64_t lda, int ma,
                              const float* b, int64_t ldb, const float* py,
                              int n, int m, const int* ids, int n_a,
                              const int* bins_a, const int* bins_b,
                              const float* table, float cut, const int* work,
                              int n_work, int* counts, int n_tb, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_work == 0) return 0;
  screen_count_general_kernel<<<n_work, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      Panels{a, b, lda, ldb, ma, m},
      general_args(a, lda, b, ldb, py, n, m, ids, n_a, bins_a, bins_b, table,
                   cut),
      work, counts, n_tb);
  return static_cast<int>(cudaGetLastError());
}

// tiles: (n_hot, 2) int32 (anchor tile, partner tile); out_p receives the
// anchor position of each hit; state as for gmat_screen_extract.
int gmat_screen_extract_general(const float* a, int64_t lda, int ma,
                                const float* b, int64_t ldb, const float* py,
                                int n, int m, const int* ids, int n_a,
                                const int* bins_a, const int* bins_b,
                                const float* table, float cut,
                                const int* tiles, int n_hot, int* out_p,
                                int* out_j, float* out_e, int capacity,
                                int* state, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_hot == 0) return 0;
  screen_extract_general_kernel<<<n_hot, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      Panels{a, b, lda, ldb, ma, m},
      general_args(a, lda, b, ldb, py, n, m, ids, n_a, bins_a, bins_b, table,
                   cut),
      tiles, out_p, out_j, out_e, capacity, state);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
