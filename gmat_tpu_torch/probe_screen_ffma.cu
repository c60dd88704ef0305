// The effect screen's phase-1 kernel as it was before its product moved to
// the tensor cores: a float32 FMA tile product on the CUDA cores (8x8
// register micro-tiles, 128 registers, two blocks per SM, two
// shared-memory stages fed by float4 loads one slice ahead, py folded into
// the A operand as it is staged).  The identity count only, with the C
// interface of csrc/screen.cu's gmat_screen_count, so that
// gmat_tpu_torch/probe.py can time it beside the package's kernel on the
// same card and inputs.  Nothing in the package builds or calls it.
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

// Every row of the panel starts on a 16-byte boundary: float4 loads apply.
bool rows_aligned(const float* mat, int64_t ld) {
  return ld % 4 == 0 && reinterpret_cast<uintptr_t>(mat) % 16 == 0;
}

}  // namespace

extern "C" {

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

}  // extern "C"
