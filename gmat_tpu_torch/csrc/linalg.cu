// The leaves of the port's symmetric positive-definite inverse, plain C
// interface for ctypes.
//
// REML forms V⁻¹ and log|V| (n x n, n = 4,168 at the yeast panel) at
// every iteration.  `core/linalg.py::spd_inverse_logdet` splits V by
// Schur complements into blocks of at most kLeaf rows, whose products run
// on cuBLAS's FP64 tensor-core GEMMs; this kernel inverts one such block,
// in place of a Cholesky factorization and two triangular solves against
// the identity (cuSOLVER's potrf and cuBLAS's trsm), whose many dependent
// launches leave a small block latency-bound.  Replaces no TPU kernel:
// the JAX package forms V⁻¹ with XLA's Cholesky and solves
// (gmat_tpu/core/linalg.py::chol_inv_logdet).
//
// Bound: one SM's FP64 rate and the b dependent steps.  Design: one
// thread block, the matrix held in registers (8 x 32 threads, each 8 rows
// by 2 columns of the block), and Gauss-Jordan sweeps without pivoting,
// which a positive-definite matrix needs none of: at step k the owners of
// row k and of column k publish them to shared memory (double-buffered, so
// one barrier a step), and every thread updates its 16 entries, one FMA
// each (b³ in all: ≈ 4,100 cycles of one SM's FP64 units at b = 64).  The
// leaves of an n x n inverse cost n·b² FMA on one SM at a time, so b is
// small; the Schur recursion's products then do the rest.  The
// pivots are those of the block's Cholesky factorization, squared: log|A|
// is the sum of their logarithms, and the first pivot that is not
// positive marks the first leading minor that is not positive definite;
// both are reduced after the sweeps, off the steps' critical path.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLeaf = 64;
constexpr int kThreadsY = 8;
constexpr int kThreadsX = 32;
constexpr int kRowsPer = kLeaf / kThreadsY;  // 8
constexpr int kColsPer = kLeaf / kThreadsX;  // 2
constexpr int kSteps = kThreadsX / kThreadsY;  // row groups a column group spans
static_assert(kRowsPer * kThreadsY == kLeaf && kColsPer * kThreadsX == kLeaf,
              "the threads tile the largest block");
static_assert(kThreadsX % kThreadsY == 0 && kLeaf % 32 == 0 &&
              kLeaf <= kThreadsY * kThreadsX, "the steps' owners and the sums");

__global__ void __launch_bounds__(kThreadsY * kThreadsX)
spd_leaf_inverse_kernel(const double* a, int64_t lda, double* out,
                        int64_t ldo, int b, int offset, double* logdet,
                        int* order) {
  __shared__ double row_k[2][kLeaf];
  __shared__ double col_k[2][kLeaf];
  __shared__ double pivots[kLeaf];
  __shared__ double sums[kLeaf / 32];
  __shared__ int firsts[kLeaf / 32];
  const int tx = threadIdx.x, ty = threadIdx.y;
  double v[kRowsPer][kColsPer];
#pragma unroll
  for (int r = 0; r < kRowsPer; ++r) {
    const int i = ty + kThreadsY * r;
#pragma unroll
    for (int c = 0; c < kColsPer; ++c) {
      const int j = tx + kThreadsX * c;
      v[r][c] = (i < b && j < b) ? a[static_cast<int64_t>(i) * lda + j] : 0.0;
    }
  }
  // Step k = kThreadsY * kr + ks: row k is row kr of the threads with
  // ty == ks, column k column kr / kSteps of those with tx == k % 32.  kr is
  // unrolled, so that v is only ever indexed by constants and stays in
  // registers.  Every entry takes the rank-1 update, one FMA; then the
  // owners overwrite row k and column k.
#pragma unroll
  for (int kr = 0; kr < kRowsPer; ++kr) {
    constexpr int kc_of = kSteps;
    for (int ks = 0; ks < kThreadsY; ++ks) {
      const int k = kThreadsY * kr + ks;
      if (k >= b) break;
      const int buf = k & 1;
      const bool row_owner = ty == ks;
      const bool col_owner = tx == k % kThreadsX;
      if (row_owner) {
#pragma unroll
        for (int c = 0; c < kColsPer; ++c) row_k[buf][tx + kThreadsX * c] = v[kr][c];
      }
      if (col_owner) {
#pragma unroll
        for (int r = 0; r < kRowsPer; ++r) col_k[buf][ty + kThreadsY * r] = v[r][kr / kc_of];
      }
      __syncthreads();
      const double inv = 1.0 / row_k[buf][k];
      double rk[kColsPer];
#pragma unroll
      for (int c = 0; c < kColsPer; ++c) rk[c] = row_k[buf][tx + kThreadsX * c];
#pragma unroll
      for (int r = 0; r < kRowsPer; ++r) {
        const double f = col_k[buf][ty + kThreadsY * r] * inv;
#pragma unroll
        for (int c = 0; c < kColsPer; ++c) v[r][c] = fma(-f, rk[c], v[r][c]);
        if (col_owner) v[r][kr / kc_of] = -f;
      }
      if (row_owner) {
#pragma unroll
        for (int c = 0; c < kColsPer; ++c) v[kr][c] = rk[c] * inv;
        if (col_owner) v[kr][kr / kc_of] = inv;
      }
      if (tx == 0 && ty == 0) pivots[k] = row_k[buf][k];
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPer; ++r) {
    const int i = ty + kThreadsY * r;
#pragma unroll
    for (int c = 0; c < kColsPer; ++c) {
      const int j = tx + kThreadsX * c;
      if (i < b && j < b) out[static_cast<int64_t>(i) * ldo + j] = v[r][c];
    }
  }
  // log|a| and the first pivot not above 0, from the pivots in parallel
  __syncthreads();
  const int t = ty * kThreadsX + tx;
  if (t < kLeaf) {
    const double p = t < b ? pivots[t] : 1.0;
    double s = log(p);
    int bad = (t < b && !(p > 0.0)) ? t + 1 : 0x7fffffff;
    for (int d = 16; d > 0; d >>= 1) {
      s += __shfl_xor_sync(0xffffffff, s, d);
      bad = min(bad, __shfl_xor_sync(0xffffffff, bad, d));
    }
    if (tx == 0) {
      sums[t / 32] = s;
      firsts[t / 32] = bad;
    }
  }
  __syncthreads();
  if (t == 0) {
    double s = 0.0;
    int bad = 0x7fffffff;
    for (int w = 0; w < kLeaf / 32; ++w) {
      s += sums[w];
      bad = min(bad, firsts[w]);
    }
    *logdet = s;
    *order = bad == 0x7fffffff ? 0 : bad + offset;
  }
}

}  // namespace

extern "C" {

int gmat_spd_leaf() { return kLeaf; }

// One leaf of the symmetric positive-definite inverse: the b x b block `a`
// (row stride lda, b ≤ kLeaf, float64) inverted into `out` (row stride
// ldo), log|a| into *logdet and into *order 0, or `offset` plus the order
// of a's first leading minor that is not positive definite (out and
// *logdet then mean nothing).  Enqueued on `stream`, nothing waited for.
// Returns the CUDA error code of the launch (0 on success).
int gmat_spd_leaf_inverse(const double* a, int64_t lda, double* out,
                          int64_t ldo, int b, int offset, double* logdet,
                          int* order, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || b > kLeaf) return static_cast<int>(cudaErrorInvalidValue);
  spd_leaf_inverse_kernel<<<1, dim3(kThreadsX, kThreadsY), 0,
                            static_cast<cudaStream_t>(stream)>>>(
      a, lda, out, ldo, b, offset, logdet, order);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
