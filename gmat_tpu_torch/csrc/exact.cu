// Fused exact epistasis scan on Hopper (sm_90a), plain C interface for ctypes.
//
// For every anchor a of a list and every partner j < m1, with the epistasis
// covariate e = m0[:, a] ⊙ m1[:, j] over the n individuals,
//
//   eff = eᵀ py,   var = eᵀ P e,   chi = eff² / var,
//
// all in float64, and keeps the pair when chi > crit under its mask: the
// strict upper triangle j > a (AA, DD) or the full rectangle, diagonal
// included (AD).  chi = 0/0 = NaN is never a hit.  With `center`, var is
// taken on e − mean(e): the same number in exact arithmetic when P·1 = 0 (a
// design with an intercept), and free of the rounding of P along 1, which
// decides var when e is nearly constant.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;    // rows of P per row tile
constexpr int kCols = 128;    // partners per block
constexpr int kDepth = 8;     // depth of one staged slice
constexpr int kMicro = 8;     // micro-tile edge per thread
constexpr int kThreads = (kRows / kMicro) * (kCols / kMicro);  // 256
constexpr int kGroups = kRows / kMicro;  // threads that share one column
static_assert(kDepth * kRows == 4 * kThreads, "four doubles per operand per thread");
static_assert(kRows == kCols, "one staging map serves both operands");

// Row (or column) offset inside the tile of micro-tile index a of thread
// coordinate t: two runs of four, 64 apart.
__device__ __forceinline__ int micro_off(int a, int t) {
  return (a & 3) + t * 4 + (a >> 2) * 64;
}

// Thread coordinates (ty, tx) in 0..15: a warp covers 4 x 8 of them.
__device__ __forceinline__ int thread_ty() {
  return (threadIdx.x / 64) * 4 + (threadIdx.x % 32) / 8;
}
__device__ __forceinline__ int thread_tx() {
  return ((threadIdx.x / 32) % 2) * 8 + threadIdx.x % 8;
}

struct Args {
  const double* mat0;  // (n, ld0) anchor coding
  int64_t ld0;
  const double* mat1;  // (n, ld1) partner coding, partners 0..m1-1
  int64_t ld1;
  int m1;
  const double* py;    // (n,)
  const double* pvp;   // (n, n) symmetric
  int n;
  const int* anchors;  // (gridDim.x,) anchor columns of mat0
  double crit;
  int tri;
  int center;
  int* out_a;          // position of the anchor in `anchors`
  int* out_j;
  double* out_eff;
  double* out_var;
  double* out_chi;
  int capacity;
  int* state;          // cursor, overflow
  bool vec_p;          // rows of P start on 16-byte boundaries
  bool vec_1;          // rows of mat1 start on 16-byte boundaries
};

// Shared memory: two slices of P and of E, used in turn; after the product,
// the per-thread partial variances for the column reduction.
struct Stage {
  double p[2][kDepth][kRows];
  double e[2][kDepth][kCols];
};
union Smem {
  Stage st;
  double red[kGroups][kCols];
};

// Four consecutive doubles p[col..col+3], zero at and past `lim`.
__device__ __forceinline__ void load4(const double* __restrict__ p, int col,
                                      int lim, bool vec, double (&v)[4]) {
  if (vec && col + 3 < lim) {
    const double2 lo = __ldg(reinterpret_cast<const double2*>(p + col));
    const double2 hi = __ldg(reinterpret_cast<const double2*>(p + col + 2));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = col + q < lim ? __ldg(p + col + q) : 0.0;
}

// One element of E: the product, rounded, then the column's shift, rounded
// (no contraction into an FMA, so staging and epilogue agree bit for bit).
__device__ __forceinline__ double e_elem(double m1, double m0, double shift) {
  return __dsub_rn(__dmul_rn(m1, m0), shift);
}

// Global -> registers: row k0 + threadIdx.x / 32 of the slice, four columns
// per thread.  P[k, r0 + c] stands for P[r0 + c, k] (P is symmetric), so
// both operands are contiguous row reads.  E is formed here from the anchor
// column and the partner row and never stored to device memory.  Element
// offsets are int64: n·ld passes 2^31 at production widths.
__device__ __forceinline__ void load_slice(const Args& g, int anchor, int r0,
                                           int j0, int k0,
                                           const double* shift,
                                           double (&rp)[4], double (&re)[4]) {
  const int k = k0 + threadIdx.x / 32;
  const int c = (threadIdx.x % 32) * 4;
  if (k >= g.n) {
#pragma unroll
    for (int q = 0; q < 4; ++q) rp[q] = re[q] = 0.0;
    return;
  }
  load4(g.pvp + static_cast<int64_t>(k) * g.n, r0 + c, g.n, g.vec_p, rp);
  load4(g.mat1 + static_cast<int64_t>(k) * g.ld1, j0 + c, g.m1, g.vec_1, re);
  const double ak = __ldg(g.mat0 + static_cast<int64_t>(k) * g.ld0 + anchor);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    re[q] = j0 + c + q < g.m1 ? e_elem(re[q], ak, shift[c + q]) : 0.0;
}

__device__ __forceinline__ void store_slice(Stage& st, int s,
                                            const double (&rp)[4],
                                            const double (&re)[4]) {
  const int kk = threadIdx.x / 32;
  const int c = (threadIdx.x % 32) * 4;
  double2* p = reinterpret_cast<double2*>(&st.p[s][kk][c]);
  double2* e = reinterpret_cast<double2*>(&st.e[s][kk][c]);
  p[0] = make_double2(rp[0], rp[1]);
  p[1] = make_double2(rp[2], rp[3]);
  e[0] = make_double2(re[0], re[1]);
  e[1] = make_double2(re[2], re[3]);
}

// Eight doubles of one staged row: runs of four at t*4 and 64 + t*4.
__device__ __forceinline__ void read8(const double* row, int t,
                                      double (&v)[kMicro]) {
  const double2* lo = reinterpret_cast<const double2*>(row + t * 4);
  const double2* hi = reinterpret_cast<const double2*>(row + 64 + t * 4);
  const double2 a = lo[0], b = lo[1], c = hi[0], d = hi[1];
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  v[4] = c.x; v[5] = c.y; v[6] = d.x; v[7] = d.y;
}

// One block per (anchor, partner tile): blockIdx.x indexes the anchor list,
// blockIdx.y the tile of kCols partners.  For each row tile of P the block
// forms Q = P[rows, :] · E in registers and folds it into the per-column
// variance at once, var[c] += Σ_rows E[r, c] · Q[r, c], so Q never leaves
// the registers.  Every sum runs in one fixed order, so results do not
// depend on the launch.
__global__ void __launch_bounds__(kThreads, 1)
exact_scan_kernel(const Args g) {
  __shared__ __align__(16) Smem sm;
  __shared__ double shift[kCols];  // mean(e) per column with `center`, else 0
  __shared__ double col_eff[kCols];
  const int ai = blockIdx.x;
  const int anchor = g.anchors[ai];
  const int j0 = blockIdx.y * kCols;
  if (g.tri && j0 + kCols - 1 <= anchor) return;  // no partner above the anchor

  // eff = eᵀpy and the column sums of e, one column per thread
  if (threadIdx.x < kCols) {
    const int j = j0 + threadIdx.x;
    double sum = 0.0, eff = 0.0;
    if (j < g.m1) {
      for (int k = 0; k < g.n; ++k) {
        const double e = __dmul_rn(
            __ldg(g.mat1 + static_cast<int64_t>(k) * g.ld1 + j),
            __ldg(g.mat0 + static_cast<int64_t>(k) * g.ld0 + anchor));
        sum += e;
        eff = __fma_rn(e, __ldg(g.py + k), eff);
      }
    }
    shift[threadIdx.x] = g.center ? sum / g.n : 0.0;
    col_eff[threadIdx.x] = eff;
  }
  __syncthreads();

  const int ty = thread_ty();
  const int tx = thread_tx();
  double vpart[kMicro];
#pragma unroll
  for (int b = 0; b < kMicro; ++b) vpart[b] = 0.0;

  for (int r0 = 0; r0 < g.n; r0 += kRows) {
    double acc[kMicro][kMicro];
#pragma unroll
    for (int a = 0; a < kMicro; ++a)
#pragma unroll
      for (int b = 0; b < kMicro; ++b) acc[a][b] = 0.0;

    double rp[4], re[4];
    load_slice(g, anchor, r0, j0, 0, shift, rp, re);
    store_slice(sm.st, 0, rp, re);
    __syncthreads();
    int s = 0;
    for (int k0 = 0; k0 < g.n; k0 += kDepth) {
      const bool more = k0 + kDepth < g.n;
      if (more) load_slice(g, anchor, r0, j0, k0 + kDepth, shift, rp, re);
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
        double av[kMicro], bv[kMicro];
        read8(sm.st.p[s][kk], ty, av);
        read8(sm.st.e[s][kk], tx, bv);
#pragma unroll
        for (int a = 0; a < kMicro; ++a)
#pragma unroll
          for (int b = 0; b < kMicro; ++b)
            acc[a][b] = __fma_rn(av[a], bv[b], acc[a][b]);
      }
      // the other stage was last read before the previous barrier
      if (more) store_slice(sm.st, s ^ 1, rp, re);
      __syncthreads();
      s ^= 1;
    }

    // fold this row tile of Q into the variances: E[r, c] recomputed from
    // the same two factors as when it was staged, so the values agree
#pragma unroll
    for (int a = 0; a < kMicro; ++a) {
      const int r = r0 + micro_off(a, ty);
      if (r >= g.n) continue;
      const double ar = __ldg(g.mat0 + static_cast<int64_t>(r) * g.ld0 + anchor);
      const double* row = g.mat1 + static_cast<int64_t>(r) * g.ld1;
#pragma unroll
      for (int b = 0; b < kMicro; ++b) {
        const int c = micro_off(b, tx);
        if (j0 + c < g.m1)
          vpart[b] = __fma_rn(e_elem(__ldg(row + j0 + c), ar, shift[c]),
                              acc[a][b], vpart[b]);
      }
    }
  }

  // the stage is free: every thread passed the product's last barrier
#pragma unroll
  for (int b = 0; b < kMicro; ++b) sm.red[ty][micro_off(b, tx)] = vpart[b];
  __syncthreads();
  if (threadIdx.x >= kCols) return;  // warps 0-3 finish the columns, whole

  const int c = threadIdx.x;
  const int j = j0 + c;
  const bool inside = j < g.m1;
  double var = 0.0;
#pragma unroll
  for (int t = 0; t < kGroups; ++t) var += sm.red[t][c];
  const double eff = col_eff[c];
  const double chi = eff * eff / var;
  const bool hit = inside && (!g.tri || j > anchor) && chi > g.crit;

  // warp-aggregated append: one atomicAdd on the cursor per ballot; the
  // cursor counts every hit, a slot past the capacity raises the overflow
  const int lane = threadIdx.x & 31;
  const unsigned mask = __ballot_sync(0xffffffffu, hit);
  if (mask == 0u) return;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(&g.state[0], __popc(mask));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (!hit) return;
  const int slot = base + __popc(mask & ((1u << lane) - 1u));
  if (slot < g.capacity) {
    g.out_a[slot] = ai;
    g.out_j[slot] = j;
    g.out_eff[slot] = eff;
    g.out_var[slot] = var;
    g.out_chi[slot] = chi;
  } else {
    atomicAdd(&g.state[1], 1);
  }
}

bool aligned16(const void* p, int64_t ld) {
  return ld % 2 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

int gmat_exact_tile() { return kCols; }

// K2, the fused exact scan.  Replaces the TPU kernel
// gmat_tpu/scan/kernels.py::_exact_kernel_factory (driven there by
// _pallas_exact_device and pallas_exact_hits, with the in-VMEM compaction
// _compact_column), and computes in float64 what the package's XLA engine
// gmat_tpu/scan/pairs.py::_anchor_hits_body computes.
//
// Bound: FP64 operations.  A pair costs 2n² + O(n) flops, nearly all in the
// pair-variance product P·e, against 8n bytes of e that the kernel forms
// itself: far above the memory roofline (the inputs, P at 139 MB for
// n = 4168 included, are read in milliseconds).  The design keeps the work
// on the FP64 FMA pipes: a 128 x 128 output tile of Q = P·E per block,
// 8 x 8 register micro-tiles per thread, two shared-memory stages fed one
// slice ahead, E formed on the fly as it is staged and Q folded into var
// in registers, so that neither E nor Q touches device memory.  P exceeds
// the 50 MB L2, but every block walks it in the same order, so the blocks
// resident together share its slices in L2.  Blocks whose partners all lie
// at or below the anchor return at once (tri), so a triangle costs half the
// rectangle.
// On CUDA cores; DMMA tensor cores (mma.sync f64), TMA and the symmetric
// half of P are later work.
//
// center != 0 takes var on e − mean(e) (see the top of this file).  Hits
// append in no order to (out_a, out_j, out_eff, out_var, out_chi),
// out_a holding the anchor's position in `anchors`; state (2 int32:
// cursor, overflow) is zeroed by the caller.  The cursor counts every hit,
// so a caller whose buffers overflowed relaunches with capacity = cursor.
// Returns the CUDA error code of the launch (0 on success).
int gmat_exact_scan(const double* mat0, int64_t ld0, const double* mat1,
                    int64_t ld1, int m1, const double* py, const double* pvp,
                    int n, const int* anchors, int n_anchors, double crit,
                    int tri, int center, int* out_a, int* out_j,
                    double* out_eff, double* out_var, double* out_chi,
                    int capacity, int* state, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_anchors == 0 || m1 == 0) return 0;
  const int tiles = (m1 + kCols - 1) / kCols;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  Args g{mat0, ld0, mat1, ld1, m1, py, pvp, n, anchors, crit, tri, center,
         out_a, out_j, out_eff, out_var, out_chi, capacity, state,
         aligned16(pvp, n), aligned16(mat1, ld1)};
  exact_scan_kernel<<<dim3(n_anchors, tiles), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
