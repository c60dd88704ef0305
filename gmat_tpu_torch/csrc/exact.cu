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

constexpr int kRows = 128;     // rows of P per row tile: the grain of its symmetric half
constexpr int kCols = 128;     // partners per block
constexpr int kDepth = 32;     // depth of one staged slice
constexpr int kStages = 3;     // slices in the shared-memory ring
constexpr int kThreads = 256;  // 8 warps, each on all the rows of 16 partners
constexpr int kWarpCols = 16;
constexpr int kAtomsM = kRows / 16;  // m16n8k8 atoms per warp tile: 8 x 2
constexpr int kAtomsN = kWarpCols / 8;
// Staged rows are padded by 4 doubles: the lanes of a half warp then read
// (4·g + t) mod 16 distinct 8-byte banks in every fragment load.
constexpr int kPStride = kDepth + 4;
constexpr int kBStride = kCols + 4;
constexpr int kStageDoubles = kRows * kPStride + kDepth * kBStride + kDepth;
constexpr int kSmemBytes = kStages * kStageDoubles * static_cast<int>(sizeof(double));
static_assert(kRows % kDepth == 0 && kDepth % 8 == 0, "slices tile a tile of P");
static_assert(kCols / kWarpCols * 32 == kThreads, "the warps cover the block's tile");
static_assert(kPStride % 16 == 4 && kBStride % 16 == 4, "fragment loads without bank conflicts");
static_assert(kThreads == 2 * kCols, "two threads per column in the prologue");

struct Args {
  const double* mat0;  // (n, ld0) anchor coding
  int64_t ld0;
  const double* mat1;  // (n, ld1) partner coding, partners 0..m1-1
  int64_t ld1;
  int m1;
  const double* py;    // (n,)
  const double* pvp;   // (n, n) symmetric; only its upper triangle (tile grain) is read
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

// One element of E: the product, rounded, then the column's shift, rounded
// (no contraction into an FMA, so the product's operand and the fold agree
// bit for bit).
__device__ __forceinline__ double e_elem(double m1, double m0, double shift) {
  return __dsub_rn(__dmul_rn(m1, m0), shift);
}

// Asynchronous copies global -> shared; bytes past `src_bytes` are zeroed.
__device__ __forceinline__ void copy16(double* dst, const double* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void copy8(double* dst, const double* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// D = A·B + D on the FP64 tensor cores, one 16 x 8 x 8 atom per warp.  Lane
// (g, t) = (lane / 4, lane % 4) holds A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]; B[t][g], B[t+4][g]; D[g][2t], D[g][2t+1], D[g+8][2t],
// D[g+8][2t+1].
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[4],
                                     const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// Stage the slice (r0, k0) of the block's walk into `st`: P[r0 + r, k0 + k]
// (kRows x kDepth, k0 >= r0: the upper triangle at tile grain), the raw
// partner rows mat1[k0 + k, j0 + c] (kDepth x kCols) and the anchor's column
// mat0[k0 + k, anchor].  Out of range reads zero.  16-byte copies where the
// rows allow them, else 8-byte ones.  Element offsets are int64: n·ld passes
// 2^31 at production widths.
__device__ __forceinline__ void stage_slice(const Args& g, int anchor, int j0,
                                            int r0, int k0, double* st) {
  double* sp = st;
  double* sb = st + kRows * kPStride;
  double* sa = sb + kDepth * kBStride;
  const int tid = threadIdx.x;
  if (g.vec_p) {
    constexpr int kChunks = kDepth / 2;
#pragma unroll
    for (int i = 0; i < kRows * kChunks / kThreads; ++i) {
      const int id = tid + i * kThreads;
      const int r = id / kChunks, k = k0 + 2 * (id % kChunks);
      const int valid = r0 + r < g.n ? min(max(g.n - k, 0), 2) : 0;
      copy16(sp + r * kPStride + k - k0,
             valid ? g.pvp + static_cast<int64_t>(r0 + r) * g.n + k : g.pvp,
             8 * valid);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < kRows * kDepth / kThreads; ++i) {
      const int id = tid + i * kThreads;
      const int r = id / kDepth, k = k0 + id % kDepth;
      const bool valid = r0 + r < g.n && k < g.n;
      copy8(sp + r * kPStride + k - k0,
            valid ? g.pvp + static_cast<int64_t>(r0 + r) * g.n + k : g.pvp,
            valid ? 8 : 0);
    }
  }
  if (g.vec_1) {
    constexpr int kChunks = kCols / 2;
#pragma unroll
    for (int i = 0; i < kDepth * kChunks / kThreads; ++i) {
      const int id = tid + i * kThreads;
      const int k = k0 + id / kChunks, c = 2 * (id % kChunks);
      const int valid = k < g.n ? min(max(g.m1 - j0 - c, 0), 2) : 0;
      copy16(sb + (k - k0) * kBStride + c,
             valid ? g.mat1 + static_cast<int64_t>(k) * g.ld1 + j0 + c : g.mat1,
             8 * valid);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < kDepth * kCols / kThreads; ++i) {
      const int id = tid + i * kThreads;
      const int k = k0 + id / kCols, c = id % kCols;
      const bool valid = k < g.n && j0 + c < g.m1;
      copy8(sb + (k - k0) * kBStride + c,
            valid ? g.mat1 + static_cast<int64_t>(k) * g.ld1 + j0 + c : g.mat1,
            valid ? 8 : 0);
    }
  }
  if (tid < kDepth) {
    const bool valid = k0 + tid < g.n;
    copy8(sa + tid,
          valid ? g.mat0 + static_cast<int64_t>(k0 + tid) * g.ld0 + anchor : g.mat0,
          valid ? 8 : 0);
  }
}

// acc += P_slice · E_slice for this warp's 128 x 16 part of the tile.  E is
// formed here, as the B fragments are loaded, from the staged partner rows,
// the anchor's column and the column shift: each element by one warp.
__device__ __forceinline__ void multiply_slice(
    const double* st, int wn, int gq, int tq,
    const double (&shift_b)[kAtomsN], double (&acc)[kAtomsM][kAtomsN][4]) {
  const double* sp = st + gq * kPStride + tq;
  const double* sb = st + kRows * kPStride + tq * kBStride + wn + gq;
  const double* sa = st + kRows * kPStride + kDepth * kBStride + tq;
#pragma unroll
  for (int kk = 0; kk < kDepth; kk += 8) {
    const double m0_lo = sa[kk], m0_hi = sa[kk + 4];
    double b[kAtomsN][2];
#pragma unroll
    for (int jn = 0; jn < kAtomsN; ++jn) {
      b[jn][0] = e_elem(sb[kk * kBStride + jn * 8], m0_lo, shift_b[jn]);
      b[jn][1] = e_elem(sb[(kk + 4) * kBStride + jn * 8], m0_hi, shift_b[jn]);
    }
#pragma unroll
    for (int im = 0; im < kAtomsM; ++im) {
      const double* p = sp + im * 16 * kPStride + kk;
      const double a[4] = {p[0], p[8 * kPStride], p[4], p[8 * kPStride + 4]};
#pragma unroll
      for (int jn = 0; jn < kAtomsN; ++jn) dmma(acc[im][jn], a, b[jn]);
    }
  }
}

// The next slice of the walk: k0 steps through the row tile from its own
// first row (k0 >= r0), then the next row tile starts on its diagonal.
__device__ __forceinline__ void advance(int n, int& r0, int& k0) {
  k0 += kDepth;
  if (k0 >= n) {
    r0 += kRows;
    k0 = r0;
  }
}

// One block per (anchor, partner tile): blockIdx.x indexes the anchor list,
// blockIdx.y the tile of kCols partners.  With P symmetric,
//   var_c = Σ_I E_Iᵀ·(P_II·E_I) + 2·Σ_{I<K} E_Iᵀ·(P_IK·E_K)
// over row tiles I and column tiles K of kRows.  For each row tile I the
// block forms Q_I = ½·P_II·E_I + Σ_{K>I} P_IK·E_K in registers (the diagonal
// tile comes first and the accumulator is halved after it, exact in binary
// floating point) and folds it into var_c += 2·Σ_{r∈I} E[r, c]·Q_I[r, c],
// so Q never leaves the registers.  Every sum runs in one fixed order, so
// results do not depend on the launch.
__global__ void __launch_bounds__(kThreads, 1)
exact_scan_kernel(const Args g) {
  extern __shared__ __align__(16) double ring[];
  __shared__ double shift[kCols];  // mean(e) per column with `center`, else 0
  __shared__ double col_eff[kCols];
  __shared__ double part[2][kCols];
  const int ai = blockIdx.x;
  const int anchor = g.anchors[ai];
  const int j0 = blockIdx.y * kCols;
  if (g.tri && j0 + kCols - 1 <= anchor) return;  // no partner above the anchor

  int total = 0;  // slices in the walk
  for (int r0 = 0; r0 < g.n; r0 += kRows) total += (g.n - r0 + kDepth - 1) / kDepth;
  int load_r0 = 0, load_k0 = 0;
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) {
      stage_slice(g, anchor, j0, load_r0, load_k0, ring + s * kStageDoubles);
      advance(g.n, load_r0, load_k0);
    }
    copy_commit();
  }

  // while the first slices land: eff = eᵀpy and the column sums of e, two
  // threads per column over the halves of the rows
  {
    const int c = threadIdx.x % kCols, h = threadIdx.x / kCols;
    const int j = j0 + c;
    const int half = (g.n + 1) / 2;
    const int k_end = min(g.n, (h + 1) * half);
    double sum = 0.0, eff = 0.0;
    if (j < g.m1) {
#pragma unroll 8
      for (int k = h * half; k < k_end; ++k) {
        const double e = __dmul_rn(
            __ldg(g.mat1 + static_cast<int64_t>(k) * g.ld1 + j),
            __ldg(g.mat0 + static_cast<int64_t>(k) * g.ld0 + anchor));
        sum += e;
        eff = __fma_rn(e, __ldg(g.py + k), eff);
      }
    }
    if (h == 1) {
      part[0][c] = sum;
      part[1][c] = eff;
    }
    __syncthreads();
    if (h == 0) {
      sum += part[0][c];
      shift[c] = g.center ? sum / g.n : 0.0;
      col_eff[c] = eff + part[1][c];
    }
    __syncthreads();
  }

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int wn = warp * kWarpCols;
  double shift_b[kAtomsN];  // shift of the column this lane feeds to B
#pragma unroll
  for (int jn = 0; jn < kAtomsN; ++jn) shift_b[jn] = shift[wn + jn * 8 + gq];
  double acc[kAtomsM][kAtomsN][4];
  double vpart[kAtomsN][2];
#pragma unroll
  for (int im = 0; im < kAtomsM; ++im)
#pragma unroll
    for (int jn = 0; jn < kAtomsN; ++jn)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[im][jn][q] = 0.0;
#pragma unroll
  for (int jn = 0; jn < kAtomsN; ++jn) vpart[jn][0] = vpart[jn][1] = 0.0;

  int r0 = 0, k0 = 0;
  for (int it = 0; it < total; ++it) {
    copy_wait<kStages - 2>();  // slice `it` has landed for this thread ...
    __syncthreads();           // ... and for all; slice it-1's stage is free
    if (it + kStages - 1 < total) {
      stage_slice(g, anchor, j0, load_r0, load_k0,
                  ring + ((it + kStages - 1) % kStages) * kStageDoubles);
      advance(g.n, load_r0, load_k0);
    }
    copy_commit();
    multiply_slice(ring + (it % kStages) * kStageDoubles, wn, gq, tq, shift_b,
                   acc);

    if (k0 < r0 + kRows && k0 + kDepth >= min(r0 + kRows, g.n)) {
#pragma unroll
      for (int im = 0; im < kAtomsM; ++im)  // end of the diagonal tile
#pragma unroll
        for (int jn = 0; jn < kAtomsN; ++jn)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[im][jn][q] *= 0.5;
    }
    if (k0 + kDepth >= g.n) {
      // fold this row tile of Q into the variances: E[r, c] recomputed from
      // the same factors as its B fragment, so the values agree
#pragma unroll
      for (int im = 0; im < kAtomsM; ++im) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + im * 16 + gq + 8 * h;
          if (r >= g.n) continue;
          const double ar = __ldg(g.mat0 + static_cast<int64_t>(r) * g.ld0 + anchor);
          const double* row = g.mat1 + static_cast<int64_t>(r) * g.ld1 + j0;
#pragma unroll
          for (int jn = 0; jn < kAtomsN; ++jn)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int c = wn + jn * 8 + 2 * tq + q;
              if (j0 + c < g.m1)
                vpart[jn][q] = __fma_rn(e_elem(__ldg(row + c), ar, shift[c]),
                                        acc[im][jn][2 * h + q], vpart[jn][q]);
            }
        }
      }
#pragma unroll
      for (int im = 0; im < kAtomsM; ++im)
#pragma unroll
        for (int jn = 0; jn < kAtomsN; ++jn)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[im][jn][q] = 0.0;
    }
    advance(g.n, r0, k0);
  }
  copy_wait<0>();  // only empty groups are left

  // column sums over the 8 lane groups, by shuffles
#pragma unroll
  for (int jn = 0; jn < kAtomsN; ++jn)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      double v = vpart[jn][q];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (gq == 0) part[0][wn + jn * 8 + 2 * tq + q] = v;
    }
  __syncthreads();
  if (threadIdx.x >= kCols) return;  // warps 0-3 finish the columns, whole

  const int c = threadIdx.x;
  const int j = j0 + c;
  const bool inside = j < g.m1;
  const double var = 2.0 * part[0][c];
  const double eff = col_eff[c];
  const double chi = eff * eff / var;
  const bool hit = inside && (!g.tri || j > anchor) && chi > g.crit;

  // warp-aggregated append: one atomicAdd on the cursor per ballot; the
  // cursor counts every hit, a slot past the capacity raises the overflow
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
// Bound: FP64 tensor-core operations.  The function needs n² + 7n FLOP per
// pair (P symmetric: the strict upper triangle of P·e, then O(n)), against
// 8n bytes of e that the kernel forms itself: far above the memory roofline
// (the inputs, P at 139 MB for n = 4168 included, are read in milliseconds).
// The kernel does n² + 128n FLOP of product per pair, 2·kRows² for each of
// the T(T+1)/2 tiles of P on or above the diagonal (T = ⌈n/128⌉, the last
// tile partial), on the FP64 tensor cores (mma.sync m16n8k8 f64, DMMA);
// besides, O(n) for eff, the column means and the fold, and on the CUDA
// cores 2 FP64 operations for each element of E, formed once per slice as
// the B fragments are loaded: 2·Σ_I (n − 128·I) ≈ n²/128 per pair, under 1%
// of the product.  Design: a block per (anchor, 128-partner tile), 8
// warps of 128 x 16 accumulators in registers; a ring of kStages
// slices of P and of the raw partner rows in dynamic shared memory, filled
// by cp.async kStages − 1 slices ahead, rows padded against bank conflicts;
// E formed from the staged partner rows as the B fragments are loaded, and
// Q folded into var in registers, so that neither E nor Q touches device
// memory.  P exceeds the 50 MB L2, but every block walks it in the same
// order, and the blocks resident together (consecutive anchors) share their
// partner tile, so both operands' slices are shared in L2.  Blocks whose
// partners all lie at or below the anchor return at once (tri), so a
// triangle costs half the rectangle.
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
  err = cudaFuncSetAttribute(exact_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args g{mat0, ld0, mat1, ld1, m1, py, pvp, n, anchors, crit, tri, center,
         out_a, out_j, out_eff, out_var, out_chi, capacity, state,
         aligned16(pvp, n), aligned16(mat1, ld1)};
  exact_scan_kernel<<<dim3(n_anchors, tiles), kThreads, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
