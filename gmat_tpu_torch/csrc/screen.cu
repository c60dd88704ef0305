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
// (gmat_tpu/scan/screen.py::_fused_visit).  Like the TPU kernel, whose tile
// product ran on the matrix unit, the product runs on the tensor cores.
//
// Bound: the TF32 tensor cores.  The screen performs n multiply-adds per
// tested pair and, since hits are rare at production cuts, writes almost
// nothing.  One TF32 product keeps 10 mantissa bits and leaves the f64
// hit bracket, so the product is 3xTF32: each operand x splits into
// hi = tf32(x) and lo = tf32(x - hi), both rounded by cvt.rna (to nearest,
// never by truncation), and S accumulates lo_a·hi_b, hi_a·lo_b and
// hi_a·hi_b in float32.  What it drops (lo_a·lo_b, the roundings of lo) is
// of float32's size.  The least time is thus 3 TF32 products per
// multiply-add at 495 TFLOP/s: 165 TFLOP/s of float32-grade work.
//
// Operand layout (the in-block split, not a prepass): wgmma takes TF32
// operands from shared memory K-major only (its transpose bits exist for
// 16-bit types), and both panels are stored (n, m) row-major, i.e.
// MN-major.  The operands must be split, which is arithmetic, and
// transposed, so they pass through registers once whatever feeds them.
// The block's own threads therefore load each k-chunk with coalesced
// global loads straight into registers (one column of A or of B per
// thread, kChunk k values), fold py into A, split, and store hi and lo
// K-major in the 128-byte swizzled layout that the wgmma descriptors name.
// No copy of the panels is made in device memory, and L2 serves 32 KB per
// chunk and block, half of what pre-split panels would need.  A TMA or
// cp.async copy into a staging buffer would add one write and one read of
// shared memory per element, and shared memory (with L1, one 128 B/clock
// path) is already shared by the loads, the split's stores (43 B/clock at
// the tensor rate) and wgmma.m64n128k8 reading both operands (96).
//
// Block: two warpgroups of 64 output rows each over a 128 x 128 output
// tile, wgmma.m64n128k8.f32.tf32.tf32 with 64 float32 accumulators per
// thread, and a ring of kStages stages of kChunk-deep k-chunks (hi and lo
// of both operands, 64 KB each) in dynamic shared memory, one block per
// SM.  While the tensor cores run chunk k, every thread splits and stores
// chunk k + 2 into the stage that chunk k - 1 has left and holds the loads
// of chunks k + 3 and k + 4 in flight in two register buffers; one barrier
// per chunk orders the stages.  Each chunk's products accumulate in
// registers of their own, which are added to the tile's sum in float32
// (product_step says why).  n is zero-padded to the chunk, which adds
// nothing to S.  The identity count runs its tiles in bands of
// kBand columns, and the wrapper hands list launches over in the same
// order, so that the blocks in flight share their panels' tiles in L2.
//
// What holds it back: the feed, not the tensor cores.  Apart, the products
// (`python -m gmat_tpu_torch.probe`'s `no_loads` variant) run near the
// 3xTF32 bound and the loads and the split (`no_product`) take somewhat
// longer; together they overlap in part (PERF.md, section 6).
//
// The general screen's per-pair cut is looked up in the epilogue: the
// anchor ids, bins and table are staged into shared memory before the
// loop, ordered by its first barrier.
//
// Both phases call the same tile_product routine over the same tile grid,
// so phase 2 recomputes bit-identical S values: the per-tile counts of
// phase 1 size the hit buffer exactly, which replaces the K-doubling retry
// of gmat_tpu/scan/kernels.py::pallas_screen.  Each output element sums
// over n in one fixed order (k-steps of 8 ascending in a chunk, in each the
// products lo·hi, hi·lo, hi·hi; the chunks' sums added in ascending
// order), with py folded into A in
// float32 before the split, so its value depends neither on the launch nor
// on where its pair sits in a tile, nor on which instantiation computed it:
// the mesh's shards, which screen anchor subsets, rely on that.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;        // output tile edge (rows i, cols j)
constexpr int kChunk = 32;        // k values per stage: one 128-byte row
constexpr int kStages = 3;        // ring of k-chunk stages
constexpr int kThreads = 256;     // two warpgroups
constexpr int kAcc = 64;          // accumulators per thread: 64 x 128 / 128
constexpr int kTableSize = 111;   // the reference's bin-pair cut table
constexpr int kBand = 8;          // tile columns per band of the block order
constexpr int kPart = kTile * kChunk * 4;  // bytes of one operand's hi or lo
constexpr int kStageBytes = 4 * kPart;     // A hi, A lo, B hi, B lo
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + alignment
static_assert(kThreads == 2 * kTile, "one thread per anchor row and partner column");
static_assert(kChunk * 4 == 128, "a chunk row is one 128-byte swizzle row");

// --- PTX wrappers ------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};"
               :: "r"(addr), "r"(a), "r"(b), "r"(c), "r"(d) : "memory");
}

// Generic-proxy stores to shared memory, made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (the stride
// byte offset); the leading byte offset is unused for this layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Pins the accumulators: no read or write of them moves across this point
// (wgmma writes them asynchronously, out of the compiler's sight).
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int x = 0; x < kAcc; ++x) asm volatile("" : "+f"(d[x]) :: "memory");
}

// d = A·Bᵀ + (accumulate ? d : 0) for A 64 x 8 and B 128 x 8, both TF32
// K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[kAcc], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// --- the tile product ----------------------------------------------------------

struct Panels {
  const float* __restrict__ a;  // anchor panel (n, lda), ma columns read
  const float* __restrict__ b;  // partner panel (n, ldb), mb columns read
  int64_t lda, ldb;
  int ma, mb;
};

// The 1024-byte aligned start of the stage ring in dynamic shared memory
// (the 128-byte swizzle repeats every 1024 bytes).
__device__ __forceinline__ uint32_t ring_base() {
  extern __shared__ uint8_t dyn_smem[];
  const uint32_t a =
      static_cast<uint32_t>(__cvta_generic_to_shared(dyn_smem));
  return (a + 1023u) & ~1023u;
}

// This thread's operand column: column i0 + t of A for threads t < 128,
// column j0 + t - 128 of B for the others (a warp reads 32 neighbouring
// floats per k), at row 0; null past the panel's width.  The identity
// screen passes one panel twice.
struct Column {
  const float* __restrict__ p;
  int64_t ld;
  bool is_a;  // warp-uniform
};

__device__ __forceinline__ Column thread_column(const Panels& pn, int i0,
                                                int j0) {
  const bool is_a = threadIdx.x < kTile;
  const int col = (is_a ? i0 : j0) + threadIdx.x % kTile;
  const bool in = col < (is_a ? pn.ma : pn.mb);
  const float* p = is_a ? pn.a : pn.b;
  return Column{in ? p + col : nullptr, is_a ? pn.lda : pn.ldb, is_a};
}

// A chunk of the thread's column in registers, and lane l's factor for
// k0 + l, which the warp's lanes pass round by shuffle: py[k0 + l] for A
// (0 past n), 1 for B.  py travels with the panel's loads: read where it
// is used, it would miss L1, which the panels' stream evicts, and stall
// every step; and one unconditional product for both operands keeps the
// split free of branches, whose serial per-value chains cost more.
struct Chunk {
  float x[kChunk];
  float py;
};

// Global -> registers: rows k0 .. k0 + kChunk - 1 of the thread's column,
// zero past n and past the panel's width.  Only loads: nothing here waits
// for them, so they stay in flight until store_chunk.  Element offsets are
// int64: n·ld exceeds 2^31 at production widths.
__device__ __forceinline__ void load_chunk(const Column& cl,
                                           const float* __restrict__ py,
                                           int n, int k0, Chunk& ch) {
  const float* __restrict__ p =
      cl.p ? cl.p + static_cast<int64_t>(k0) * cl.ld : nullptr;
  if (p != nullptr && k0 + kChunk <= n) {
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) ch.x[kk] = __ldg(p + kk * cl.ld);
  } else {
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk)
      ch.x[kk] = (p != nullptr && k0 + kk < n) ? __ldg(p + kk * cl.ld)
                                               : 0.0f;
  }
  const int k = k0 + threadIdx.x % 32;
  ch.py = !cl.is_a ? 1.0f : k < n ? __ldg(py + k) : 0.0f;
}

// Registers -> stage: the values times their factor (A's py[k], folded in
// float32 before the split, as the plain version folds it; __fmul_rn keeps
// the product out of the split's subtraction; past n both factors are 0;
// B's 1 changes no bit), then hi and lo.  The thread's column is row c of
// its operand, stored as hi then lo (each 128 rows of 128 bytes); the
// 16-byte group q of row c (k = 4q .. 4q+3) goes to group q ^ (c % 8), the
// 128-byte swizzle.
__device__ __forceinline__ void store_chunk(uint32_t stage, const Chunk& ch) {
  const int c = threadIdx.x % kTile;
  const uint32_t row = stage + (threadIdx.x / kTile) * 2 * kPart + c * 128;
#pragma unroll
  for (int q = 0; q < kChunk / 4; ++q) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = 4 * q + e;
      float v = ch.x[kk];
      v = __fmul_rn(v, __shfl_sync(0xffffffffu, ch.py, kk));
      hi[e] = tf32_rna(v);
      lo[e] = tf32_rna(__fsub_rn(v, __uint_as_float(hi[e])));
    }
    const uint32_t off = static_cast<uint32_t>((q ^ (c & 7)) << 4);
    st_shared_v4(row + off, hi[0], hi[1], hi[2], hi[3]);
    st_shared_v4(row + kPart + off, lo[0], lo[1], lo[2], lo[3]);
  }
}

// The 3xTF32 products of one stage into `part`, which they overwrite: per
// k-step of 8, lo·hi, hi·lo, hi·hi.  Warpgroup w multiplies the anchor rows
// 64w .. 64w+63.
__device__ __forceinline__ void multiply_chunk(float (&part)[kAcc],
                                            uint32_t stage) {
  const uint32_t a = stage + (threadIdx.x / 128) * (64 * 128);
  const uint32_t b = stage + 2 * kPart;
#pragma unroll
  for (int ks = 0; ks < kChunk / 8; ++ks) {
    const uint32_t k_off = ks * 32;  // 8 TF32 values
    wgmma_tf32(part, smem_desc(a + kPart + k_off), smem_desc(b + k_off),
               ks > 0);
    wgmma_tf32(part, smem_desc(a + k_off), smem_desc(b + kPart + k_off), 1);
    wgmma_tf32(part, smem_desc(a + k_off), smem_desc(b + k_off), 1);
  }
}

// One step of the product loop, on the register buffer x.  The products of
// chunk kc go to the tensor cores, into `part`; while they run, chunk
// kc + 2 is split and stored from x into the stage that chunk kc - 1 left
// (retired by every warp before the last barrier), and x takes the loads
// of chunk kc + 4, which nothing uses before they are stored two steps
// later.  Then the chunk's sum is added to d in float32, rounded to
// nearest.
//
// The two-level sum is for precision: the tensor cores' float32
// accumulation is coarser than an FADD's round to nearest.  With one
// accumulator over all of n, scores that cancel to a small |S| (a near
// keep-all cut at n = 1304) came out 2e-4 off the f64 oracle on the card,
// past the 1e-4 that the float32 product meets and that the same scheme
// with rounded sums meets (tile_product_3xtf32_ref).  Within a chunk the
// tensor cores accumulate 12 products from zero; across chunks d takes
// one rounded addition each.
__device__ __forceinline__ void product_step(const Column& cl,
                                             const float* __restrict__ py,
                                             int n, int nk, int kc,
                                             uint32_t ring, float (&d)[kAcc],
                                             float (&part)[kAcc], Chunk& x) {
  wgmma_fence();
  multiply_chunk(part, ring + (kc % kStages) * kStageBytes);
  wgmma_commit();
  if (kc + 2 < nk) {
    store_chunk(ring + ((kc + 2) % kStages) * kStageBytes, x);
    fence_proxy_async();
  }
  if (kc + 4 < nk) load_chunk(cl, py, n, (kc + 4) * kChunk, x);
  wgmma_wait<0>();
  fence_acc(part);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) d[i] = __fadd_rn(d[i], part[i]);
  __syncthreads();
}

// d[x] = S at (acc_row(x), acc_col(x)) of the tile (i0, j0): chunks 0 and 1
// staged before the loop, chunks 2 and 3 loaded into the two buffers, the
// loop unrolled by two so that the buffers alternate by name.
__device__ __forceinline__ void tile_product(const Panels& pn,
                                             const float* __restrict__ py,
                                             int n, int i0, int j0,
                                             float (&d)[kAcc]) {
  const uint32_t ring = ring_base();
  const Column cl = thread_column(pn, i0, j0);
  const int nk = (n + kChunk - 1) / kChunk;
  float part[kAcc];
#pragma unroll
  for (int x = 0; x < kAcc; ++x) d[x] = part[x] = 0.0f;
  Chunk xa, xb;
  for (int kc = 0; kc < 2 && kc < nk; ++kc) {
    load_chunk(cl, py, n, kc * kChunk, xa);
    store_chunk(ring + kc * kStageBytes, xa);
  }
  fence_proxy_async();
  if (2 < nk) load_chunk(cl, py, n, 2 * kChunk, xa);
  if (3 < nk) load_chunk(cl, py, n, 3 * kChunk, xb);
  __syncthreads();
  fence_acc(part);
  for (int kc = 0; kc < nk; kc += 2) {
    product_step(cl, py, n, nk, kc, ring, d, part, xa);
    if (kc + 1 == nk) break;
    product_step(cl, py, n, nk, kc + 1, ring, d, part, xb);
  }
}

// Tile row and column of accumulator x of this thread: warp w of the block
// holds rows 16w .. 16w+15 (warpgroup w / 4, rows 64 apart), lane (g, t) =
// (lane / 4, lane % 4) rows g and g + 8 and, in each 8-column group,
// columns 2t and 2t + 1.
__device__ __forceinline__ int acc_row(int x) {
  return (threadIdx.x / 32) * 16 + (threadIdx.x % 32) / 4 + 8 * ((x >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int x) {
  return 8 * (x >> 2) + 2 * (threadIdx.x % 4) + (x & 1);
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
__device__ __forceinline__ void count_tile(const float (&d)[kAcc], Hit hit,
                                           int* block_sum,
                                           int* __restrict__ dst) {
  int c = 0;
#pragma unroll
  for (int x = 0; x < kAcc; ++x) c += hit(d[x], acc_row(x), acc_col(x));
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
    const float (&d)[kAcc], Hit hit, int i0, int j0,
    int* __restrict__ out_i, int* __restrict__ out_j,
    float* __restrict__ out_e, int capacity, int* __restrict__ state) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int x = 0; x < kAcc; ++x) {
    const int r = acc_row(x);
    const int c = acc_col(x);
    const bool h = hit(d[x], r, c);
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
        out_e[slot] = d[x];
      } else {
        atomicAdd(&state[1], 1);
      }
    }
  }
}

// The upper-triangle tile (ti <= tj) of block b: the tiles in bands of
// kBand columns, band by band, and in a band row by row, so that the
// blocks in flight at once (one per SM, in block order) read a few tiles
// of each panel, each from L2 by several blocks, rather than one column
// of tiles, each read from device memory by one block.  Band q starts at
// column c0 = q·kBand after c0(c0+1)/2 blocks; its rows 0 .. c0 hold all
// its w columns, row c0 + r the w - r columns right of the diagonal.
__device__ __forceinline__ void band_tile(int64_t b, int n_tiles, int& ti,
                                          int& tj) {
  int c = static_cast<int>((sqrt(8.0 * static_cast<double>(b) + 1.0) - 1.0) / 2.0);
  while (static_cast<int64_t>(c + 1) * (c + 2) / 2 <= b) ++c;
  while (static_cast<int64_t>(c) * (c + 1) / 2 > b) --c;
  const int c0 = c - c % kBand;
  const int w = min(kBand, n_tiles - c0);
  int64_t local = b - static_cast<int64_t>(c0) * (c0 + 1) / 2;
  if (local < static_cast<int64_t>(c0 + 1) * w) {
    ti = static_cast<int>(local / w);
    tj = c0 + static_cast<int>(local % w);
    return;
  }
  local -= static_cast<int64_t>(c0 + 1) * w;
  ti = c0 + 1;
  for (int width = w - 1; local >= width; --width) {
    local -= width;
    ++ti;
  }
  tj = ti + static_cast<int>(local);
}

// Identity screen, phase 1: one block per upper-triangle tile (ti <= tj),
// in band_tile's order.
__global__ void __launch_bounds__(kThreads, 1)
screen_count_kernel(const float* __restrict__ mat,
                    const float* __restrict__ py, int n, int64_t ld, int m,
                    float cut, int n_tiles, int* __restrict__ counts) {
  __shared__ int block_sum;
  int ti, tj;
  band_tile(blockIdx.x, n_tiles, ti, tj);
  const int i0 = ti * kTile, j0 = tj * kTile;

  if (threadIdx.x == 0) block_sum = 0;  // ordered by tile_product's barriers
  float d[kAcc];
  tile_product(Panels{mat, mat, ld, ld, m, m}, py, n, i0, j0, d);
  count_tile(d,
             [&](float s, int r, int c) {
               return is_hit(s, i0 + r, j0 + c, m, cut);
             },
             &block_sum, &counts[static_cast<int64_t>(ti) * n_tiles + tj]);
}

// Identity screen, phase 2: one block per hot tile (ti, tj).
__global__ void __launch_bounds__(kThreads, 1)
screen_extract_kernel(const float* __restrict__ mat,
                      const float* __restrict__ py, int n, int64_t ld, int m,
                      float cut, const int* __restrict__ tiles,
                      int* __restrict__ out_i, int* __restrict__ out_j,
                      float* __restrict__ out_e, int capacity,
                      int* __restrict__ state) {
  const int i0 = tiles[2 * blockIdx.x] * kTile;
  const int j0 = tiles[2 * blockIdx.x + 1] * kTile;
  float d[kAcc];
  tile_product(Panels{mat, mat, ld, ld, m, m}, py, n, i0, j0, d);
  extract_tile(d,
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
};

// General screen, phase 1: one block per work-list entry (anchor tile ta,
// partner tile tb); counts is (., n_tb).
__global__ void __launch_bounds__(kThreads, 1)
screen_count_general_kernel(Panels pn, General g,
                            const int* __restrict__ work,
                            int* __restrict__ counts, int n_tb) {
  __shared__ CutTile ct;
  __shared__ int block_sum;
  const int ta = work[2 * blockIdx.x], tb = work[2 * blockIdx.x + 1];
  const int i0 = ta * kTile, j0 = tb * kTile;
  if (threadIdx.x == 0) block_sum = 0;
  stage_cut_tile(ct, g.ids, g.n_a, i0, j0, g.m, g.bins_a, g.bins_b, g.table,
                 g.cut);
  float d[kAcc];
  tile_product(pn, g.py, g.n, i0, j0, d);
  const int m = g.m;
  count_tile(d,
             [&](float s, int r, int c) {
               return is_general_hit(s, ct, r, c, j0, m);
             },
             &block_sum, &counts[static_cast<int64_t>(ta) * n_tb + tb]);
}

// General screen, phase 2: one block per hot tile (ta, tb); the rows are
// anchor positions.
__global__ void __launch_bounds__(kThreads, 1)
screen_extract_general_kernel(Panels pn, General g,
                              const int* __restrict__ tiles,
                              int* __restrict__ out_p, int* __restrict__ out_j,
                              float* __restrict__ out_e, int capacity,
                              int* __restrict__ state) {
  __shared__ CutTile ct;
  const int i0 = tiles[2 * blockIdx.x] * kTile;
  const int j0 = tiles[2 * blockIdx.x + 1] * kTile;
  stage_cut_tile(ct, g.ids, g.n_a, i0, j0, g.m, g.bins_a, g.bins_b, g.table,
                 g.cut);
  float d[kAcc];
  tile_product(pn, g.py, g.n, i0, j0, d);
  const int m = g.m;
  extract_tile(d,
               [&](float s, int r, int c) {
                 return is_general_hit(s, ct, r, c, j0, m);
               },
               i0, j0, out_p, out_j, out_e, capacity, state);
}

// Opens the stage ring's dynamic shared memory (above the 48 KB default)
// for `kernel` on the current device; the CUDA error code.
template <class Kernel>
cudaError_t allow_ring(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemBytes);
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
  err = allow_ring(screen_count_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  screen_count_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      mat, py, n, ld, m, cut, n_tiles, counts);
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
  err = allow_ring(screen_extract_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  screen_extract_kernel<<<n_hot, kThreads, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      mat, py, n, ld, m, cut, tiles, out_i, out_j, out_e, capacity, state);
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
  err = allow_ring(screen_count_general_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  screen_count_general_kernel<<<n_work, kThreads, kSmemBytes,
                                static_cast<cudaStream_t>(stream)>>>(
      Panels{a, b, lda, ldb, ma, m},
      General{py, ids, bins_a, bins_b, table, cut, n, m, n_a}, work, counts,
      n_tb);
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
  err = allow_ring(screen_extract_general_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  screen_extract_general_kernel<<<n_hot, kThreads, kSmemBytes,
                                  static_cast<cudaStream_t>(stream)>>>(
      Panels{a, b, lda, ldb, ma, m},
      General{py, ids, bins_a, bins_b, table, cut, n, m, n_a}, tiles, out_p,
      out_j, out_e, capacity, state);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
