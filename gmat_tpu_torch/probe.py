"""Probes of the tensor cores and of the scan kernels on the card.

    python -m gmat_tpu_torch.probe

1. The f64 shapes of `mma.sync` (DMMA): m8n8k4 (sm_80 on) and m16n8k4 /
   m16n8k8 / m16n8k16 (sm_90 on).  For each, checks the fragment layout that
   `csrc/exact.cu` assumes (lane (g, t) = (lane / 4, lane % 4); A register
   i at row g + 8·(i % 2), column t + 4·(i // 2) for 16 rows, column
   t + 4·i for 8; B register i at row t + 4·i, column g; D register i at
   row g + 8·(i // 2), column 2t + i % 2) against torch.matmul on one atom,
   and times its register-resident rate: 8 independent accumulators per
   warp, 8 warps per block, at 4 blocks per SM and at 1 (the exact-scan
   kernel's 8 warps per SM).
2. The exact-scan kernel at the yeast part of chip_smoke.py (n=4168,
   m=28220, the 301 anchors of part 1 of 100, tri, center; seeded inputs):
   as built; `m8n8k4`, with each m16n8k8 atom issued as four m8n8k4 DMMAs
   on the same fragments; and two variants of `csrc/exact.cu` whose
   results are wrong by design, each without one piece of the work:
   `no_staging` (after the first slices the ring is not refilled) and
   `no_product` (no DMMA).
3. The screen's count kernel (`csrc/screen.cu::gmat_screen_count`) at the
   yeast shape of chip_smoke.py (n=4168, m=28220; a seeded panel, the cut
   at about 1e5 hits): as built (3xTF32 on wgmma); `no_loads` (after the
   two stages of the prologue no chunk is loaded, split or stored),
   `no_product` (no wgmma), `no_split` (hi = lo = x, no TF32 rounding)
   and `no_fence` (no proxy fence behind the stores), all wrong by design;
   `unbanded`, its blocks column by column instead of in bands of 8 tile
   columns; and `ffma`, the kernel's earlier float32 FMA product on the
   CUDA cores (`probe_screen_ffma.cu`, the identity count with the same C
   interface).

Times are the median of 3 launches after a warm-up (CUDA events).  Prints
the card's name and power limit, the DMMA opcodes in each shape's SASS, the
variants' registers and spills, and one JSON line per shape and per
variant.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

from gmat_tpu_torch.core import native
from gmat_tpu_torch.scan import kernels as K
from gmat_tpu_torch.scan.pairs import balanced_anchor_split

SHAPES = [(8, 4), (16, 4), (16, 8), (16, 16)]  # (M, K); N = 8
YEAST = (4168, 28220)

_SOURCE = r"""
#include <cuda_runtime.h>

template <int M, int K> __device__ void mma(double* d, const double* a, const double* b);
template <> __device__ __forceinline__ void mma<8, 4>(double* d, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(d[0]), "+d"(d[1]) : "d"(a[0]), "d"(b[0]));
}
template <> __device__ __forceinline__ void mma<16, 4>(double* d, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
               "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}
template <> __device__ __forceinline__ void mma<16, 8>(double* d, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
template <> __device__ __forceinline__ void mma<16, 16>(double* d, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
               "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
                 "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

template <int M, int K>
__global__ void check_kernel(const double* a, const double* b, double* d) {
  const int g = threadIdx.x / 4, t = threadIdx.x % 4;
  double ra[M * K / 32], rb[K / 4], rd[M / 4];
  for (int i = 0; i < M * K / 32; ++i)
    ra[i] = M == 16 ? a[(g + 8 * (i % 2)) * K + t + 4 * (i / 2)] : a[g * K + t + 4 * i];
  for (int i = 0; i < K / 4; ++i) rb[i] = b[(t + 4 * i) * 8 + g];
  for (int i = 0; i < M / 4; ++i) rd[i] = 0.0;
  mma<M, K>(rd, ra, rb);
  for (int i = 0; i < M / 4; ++i) d[(g + 8 * (i / 2)) * 8 + 2 * t + i % 2] = rd[i];
}

template <int M, int K>
__global__ void rate_kernel(const double* seed, double* out, int iters) {
  double ra[M * K / 32], rb[K / 4], rd[8][M / 4];
  for (int i = 0; i < M * K / 32; ++i) ra[i] = seed[(threadIdx.x + i) % 64];
  for (int i = 0; i < K / 4; ++i) rb[i] = seed[(threadIdx.x + 7 * i) % 64];
  for (int q = 0; q < 8; ++q)
    for (int i = 0; i < M / 4; ++i) rd[q][i] = 0.0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int q = 0; q < 8; ++q) mma<M, K>(rd[q], ra, rb);
  }
  double s = 0.0;
  for (int q = 0; q < 8; ++q)
    for (int i = 0; i < M / 4; ++i) s += rd[q][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int M, int K>
int run(int check, const double* a, const double* b, double* d, int blocks,
        int iters, cudaStream_t stream) {
  if (check) check_kernel<M, K><<<1, 32, 0, stream>>>(a, b, d);
  else rate_kernel<M, K><<<blocks, 256, 0, stream>>>(a, d, iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dmma_probe(int shape, int check, const double* a, const double* b,
                          double* d, int blocks, int iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (shape) {
    case 0: return run<8, 4>(check, a, b, d, blocks, iters, s);
    case 1: return run<16, 4>(check, a, b, d, blocks, iters, s);
    case 2: return run<16, 8>(check, a, b, d, blocks, iters, s);
    case 3: return run<16, 16>(check, a, b, d, blocks, iters, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
"""

# variants of K2, as (pattern, replacement) edits of csrc/exact.cu
_VARIANTS = {
    "kernel": [],
    "no_staging": [("    if (it + kStages - 1 < total) {\n      stage_slice",
                    "    if (false) {\n      stage_slice")],
    "no_product": [("    multiply_slice(ring", "    if (it < 0) multiply_slice(ring")],
    # each 16 x 8 x 8 atom as four 8 x 8 x 4 DMMAs on the same fragments:
    # rows g (d[0], d[1]) and g + 8 (d[2], d[3]), k = t then t + 4
    "m8n8k4": [(
        """  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));""",
        """  for (int h = 0; h < 2; ++h)
    for (int k = 0; k < 2; ++k)
      asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
          "{%0, %1}, {%2}, {%3}, {%0, %1};\\n"
          : "+d"(d[2 * h]), "+d"(d[2 * h + 1]) : "d"(a[2 * k + h]), "d"(b[k]));""")],
}


# variants of K1's count kernel, as (pattern, replacement) edits of
# csrc/screen.cu
_SCREEN_VARIANTS = {
    "kernel": [],
    "no_loads": [("  if (kc + 4 < nk) load_chunk", "  if (false) load_chunk"),
                 ("  if (kc + 2 < nk) {\n    store_chunk",
                  "  if (false) {\n    store_chunk")],
    "no_product": [("  multiply_chunk(part, ring", "  if (kc < 0) multiply_chunk(part, ring")],
    # hi = lo = x: the split's TF32 roundings and subtraction left out
    "no_split": [("      hi[e] = tf32_rna(v);\n"
                  "      lo[e] = tf32_rna(__fsub_rn(v, __uint_as_float(hi[e])));",
                  "      hi[e] = __float_as_uint(v);\n      lo[e] = hi[e];")],
    # no proxy fence behind the stores in the loop (its MEMBAR waits for
    # every load in flight)
    "no_fence": [("    fence_proxy_async();\n  }\n  if (kc + 4",
                  "  }\n  if (kc + 4")],
    # the identity count's blocks column by column, as before the bands
    "unbanded": [("constexpr int kBand = 8;", "constexpr int kBand = 1;")],
}
_FFMA_SCREEN = Path(__file__).resolve().parent / "probe_screen_ffma.cu"


def cuda_ms(fn, reps=3):
    """Median device time of fn() in ms, by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def _build(name, source, out_dir):
    """Compile `source` into out_dir/lib{name}.so; the ptxas lines that
    report registers and spills."""
    src = out_dir / f"{name}.cu"
    src.write_text(source)
    log = K.compile_sources([src], out_dir / f"lib{name}.so")
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]


def sass_opcodes(lib, prefix):
    """{function: {opcode: count}} of the opcodes starting with `prefix` in
    the SASS of the shared library `lib` (cuobjdump beside nvcc)."""
    tool = Path(native._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    return {fn.split("\n", 1)[0].strip():
            dict(Counter(re.findall(rf"\b{prefix}\S*", fn)))
            for fn in sass.split("Function : ")[1:]}


def shapes(out_dir):
    _build("dmma_probe", _SOURCE, out_dir)
    lib_path = out_dir / "libdmma_probe.so"
    lib = ctypes.CDLL(str(lib_path))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dmma_probe.restype = i32
    lib.dmma_probe.argtypes = [i32, i32, vp, vp, vp, i32, i32, vp]
    sass = {"m{}n8k{}".format(*re.findall(r"Li(\d+)E", fn)): sorted(ops)
            for fn, ops in sass_opcodes(lib_path, "DMMA").items()
            if "rate_kernel" in fn}
    print(f"sass {json.dumps(sass)}", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    seed = torch.rand(64, generator=gen, dtype=torch.float64, device="cuda")
    out = torch.empty(4 * sms * 256, dtype=torch.float64, device="cuda")
    for shape, (m, k) in enumerate(SHAPES):
        a = torch.randn(m, k, generator=gen, dtype=torch.float64, device="cuda")
        b = torch.randn(k, 8, generator=gen, dtype=torch.float64, device="cuda")
        d = torch.full((m, 8), float("nan"), dtype=torch.float64, device="cuda")
        K._raise_on(lib.dmma_probe(shape, 1, a.data_ptr(), b.data_ptr(),
                                   d.data_ptr(), 1, 0, stream),
                    "dmma_probe check")
        err = float((d - a @ b).abs().max())
        rates = {}
        for per_sm in (4, 1):
            blocks = per_sm * sms
            flop_per_iter = 2.0 * m * 8 * k * 8 * (blocks * 8)
            iters = int(per_sm * 1e12 / flop_per_iter)

            def launch():
                K._raise_on(lib.dmma_probe(shape, 0, seed.data_ptr(), 0,
                                           out.data_ptr(), blocks, iters,
                                           stream), "dmma_probe rate")
            rates[f"tflops_{per_sm * 8}_warps_per_sm"] = (
                flop_per_iter * iters / cuda_ms(launch) / 1e9)
        print(json.dumps({"shape": f"m{m}n8k{k}", "layout_ok": err < 1e-12,
                          "max_abs_err": err, **rates}), flush=True)


def _variant(name, text, subs, out_dir, fn):
    """The library built from `text` with the edits `subs`, its entry point
    `fn` typed as the package's; prints its registers and spills."""
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: pattern not found once: {old!r}")
        text = text.replace(old, new)
    print(f"{name}: {_build(name, text, out_dir)}", flush=True)
    lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
    getattr(lib, fn).restype = ctypes.c_int
    getattr(lib, fn).argtypes = getattr(K._library(), fn).argtypes
    return lib


def exact_variants(out_dir):
    src = (native._CSRC / "exact.cu").read_text()
    libs = {name: _variant(f"exact_{name}", src, subs, out_dir,
                           "gmat_exact_scan")
            for name, subs in _VARIANTS.items()}
    n, m = YEAST
    gen = torch.Generator(device="cuda").manual_seed(0)
    f64 = {"dtype": torch.float64, "device": "cuda"}
    mat = torch.randint(0, 3, (n, m), generator=gen, device="cuda").double() - 1.0
    a = torch.randn(n, n, generator=gen, **f64) / n ** 0.5
    pvp = a @ a.T + torch.eye(n, **f64)
    pvp = (torch.triu(pvp) + torch.triu(pvp, 1).T).contiguous()
    del a
    py = 0.1 * torch.randn(n, generator=gen, **f64)
    anchors = torch.tensor(balanced_anchor_split(m, 100, 1), dtype=torch.int32,
                           device="cuda")
    cap = 1 << 20
    out_a = torch.empty(cap, dtype=torch.int32, device="cuda")
    out_j = torch.empty_like(out_a)
    vals = torch.empty((3, cap), **f64)
    state = torch.zeros(2, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for name, lib in libs.items():
        def launch():
            state.zero_()
            K._raise_on(lib.gmat_exact_scan(
                mat.data_ptr(), m, mat.data_ptr(), m, m, py.data_ptr(),
                pvp.data_ptr(), n, anchors.data_ptr(), len(anchors), 15.0, 1,
                1, out_a.data_ptr(), out_j.data_ptr(), vals[0].data_ptr(),
                vals[1].data_ptr(), vals[2].data_ptr(), cap, state.data_ptr(),
                0, stream), f"exact variant {name}")
        print(json.dumps({"variant": name, "ms": cuda_ms(launch)}), flush=True)


def ffma_screen_library(out_dir):
    """The earlier CUDA-core count kernel (`probe_screen_ffma.cu`), built
    into out_dir, with `gmat_screen_count` typed as the package's."""
    return _variant("screen_ffma", _FFMA_SCREEN.read_text(), [], out_dir,
                    "gmat_screen_count")


def screen_count_ms(lib, mat, py, cut, m):
    """(ms, counts) of lib.gmat_screen_count on the identity screen of
    mat at `cut`: the counts of one launch, the median time of 3."""
    t = K._n_tiles(m)
    counts = torch.zeros((t, t), dtype=torch.int32, device=mat.device)

    def launch():
        counts.zero_()
        K._raise_on(lib.gmat_screen_count(
            mat.data_ptr(), py.data_ptr(), mat.shape[0], mat.shape[1], m,
            float(cut), counts.data_ptr(), t, *K._launch_args(mat)),
            "gmat_screen_count")
    launch()
    first = counts.clone()
    return cuda_ms(launch), first


def screen_product_turns(mat, py, cut, m, out_dir):
    """The identity count with the CUDA-core product (`ffma`) and with the
    package's 3xTF32 product (`wgmma`), timed on the same inputs in turns
    ffma, wgmma, wgmma, ffma: {name: [ms, ms]} and each one's counts.
    Neither launch counts in `K.LAUNCHES`."""
    libs = {"ffma": ffma_screen_library(out_dir), "wgmma": K._library()}
    ms = {"ffma": [], "wgmma": []}
    counts = {}
    for name in ("ffma", "wgmma", "wgmma", "ffma"):
        t, counts[name] = screen_count_ms(libs[name], mat, py, cut, m)
        ms[name].append(t)
    return ms, counts


def screen_variants(out_dir):
    n, m = YEAST
    gen = torch.Generator(device="cuda").manual_seed(1)
    p = 0.05 + 0.9 * torch.rand(m, generator=gen, device="cuda")
    geno = ((torch.rand(n, m, generator=gen, device="cuda") < p).float()
            + (torch.rand(n, m, generator=gen, device="cuda") < p).float())
    mat = (geno - geno.mean(dim=0)).contiguous()
    del geno
    py = (0.1 * torch.randn(n, generator=gen, device="cuda")).contiguous()
    rows = torch.randperm(m, generator=gen, device="cuda")[:256]
    s = ((mat[:, rows] * py[:, None]).T @ mat).abs().flatten()
    cut = float(torch.quantile(s, 1.0 - 1e5 / (m * (m - 1) / 2)))
    src = (native._CSRC / "screen.cu").read_text()
    libs = {name: _variant(f"screen_{name}", src, subs, out_dir,
                           "gmat_screen_count")
            for name, subs in _SCREEN_VARIANTS.items()}
    libs["ffma"] = ffma_screen_library(out_dir)
    for name, lib in libs.items():
        ms, counts = screen_count_ms(lib, mat, py, cut, m)
        print(json.dumps({"screen_variant": name, "ms": ms,
                          "hits": int(counts.sum())}), flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("probe: needs a CUDA card")
    from gmat_tpu_torch.bench import card_line

    print(card_line(torch.device("cuda", 0)), flush=True)
    out_dir = native._BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    shapes(out_dir)
    exact_variants(out_dir)
    screen_variants(out_dir)


if __name__ == "__main__":
    main()
