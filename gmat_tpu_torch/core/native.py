"""The port's native kernel library, and the leaf of its float64 inverse.

Every `csrc/*.cu` is built at first use (one nvcc process per source, all
started together, then one link) into one library under
`build/gmat_tpu_torch/`, named by the hash of the sources and flags, and
loaded through ctypes (`library`).  A module that calls into it declares
its functions' signatures with `declare`; `scan.kernels` declares the
scans' kernels.

The inverse's leaf (`spd_leaf_inverse`, kernel `gmat_spd_leaf_inverse`,
`csrc/linalg.cu`) inverts a symmetric positive-definite block of at most
`SPD_LEAF` rows in one thread block, with its log-determinant and the
order of its first leading minor that is not positive definite: the
leaves of `core.linalg.spd_inverse_logdet`, which forms V⁻¹ on a card by
Schur complements.  On the CPU it runs its plain twin,
`spd_leaf_inverse_ref`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

SPD_LEAF = 64  # the largest block `spd_leaf_inverse` takes; checked at load
#: launches of the leaf kernel by this process.  A CUDA graph that holds
#: leaves adds them at each replay (`count_leaf_launches`), since the
#: wrapper runs only while the graph is captured.
LEAF_LAUNCHES = {"spd_leaf_inverse": 0}

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gmat_tpu_torch"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
_declarers = []  # functions that declare signatures on the loaded library
_LIB_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def compile_sources(srcs, out: Path) -> str:
    """Build the sources `srcs` into the shared library `out`: one nvcc per
    source, all started together, then one link.  Returns the compilers'
    output; raises with it when a step fails."""
    tag = f"{out.name}.{os.getpid()}"
    objs = [out.parent / f"{p.stem}.{tag}.o" for p in srcs]
    procs = [subprocess.Popen([_nvcc(), *_NVCC_FLAGS, "-c", "-o", str(o),
                               str(p)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for p, o in zip(srcs, objs)]
    logs = [f"== {p.name}\n{proc.communicate()[0]}"
            for p, proc in zip(srcs, procs)]
    link = None
    if all(proc.returncode == 0 for proc in procs):
        link = subprocess.run([_nvcc(), *_NVCC_FLAGS[:2], "-shared", "-o",
                               str(out), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
    for o in objs:
        o.unlink(missing_ok=True)
    if link is None or link.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + "".join(logs))
    return "".join(logs)


def build_library() -> Path:
    """Compile every `csrc/*.cu` into one shared library named by the hash
    of the sources and flags (a no-op when that library exists), by
    `compile_sources`.  The compilers' output, with ptxas's register and
    shared-memory report, goes to the `.log` file beside it."""
    srcs = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(b"".join(
        [p.name.encode() + p.read_bytes() for p in srcs]
        + [" ".join(_NVCC_FLAGS).encode()])).hexdigest()
    out = _BUILD_DIR / f"libgmat_kernels_{digest[:16]}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    out.with_suffix(".log").write_text(compile_sources(srcs, tmp))
    os.replace(tmp, out)
    return out


def declare(fn):
    """Have `fn(lib)` set the signatures of the library's functions that a
    module calls (and check its constants) when the library is loaded, or
    now if it is.  Returns `fn`."""
    with _LIB_LOCK:
        _declarers.append(fn)
        if _lib is not None:
            fn(_lib)
    return fn


def library():
    """The kernels' library, built and loaded at first use (under a lock:
    the shard threads of a mesh may ask for it at once)."""
    global _lib
    with _LIB_LOCK:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            for fn in _declarers:
                fn(lib)
            _lib = lib
    return _lib


def launch_args(t):
    """(device index, current stream) of a launch on `t`'s device."""
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")


@declare
def _declare_leaf(lib):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.gmat_spd_leaf.restype = i32
    lib.gmat_spd_leaf.argtypes = []
    lib.gmat_spd_leaf_inverse.restype = i32
    lib.gmat_spd_leaf_inverse.argtypes = [vp, i64, vp, i64, i32, i32, vp, vp,
                                          i32, vp]
    edge = lib.gmat_spd_leaf()
    if edge != SPD_LEAF:
        raise RuntimeError(f"inverse leaf {edge} != {SPD_LEAF}")


def count_leaf_launches(n):
    with _COUNT_LOCK:
        LEAF_LAUNCHES["spd_leaf_inverse"] += n


def spd_leaf_inverse_ref(a):
    """(A⁻¹, log|A|, order) for a small symmetric A by Gauss-Jordan sweeps
    without pivoting, the kernel's arithmetic; order is 0, or that of A's
    first leading minor that is not positive definite (its first pivot not
    above 0)."""
    v = a.clone()
    logdet = torch.zeros((), dtype=a.dtype, device=a.device)
    order = 0
    for k in range(v.shape[0]):
        row, col = v[k].clone(), v[:, k].clone()
        pivot = row[k]
        inv = 1.0 / pivot
        if order == 0 and not pivot > 0.0:
            order = k + 1
        logdet = logdet + torch.log(pivot)
        v -= torch.outer(col * inv, row)
        v[k] = row * inv
        v[:, k] = -col * inv
        v[k, k] = inv
    return v, logdet, order


def spd_leaf_inverse(a, out, logdet, order, offset):
    """Invert the block `a` (b x b float64, b ≤ SPD_LEAF, unit column
    stride) into `out` (likewise), with log|a| into the 0-dim `logdet`
    (float64) and into the 0-dim `order` (int32) 0, or `offset` plus the
    order of a's first leading minor that is not positive definite.  On a
    card the kernel `gmat_spd_leaf_inverse` (`csrc/linalg.cu`), nothing
    waited for; on the CPU `spd_leaf_inverse_ref`."""
    b = a.shape[0]
    if not 1 <= b <= SPD_LEAF or a.shape != (b, b) or out.shape != (b, b):
        raise ValueError(f"an inverse leaf is b x b, 1 <= b <= {SPD_LEAF}")
    if a.device.type == "cpu":
        inv, ld, first = spd_leaf_inverse_ref(a)
        out.copy_(inv)
        logdet.copy_(ld)
        order.fill_(first + offset if first else 0)
        return
    if any(t.dtype != d for t, d in ((a, torch.float64), (out, torch.float64),
                                     (logdet, torch.float64),
                                     (order, torch.int32))):
        raise ValueError("an inverse leaf is float64, its order int32")
    if a.stride(1) != 1 or out.stride(1) != 1:
        raise ValueError("an inverse leaf's rows are contiguous")
    rc = library().gmat_spd_leaf_inverse(
        a.data_ptr(), a.stride(0), out.data_ptr(), out.stride(0), b, offset,
        logdet.data_ptr(), order.data_ptr(), *launch_args(a))
    raise_on(rc, "gmat_spd_leaf_inverse")
    count_leaf_launches(1)
