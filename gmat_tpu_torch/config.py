"""Device and numeric policy for the PyTorch port of gmat-tpu.

The statistical path (GRM, REML, score pieces, exact pair tests) runs in
float64 end to end, like the JAX reference on the CPU: Hopper has native
FP64, so the TPU's mixed-precision inverse (`gmat_tpu/core/linalg.py::
mixed_inv_psd`) has no counterpart here.

The effect screen runs in float32 on a hand-written CUDA kernel whose
product keeps float32's precision on the TF32 tensor cores: each operand
is split into two TF32 parts and three products are summed in float32
(3xTF32, `csrc/screen.cu`).  TF32 is switched off for every float32
matrix product and convolution that torch itself runs in the process, so
that a plain float32 product (the kernel's PyTorch twin, the oracles in
the tests) keeps float32 precision too.

Every entry point takes a `device`; `None` means `DEFAULT_DEVICE`, which
is CUDA.  Nothing picks the CPU on its own: the tests pass
`device="cpu"` themselves.
"""
from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEVICE = torch.device("cuda")
EXACT_DTYPE = torch.float64
SCREEN_DTYPE = torch.float32

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device, `DEFAULT_DEVICE` when None."""
    return DEFAULT_DEVICE if device is None else torch.device(device)


def as_exact(a, device) -> torch.Tensor:
    """`a` (array-like) as a float64 tensor on `device`."""
    return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)
