"""The two sides that a run can put in the window: the system under test,
`gmat_tpu_torch` driven through its public entry points as a user's script
drives them (`Program`), and the plain reference computed one precision
lower than the configuration states (`Control`), which the limits of the
check are set against; the benchmark's own runs never use the control.

Each side of a mix is its family's class of that name
(`families/<family>.py`), made by `make(family, device)`, with the methods

- `build()`: compile or find what the side runs (set-up's "library");
- `setup(ctx)`: the set-up product that every unit uses (`ctx.product`);
- `reml(ctx, trait, inputs, out)`: the trait's variance components from
  its input files (`inputs`, the family's `write_inputs`);
- `scan(ctx, trait, inputs, var, out, part)`: the unit's scan at the
  variances `var`, returning (the path of its table, or its rows; the
  program's stage seconds or {}).
"""
from __future__ import annotations

import torch


class Program:
    """The port: the mix's family's `Program`."""

    @classmethod
    def make(cls, family, device):
        return getattr(family, cls.__name__)(torch.device(device))


class Control(Program):
    """The reference one precision lower in the program's place: the mix's
    family's `Control`."""
