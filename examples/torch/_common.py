"""Shared example-script setup for the PyTorch port: the `--device`
argument, fixture paths and the output directory.

Every script takes `--device` (default `cuda`; `cpu` runs the kernels'
plain PyTorch versions) and hands it to each entry point.  Nothing falls
back to the CPU: on a machine without CUDA, the default fails as the entry
points do.
"""
from __future__ import annotations

import argparse
import logging
import shutil
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
DATA = REPO / "tests" / "data"
MOUSE_LONG = DATA / "mouse_long"

sys.path.insert(0, str(REPO))
logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                    format="%(levelname)s %(name)s: %(message)s")


def parse_device(doc: str) -> torch.device:
    """The script's `--device` as a torch.device."""
    parser = argparse.ArgumentParser(description=doc.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device of every entry point "
                             "(default cuda; cpu for a host without a GPU)")
    return torch.device(parser.parse_args().device)


def out_dir(script_file: str) -> Path:
    out = Path(script_file).resolve().parent / "out"
    out.mkdir(exist_ok=True)
    return out


def stage_mouse(out: Path) -> str:
    """Copy the mouse fixture next to the outputs (GRM writers drop their
    files beside the .bed, like the reference's `<bed>.agrm0` contract)."""
    for ext in (".bed", ".bim", ".fam"):
        shutil.copy(DATA / ("plink" + ext), out / ("plink" + ext))
    shutil.copy(DATA / "pheno", out / "pheno")
    return str(out / "plink")


def stage_mouse_long(out: Path) -> str:
    for ext in (".bed", ".bim", ".fam"):
        shutil.copy(MOUSE_LONG / ("plink" + ext), out / ("plink" + ext))
    for f in ("phe.balance.txt", "phe.unbalance.txt"):
        shutil.copy(MOUSE_LONG / f, out / f)
    return str(out / "plink")
