"""The system under test: `gmat_tpu_torch`, driven through its public entry
points as a user's script drives them (files in, files out).

`Program` builds the GRMs, runs REML and the scan that a traffic mix
names, and reads the scan's output table back.  `Control` has the same
methods and puts the plain reference in the program's place, computed one
precision lower than the configuration states (float32 for float64, TF32
for the float32 screen); the benchmark's own runs never use it.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import remma as R

ROW_KEYS = ("i", "j", "eff", "var", "chi", "p")


def read_rows(path):
    """The rows of a scan table as {i, j, eff, var, chi, p} arrays: the
    approx merge `snp_0 snp_1 eff var chi p_app p` or the exhaustive
    `snp_0 snp_1 eff chi p_val` (var then NaN)."""
    with open(path) as f:
        head = f.readline().split()
        body = np.loadtxt(f, ndmin=2)
    if body.size == 0:
        body = np.empty((0, len(head)))
    col = {name: body[:, k] for k, name in enumerate(head)}
    if "var" in col:
        stats = (col["eff"], col["var"], col["chi"], col[head[-1]])
    else:
        stats = (col["eff"], np.full(len(body), np.nan), col["chi"],
                 col[head[-1]])
    return dict(zip(ROW_KEYS, (body[:, 0].astype(np.int64),
                               body[:, 1].astype(np.int64)) + stats))


class Program:
    """gmat_tpu_torch on `device`."""

    def __init__(self, device):
        self.device = torch.device(device)

    def build(self):
        """Compile (first run) or find the kernels' library."""
        if self.device.type == "cuda":
            from gmat_tpu_torch.scan.kernels import build_library

            build_library()

    def grms(self, ctx):
        from gmat_tpu_torch.pipeline.remmax import grm_products

        return grm_products(ctx.config["model"]["grms"], ctx.prefix,
                            device=self.device)

    def reml(self, ctx, trait, pheno, out):
        from gmat_tpu_torch import wemai_multi_gmat

        return np.asarray(wemai_multi_gmat(pheno, ctx.prefix, ctx.gmat_lst,
                                           out_file=out, device=self.device))

    def scan(self, ctx, trait, pheno, var, out, part=None):
        """Run the mix's scan; returns (output, approx stages or {})."""
        import gmat_tpu_torch
        from gmat_tpu_torch.scan import screen

        kw = dict(ctx.traffic["args"])
        if part is not None:
            kw["parallel"] = [ctx.traffic["parts"], part]
        fn = getattr(gmat_tpu_torch, ctx.traffic["scan"])
        fn(pheno, ctx.prefix, ctx.gmat_lst, var, out_file=out,
           device=self.device, **kw)
        stages = (dict(screen.LAST_APPROX_STAGES)
                  if ctx.traffic["family"] == "approx" else {})
        return (out if part is None else f"{out}.{part}"), stages


class Control:
    """The reference in the program's place, one precision lower."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._mats = None

    def build(self):
        pass

    def grms(self, ctx):
        self._mats = R.codings(ctx.geno, ctx.kind, torch.float32)
        return R.grms(ctx.geno, ctx.config["model"]["grms"], torch.float32)

    def _design(self, ctx, trait):
        y = torch.as_tensor(ctx.traits[trait], dtype=torch.float32,
                            device=self.device)
        x = torch.as_tensor(ctx.xmat, dtype=torch.float32, device=self.device)
        return y, x

    def reml(self, ctx, trait, pheno, out):
        y, x = self._design(ctx, trait)
        return R.reml(y, x, ctx.gmat_lst)[0]

    def scan(self, ctx, trait, pheno, var, out, part=None):
        y, x = self._design(ctx, trait)
        py, pmat = R.pieces(var, y, x, ctx.gmat_lst)
        args, mats, ordered = ctx.traffic["args"], self._mats, ctx.ordered
        if ctx.traffic["family"] == "approx":
            calib = R.random_pairs(ctx.n_snp, args["num_random_pair"],
                                   args.get("seed", 0), ordered=ordered)
            med = np.median(R.pair_stats(*mats, py, pmat, calib[:, 0],
                                         calib[:, 1])[1])
            cut = np.sqrt(R.chi2_crit(args["p_cut"]) * med)
            i, j, _ = R.screen(*mats, py, cut, ordered=ordered, tf32=True)
            rows = (i, j) + R.pair_stats(*mats, py, pmat, i, j)
        else:
            rows = R.exact_scan(*mats, py, pmat, ctx.anchors(part),
                                args["p_cut"], ordered=ordered)
        return dict(zip(ROW_KEYS, rows)), {}
