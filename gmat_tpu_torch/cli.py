"""Command-line interface for the standard REMMAX workflows (counterpart of
`gmat_tpu/cli.py`, with the same subcommands and flags):

    gmat-tpu-torch agmat plink --inv --out-fmt id_id_val
    gmat-tpu-torch reml pheno plink --grm ag --grm 'ag*ag' --out var.txt
    gmat-tpu-torch remma-add pheno plink --grm ag --grm 'ag*ag' --var var.txt
    gmat-tpu-torch epiaa-approx pheno plink --grm ag --grm 'ag*ag' \
        --var var.txt --p-cut 1e-5 --out epiAA
    gmat-tpu-torch annotate epiAA plink --p-cut 1e-5
    gmat-tpu-torch remmax pheno plink --out remmax
    gmat-tpu-torch longwas-balance-varcom data.txt --id ID --tpoints 1,2,...
    gmat-tpu-torch bench

(also `python -m gmat_tpu_torch.cli ...`).  The global `--device` (default
`cuda`) goes to every entry point; `--device cpu` runs the plain PyTorch
versions of the kernels.  The global `--devices N` shards the GRM, the
exhaustive scans and the approx pipelines over a mesh of N devices of
that type (`dist/`): N CUDA devices (0: every visible one), or N virtual
shards of the CPU.  `bench` runs the headline benchmark
(`gmat_tpu_torch/bench.py`, one JSON line) on `--device`; like
`gmat_tpu`'s, it takes no mesh, so `--devices` is checked and then
ignored.
"""
from __future__ import annotations

import argparse
import logging
import sys

import numpy as np
import torch


def _load_grms(specs, bed_prefix, device=None):
    """Parse --grm specs: 'ag', 'dg', or products like 'ag*ag', 'ag*dg'."""
    from gmat_tpu_torch.pipeline.remmax import grm_products

    try:
        return grm_products(specs, bed_prefix, device)
    except ValueError as err:
        raise SystemExit(str(err)) from err


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="gmat-tpu-torch",
        description="REMMAX on PyTorch and CUDA: GRMs, REML, epistasis "
                    "scans, longwas",
    )
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument(
        "--device", default="cuda",
        help="torch device of every computation (default: cuda)",
    )
    parser.add_argument(
        "--devices", type=int, default=None, metavar="N",
        help="shard the compute over a mesh of N devices of --device's "
             "type (0 = all local devices; N virtual shards of the CPU; "
             "omit for one device)",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("agmat", help="additive GRM")
    p.add_argument("bed_prefix")
    p.add_argument("--inv", action="store_true")
    p.add_argument("--small-val", type=float, default=0.001)
    p.add_argument("--out-fmt", default="mat",
                   choices=["mat", "row_col_val", "id_id_val"])

    p = sub.add_parser("dgmat", help="dominance GRM")
    p.add_argument("bed_prefix")
    p.add_argument("--inv", action="store_true")
    p.add_argument("--small-val", type=float, default=0.001)
    p.add_argument("--out-fmt", default="mat",
                   choices=["mat", "row_col_val", "id_id_val"])

    p = sub.add_parser("inbreed", help="genomic inbreeding coefficients")
    p.add_argument("bed_prefix")

    p = sub.add_parser("reml", help="multi-GRM weighted EM+AI REML")
    p.add_argument("pheno")
    p.add_argument("bed_prefix")
    p.add_argument("--grm", action="append", required=True,
                   help="GRM spec: ag, dg, ag*ag, ag*dg, dg*dg (repeatable)")
    p.add_argument("--maxiter", type=int, default=200)
    p.add_argument("--out", default="wemai_multi_gmat.var")

    for name, helptext in (("remma-add", "additive score test"),
                           ("remma-dom", "dominance score test")):
        p = sub.add_parser(name, help=helptext)
        p.add_argument("pheno")
        p.add_argument("bed_prefix")
        p.add_argument("--grm", action="append", required=True)
        p.add_argument("--var", required=True, help="variance file from reml")
        p.add_argument("--out", default=name.replace("-", "_"))

    for kind in ("aa", "ad", "dd"):
        p = sub.add_parser(f"epi{kind}", help=f"exact epi{kind.upper()} scan")
        p.add_argument("pheno")
        p.add_argument("bed_prefix")
        p.add_argument("--grm", action="append", required=True)
        p.add_argument("--var", required=True)
        p.add_argument("--p-cut", type=float, default=1.0e-5)
        p.add_argument("--parallel", nargs=2, type=int, metavar=("N", "I"))
        p.add_argument("--out", default=f"epi{kind.upper()}")

        p = sub.add_parser(f"epi{kind}-approx",
                           help=f"screen->exact epi{kind.upper()} pipeline")
        p.add_argument("pheno")
        p.add_argument("bed_prefix")
        p.add_argument("--grm", action="append", required=True)
        p.add_argument("--var", required=True)
        p.add_argument("--p-cut", type=float, default=1.0e-5)
        p.add_argument("--num-random-pair", type=int, default=100000)
        p.add_argument("--maf", action="store_true",
                       help="MAF-stratified thresholds")
        p.add_argument("--out", default=f"epi{kind.upper()}_approx")

    p = sub.add_parser("annotate", help="join scan results to .bim info")
    p.add_argument("res_file")
    p.add_argument("bed_prefix")
    p.add_argument("--p-cut", type=float, default=1.0)
    p.add_argument("--dis", type=float, default=0.0)
    p.add_argument("--ld-file")
    p.add_argument("--r2", type=float, default=0.2)

    p = sub.add_parser("longwas-balance-varcom")
    p.add_argument("data_file")
    p.add_argument("--id", required=True)
    p.add_argument("--tpoints", required=True,
                   help="comma-separated timepoints, e.g. 1,2,...,16")
    p.add_argument("--traits", required=True,
                   help="comma-separated 0-based trait column indexes")
    p.add_argument("--kin-file", required=True)
    p.add_argument("--forder", type=int, default=3)
    p.add_argument("--rorder", type=int, default=3)
    p.add_argument("--maxiter", type=int, default=100)
    p.add_argument("--out", default="balance_varcom")

    p = sub.add_parser("longwas-unbalance-varcom")
    p.add_argument("data_file")
    p.add_argument("--id", required=True)
    p.add_argument("--tpoint", required=True, help="time column name")
    p.add_argument("--trait", required=True, help="trait column name")
    p.add_argument("--kin-inv-file", required=True)
    p.add_argument("--maxiter", type=int, default=100)
    p.add_argument("--out", default="unbalance_varcom")

    p = sub.add_parser("remmax", help="one-call pipeline: GRM -> REML -> "
                       "scan -> annotate (stage-resumable)")
    p.add_argument("pheno")
    p.add_argument("bed_prefix")
    p.add_argument("--out", default="remmax")
    p.add_argument("--model", default="a_axa",
                   choices=["a_axa", "a_d_axa", "a_d_axa_axd_dxd"])
    p.add_argument("--scan", default="epiAA_approx")
    p.add_argument("--p-cut", type=float, default=1.0e-5)
    p.add_argument("--num-random-pair", type=int, default=100000)
    p.add_argument("--dis", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-resume", action="store_true")

    sub.add_parser("bench", help="run the headline benchmark")

    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(message)s",
    )

    dev = args.device
    mesh = None
    if args.devices is not None:
        from gmat_tpu_torch.dist.mesh import make_mesh

        try:
            if torch.device(dev).type == "cpu":
                mesh = make_mesh(devices=["cpu"] * max(args.devices, 1))
            else:
                mesh = make_mesh(args.devices or None)
        except (RuntimeError, ValueError) as err:
            parser.error(f"--devices {args.devices}: {err}")
    if args.cmd == "agmat":
        from gmat_tpu_torch.grm.grm import agmat

        agmat(args.bed_prefix, inv=args.inv, small_val=args.small_val,
              out_fmt=args.out_fmt, device=dev, mesh=mesh)
    elif args.cmd == "dgmat":
        from gmat_tpu_torch.grm.grm import dgmat_as

        dgmat_as(args.bed_prefix, inv=args.inv, small_val=args.small_val,
                 out_fmt=args.out_fmt, device=dev, mesh=mesh)
    elif args.cmd == "inbreed":
        from gmat_tpu_torch.grm.grm import ginbreedcoef

        ginbreedcoef(args.bed_prefix, device=dev)
    elif args.cmd == "reml":
        from gmat_tpu_torch.reml.wemai import wemai_multi_gmat

        gmat_lst = _load_grms(args.grm, args.bed_prefix, dev)
        wemai_multi_gmat(args.pheno, args.bed_prefix, gmat_lst,
                         maxiter=args.maxiter, out_file=args.out, device=dev)
    elif args.cmd in ("remma-add", "remma-dom"):
        from gmat_tpu_torch.scan.single import remma_add, remma_dom

        gmat_lst = _load_grms(args.grm, args.bed_prefix, dev)
        var = np.loadtxt(args.var)
        fn = remma_add if args.cmd == "remma-add" else remma_dom
        fn(args.pheno, args.bed_prefix, gmat_lst, var, out_file=args.out,
           device=dev)
    elif args.cmd.startswith("epi") and not args.cmd.endswith("approx"):
        from gmat_tpu_torch.scan import pairs

        kind = args.cmd[3:5].upper()
        gmat_lst = _load_grms(args.grm, args.bed_prefix, dev)
        var = np.loadtxt(args.var)
        if args.parallel:
            fn = getattr(pairs, f"remma_epi{kind}_parallel")
            fn(args.pheno, args.bed_prefix, gmat_lst, var, args.parallel,
               p_cut=args.p_cut, out_file=args.out, device=dev)
        else:
            fn = getattr(pairs, f"remma_epi{kind}")
            fn(args.pheno, args.bed_prefix, gmat_lst, var, p_cut=args.p_cut,
               out_file=args.out, device=dev, mesh=mesh)
    elif args.cmd.endswith("approx"):
        from gmat_tpu_torch.scan import screen

        kind = args.cmd[3:5].upper()
        gmat_lst = _load_grms(args.grm, args.bed_prefix, dev)
        var = np.loadtxt(args.var)
        name = f"remma_epi{kind}_maf_approx" if args.maf else \
            f"remma_epi{kind}_approx"
        getattr(screen, name)(args.pheno, args.bed_prefix, gmat_lst, var,
                              p_cut=args.p_cut,
                              num_random_pair=args.num_random_pair,
                              out_file=args.out, device=dev, mesh=mesh)
    elif args.cmd == "annotate":
        from gmat_tpu_torch.scan.annotation import annotation_snp_pos

        annotation_snp_pos(args.res_file, args.bed_prefix, p_cut=args.p_cut,
                           dis=args.dis, ld_file=args.ld_file, r2=args.r2)
    elif args.cmd == "longwas-balance-varcom":
        from gmat_tpu_torch.longwas.balance import balance_varcom

        tp = np.array([float(v) for v in args.tpoints.split(",")])
        traits = [int(v) for v in args.traits.split(",")]
        balance_varcom(args.data_file, args.id, tp, traits, args.kin_file,
                       forder=args.forder, rorder=args.rorder,
                       maxiter=args.maxiter, prefix_outfile=args.out,
                       device=dev)
    elif args.cmd == "longwas-unbalance-varcom":
        from gmat_tpu_torch.longwas.unbalance import unbalance_varcom

        unbalance_varcom(args.data_file, args.id, args.tpoint, args.trait,
                         args.kin_inv_file, maxiter=args.maxiter,
                         prefix_outfile=args.out, device=dev)
    elif args.cmd == "remmax":
        from gmat_tpu_torch.pipeline.remmax import remmax

        remmax(args.pheno, args.bed_prefix, out_prefix=args.out,
               model=args.model, scan=args.scan, p_cut=args.p_cut,
               num_random_pair=args.num_random_pair, dis=args.dis,
               seed=args.seed, resume=not args.no_resume, device=dev)
    elif args.cmd == "bench":
        from gmat_tpu_torch import bench

        bench.main(device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
