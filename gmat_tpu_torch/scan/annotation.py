"""Result annotation (counterpart of `gmat_tpu/scan/annotation.py`)."""
from __future__ import annotations


def annotation_snp_pos(res_file: str, bed_prefix: str, p_cut: float = 1,
                       dis: float = 0, ld_file: str | None = None,
                       r2: float = 0.2) -> int:
    """Annotate result rows with .bim SNP info (writes `<res>.anno`), then
    optionally prune LD-linked pairs from a plink `.ld` table (`.anno.ld`).

    Rows keep p <= p_cut AND (different chromosome OR |bp distance| > dis);
    every written token is the verbatim text from the input files."""
    import numpy as np
    import pandas as pd

    bim = pd.read_csv(bed_prefix + ".bim", sep=r"\s+", header=None,
                      dtype=str, keep_default_na=False)
    res = pd.read_csv(res_file, sep=r"\s+", dtype=str,
                      keep_default_na=False)
    header = [str(c) for c in res.columns]
    s0 = bim.iloc[res[header[0]].astype(np.int64)].reset_index(drop=True)
    s1 = bim.iloc[res[header[1]].astype(np.int64)].reset_index(drop=True)
    keep = (res[header[-1]].astype(float).to_numpy() <= p_cut) & (
        (s0[0].to_numpy() != s1[0].to_numpy())
        | (np.abs(s0[3].astype(float).to_numpy()
                  - s1[3].astype(float).to_numpy()) > dis)
    )
    parts = ([res[header[0]]] + [s0[c] for c in bim.columns]
             + [res[header[1]]] + [s1[c] for c in bim.columns]
             + [res[c] for c in res.columns[2:]])
    anno = pd.concat(parts, axis=1)[keep]
    anno.columns = (
        [header[0], "snp0_chr", "snp0_ID", "snp0_cm", "snp0_bp",
         "snp0_allele1", "snp0_allele2", header[1], "snp1_chr", "snp1_ID",
         "snp1_cm", "snp1_bp", "snp1_allele1", "snp1_allele2"]
        + header[2:])
    anno.to_csv(res_file + ".anno", sep=" ", index=False)
    if ld_file is not None:
        ld = pd.read_csv(ld_file, sep=r"\s+", dtype=str,
                         keep_default_na=False)
        linked = ld[ld[ld.columns[-1]].astype(float).to_numpy() > r2]
        a = linked[ld.columns[2]].to_numpy()
        b = linked[ld.columns[5]].to_numpy()
        ld_id = set(zip(a, b)) | set(zip(b, a))
        pairs = zip(anno["snp0_ID"].to_numpy(), anno["snp1_ID"].to_numpy())
        unlinked = np.fromiter((p not in ld_id for p in pairs), dtype=bool,
                               count=len(anno))
        anno[unlinked].to_csv(res_file + ".anno.ld", sep=" ", index=False)
    return 0
