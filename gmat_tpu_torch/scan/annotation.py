"""Result annotation (counterpart of `gmat_tpu/scan/annotation.py`):
result rows joined to .bim SNP info, GTF gene rows, and the genes near
each SNP.  Host text I/O; the files are byte-identical to the JAX
package's."""
from __future__ import annotations

import re


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


def gtf_to_gene_info(gtf_file: str) -> str:
    """Gene rows of a GTF as `chrom start end strand gene_id gene_name`
    lines in `<gtf>.gene_info`; returns that path."""
    out = gtf_file + ".gene_info"
    with open(gtf_file) as fin, open(out, "w") as fout:
        for line in fin:
            if "#" in line:
                continue
            arr = line.split()
            if len(arr) > 2 and arr[2] == "gene":
                m = re.search(r'gene_id\s+"(.+?)".+gene_name\s+"(.+?)"', line,
                              re.I)
                if m:
                    fout.write(
                        " ".join([arr[0], arr[3], arr[4], arr[6],
                                  m.group(1), m.group(2)]) + "\n"
                    )
    return out


def annotation_snp_nearest_gene(bed_prefix: str, gene_file: str,
                                max_distance: int = 150000) -> str:
    """Each .bim SNP beside every gene of its chromosome that contains it
    ("within") or lies closer than `max_distance` bp (the distance), in
    `<prefix>.nearby_genes`; returns that path."""
    gene_info: dict[str, list[list[str]]] = {}
    with open(gene_file) as fin:
        for line in fin:
            arr = line.split()
            gene_info.setdefault(arr[0], []).append(arr)
    out = bed_prefix + ".nearby_genes"
    with open(bed_prefix + ".bim") as fin, open(out, "w") as fout:
        for line in fin:
            snp_line = line.strip()
            arr = line.split()
            snp_pos = int(arr[3])
            for gene in gene_info.get(arr[0], []):
                start, end = int(gene[1]), int(gene[2])
                if snp_pos > start and snp_pos < end:
                    fout.write(f"{snp_line} {' '.join(gene)} within\n")
                else:
                    distance = min(abs(snp_pos - start), abs(snp_pos - end))
                    if distance < max_distance:
                        fout.write(f"{snp_line} {' '.join(gene)} {distance}\n")
    return out
