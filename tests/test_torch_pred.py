"""Prediction, I/O, GRM and annotation parts of gmat_tpu_torch vs the JAX
package on the mouse fixture: `wemai_multi_gmat_pred` (`.var` and
`.rand_eff` at rtol 1e-8), `_blup_effects` against the MME solution
(Henderson's identity, rtol 1e-8), the prediction design and the
reference-name tuples (equal arrays and CSR), `ginbreedcoef`,
`shuffle_bed`, `read_grm_id_id_val` / `output_mat`, `gtf_to_gene_info` and
`annotation_snp_nearest_gene` (byte-identical files where the work is
host I/O)."""
import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from gmat_tpu_torch.grm import grm as tgrm
from gmat_tpu_torch.io import bed as tbed
from gmat_tpu_torch.io import grm_io as tgrm_io
from gmat_tpu_torch.io import pheno as tpheno
from gmat_tpu_torch.reml import mme as tmme
from gmat_tpu_torch.reml import wemai as twemai
from gmat_tpu_torch.scan import annotation as tanno

DATA = Path(__file__).parent / "data"
PREFIX, PHENO = str(DATA / "plink"), str(DATA / "pheno")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several pytest-xdist workers at once: one torch
    thread per worker keeps the n³ CPU work from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ag():
    geno = tbed.read_plink(PREFIX)
    return tgrm.additive_grm(torch.as_tensor(geno)).numpy()


@pytest.fixture(scope="module")
def pheno_gaps(tmp_path_factory):
    """The mouse phenotype file without a seeded 10% of its individuals."""
    lines = Path(PHENO).read_text().splitlines(keepends=True)
    rng = np.random.default_rng(7)
    drop = set(rng.choice(len(lines), size=len(lines) // 10,
                          replace=False).tolist())
    path = tmp_path_factory.mktemp("pheno") / "pheno_gaps"
    path.write_text("".join(ln for k, ln in enumerate(lines) if k not in drop))
    return str(path)


def _copy_plink(dst):
    for suffix in (".bed", ".bim", ".fam"):
        shutil.copy(PREFIX + suffix, str(dst) + suffix)
    return str(dst)


@pytest.mark.parametrize("case", ["gaps", "repeat_pe"])
def test_wemai_multi_gmat_pred_matches_jax(tmp_path, ag, pheno_gaps, case):
    from gmat_tpu.reml.wemai import wemai_multi_gmat_pred as j_pred

    if case == "gaps":
        pheno, grms = pheno_gaps, [ag, ag * ag]
    else:  # repeated records, [a, axa, pe] (tests/test_reml.py)
        pheno, grms = str(DATA / "pheno_repeat"), [ag, ag * ag,
                                                   np.eye(ag.shape[0])]
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    var = twemai.wemai_multi_gmat_pred(pheno, PREFIX, grms, out_file=out_t,
                                       device="cpu")
    j_pred(pheno, PREFIX, grms, out_file=out_j)
    np.testing.assert_allclose(np.loadtxt(out_t + ".var"),
                               np.loadtxt(out_j + ".var"), rtol=1e-8)
    np.testing.assert_array_equal(np.loadtxt(out_t + ".var"), var)
    eff_t = np.loadtxt(out_t + ".rand_eff")
    eff_j = np.loadtxt(out_j + ".rand_eff")
    assert eff_t.shape == (ag.shape[0], len(grms))
    np.testing.assert_allclose(eff_t, eff_j, rtol=1e-8,
                               atol=1e-12 * np.abs(eff_j).max())


def test_blup_effects_equal_mme_solution(ag):
    """u = σ²_g G Zᵀ P y equals the random-effect block of the MME solution
    at the same variances (Henderson's identity)."""
    dm = tpheno.design_matrix(PHENO, PREFIX)
    var = np.array([0.6, 0.4])
    u_blup = twemai._blup_effects(
        torch.as_tensor(var), torch.as_tensor(dm.y),
        torch.as_tensor(dm.xmat), twemai.build_zgzt_stack(dm, [ag], "cpu"),
        torch.as_tensor(ag)[None], dm.rec_index("cpu"), dm.n_col)[:, 0]
    y, xmat, g_inv, wmat, coef_pre, p, _ = tmme._mme_setup(
        dm.y, dm.xmat, np.linalg.inv(ag), "cpu")
    _, eff, _ = tmme._mme_solve(torch.as_tensor(var), y, xmat, g_inv, wmat,
                                coef_pre)
    np.testing.assert_allclose(u_blup.numpy(), eff[p:].numpy(), rtol=1e-8,
                               atol=1e-12 * float(eff[p:].abs().max()))


@pytest.mark.parametrize("which", ["full", "gaps"])
def test_design_tuples_match_jax(pheno_gaps, which):
    from gmat_tpu.io import pheno as jpheno

    pheno = PHENO if which == "full" else pheno_gaps
    got = tpheno.design_matrix_pred(pheno, PREFIX)
    want = jpheno.design_matrix_pred(pheno, PREFIX)
    for field in ("y", "xmat", "rec_ids"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    assert got.n_col == want.n_col == 1304
    assert (got.n_rec < got.n_col) == (which == "gaps")
    names = ["design_matrix_wemai_multi_gmat_pred"]
    if which == "full":  # the estimation design needs every id phenotyped
        names.append("design_matrix_wemai_multi_gmat")
    for name in names:
        y_t, x_t, z_t = getattr(tpheno, name)(pheno, PREFIX)
        y_j, x_j, z_j = getattr(jpheno, name)(pheno, PREFIX)
        assert y_t.shape == y_j.shape == (got.n_rec, 1)
        np.testing.assert_array_equal(y_t, y_j)
        np.testing.assert_array_equal(x_t, x_j)
        assert z_t.format == z_j.format == "csr" and z_t.shape == z_j.shape
        for attr in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(z_t, attr),
                                          getattr(z_j, attr))


@pytest.mark.parametrize("missing", [False, True])
def test_ginbreedcoef_matches_jax(tmp_path, missing):
    from gmat_tpu.grm.grm import ginbreedcoef as j_inbreed

    geno = tbed.read_plink(PREFIX)[:, :400]
    if missing:  # seeded holes, imputed with the same seed by both packages
        rng = np.random.default_rng(3)
        geno[rng.random(geno.shape) < 0.02] = np.nan
    bim = tbed.Bed(PREFIX)
    for name in ("t", "j"):
        tbed.write_bed(str(tmp_path / name), geno, bim=bim.bim.iloc[:400],
                       fam=bim.fam)
    got = tgrm.ginbreedcoef(str(tmp_path / "t"), device="cpu")
    want = j_inbreed(str(tmp_path / "j"))
    assert list(got.columns) == ["id", "homo_F", "grm_F1", "grm_F2"]
    np.testing.assert_array_equal(got["id"], want["id"])
    for col in ("homo_F", "grm_F1", "grm_F2"):
        np.testing.assert_allclose(got[col], want[col], rtol=1e-12,
                                   atol=1e-15, err_msg=col)
    t = pd.read_csv(tmp_path / "t.ginbreedcoef", sep=" ")
    j = pd.read_csv(tmp_path / "j.ginbreedcoef", sep=" ")
    assert list(t.columns) == list(j.columns)
    np.testing.assert_allclose(t.iloc[:, 1:], j.iloc[:, 1:], rtol=1e-12,
                               atol=1e-15)


def test_shuffle_bed_matches_jax(tmp_path):
    from gmat_tpu.io.bed import shuffle_bed as j_shuffle

    t = tbed.shuffle_bed(_copy_plink(tmp_path / "t"), seed=5)
    j = j_shuffle(_copy_plink(tmp_path / "j"), seed=5)
    assert t == str(tmp_path / "t_shuffle")
    for suffix in (".bed", ".bim", ".fam"):
        assert Path(t + suffix).read_bytes() == Path(j + suffix).read_bytes()
    src, out = tbed.read_plink(PREFIX), tbed.read_plink(t)
    np.testing.assert_array_equal(np.sort(out, axis=0), np.sort(src, axis=0))
    assert not np.array_equal(out, src)


def test_grm_io_matches_jax(tmp_path, ag):
    from gmat_tpu.io import grm_io as jgrm_io

    sub = ag[:30, :30]
    ids = tbed.Bed(PREFIX).fam["iid"].to_numpy()[:30]
    for fmt in ("mat", "row_col_val", "id_id_val"):
        assert tgrm_io.output_mat(sub, ids, str(tmp_path / "t"), fmt) == 1
        assert jgrm_io.output_mat(sub, ids, str(tmp_path / "j"), fmt) == 1
    for k in "012":
        assert (Path(f"{tmp_path}/t{k}").read_bytes()
                == Path(f"{tmp_path}/j{k}").read_bytes())
    assert tgrm_io.output_mat(sub, ids, str(tmp_path / "t"), "csv") == 0
    assert jgrm_io.output_mat(sub, ids, str(tmp_path / "j"), "csv") == 0
    # read back over an id list with an extra id and a reordering
    want_ids = list(ids[::-1]) + ["not_genotyped"]
    got = tgrm_io.read_grm_id_id_val(f"{tmp_path}/t2", want_ids)
    np.testing.assert_array_equal(
        got, jgrm_io.read_grm_id_id_val(f"{tmp_path}/j2", want_ids))
    np.testing.assert_allclose(got[:30, :30], sub[::-1, ::-1], rtol=1e-15)
    assert not got[30].any()


def _write_gtf(path, bim):
    """A small GTF over the .bim positions: genes that hold a SNP, genes
    near one, far ones, a transcript row, a gene without gene_name and a
    comment."""
    lines = ["#!genome-build test\n"]
    placed = bim[bim["pos"] > 0].groupby("chro").head(3)
    for k, (chro, pos) in enumerate(zip(placed["chro"], placed["pos"])):
        for kind, (a, b) in (("in", (pos - 500, pos + 800)),
                             ("near", (pos + 20000, pos + 60000)),
                             ("far", (pos + 900000, pos + 950000))):
            lines.append(
                f'{chro}\tsrc\tgene\t{a}\t{b}\t.\t{"+-"[k % 2]}\t.\t'
                f'gene_id "G{k}{kind}"; gene_version "1"; '
                f'gene_name "Gene{k}{kind}";\n')
        lines.append(f'{chro}\tsrc\ttranscript\t{pos}\t{pos + 9}\t.\t+\t.\t'
                     f'gene_id "T{k}"; gene_name "Tx{k}";\n')
    lines.append('1\tsrc\tgene\t10\t20\t.\t+\t.\tgene_id "NoName";\n')
    Path(path).write_text("".join(lines))


def test_annotation_nearest_gene_matches_jax(tmp_path):
    from gmat_tpu.scan import annotation as janno

    bim = tbed.Bed(PREFIX).bim
    outs = {}
    for name, mod in (("t", tanno), ("j", janno)):
        d = tmp_path / name
        d.mkdir()
        _write_gtf(d / "genes.gtf", bim)
        info = mod.gtf_to_gene_info(str(d / "genes.gtf"))
        near = mod.annotation_snp_nearest_gene(_copy_plink(d / "plink"), info)
        outs[name] = (Path(info).read_bytes(), Path(near).read_bytes())
    assert outs["t"] == outs["j"]
    info, near = (b.decode() for b in outs["t"])
    assert "NoName" not in info and "Tx" not in info
    last = [ln.split()[-1] for ln in near.splitlines()]
    assert "within" in last and "Gene0near" in near
    assert all(v == "within" or int(v) < 150000 for v in last)
