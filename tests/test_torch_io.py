"""gmat_tpu_torch.io and the device unpack vs the JAX package: genotype decode
and unpack exactly, design matrices exactly, GRM and PLINK files
byte-identical."""
import filecmp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmat_tpu.io import bed as jbed
from gmat_tpu.io import grm_io as jgrm_io
from gmat_tpu.io.pheno import design_matrix as j_design_matrix
from gmat_tpu.scan.common import _unpack_f64_device as j_unpack
from gmat_tpu_torch.io import bed as tbed
from gmat_tpu_torch.io import grm_io as tgrm_io
from gmat_tpu_torch.io.pheno import design_matrix as t_design_matrix
from gmat_tpu_torch.scan import common as tcommon

from conftest import DATA


def test_bed_decode_matches_jax(mouse_prefix):
    got = tbed.Bed(mouse_prefix)
    want = jbed.Bed(mouse_prefix)
    assert (got.num_id, got.num_snp) == (want.num_id, want.num_snp)
    np.testing.assert_array_equal(got.read(), want.read())
    np.testing.assert_array_equal(got.read(np.float32), want.read(np.float32))
    np.testing.assert_array_equal(got.read_raw(), want.read_raw())
    np.testing.assert_array_equal(tbed.read_plink(mouse_prefix),
                                  jbed.read_plink(mouse_prefix))


def test_numpy_decode_matches_native(mouse_prefix):
    b = tbed.Bed(mouse_prefix)
    got = tbed._decode_numpy(mouse_prefix + ".bed", b.num_id, b.num_snp)
    np.testing.assert_array_equal(got, b.read())
    np.testing.assert_array_equal(
        got, jbed._decode_numpy(mouse_prefix + ".bed", b.num_id, b.num_snp))


def test_unpack_twin_matches_jax_exactly(mouse_prefix):
    b = tbed.Bed(mouse_prefix)
    raw = b.read_raw()
    got = tcommon._unpack_f64_device(torch.as_tensor(raw), b.num_id)
    want = np.asarray(j_unpack(jnp.asarray(raw), b.num_id))
    assert got.dtype == torch.float64 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), b.read())


def test_prepare_genotypes_device_paths(tmp_path, mouse_prefix):
    """Packed upload without missing codes; host impute with them."""
    geno = tbed.read_plink(mouse_prefix)[:97, :50].copy()
    prefix = str(tmp_path / "g")
    tbed.write_bed(prefix, geno)
    dev, m = tcommon.prepare_genotypes_device(prefix, device="cpu")
    assert m == 50
    np.testing.assert_array_equal(dev.numpy(), geno)
    geno[3, 7] = geno[10, 7] = np.nan
    tbed.write_bed(prefix + "_na", geno)
    dev, _ = tcommon.prepare_genotypes_device(prefix + "_na", device="cpu")
    np.testing.assert_array_equal(dev.numpy(),
                                  jbed.impute_geno(geno, seed=0))


def test_impute_geno_matches_jax():
    rng = np.random.default_rng(5)
    geno = rng.choice([0.0, 1.0, 2.0], size=(50, 30))
    geno[rng.random(geno.shape) < 0.1] = np.nan
    np.testing.assert_array_equal(tbed.impute_geno(geno, seed=3),
                                  jbed.impute_geno(geno, seed=3))


def test_write_bed_byte_identical(tmp_path):
    rng = np.random.default_rng(6)
    geno = rng.choice([0.0, 1.0, 2.0], size=(101, 37))  # num_id % 4 != 0
    geno[rng.random(geno.shape) < 0.05] = np.nan
    tbed.write_bed(str(tmp_path / "t"), geno)
    jbed.write_bed(str(tmp_path / "j"), geno)
    for ext in (".bed", ".bim", ".fam"):
        assert filecmp.cmp(tmp_path / f"t{ext}", tmp_path / f"j{ext}",
                           shallow=False)
    np.testing.assert_array_equal(tbed.read_plink(str(tmp_path / "t")), geno)


@pytest.mark.parametrize("pheno", ["pheno", "pheno_repeat"])
def test_design_matrix_matches_jax(pheno, mouse_prefix):
    got = t_design_matrix(str(DATA / pheno), mouse_prefix)
    want = j_design_matrix(str(DATA / pheno), mouse_prefix)
    np.testing.assert_array_equal(got.y, want.y)
    np.testing.assert_array_equal(got.xmat, want.xmat)
    np.testing.assert_array_equal(got.rec_ids, want.rec_ids)
    assert got.n_col == want.n_col
    np.testing.assert_array_equal(got.z_dense(), want.z_dense())
    rng = np.random.default_rng(7)
    g = rng.standard_normal((got.n_col, got.n_col))
    np.testing.assert_array_equal(got.zgzt(g, "cpu").numpy(),
                                  np.asarray(want.zgzt(g)))
    b = rng.standard_normal((got.n_rec, 3))
    np.testing.assert_array_equal(got.ztdot(b, "cpu").numpy(),
                                  np.asarray(want.ztdot(b)))
    np.testing.assert_array_equal(got.zdot(g[:, :2], "cpu").numpy(),
                                  np.asarray(want.zdot(g[:, :2])))


@pytest.mark.parametrize("fmt", ["mat", "row_col_val", "id_id_val"])
def test_write_grm_byte_identical(tmp_path, fmt):
    rng = np.random.default_rng(8)
    a = rng.standard_normal((30, 30))
    mat = a @ a.T / 30
    ids = np.array([f"id{i}" for i in range(30)])
    got = tgrm_io.write_grm(mat, ids, str(tmp_path / "t.agrm"), fmt)
    want = jgrm_io.write_grm(mat, ids, str(tmp_path / "j.agrm"), fmt)
    assert filecmp.cmp(got, want, shallow=False)
    if fmt == "mat":
        np.testing.assert_array_equal(tgrm_io.read_grm_mat(got),
                                      jgrm_io.read_grm_mat(want))
