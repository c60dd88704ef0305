"""Array-level underscore API (counterpart of `gmat_tpu/scan/array_api.py`,
the reference's exported `_`-twins).

The reference's packages export array-level versions of their entry points
beside the file-level ones: `_remma_add(y, xmat, zmat, ...)`,
`_wemai_multi_gmat(y, xmat, zmat, ...)`, `_remma_epiAA[_parallel/_pair/
_eff/_eff_parallel/_maf_eff]` and the AD/DD twins, all taking
(y, xmat, zmat) instead of a phenotype file.  Users migrating from the
reference import these names; they keep its signatures and output-file
defaults, take a `device` (default CUDA), and run the file-level API's
engines: the exact scans and their `_parallel` parts on the exact-scan
kernel K2, the `_eff` screens on the screen kernels K1, `_pair` on the
float64 pair test, `_wemai_multi_gmat` on `reml.wemai.wemai_reml`.

`zmat` may be a scipy-sparse or dense 0/1 incidence matrix, or a
`DesignMatrices` (see `scan/legacy.py::_as_dm`).
"""
from __future__ import annotations

from gmat_tpu_torch.scan.legacy import (_as_dm, _epi_cpu, _epi_pair_cpu,
                                        remma_add_cpu, remma_dom_cpu)
from gmat_tpu_torch.scan.pairs import balanced_anchor_split
from gmat_tpu_torch.scan.screen import (_num_snp, _remma_epi_eff,
                                        _remma_epi_maf_eff)


def _wemai_multi_gmat(y, xmat, zmat, gmat_lst, init=None, maxiter=200,
                      cc_par=1.0e-8, cc_gra=1.0e-6, device=None):
    """Weighted EM+AI REML on arrays (reference uvlmm_varcom.py:8-104);
    returns the converged variance-component vector."""
    from gmat_tpu_torch.reml.wemai import wemai_reml

    return wemai_reml(_as_dm(y, xmat, zmat), gmat_lst, init=init,
                      maxiter=maxiter, cc_par=cc_par, cc_gra=cc_gra,
                      device=device)


def _remma_add(y, xmat, zmat, gmat_lst, var_com, bed_file,
               out_file="remma_add", device=None):
    """Array-level additive score test (reference remma_add.py:15-94)."""
    return remma_add_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                         out_file=out_file, device=device)


def _remma_dom(y, xmat, zmat, gmat_lst, var_com, bed_file,
               out_file="remma_dom", device=None):
    """Array-level dominance score test (reference remma_dom.py:15-96)."""
    return remma_dom_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                         out_file=out_file, device=device)


# exact scans (reference remma_epi{AA,AD,DD}.py:16) ---------------------------

def _remma_epiAA(y, xmat, zmat, gmat_lst, var_com, bed_file, snp_lst_0=None,
                 p_cut=1.0e-5, out_file="epiAA", device=None):
    return _epi_cpu("AA", y, xmat, zmat, gmat_lst, var_com, bed_file,
                    snp_lst_0, p_cut, out_file, device)


def _remma_epiAD(y, xmat, zmat, gmat_lst, var_com, bed_file, snp_lst_0=None,
                 p_cut=1.0e-4, out_file="epiAD", device=None):
    return _epi_cpu("AD", y, xmat, zmat, gmat_lst, var_com, bed_file,
                    snp_lst_0, p_cut, out_file, device)


def _remma_epiDD(y, xmat, zmat, gmat_lst, var_com, bed_file, snp_lst_0=None,
                 p_cut=1.0e-4, out_file="epiDD", device=None):
    return _epi_cpu("DD", y, xmat, zmat, gmat_lst, var_com, bed_file,
                    snp_lst_0, p_cut, out_file, device)


def _anchor_split(kind, bed_file, parallel):
    return balanced_anchor_split(_num_snp(bed_file), parallel[0], parallel[1],
                                 triangular=(kind != "AD"))


def _remma_epiAA_parallel(y, xmat, zmat, gmat_lst, var_com, bed_file,
                          parallel, p_cut=1.0e-5, out_file="epiAA_parallel",
                          device=None):
    """Balanced anchor shard of the exact scan (reference
    remma_epiAA.py:109-140); writes `<out_file>.<i>`."""
    snp_lst_0 = _anchor_split("AA", bed_file, parallel)
    return _epi_cpu("AA", y, xmat, zmat, gmat_lst, var_com, bed_file,
                    snp_lst_0, p_cut, f"{out_file}.{parallel[1]}", device)


def _remma_epiAD_parallel(y, xmat, zmat, gmat_lst, var_com, bed_file,
                          parallel, p_cut=1.0e-4, out_file="epiAD_parallel",
                          device=None):
    snp_lst_0 = _anchor_split("AD", bed_file, parallel)
    return _epi_cpu("AD", y, xmat, zmat, gmat_lst, var_com, bed_file,
                    snp_lst_0, p_cut, f"{out_file}.{parallel[1]}", device)


def _remma_epiDD_parallel(y, xmat, zmat, gmat_lst, var_com, bed_file,
                          parallel, p_cut=1.0e-4, out_file="epiDD_parallel",
                          device=None):
    snp_lst_0 = _anchor_split("DD", bed_file, parallel)
    return _epi_cpu("DD", y, xmat, zmat, gmat_lst, var_com, bed_file,
                    snp_lst_0, p_cut, f"{out_file}.{parallel[1]}", device)


# explicit pair lists (reference remma_epi*_pair.py:16) -----------------------

def _remma_epiAA_pair(y, xmat, zmat, gmat_lst, var_com, bed_file,
                      snp_pair_file, max_test_pair=50000, p_cut=1.0e-4,
                      out_file="epiAA_pair", device=None):
    return _epi_pair_cpu("AA", y, xmat, zmat, gmat_lst, var_com, bed_file,
                         snp_pair_file, max_test_pair, p_cut, out_file,
                         device)


def _remma_epiAD_pair(y, xmat, zmat, gmat_lst, var_com, bed_file,
                      snp_pair_file, max_test_pair=50000, p_cut=1.0e-4,
                      out_file="epiAD_pair", device=None):
    return _epi_pair_cpu("AD", y, xmat, zmat, gmat_lst, var_com, bed_file,
                         snp_pair_file, max_test_pair, p_cut, out_file,
                         device)


def _remma_epiDD_pair(y, xmat, zmat, gmat_lst, var_com, bed_file,
                      snp_pair_file, max_test_pair=50000, p_cut=1.0e-4,
                      out_file="epiDD_pair", device=None):
    return _epi_pair_cpu("DD", y, xmat, zmat, gmat_lst, var_com, bed_file,
                         snp_pair_file, max_test_pair, p_cut, out_file,
                         device)


# effect-only screens (reference remma_epi*_eff.py:20, with the appended
# chi_app/p_app columns) ------------------------------------------------------

def _remma_epiAA_eff(y, xmat, zmat, gmat_lst, var_com, bed_file,
                     snp_lst_0=None, var_app=1.0, p_cut=1.0e-5,
                     out_file="epiAA_eff", device=None):
    return _remma_epi_eff("AA", None, bed_file, gmat_lst, var_com,
                          snp_lst_0, var_app, p_cut, out_file,
                          dm=_as_dm(y, xmat, zmat), device=device)


def _remma_epiAD_eff(y, xmat, zmat, gmat_lst, var_com, bed_file,
                     snp_lst_0=None, var_app=1.0, p_cut=1.0e-5,
                     out_file="epiAD_eff", device=None):
    return _remma_epi_eff("AD", None, bed_file, gmat_lst, var_com,
                          snp_lst_0, var_app, p_cut, out_file,
                          dm=_as_dm(y, xmat, zmat), device=device)


def _remma_epiDD_eff(y, xmat, zmat, gmat_lst, var_com, bed_file,
                     snp_lst_0=None, var_app=1.0, p_cut=1.0e-5,
                     out_file="epiDD_eff", device=None):
    return _remma_epi_eff("DD", None, bed_file, gmat_lst, var_com,
                          snp_lst_0, var_app, p_cut, out_file,
                          dm=_as_dm(y, xmat, zmat), device=device)


def _remma_epiAA_eff_parallel(y, xmat, zmat, gmat_lst, var_com, bed_file,
                              parallel, var_app=1.0, p_cut=1.0e-5,
                              out_file="epiAA_eff_parallel", device=None):
    snp_lst_0 = _anchor_split("AA", bed_file, parallel)
    return _remma_epiAA_eff(y, xmat, zmat, gmat_lst, var_com, bed_file,
                            snp_lst_0, var_app, p_cut,
                            f"{out_file}.{parallel[1]}", device)


def _remma_epiAD_eff_parallel(y, xmat, zmat, gmat_lst, var_com, bed_file,
                              parallel, var_app=1.0, p_cut=1.0e-5,
                              out_file="epiAD_eff_parallel", device=None):
    snp_lst_0 = _anchor_split("AD", bed_file, parallel)
    return _remma_epiAD_eff(y, xmat, zmat, gmat_lst, var_com, bed_file,
                            snp_lst_0, var_app, p_cut,
                            f"{out_file}.{parallel[1]}", device)


def _remma_epiDD_eff_parallel(y, xmat, zmat, gmat_lst, var_com, bed_file,
                              parallel, var_app=1.0, p_cut=1.0e-5,
                              out_file="epiDD_eff_parallel", device=None):
    snp_lst_0 = _anchor_split("DD", bed_file, parallel)
    return _remma_epiDD_eff(y, xmat, zmat, gmat_lst, var_com, bed_file,
                            snp_lst_0, var_app, p_cut,
                            f"{out_file}.{parallel[1]}", device)


# MAF-binned screens (reference remma_epi*_maf_eff.py:20) ---------------------

def _remma_epiAA_maf_eff(y, xmat, zmat, gmat_lst, var_com, bed_file,
                         snp_lst_0=None, freq=None, freq_deno=None,
                         p_cut=1.0e-5, out_file="epiAA_maf_eff", device=None):
    return _remma_epi_maf_eff("AA", None, bed_file, gmat_lst, var_com,
                              snp_lst_0, freq, freq, freq_deno, p_cut,
                              out_file, dm=_as_dm(y, xmat, zmat),
                              device=device)


def _remma_epiAD_maf_eff(y, xmat, zmat, gmat_lst, var_com, bed_file,
                         snp_lst_0=None, freqA=None, freqD=None,
                         freq_deno=None, p_cut=1.0e-5,
                         out_file="epiAD_maf_eff", device=None):
    return _remma_epi_maf_eff("AD", None, bed_file, gmat_lst, var_com,
                              snp_lst_0, freqA, freqD, freq_deno, p_cut,
                              out_file, dm=_as_dm(y, xmat, zmat),
                              device=device)


def _remma_epiDD_maf_eff(y, xmat, zmat, gmat_lst, var_com, bed_file,
                         snp_lst_0=None, freq=None, freq_deno=None,
                         p_cut=1.0e-5, out_file="epiDD_maf_eff", device=None):
    return _remma_epi_maf_eff("DD", None, bed_file, gmat_lst, var_com,
                              snp_lst_0, freq, freq, freq_deno, p_cut,
                              out_file, dm=_as_dm(y, xmat, zmat),
                              device=device)
