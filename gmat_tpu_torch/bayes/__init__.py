"""Bayesian alphabet: declared but empty in the reference GMAT package and
in `gmat_tpu`; kept as an importable placeholder for API parity."""
