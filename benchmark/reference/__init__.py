"""The benchmark's plain reference: REMMA's statistics in plain PyTorch.

Nothing here imports the measured program (`gmat_tpu_torch`), JAX or the
JAX package: the reference works out again, from the inputs the benchmark
made, everything the program derives from them.
"""
