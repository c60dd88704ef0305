"""The benchmark of the PyTorch/CUDA port `gmat_tpu_torch` (`run.py`)."""
