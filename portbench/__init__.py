"""The benchmark of the PyTorch and CUDA port (`groan_rs_tpu_torch`); see README.md."""
