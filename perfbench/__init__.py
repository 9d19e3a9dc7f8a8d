"""The benchmark of the PyTorch and CUDA port (``dpvo_tpu_torch``): see
README.md."""
