"""kernels layer of the PyTorch/CUDA port (twin of ``repro.kernels``)."""
