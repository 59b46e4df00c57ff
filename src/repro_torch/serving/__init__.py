"""serving layer of the PyTorch/CUDA port (twin of ``repro.serving``)."""
