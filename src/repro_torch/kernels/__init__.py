"""Hand-written CUDA kernels of the port (``repro.kernels`` counterpart)."""
