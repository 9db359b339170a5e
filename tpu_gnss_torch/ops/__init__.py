"""Device operations and the CUDA kernels' wrappers."""
