"""Scripts that measure the port on a CUDA device (run as modules)."""
