"""Device-side ops of the port: log-mel, retrieval scoring and the hand-written CUDA kernels."""
