"""Dense ops in plain torch and the hand-written CUDA kernels' wrappers."""
