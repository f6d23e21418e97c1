"""PyTorch compute primitives and the hand-written CUDA kernel wrappers."""
