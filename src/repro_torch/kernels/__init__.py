"""Paged attention: hand-written CUDA kernels, their plain PyTorch
versions and the device dispatch between them."""
