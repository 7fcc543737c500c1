"""Hand-written CUDA kernels (paged attention, fused dequant), their plain
PyTorch versions and the device dispatch between them."""
