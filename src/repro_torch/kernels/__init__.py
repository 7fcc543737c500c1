"""Hand-written CUDA kernels (paged and flash attention, fused dequant),
their plain PyTorch versions and the device dispatch between them."""
