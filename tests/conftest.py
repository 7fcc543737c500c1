import os

# smoke tests and benches must see ONE device (the dry-run sets its own
# 512-device flag in a separate process)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the CUDA kernels); skips "
        "without one")
