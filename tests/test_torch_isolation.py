"""The port stands alone: no JAX, no ``ml_dtypes`` (absent beside the card)
and nothing of the reference package in ``src/repro_torch``,
``chip_smoke.py`` or the card's test file ``tests/test_torch_cuda.py``; it imports without ``triton`` or ``nvcc``; its entry
points run on CUDA unless asked for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py"]
BANNED = ("jax", "jaxlib", "repro", "ml_dtypes")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              in ("__import__",) and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    assert path.exists(), path
    bad = sorted(set(_imported_roots(path)) & set(BANNED))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_without_triton_nvcc_or_jax(tmp_path):
    """Import every module of the port in a fresh interpreter whose import
    system refuses jax, ml_dtypes, repro and triton, with no nvcc on
    PATH."""
    mods = sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  .removesuffix(".__init__")
                  for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    assert {"repro_torch.transfer", "repro_torch.transfer.chunkstore",
            "repro_torch.core", "repro_torch.core.weight_transfer",
            "repro_torch.core.kv_migration", "repro_torch.optim.adamw",
            "repro_torch.rl.grpo", "repro_torch.checkpoint.checkpoint",
            "repro_torch.launch.train",
            "repro_torch.kernels.flash_attention",
            "repro_torch.kernels.decode_attention",
            "repro_torch.kernels.ssd_scan", "repro_torch.models.ssm",
            "repro_torch.configs.hymba_1_5b",
            "repro_torch.configs.mamba2_130m"} <= set(mods)
    code = (
        "import sys, importlib\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro', "
        "'ml_dtypes', 'triton'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": str(tmp_path),
           "CUDA_HOME": str(tmp_path), "HOME": str(tmp_path)}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_entry_points_default_to_cuda():
    from repro_torch import resolve_device
    from repro_torch.configs import tiny_math_config
    from repro_torch.launch import train
    from repro_torch.models.kv_cache import init_paged_cache
    from repro_torch.models.transformer import init_params
    from repro_torch.rl.grpo import init_train_state
    from repro_torch.serving.engine import InferenceEngine
    cfg = tiny_math_config()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert resolve_device("cpu").type == "cpu"
    assert init_paged_cache(cfg, 2, 4, 16, device="cpu")["k_pages"] \
        .device.type == "cpu"
    assert init_train_state(params, "cpu")["opt"]["count"].device.type \
        == "cpu"
    if torch.cuda.is_available():
        assert InferenceEngine(cfg, params).device.type == "cuda"
        assert init_paged_cache(cfg, 2, 4, 16)["k_pages"].is_cuda
        with pytest.raises(ValueError, match="cuda"):
            init_train_state(params)            # CPU params, CUDA state
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            InferenceEngine(cfg, params)
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="CUDA"):
            init_params(cfg, torch.Generator().manual_seed(0))
        with pytest.raises(RuntimeError, match="CUDA"):
            init_paged_cache(cfg, 2, 4, 16)
        with pytest.raises(RuntimeError, match="CUDA"):
            init_train_state(params)
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(["--arch", "qwen3-8b", "--reduced", "--steps", "1"])
