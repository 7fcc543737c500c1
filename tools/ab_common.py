"""What the kernel A/B tools share (``decode_ab.py``, ``prefill_ab.py``):
an earlier checkout's kernel sources built with this checkout's
``build.NVCC_FLAGS`` and bound beside this checkout's, copies of a
``csrc/`` directory with lines patched out (probes), and a run's header.

A tool swaps a side in by writing its bound C entry into ``build._BOUND``,
where the wrappers look their entry up at each call.
"""

from __future__ import annotations

import ctypes
import importlib.util
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Mapping, Sequence, Tuple

ROOT = Path(__file__).resolve().parents[1]


def log(msg: str):
    print(msg, flush=True)


def load_module(path: Path, name: str):
    """A module of the baseline's wrappers, loaded from its file under
    ``name`` (its imports resolve to this checkout's package)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def nvcc_all(jobs):
    """Build every (source, output) of ``jobs`` with one nvcc each, all at
    once; raise with nvcc's output on a failure."""
    from repro_torch.kernels import build
    procs = [(src, out, subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src, out in jobs]
    for src, out, p in procs:
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc {src} failed:\n{text}")


def bind(lib_path: Path, symbol: str, argtypes):
    fn = getattr(ctypes.CDLL(str(lib_path)), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def baseline_csrc(base_root: Path) -> Path:
    """The baseline checkout's kernels directory (``.../kernels``)."""
    base_k = base_root / "src" / "repro_torch" / "kernels"
    if not (base_k / "csrc").is_dir():
        raise SystemExit(f"{base_root}: no src/repro_torch/kernels/csrc")
    return base_k


def build_both(base_root: Path, names: Sequence[str],
               work: Path) -> Dict[str, Path]:
    """This checkout's libraries of ``names`` (``build.build``) and the
    baseline's, one nvcc each, all at once.  Returns {name: the baseline's
    library}."""
    from repro_torch.kernels import build
    base_k = baseline_csrc(base_root)
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    build.build(tuple(names))
    libs = {n: work / f"base_{n}.so" for n in names}
    nvcc_all([(base_k / "csrc" / f"{n}.cu", libs[n]) for n in names])
    log(f"[build] this checkout's and the baseline's {', '.join(names)} in "
        f"{time.perf_counter() - t0:.1f} s")
    return libs


def patched_copies(csrc: Path, work: Path,
                   probes: Mapping[str, Iterable[Tuple[str, str, str]]],
                   names: Sequence[str]) -> Dict[Tuple[str, str], Path]:
    """For each probe tag, a copy of ``csrc`` with its (file, old, new)
    patches applied (each ``old`` must be in its file; every occurrence is
    replaced) and ``names`` built from it.  Returns {(tag, name): library}."""
    libs, jobs = {}, []
    for tag, patches in probes.items():
        var = work / tag.replace(" ", "_")
        shutil.rmtree(var, ignore_errors=True)
        shutil.copytree(csrc, var)
        for fname, old, new in patches:
            src = var / fname
            text = src.read_text()
            if old not in text:
                raise SystemExit(f"probe '{tag}': the line to patch is not "
                                 f"in {fname}")
            src.write_text(text.replace(old, new))
        for n in names:
            jobs.append((var / f"{n}.cu", var / f"{n}.so"))
            libs[(tag, n)] = var / f"{n}.so"
    nvcc_all(jobs)
    return libs


def device_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def warm_clocks(torch, seconds: float = 1.0):
    """Products on the card for ``seconds``: its clocks up."""
    warm = torch.randn(8192, 8192, device="cuda").bfloat16()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        warm @ warm
        torch.cuda.synchronize()
    del warm
