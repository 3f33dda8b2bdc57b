"""Import rules of the PyTorch port.

The port (``ldm3d_torch/``) and ``chip_smoke.py`` import torch, numpy and the
standard library: never JAX, Flax, Optax, Orbax or the JAX package
(``ldm3d_tpu``), not even its numpy-only modules. And the port imports on a
machine with no ``nvcc``, no GPU and no ``triton``: kernels are built and
loaded only when a CUDA tensor first reaches them.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ldm3d_tpu")


def _port_sources():
    return sorted(ROOT.joinpath("ldm3d_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_without_nvcc_gpu_or_triton(tmp_path):
    """A fresh interpreter with no nvcc on PATH and no visible GPU imports the
    port's modules, loads no JAX and no triton, and builds nothing."""
    code = (
        "import sys\n"
        "import ldm3d_torch.ops.attention, ldm3d_torch.ops.groupnorm, ldm3d_torch.nn\n"
        "import ldm3d_torch.cli.inference, ldm3d_torch.cli.train_diffusion\n"
        "import ldm3d_torch.ops._kernels as k\n"
        "bad = [m for m in ('jax', 'flax', 'triton', 'ldm3d_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "libs = (k.flash_fwd_library, k.flash_bwd_library, k.groupnorm_library)\n"
        "assert all(lib.cache_info().currsize == 0 for lib in libs)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH=str(tmp_path), CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """``chip_smoke.py`` exits non-zero and prints no result line where
    ``torch.cuda.is_available()`` is false."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
