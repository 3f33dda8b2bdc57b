"""Import rules of the PyTorch port.

The port (``ldm3d_torch/``), ``chip_smoke.py`` and the rank functions it
runs on the card (``tools/dp_check.py``) import torch, numpy and the
standard library: never JAX, Flax, Optax, Orbax, MLflow (the port's
tracker writes local JSON only), psutil (the host probes read ``/proc``),
nibabel (NIfTI goes through the port's own reader), scipy or PyYAML, or the
JAX package (``ldm3d_tpu``), not even its numpy-only modules. And the port imports on a
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
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mlflow", "ldm3d_tpu", "psutil",
             "nibabel", "scipy", "yaml")


def _port_sources():
    return sorted(ROOT.joinpath("ldm3d_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "dp_check.py"]


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
        "import ldm3d_torch.ops.conv3d, ldm3d_torch.tools.conv_ab\n"
        "import ldm3d_torch.cli.inference, ldm3d_torch.cli.train_diffusion\n"
        "import ldm3d_torch.cli.train_autoencoder, ldm3d_torch.training.stage1\n"
        "import ldm3d_torch.nn.discriminator, ldm3d_torch.nn.lpips, ldm3d_torch.losses\n"
        "import ldm3d_torch.serving.api_server, ldm3d_torch.serving.score\n"
        "import ldm3d_torch.serving.health_check\n"
        "import ldm3d_torch.cli.distill, ldm3d_torch.cli.evaluate, ldm3d_torch.evaluation\n"
        "import ldm3d_torch.training.distill\n"
        "import ldm3d_torch.configs.schema, ldm3d_torch.ckpt.import_torch\n"
        "import ldm3d_torch.cli.import_checkpoint, ldm3d_torch.cli.export_checkpoint\n"
        "import ldm3d_torch.cli.prepare_data, ldm3d_torch.cli.check_system\n"
        "import ldm3d_torch.data.native_loader, ldm3d_torch.mlops.workspace\n"
        "import ldm3d_torch.mlops.deployment, ldm3d_torch.mlops.monitoring\n"
        "import ldm3d_torch.mlops.pipelines\n"
        "import ldm3d_torch.ops._kernels as k\n"
        "bad = [m for m in ('jax', 'flax', 'triton', 'ldm3d_tpu', 'psutil', 'fastapi',\n"
        "                   'nibabel', 'scipy', 'yaml') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "import ldm3d_torch.data.native_loader as nl\n"
        "assert nl._lib is None  # the native loader is built at first use only\n"
        "libs = (k.flash_fwd_library, k.flash_bwd_library, k.groupnorm_library,\n"
        "        k.conv3d_library)\n"
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
