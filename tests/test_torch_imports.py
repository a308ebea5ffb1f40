"""The port, its chip_smoke.py and its profiling and kernel-timing scripts import nothing of JAX or
of the JAX package, and the package needs no yaml when imported."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "speech_enhancement_clskd_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "speech_enhancement_clskd_tpu"}
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                      ROOT / "scripts" / "profile_serving_torch.py",
                                      ROOT / "scripts" / "kernel_pair_timing.py",
                                      ROOT / "scripts" / "conv_bf16_variants.py",
                                      ROOT / "scripts" / "gram_variants.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_without_jax_or_yaml():
    """Import every module of the port in a fresh interpreter in which jax,
    flax and yaml cannot be imported."""
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'optax', 'yaml', 'speech_enhancement_clskd_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
