"""Import guard: the port and chip_smoke.py import no JAX-stack module and
nothing of the JAX package (only tests import both)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "chex", "msgpack", "floodgan_tpu"}
SCANNED = sorted((ROOT / "floodgan_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_top_levels(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


def test_scan_covers_the_port():
    names = {p.name for p in SCANNED}
    assert {"serve.py", "kernels.py", "attention.py", "patchgan.py", "paired.py", "microbench_head.py",
            "chip_smoke.py"} <= names


@pytest.mark.parametrize("path", SCANNED, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [(line, mod) for line, mod in imported_top_levels(path) if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_compares_top_level_names_exactly(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import floodgan_tpu_torch.serve\nfrom floodgan_tpu_torch.ops import kernels\n"
        "import floodgan_tpu.ops\nfrom jax import numpy\n"
    )
    found = [m for _, m in imported_top_levels(src) if m in FORBIDDEN]
    assert found == ["floodgan_tpu", "jax"]
