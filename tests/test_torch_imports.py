"""Import guard: the port and chip_smoke.py import no JAX-stack module,
nothing of the JAX package (only tests import both), no pandas or msgpack
(the card's machine has neither), and matplotlib and plotly only inside
the plot functions (``plot_*`` and ``compare_output_images``)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "chex", "msgpack", "floodgan_tpu", "pandas"}
PLOT_ONLY = {"matplotlib", "plotly"}
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
    names = {str(p.relative_to(ROOT)) for p in SCANNED}
    port = "floodgan_tpu_torch/"
    assert {port + m for m in (
        "serve.py", "ops/kernels.py", "models/attention.py", "models/patchgan.py", "train/paired.py",
        "tools/microbench_head.py", "ckpt/_msgpack.py", "ckpt/checkpoint.py", "ckpt/migrate.py",
        "utils/jax_params.py", "utils/profiling.py", "utils/png.py", "data/tiff.py", "data/native.py",
        "data/splits.py", "data/pipeline.py", "api/paths.py", "api/model.py", "cli/train.py", "cli/predict.py",
        "models/unet.py", "train/seg.py", "eval/metrics.py", "eval/lpips.py", "api/segmentation.py",
        "cli/evaluate.py", "cli/segment.py", "utils/tables.py", "core/rng.py", "models/pix2pix.py",
        "models/cyclegan.py", "train/cycle.py", "api/group.py", "cli/compare.py", "train/remat.py",
        "parallel/mesh.py", "parallel/multihost.py", "parallel/spatial.py", "ckpt/sharded.py", "pre_processing/__init__.py",
        "pre_processing/metadata.py", "pre_processing/stack.py", "pre_processing/scripts.py",
        "pre_processing/explore.py", "utils/torch_export.py", "tools/serve_bench.py",
        "tools/bench.py", "tools/dryrun.py",
    )} | {"chip_smoke.py"} <= names


def plot_function_lines(path: Path):
    """The line numbers inside functions named plot_* or
    compare_output_images."""
    lines = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.FunctionDef) and (node.name.startswith("plot_") or node.name == "compare_output_images"):
            lines.update(range(node.lineno, node.end_lineno + 1))
    return lines


@pytest.mark.parametrize("path", SCANNED, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [(line, mod) for line, mod in imported_top_levels(path) if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    plots = plot_function_lines(path)
    outside = [(line, mod) for line, mod in imported_top_levels(path) if mod in PLOT_ONLY and line not in plots]
    assert not outside, f"{path.relative_to(ROOT)} imports {outside} outside a plot_* function"


def test_guard_compares_top_level_names_exactly(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import floodgan_tpu_torch.serve\nfrom floodgan_tpu_torch.ops import kernels\n"
        "import floodgan_tpu.ops\nfrom jax import numpy\n"
    )
    found = [m for _, m in imported_top_levels(src) if m in FORBIDDEN]
    assert found == ["floodgan_tpu", "jax"]


def test_guard_allows_matplotlib_only_in_plot_functions(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "def plot_losses():\n    import matplotlib.pyplot as plt\n\n"
        "def generate():\n    import matplotlib\n\n"
        "def compare_output_images():\n    import matplotlib\n"
    )
    plots = plot_function_lines(src)
    assert [(line, line in plots) for line, m in imported_top_levels(src) if m in PLOT_ONLY] == [
        (2, True), (5, False), (8, True)]


def test_guard_allows_plotly_only_in_plot_functions(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "def plot_extents_map():\n    import plotly.express as px\n\n"
        "def summarize_dataset_split():\n    import plotly\n"
    )
    plots = plot_function_lines(src)
    assert [(line, line in plots) for line, m in imported_top_levels(src) if m in PLOT_ONLY] == [
        (2, True), (5, False)]
