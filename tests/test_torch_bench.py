"""The port's bench (floodgan_tpu_torch/tools/bench.py) against the root
bench.py, on the CPU at small sizes.

- The flags: every flag of bench.py but ``--pallas`` (the port has no
  switch that turns a kernel off), with its default and choices, read from
  bench.py by ``ast``; the port adds ``--device``.
- ``--mode train`` at 32^2 (Pix2Pix at 256^2, its least size), batch 2,
  one warm-up and one timed step, for each family and the U-Net: the JSON
  keys of bench.py's line, plus ``device``, less ``tflops_per_sec``,
  ``mfu`` and ``peak_tflops`` (no device metric on the CPU), and the
  ``metric`` and ``unit`` strings of bench.py's ``main()`` for the same
  arguments (run for PairedAttention only: its XLA compiles take ~45 s).
- The FLOPs: FlopCounterMode's count of one forward of each generator and
  of the U-Net equals the sum over their Conv2d and ConvTranspose2d
  modules of 2·N·(Cin/groups)·Cout·k²·P, P the pixels the kernel is
  applied at: the output's for a convolution, the input's for a
  transposed one.  ``count_step`` reports TF32 as the convolutions saw it.
- The peak table: an H100 SXM's dense rates, none for another card.
- ``--device cuda`` without a card fails; it never runs on the CPU.
(``--mode eval`` and ``--mode pipeline`` are tests/test_torch_bench_modes.py.)
"""

import ast
import importlib.util
import json
import math
import sys
from contextlib import redirect_stdout
from io import StringIO
from pathlib import Path

import pytest
import torch

from floodgan_tpu_torch.core.device import full_f32
from floodgan_tpu_torch.models.registry import build_generator
from floodgan_tpu_torch.models.unet import UNet
from floodgan_tpu_torch.tools import bench

from torch_seg_fixtures import few_torch_threads

ROOT = Path(__file__).resolve().parents[1]
NO_DEVICE_METRIC = {"tflops_per_sec", "mfu", "peak_tflops"}
SIZES = {"pairedattention": 32, "cyclegan": 32, "attentiongan": 32, "pix2pix": 256, "unet": 32}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    yield from few_torch_threads()


def load_jax_bench():
    """The root bench.py, unedited, as a module."""
    spec = importlib.util.spec_from_file_location("floodgan_root_bench", ROOT / "bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_flags() -> dict:
    """{flag: (default, choices)} of bench.py's parser, read by ``ast``."""
    flags = {}
    for node in ast.walk(ast.parse((ROOT / "bench.py").read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            store_true = "action" in kw and ast.literal_eval(kw["action"]) == "store_true"
            default = False if store_true else ast.literal_eval(kw["default"]) if "default" in kw else None
            choices = ast.literal_eval(kw["choices"]) if "choices" in kw else None
            flags[ast.literal_eval(node.args[0])] = (default, choices)
    return flags


def test_flags_are_bench_pys_less_pallas():
    jax_flags = _jax_flags()
    assert "--pallas" in jax_flags and len(jax_flags) == 13
    ours = {a.option_strings[0]: (a.default, a.choices) for a in bench.build_parser()._actions
            if a.option_strings and a.dest != "help"}
    assert set(ours) == set(jax_flags) - {"--pallas"} | {"--device"}
    for flag, (default, choices) in jax_flags.items():
        if flag != "--pallas":
            assert ours[flag] == (default, choices), flag
    assert ours["--device"] == ("cuda", None)


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_train_line(tmp_path_factory):
    """bench.py's train line for PairedAttention at 32^2, batch 2."""
    jax_bench = load_jax_bench()
    mp = pytest.MonkeyPatch()
    mp.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path_factory.mktemp("jax_cache")))
    mp.setattr(sys, "argv", ["bench.py", "--size", "32", "--batch", "2", "--steps", "1", "--warmup", "1"])
    out = StringIO()
    try:
        with redirect_stdout(out):
            jax_bench.main()
    finally:
        mp.undo()
    return _last_json(out.getvalue())


@pytest.mark.parametrize("model", list(SIZES))
def test_train_line_matches_bench_py(model, jax_train_line, capsys):
    size = SIZES[model]
    got = bench.main(["--model", model, "--size", str(size), "--batch", "2", "--steps", "1", "--warmup", "1",
                      "--device", "cpu"])
    assert _last_json(capsys.readouterr().out) == got
    assert set(got) == set(jax_train_line) - NO_DEVICE_METRIC | {"device"}
    assert got["device"] == "cpu"
    workload = "mask train" if model == "unet" else "topo=all train"
    assert got["metric"] == jax_train_line["metric"].replace("pairedattention 32^2 topo=all train",
                                                             f"{model} {size}^2 {workload}")
    assert got["unit"] == jax_train_line["unit"] and got["baseline"] == jax_train_line["baseline"]
    assert math.isfinite(got["value"]) and got["value"] > 0 and got["flops_per_sample_tf"] > 0
    if model == "unet":
        assert got["vs_baseline"] is None
    else:
        assert got["vs_baseline"] == round(got["value"] / bench.REF_A100_SAMPLES_PER_SEC_EST, 4)
    if model == "pairedattention":
        assert got["metric"] == jax_train_line["metric"]


def _analytic_conv_flops(module: torch.nn.Module, x: torch.Tensor, monkeypatch) -> int:
    """2·N·(Cin/groups)·Cout·k²·P summed over the convolutions of one
    forward of ``module``, from the shapes of each ``F.conv2d`` /
    ``F.conv_transpose2d`` call (the trunk's convolutions run functionally
    on their modules' weights).  Every kernel applied must be a Conv2d's or
    a ConvTranspose2d's of ``module``, and every one of them is applied."""
    modules = {id(m.weight): m for m in module.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))}
    flops, used = [], set()

    def counted(fn, transposed):
        def call(inp, weight, *args, **kwargs):
            out = fn(inp, weight, *args, **kwargs)
            m = modules[id(weight)]
            assert isinstance(m, torch.nn.ConvTranspose2d) == transposed
            used.add(id(weight))
            k = m.kernel_size[0] * m.kernel_size[1]
            n, _, h, w = (inp if transposed else out).shape  # the pixels the kernel is applied at
            flops.append(2 * n * (m.in_channels // m.groups) * m.out_channels * k * h * w)
            return out
        return call

    monkeypatch.setattr(torch.nn.functional, "conv2d", counted(torch.nn.functional.conv2d, False))
    monkeypatch.setattr(torch.nn.functional, "conv_transpose2d",
                        counted(torch.nn.functional.conv_transpose2d, True))
    try:
        module(x)
    finally:
        monkeypatch.undo()
    assert used == set(modules)
    return sum(flops)


@pytest.mark.parametrize("model", list(SIZES))
def test_flop_count_is_the_convolutions(model, monkeypatch):
    size = SIZES[model]
    net = UNet() if model == "unet" else build_generator(model, 9, dropout_rate=0.0)
    x = torch.randn(2, 3 if model == "unet" else 9, size, size, generator=torch.Generator().manual_seed(0))
    with torch.no_grad(), full_f32():
        _, flops, tf32 = bench.count_step(lambda: net(x))
        assert flops == _analytic_conv_flops(net, x, monkeypatch) > 0
    assert not tf32


def test_count_step_reads_tf32_as_the_convolutions_see_it():
    conv = torch.nn.Conv2d(3, 4, 3)
    x = torch.zeros(1, 3, 8, 8)
    saved = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        assert bench.count_step(lambda: conv(x))[1:] == (2 * 3 * 4 * 9 * 36, True)
        with full_f32():
            assert bench.count_step(lambda: conv(x))[2] is False
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def test_peak_table():
    assert bench.peak_tflops("NVIDIA H100 80GB HBM3", "bf16") == 989.4
    assert bench.peak_tflops("NVIDIA H100 80GB HBM3", "tf32") == 494.7
    assert bench.peak_tflops("NVIDIA H100 80GB HBM3", "f32") == 66.9
    assert bench.peak_tflops("NVIDIA H100 PCIe", "bf16") == 756.5
    assert bench.peak_tflops("NVIDIA A100-SXM4-80GB", "bf16") is None
    assert bench.peak_tflops("cpu", "f32") is None


def test_the_card_without_a_card_fails(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--size", "32", "--batch", "2", "--steps", "1"])


def test_warmup_of_zero_is_refused(capsys):
    with pytest.raises(SystemExit):
        bench.main(["--warmup", "0", "--device", "cpu"])
    assert "--warmup must be at least 1" in capsys.readouterr().err
