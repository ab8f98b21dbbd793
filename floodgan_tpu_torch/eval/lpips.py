"""LPIPS (the AlexNet variant), the port of floodgan_tpu/eval/lpips.py:
torchmetrics' ``LearnedPerceptualImagePatchSimilarity`` default.

Scale the inputs by the fixed shift and scale; run the five AlexNet conv
layers; tap after each ReLU; unit-normalise each tap over channels; take
the squared difference; apply the tap's non-negative 1x1 linear head; mean
over space; sum over taps.  The convolutions run under
``core.device.full_f32()`` (TF32 off), the f32 the metric is held to.

The weights come from an ``.npz`` in the JAX package's layout (``conv{i}_w``
HWIO, ``conv{i}_b``, ``lin{i}_w`` (1, 1, C, 1)).  ``load_lpips`` searches an
explicit path, then ``FLOODGAN_LPIPS_WEIGHTS``, then the port's own
``floodgan_tpu_torch/assets/lpips_alex.npz``.  With none found,
``FLOODGAN_LPIPS_FALLBACK=1`` opts in to the seed-47 random features of
``fallback_weights`` (the same draws as the JAX package's, so the same
metric, but not comparable to the trained one); otherwise it returns None
and the LPIPS column is NaN.  The JAX package's one-time export through the
``lpips`` package needs a download and is not ported.

The reference feeds [0, 1] images to torchmetrics with ``normalize=False``
(which expects [-1, 1]); the callers here do the same, for parity.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from floodgan_tpu_torch.core.device import full_f32

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# AlexNet features: (out_ch, kernel, stride, pad, maxpool_before)
_ALEX = [
    (64, 11, 4, 2, False),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, True),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
]


class LPIPS:
    """Callable LPIPS metric over a dict of numpy weights in the JAX
    layout.  The weights are copied to the device of the first input that
    arrives there, once per device."""

    def __init__(self, weights: Dict[str, np.ndarray]):
        self._host = {}
        for i in range(len(_ALEX)):
            self._host[f"conv{i}_w"] = torch.from_numpy(np.ascontiguousarray(
                np.transpose(weights[f"conv{i}_w"], (3, 2, 0, 1)), np.float32))
            self._host[f"conv{i}_b"] = torch.from_numpy(np.asarray(weights[f"conv{i}_b"], np.float32))
            self._host[f"lin{i}_w"] = torch.from_numpy(np.ascontiguousarray(
                np.transpose(weights[f"lin{i}_w"], (3, 2, 0, 1)), np.float32))
        self._by_device: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def _weights(self, device: torch.device) -> Dict[str, torch.Tensor]:
        w = self._by_device.get(device)
        if w is None:
            w = self._by_device[device] = {k: v.to(device) for k, v in self._host.items()}
        return w

    @torch.no_grad()
    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Per-image LPIPS distance of NHWC inputs (nominally in [-1, 1])."""
        w = self._weights(pred.device)
        shift = torch.tensor(_SHIFT, device=pred.device).view(1, 3, 1, 1)
        scale = torch.tensor(_SCALE, device=pred.device).view(1, 3, 1, 1)

        def feats(x):
            x = (x.permute(0, 3, 1, 2).float() - shift) / scale
            taps = []
            for i, (_, _, stride, pad, pool_before) in enumerate(_ALEX):
                if pool_before:
                    x = F.max_pool2d(x, 3, 2)
                x = torch.relu(F.conv2d(x, w[f"conv{i}_w"], w[f"conv{i}_b"], stride=stride, padding=pad))
                taps.append(x)
            return taps

        total = None
        with full_f32():
            for i, (fp, ft) in enumerate(zip(feats(pred), feats(target))):
                fp = fp * torch.rsqrt(torch.sum(fp * fp, dim=1, keepdim=True) + 1e-10)
                ft = ft * torch.rsqrt(torch.sum(ft * ft, dim=1, keepdim=True) + 1e-10)
                d = torch.square(fp - ft)
                v = F.conv2d(d, torch.clamp(w[f"lin{i}_w"], min=0.0)).mean(dim=(1, 2, 3))
                total = v if total is None else total + v
        return total


_warned = False


def fallback_weights(seed: int = 47) -> Dict[str, np.ndarray]:
    """Deterministic random-feature LPIPS weights, bit for bit those of the
    JAX package: He-normal AlexNet-shaped convs and uniform 1/C
    non-negative heads from ``np.random.default_rng(seed)``.  Reproducible,
    but not comparable to torchmetrics' trained LPIPS."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    cin = 3
    for i, (cout, k, _, _, _) in enumerate(_ALEX):
        fan_in = cin * k * k
        out[f"conv{i}_w"] = rng.normal(0.0, np.sqrt(2.0 / fan_in), size=(k, k, cin, cout)).astype(np.float32)
        out[f"conv{i}_b"] = np.zeros((cout,), dtype=np.float32)
        out[f"lin{i}_w"] = np.full((1, 1, cout, 1), 1.0 / cout, dtype=np.float32)
        cin = cout
    return out


def _asset_path() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "lpips_alex.npz")


def load_lpips(weights_path: Optional[str] = None) -> Optional[LPIPS]:
    """The LPIPS metric from the first weights found (module docstring), or
    None, with a one-time warning, when there are none."""
    global _warned
    if weights_path and not os.path.isfile(weights_path):
        # An explicit path is a promise: other weights would score with
        # something the caller did not ask for.
        raise FileNotFoundError(f"LPIPS weights file not found: {weights_path}")
    for path in (weights_path, os.environ.get("FLOODGAN_LPIPS_WEIGHTS"), _asset_path()):
        if path and os.path.isfile(path):
            try:
                with np.load(path) as npz:
                    return LPIPS(dict(npz))
            except (OSError, ValueError, KeyError) as e:
                if path == weights_path:
                    raise
                warnings.warn(f"skipping unreadable LPIPS weights {path}: {e}")
    if os.environ.get("FLOODGAN_LPIPS_FALLBACK") == "1":
        if not _warned:
            warnings.warn(
                "FLOODGAN_LPIPS_FALLBACK=1: using the deterministic random-feature LPIPS fallback "
                "(seed 47).  Values are reproducible but NOT numerically comparable to torchmetrics' "
                "trained LPIPS."
            )
            _warned = True
        return LPIPS(fallback_weights())
    if not _warned:
        warnings.warn(
            "Pretrained LPIPS weights not found (FLOODGAN_LPIPS_WEIGHTS, the asset "
            f"{_asset_path()}); the LPIPS column is NaN.  Set FLOODGAN_LPIPS_FALLBACK=1 for a "
            "deterministic random-feature stand-in (not comparable to the trained metric)."
        )
        _warned = True
    return None
