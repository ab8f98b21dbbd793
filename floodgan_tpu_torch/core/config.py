"""Model names and the topography channel contract.

A copy of the tables in floodgan_tpu/core/config.py, so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

# Channel-count contract keyed by topography selection.  Input stack
# channel order: 0-2 pre-flood RGB, 3 DEM, 4 flow accumulation,
# 5 river distance, 6-8 OSM map.
TOPOGRAPHY_CHANNELS = {"all": 9, "map": 6, "dem": 4, "flow": 4, "river": 4, None: 3}

MODEL_NAMES = ("pix2pix", "cyclegan", "attentiongan", "pairedattention")

_IS_CYCLE = {
    "pix2pix": False,
    "pairedattention": False,
    "cyclegan": True,
    "attentiongan": True,
}
_IS_ATTENTION = {
    "pix2pix": False,
    "pairedattention": True,
    "cyclegan": False,
    "attentiongan": True,
}


def _check_model(model: str) -> str:
    model = model.lower()
    if model not in MODEL_NAMES:
        raise NotImplementedError(
            "Model must be one of: Pix2Pix, CycleGAN, AttentionGAN or PairedAttention"
        )
    return model


def model_is_cycle(model: str) -> bool:
    return _IS_CYCLE[_check_model(model)]


def model_is_attention(model: str) -> bool:
    return _IS_ATTENTION[_check_model(model)]
