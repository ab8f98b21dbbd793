"""Model names, the topography channel contract and the training recipe.

A copy of the tables, ``TrainConfig`` and ``lambda_rule`` in
floodgan_tpu/core/config.py, so that the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import dataclasses

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


@dataclasses.dataclass
class TrainConfig:
    """Fixed training recipe constants (reference models/model.py:109-124,
    175-181, 631, 643, 703-712; models/segmentation_model.py:65-67)."""

    gan_lr: float = 2e-4
    seg_lr: float = 1e-4
    adam_b1: float = 0.5
    adam_b2: float = 0.999
    l1_weight: float = 100.0        # pix2pix L1 (model.py:643)
    cycle_weight: float = 10.0      # cycle L1 (model.py:710-711)
    identity_weight: float = 5.0    # identity L1 (model.py:703-704)
    disc_weight: float = 0.5        # D loss halving (model.py:631, 730, 737)
    buffer_size: int = 50           # replay buffer (model.py:283)


def lambda_rule(epoch: int, num_epochs: int) -> float:
    """Linear LR decay factor: constant for the first half of training,
    then linearly decaying (reference models/model.py:175-181).

    ``epoch`` follows torch ``LambdaLR`` semantics: the scheduler's internal
    counter, 0 during the first epoch, incremented once per epoch.
    """
    return 1.0 - max(0, epoch + 1 - (num_epochs / 2)) / float((num_epochs / 2) + 1)
