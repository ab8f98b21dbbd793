"""The AttentionGAN cycle step against the JAX package's with
FLOODGAN_PALLAS=1 in interpret mode, as JAX's own tests run its kernels on
the CPU (tests/torch_cycle_steps.py holds the cases; the defaults' run is
tests/test_torch_cycle_attention.py)."""

import pytest

from torch_cycle_steps import step_fixture, threads_and_warm_exp
from torch_cycle_steps import (  # noqa: F401  the step's parity tests, on this file's cases
    test_step1_losses_match_jax,
    test_step1_gradients_match_jax,
    test_generator_backward_leaves_no_gradient_in_the_discriminators,
    test_step2_losses_match_jax,
    test_step1_buffers_hold_jaxs_synthetics,
    test_generate_both_directions_matches_jax,
)


@pytest.fixture(scope="module", autouse=True)
def _threads_and_warm_exp():
    yield from threads_and_warm_exp()


step_runs = step_fixture(["attentiongan_pallas_interpret"])
