"""The port's AMP train step against the JAX package's at O2 (fp16
params from fp32 masters, bf16 compute): the cases and tolerances of
tests/test_torch_train_step.py, split off to keep each file short."""

import pytest

from torch_train_cases import check_tracks_jax, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("fused", [True, False], ids=["fused_ce", "xentropy"])
def test_train_step_tracks_jax(fused):
    check_tracks_jax("O2", fused)
