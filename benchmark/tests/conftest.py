"""Fixtures of the benchmark's own tests (``python -m pytest benchmark/tests``).
They import neither JAX nor the JAX package."""

import pytest
import torch


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    """Each device a test runs on; the card's case skips without a card."""
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return request.param
