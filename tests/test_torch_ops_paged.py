"""The port's paged_attend at one q head a kv head against the JAX Pallas
kernel in interpret mode and the JAX gather path
(``tests/test_torch_ops.py:check_paged_attend``, which holds the grid at
two). Split from ``tests/test_torch_ops.py``, whose test count puts it
early in pytest-xdist's loadfile queue: a file of 24 tests or fewer runs
after the JAX package's ``tests/test_pipeline.py``, whose start bounds the
tier-1 run."""
import pytest
from test_torch_ops import check_paged_attend, paged_grid, paged_ids

import torch_threads  # noqa: F401  (one torch thread a test process)

PAGED_GRID = paged_grid(1)


@pytest.mark.parametrize("t,groups,window,softcap,quantized", PAGED_GRID,
                         ids=paged_ids(PAGED_GRID))
def test_paged_attend_matches_jax_kernel_and_gather(t, groups, window,
                                                    softcap, quantized):
    check_paged_attend(t, groups, window, softcap, quantized)
