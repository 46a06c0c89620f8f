"""The remat policies on moe-debug (dense dispatch with the einsum
attention, ragged with the flash path's plain version): under each policy
the loss and grads are bitwise the port's step without remat and within
1e-4 of the JAX package's under the same policy
(``tests/test_torch_remat.py:check_policy``). Split from
``tests/test_torch_remat.py``, whose test count puts it early in
pytest-xdist's loadfile queue: a file of few tests runs late, after the
JAX package's ``tests/test_pipeline.py``, whose start bounds the tier-1
run."""
import pytest
from test_torch_remat import POLICIES, check_policy

import torch_threads  # noqa: F401  (one torch thread a test process)

MODELS = [("moe-debug", "dense", "xla"), ("moe-debug", "ragged", "flash")]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("model,dispatch,attn_impl", MODELS,
                         ids=lambda x: str(x))
def test_policy_is_bitwise_the_remat_free_step_and_near_jax(
        model, dispatch, attn_impl, policy):
    check_policy(model, dispatch, attn_impl, policy)
