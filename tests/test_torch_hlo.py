"""The port's ``utils/hlo.py``: an eager call's operations recorded under a
``TorchDispatchMode``, read by the JAX helpers' names (``find_collectives``,
``has_aval``, ``has_shape_run``) as the JAX ones read a module's text.
The JAX helpers on the same spellings give the same answers."""
import os
import socket

import pytest
import torch
import torch.distributed as dist

from distributed_training_guide_tpu.utils import hlo as jhlo
from distributed_training_guide_tpu_torch.utils import hlo
import torch_threads  # noqa: F401  (one torch thread a test process)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def group():
    """A gloo group of one on this process (the collectives dispatch as
    they do at any world size)."""
    if dist.is_initialized():
        yield dist.group.WORLD
        return
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


def test_records_outputs_in_the_compiled_spelling():
    a = torch.ones(8, 16)
    b = torch.ones(16, 4, dtype=torch.bfloat16)
    out, text = hlo.record_ops(lambda: (a @ a.T, b.to(torch.float32)))
    assert out[0].shape == (8, 8)
    assert hlo.has_aval(text, "f32", (8, 8))
    assert hlo.has_aval(text, "f32", (16, 4))
    assert not hlo.has_aval(text, "f32", (8, 16))   # an operand, not made
    assert hlo.has_shape_run(text, (16, 4))
    assert not hlo.has_shape_run(text, (6, 4))      # boundary-delimited
    # the JAX helper reads the same text the same way
    assert jhlo.has_aval(text, "f32", (8, 8))
    assert jhlo.has_shape_run(text, (16, 4))
    assert not jhlo.has_shape_run(text, (6, 4))


def test_finds_collectives_by_kind(group):
    x = torch.ones(4)
    y = torch.empty(4)

    def step():
        dist.all_reduce(x, group=group)
        dist.all_gather_into_tensor(y, x, group=group)
        dist.broadcast(x, 0, group=group)
        return x * 2

    _, text = hlo.record_ops(step)
    kinds = [c.kind for c in hlo.find_collectives(text)]
    assert kinds == ["all-reduce", "all-gather", "broadcast"]
    assert [c.kind for c in hlo.find_collectives(
        text, kinds=("all-gather",))] == ["all-gather"]
    _, plain = hlo.record_ops(lambda: x * 2)
    assert hlo.find_collectives(plain) == []


def test_the_jax_names_without_an_eager_meaning_are_not_ported():
    """A schedule's loops and async pairs exist only in a compiled
    program; the docstring says so and names them."""
    for name in ("while_body_computations", "collectives_outside_loops",
                 "assert_async_pairs_span_compute"):
        assert hasattr(jhlo, name) and not hasattr(hlo, name)
        assert name in hlo.__doc__
    assert "utils.hlo" not in "".join(
        open(os.path.join(os.path.dirname(hlo.__file__), "..", sub)).read()
        for sub in ("serve/engine.py", "parallel/plans.py"))
