"""Operation records of an eager call: the PyTorch stand-in for the JAX
package's HLO helpers (``distributed_training_guide_tpu/utils/hlo.py``).

The JAX tests pin facts about a compiled program's text: a tensor of some
shape must (not) exist in it ("no device holds the whole kv-head pool"),
and which collectives it issues. The port runs eagerly and has no program
text, so ``record_ops`` runs a call under a ``TorchDispatchMode`` and
writes one line per dispatched operation in the compiled-HLO spelling of
its outputs::

    %3 = bf16[2,1,2,16] aten.index.Tensor
    %7 = f32[2,8] c10d.allreduce_.default

so the JAX helpers whose meaning survives take the record's ``text`` as
they take a module's: ``find_collectives`` (every ``c10d.*`` and
``_c10d_functional.*`` operation, by kind), ``has_aval`` (a tensor of
exactly this dtype and shape was made) and ``has_shape_run`` (some
tensor's dims hold this run). Only outputs are written: an operand a call
receives was made before it.

The JAX helpers that read a compiled schedule have no eager meaning and no
counterpart here: ``while_body_computations`` and
``collectives_outside_loops`` (an eager layer loop is Python, not a
``while`` body: every collective is issued flat) and
``assert_async_pairs_span_compute`` (an eager collective is one call, not
an async start / done pair in a schedule; the port's overlap pins count
its gathers instead, ``ops/overlap.py``). A test helper: no module of the
package imports it.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Iterable, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_KINDS = ("all-gather", "reduce-scatter", "all-reduce",
                    "collective-permute", "all-to-all", "broadcast")

# an operation's name -> its collective kind (the c10d and functional
# collectives' spellings)
_KIND_OF = (
    ("reduce_scatter", "reduce-scatter"), ("allreduce", "all-reduce"),
    ("all_reduce", "all-reduce"), ("allgather", "all-gather"),
    ("all_gather", "all-gather"), ("alltoall", "all-to-all"),
    ("all_to_all", "all-to-all"), ("broadcast", "broadcast"),
    ("send", "collective-permute"), ("recv", "collective-permute"),
)

# torch dtype -> the HLO element type name
_HLO_DTYPE = {
    torch.float32: "f32", torch.float64: "f64", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int8: "s8", torch.int16: "s16",
    torch.int32: "s32", torch.int64: "s64", torch.uint8: "u8",
    torch.bool: "pred",
}

_LINE_RE = re.compile(r"^(%\d+) = (.*) (\S+)$")


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    kind: str           # e.g. "all-reduce"
    name: str           # e.g. "c10d.allreduce_.default"
    line: int           # line index into the record's text


def collective_kind(op_name: str):
    """The collective kind of a dispatched operation's name, or None."""
    if not op_name.startswith(("c10d.", "_c10d_functional.")):
        return None
    base = op_name.split(".")[1]
    for key, kind in _KIND_OF:
        if key in base:
            return kind
    return None


def _aval(x) -> str:
    return (f"{_HLO_DTYPE.get(x.dtype, str(x.dtype).replace('torch.', ''))}"
            f"[{','.join(str(int(d)) for d in x.shape)}]")


def _outputs(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _outputs(o)]
    return []


class OpRecorder(TorchDispatchMode):
    """Records every operation dispatched inside ``with OpRecorder() as r``:
    ``r.text`` holds one line per operation (its outputs' avals and its
    name), ``r.ops`` the (name, [aval, ...]) pairs."""

    def __init__(self):
        super().__init__()
        self.ops: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.append((str(func), [_aval(t) for t in _outputs(out)]))
        return out

    @property
    def text(self) -> str:
        lines = []
        for i, (name, avals) in enumerate(self.ops):
            shown = avals[0] if len(avals) == 1 else f"({', '.join(avals)})"
            lines.append(f"%{i} = {shown} {name}")
        return "\n".join(lines)


def record_ops(fn, *args, **kwargs) -> tuple:
    """(fn's result, the record's text) of one eager call."""
    with OpRecorder() as rec:
        out = fn(*args, **kwargs)
    return out, rec.text


def find_collectives(text: str, kinds: Sequence[str] = COLLECTIVE_KINDS
                     ) -> list[CollectiveOp]:
    """Every collective operation in a record's text."""
    out = []
    for i, line in enumerate(text.splitlines()):
        m = _LINE_RE.match(line)
        if m is None:
            continue
        kind = collective_kind(m.group(3))
        if kind is not None and kind in kinds:
            out.append(CollectiveOp(kind=kind, name=m.group(3), line=i))
    return out


def aval_patterns(dtype: str, shape: Iterable[int]) -> tuple[str, str]:
    """The two textual spellings of an aval, as the JAX helper gives them:
    ``f32[8,16]`` (what a record writes) and ``tensor<8x16xf32>``."""
    dims = [str(int(d)) for d in shape]
    return (f"{dtype}[{','.join(dims)}]",
            f"tensor<{'x'.join(dims)}x{dtype}>")


def has_aval(text: str, dtype: str, shape: Iterable[int]) -> bool:
    """True if a tensor of exactly this dtype and shape appears."""
    return any(p in text for p in aval_patterns(dtype, shape))


def has_shape_run(text: str, shape: Iterable[int]) -> bool:
    """True if some tensor's dims contain this CONTIGUOUS run (any dtype,
    any position); runs are boundary-delimited, so 8192 does not match
    inside 18192."""
    dims = [str(int(d)) for d in shape]
    return bool(re.search(r"[\[,]" + ",".join(dims) + r"[,\]]", text)
                or re.search(r"[<x]" + "x".join(dims) + r"[x>]", text))
