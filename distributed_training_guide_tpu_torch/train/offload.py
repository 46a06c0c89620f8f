"""Host offload of the training state between steps.

Counterpart of the offload half of ``distributed_training_guide_tpu/train/
step.py`` (``offload_opt_state`` / ``offload_params``, ``:725-758``): the
reference's ``CPUOffloadPolicy`` (``05-training-llama-405b/train_llm.py:
69-72``). Between steps the offloaded tensors live in host memory (pinned
when the trainer's device is a card); the step copies them to the device
before it runs and back after, both copies asynchronous on a side stream
ordered by events, and the device copies are freed when the step returns.
The update itself is unchanged, so losses and params are bitwise those of
the same run without offload.

What moves: ``offload_params`` moves every param leaf (and, under ZeRO, the
optimizer's update shard of it) by swapping its ``.data``, so the tensors
the optimizer and autograd hold keep their identity; ``offload_opt_state``
moves every tensor of the optimizer's per-leaf state (a quantized moment's
payload and scales too), read from ``optimizer.state`` at each release, so
a slot the update stores anew is caught as well. Grads are not moved: the
single-device trainer keeps them from one step to the next as it does
without offload.

Like the JAX package's, the whole offloaded state crosses at once, so the
step's device peak is the same as without offload; only the memory held
between steps falls. Leaf-by-leaf streaming is ROADMAP.md queue 1b.
On the CPU (``device="cpu"``) nothing is pinned and the copies are plain
clones, so the same path runs in the tests.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from .precision import Quantized
from .state import named_leaves


class HostOffload:
    """The host half of one ``TrainState``. ``params`` / ``opt_state``
    select what lives on the host between steps."""

    def __init__(self, device: torch.device, *, params: bool,
                 opt_state: bool):
        self.device = torch.device(device)
        self.params = params
        self.opt_state = opt_state
        self._host: dict = {}   # id(param) or (id(leaf), slot) -> buffer
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self.resident_now = False

    # ---- what moves --------------------------------------------------------
    def _param_tensors(self, state) -> list:
        if not self.params:
            return []
        leaves = [p for _, p in named_leaves(state.params)]
        if state.sharding is not None:
            leaves += list(state.sharding.update.values())
        return leaves

    def _opt_slots(self, state) -> list:
        """[(per-leaf state dict, slot name, buffer key)] of every tensor
        slot."""
        if not self.opt_state:
            return []
        out = []
        for leaf, slots in state.opt_state.optimizer.state.items():
            for k, v in slots.items():
                if isinstance(v, (torch.Tensor, Quantized)):
                    out.append((slots, k, (id(leaf), k)))
        return out

    # ---- copies ------------------------------------------------------------
    def _buffer(self, key, t: torch.Tensor) -> torch.Tensor:
        buf = self._host.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                              pin_memory=self.device.type == "cuda")
            self._host[key] = buf
        return buf

    def _to_host(self, key, t: torch.Tensor) -> torch.Tensor:
        buf = self._buffer(key, t)
        buf.copy_(t, non_blocking=self._stream is not None)
        if self._stream is not None and t.is_cuda:
            t.record_stream(self._stream)
        return buf

    def _to_device(self, h: torch.Tensor, compute) -> torch.Tensor:
        """``h`` copied to the device on the side stream; the copy is then
        used on ``compute``, the stream the step runs on."""
        if self._stream is None:
            return h.clone()
        t = h.to(self.device, non_blocking=True)
        t.record_stream(compute)
        return t

    def _map_slot(self, fn, v, key):
        if isinstance(v, Quantized):
            return Quantized(q=fn((key, "q"), v.q),
                             scale=fn((key, "scale"), v.scale))
        return fn(key, v)

    @contextlib.contextmanager
    def _on_side_stream(self):
        """Run the enclosed copies on the side stream, after everything
        queued so far on the compute stream, and make the compute stream
        wait for them. Yields the compute stream (None on the CPU)."""
        if self._stream is None:
            yield None
            return
        compute = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(compute)
        with torch.cuda.stream(self._stream):
            yield compute
        compute.wait_stream(self._stream)

    # ---- the step's two halves ---------------------------------------------
    def fetch(self, state) -> None:
        """Host -> device, before a step."""
        with self._on_side_stream() as compute:
            for p in self._param_tensors(state):
                p.data = self._to_device(p.data, compute)
            for slots, k, _ in self._opt_slots(state):
                slots[k] = self._map_slot(
                    lambda _, h: self._to_device(h, compute), slots[k], None)
        self.resident_now = True

    def release(self, state) -> None:
        """Device -> host, after a step (or at placement): the host
        buffers take the values, the device copies are dropped."""
        with self._on_side_stream():
            for p in self._param_tensors(state):
                p.data = self._to_host(id(p), p.data)
            for slots, k, key in self._opt_slots(state):
                slots[k] = self._map_slot(self._to_host, slots[k], key)
        self.resident_now = False

    def wait(self) -> None:
        """Block until the host buffers hold the last release's values."""
        if self._stream is not None:
            self._stream.synchronize()

    @contextlib.contextmanager
    def resident(self, state):
        """The offloaded tensors on the device for the enclosed block (a
        checkpoint read or write), back on the host after it."""
        if self.resident_now:
            yield
            return
        self.fetch(state)
        try:
            yield
        finally:
            self.release(state)
            self.wait()

    def on_host(self, state) -> bool:
        """True when every offloaded tensor of ``state`` is one of this
        offload's host buffers (pinned on a card): the placement between
        steps."""
        bufs = {b.data_ptr() for b in self._host.values()}
        pinned = self._stream is not None
        tensors = [p.data for p in self._param_tensors(state)]
        for slots, k, _ in self._opt_slots(state):
            v = slots[k]
            tensors += [v.q, v.scale] if isinstance(v, Quantized) else [v]
        return all(t.device.type == "cpu" and t.data_ptr() in bufs
                   and (t.is_pinned() or not pinned) for t in tensors)

    def host_bytes(self, state) -> int:
        """Bytes of the tensors this offload keeps on the host."""
        n = sum(p.numel() * p.element_size()
                for p in self._param_tensors(state))
        for slots, k, _ in self._opt_slots(state):
            v = slots[k]
            for t in ((v.q, v.scale) if isinstance(v, Quantized) else (v,)):
                n += t.numel() * t.element_size()
        return n


def make_offload(device, *, params: bool,
                 opt_state: bool) -> Optional[HostOffload]:
    """A ``HostOffload`` when anything is offloaded, else None (also on
    the meta device: the preflight's state has nothing to move)."""
    if not (params or opt_state) or torch.device(device).type == "meta":
        return None
    return HostOffload(device, params=params, opt_state=opt_state)
