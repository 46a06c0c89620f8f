"""Cross-host KV-page transport: the wire under the disaggregated
handoff's cross-host branch (``serve/disagg.py``), the host tier's spill
unit (``serve/tiering.py``) and the fleet's prefix pulls.

Counterpart of ``distributed_training_guide_tpu/serve/transport.py``.
The same-host :class:`~.disagg.PageHandoff` moves refcounts and zero
bytes; crossing hosts there is no shared pool, so a sequence's committed
k/v must MOVE:

- ``gather_payload`` / ``scatter_payload``: one sequence's pages out of
  every pool leaf (an int8 pool ships its int8 payload AND its fp32
  scale rows) into pinned host tensors, device-to-host behind a CUDA
  event; and back into freshly allocated pages of a receiver pool with
  an in-place ``index_copy_`` on the pool's stream, ordered after every
  kernel already queued there. Raw bytes round-trip, so the receiver's
  pool holds bitwise the sender's bytes.
- A length-prefixed CRC-checked frame (``encode_frame`` /
  ``decode_frame``) whose header carries the request and generation
  state. An fp32 or int8 payload encodes to the same bytes as the JAX
  package's frame. numpy has no bfloat16, so a bf16 leaf travels as its
  raw 2-byte words under the declared dtype ``"bfloat16"`` and is viewed
  back as ``torch.bfloat16`` at the receiver (no ``ml_dtypes``).
- A crash-safe delivery protocol (:class:`HandoffSender` +
  :class:`ReceiverThread`) whose only outcomes are "delivered exactly
  once" or "payload dropped"::

      sender                          receiver
      FRAME(id, header, payload, crc) ->
                                      (CRC ok)   <- ACK(id)
                                      (CRC bad)  <- NAK(id)   [drop]
      COMMIT(id) ->                   [decode + enqueue]
                                      <- FIN(id)
      -- or, on ACK timeout:  ABORT(id) ->       [drop]

  The receiver buffers a frame without touching any pool and commits it
  only on COMMIT; the sender declares delivery only on FIN, by which
  point the record is already in the receiver's inbox. Any failure
  before COMMIT (torn frame, ack timeout, NAK) resolves to the drop
  outcome on both ends, and the disaggregated facade requeues the
  request (recompute + bitwise replay). A FIN lost after COMMIT is the
  two-generals residue; ``disagg.CrossHostPageHandoff`` discards such a
  frame at the inbox by its transfer id.

Deterministic faults (``utils/faults.py``): ``handoff_fault(xfer_id)``
tears transfer N's payload on the wire or sits on it past the ack window.

``python -m distributed_training_guide_tpu_torch.serve.transport --echo``
serves one connection as a receive-validate-commit echo endpoint over
TCP on 127.0.0.1 and prints a payload digest.
"""
from __future__ import annotations

import hashlib
import json
import queue as queue_mod
import socket
import struct
import threading
import time
import zlib
from typing import Optional

import numpy as np
import torch

from ..train.precision import Quantized
from ..utils import faults

MAGIC = b"DTGH"
# frame prefix: magic, xfer_id, header_len, payload_len
_PRE = struct.Struct("<4sQIQ")
_CRC = struct.Struct("<I")
# control message: tag, xfer_id
_CTRL = struct.Struct("<4sQ")
ACK, NAK, CMT, ABT, FIN = b"ACK!", b"NAK!", b"CMT!", b"ABT!", b"FIN!"

_CRASH_TEAR_BYTES = 64

# the pools' leaf dtypes by their wire names (numpy's spelling, as the
# JAX frame writes them)
_WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}
_WIRE_NAMES = {v: k for k, v in _WIRE_DTYPES.items()}


class TransportError(RuntimeError):
    """A wire-level failure (short read, bad magic, CRC mismatch)."""


# ---- payload <-> pool ------------------------------------------------------

def pool_leaf_names(pages: dict) -> list:
    """Stable leaf order for the wire: k then v, payload before scales
    for a quantized pool."""
    names = []
    for name in ("k", "v"):
        if isinstance(pages[name], Quantized):
            names.extend([f"{name}.q", f"{name}.scale"])
        else:
            names.append(name)
    return names


def _leaf(pages: dict, name: str):
    base, _, part = name.partition(".")
    leaf = pages[base]
    return getattr(leaf, part) if part else leaf


def _nbytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    return int(np.asarray(v).nbytes)


def payload_nbytes(payload: dict) -> int:
    """Total host bytes of a gathered payload: the unit the host tier
    budgets in and the wire-cost row preflight prices."""
    return sum(_nbytes(v) for v in payload.values())


def _host_empty(shape, dtype, pin: bool) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, pin_memory=pin)


def gather_payload(pages: dict, page_ids) -> dict:
    """Device-to-host: one sequence's pages out of every pool leaf,
    ``{leaf_name: [L, n, page, kvh, hd(|1)]}`` CPU tensors in logical
    page order. The bytes are the pool's bytes (no dtype cast). From a
    CUDA pool the copies land in pinned buffers behind one event, which
    the host waits on before returning: the gather reads the pool after
    every kernel already queued on the stream."""
    names = pool_leaf_names(pages)
    first = _leaf(pages, names[0])
    idx = torch.as_tensor(list(page_ids), dtype=torch.long,
                          device=first.device)
    out = {}
    for name in names:
        src = _leaf(pages, name).index_select(1, idx)
        if src.is_cuda:
            host = _host_empty(src.shape, src.dtype, True)
            host.copy_(src, non_blocking=True)
            out[name] = host
        else:
            out[name] = src
    if first.is_cuda:
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
    return out


def scatter_payload(pages: dict, page_ids, payload: dict) -> dict:
    """Host-to-device: write a received payload into freshly allocated
    pages of the receiver's pool, in place (``index_copy_`` on the
    current stream, so after any horizon block already queued there).
    Returns the same pools dict."""
    names = pool_leaf_names(pages)
    dev = _leaf(pages, names[0]).device
    idx = torch.as_tensor(list(page_ids), dtype=torch.long, device=dev)
    with torch.no_grad():
        for name in names:
            leaf = _leaf(pages, name)
            src = payload[name]
            if not isinstance(src, torch.Tensor):
                src = torch.from_numpy(np.ascontiguousarray(src))
            if src.dtype != leaf.dtype:
                raise TransportError(
                    f"payload leaf {name} is {src.dtype}, the pool holds "
                    f"{leaf.dtype}: a scatter never casts")
            leaf.index_copy_(1, idx, src.to(dev, non_blocking=True))
    return pages


# ---- frame -----------------------------------------------------------------

def _wire_name(v) -> str:
    if isinstance(v, torch.Tensor):
        if v.dtype not in _WIRE_NAMES:
            raise TransportError(f"no wire name for dtype {v.dtype}")
        return _WIRE_NAMES[v.dtype]
    return str(np.asarray(v).dtype)


def _raw_bytes(v) -> bytes:
    if isinstance(v, torch.Tensor):
        t = v.detach().contiguous().reshape(-1)
        if t.dtype == torch.bfloat16:       # the 2-byte words, as they are
            t = t.view(torch.int16)
        return t.cpu().numpy().tobytes()
    return np.ascontiguousarray(v).tobytes()


def encode_frame(xfer_id: int, header: dict, payload: dict) -> bytes:
    """One transfer on the wire: prefix | header JSON | concatenated
    leaf bytes | CRC32(header+payload). The header's ``leaves`` entry
    records (name, shape, dtype) in payload order so the receiver can
    split the byte run without guessing."""
    header = dict(header)
    header["leaves"] = [{"name": k, "shape": list(v.shape),
                         "dtype": _wire_name(v)}
                        for k, v in payload.items()]
    blob = b"".join(_raw_bytes(v) for v in payload.values())
    hdr = json.dumps(header).encode()
    crc = zlib.crc32(hdr)
    crc = zlib.crc32(blob, crc)
    return (_PRE.pack(MAGIC, xfer_id, len(hdr), len(blob))
            + hdr + blob + _CRC.pack(crc))


def split_payload(header: dict, blob, *, pin: bool = False) -> dict:
    """Rebuild the leaf tensors (CPU, pinned with ``pin``) from a
    validated frame's payload bytes; each leaf is its own aligned copy,
    a bf16 leaf its 2-byte words viewed as ``torch.bfloat16``."""
    view = memoryview(blob)
    out, at = {}, 0
    for leaf in header["leaves"]:
        name = leaf["dtype"]
        if name not in _WIRE_DTYPES:
            raise TransportError(f"unknown wire dtype {name!r}")
        t = _host_empty(leaf["shape"], _WIRE_DTYPES[name], pin)
        n = t.numel() * t.element_size()
        if at + n > len(view):
            raise TransportError(f"payload length mismatch: leaves declare "
                                 f"more than the frame's {len(view)} B")
        if n:
            raw = np.frombuffer(view[at:at + n], dtype=np.uint8)
            if not raw.flags.writeable:     # a bytes frame, not a buffer
                raw = raw.copy()
            t.reshape(-1).view(torch.uint8).copy_(torch.from_numpy(raw))
        out[leaf["name"]] = t
        at += n
    if at != len(view):
        raise TransportError(f"payload length mismatch: leaves declare "
                             f"{at} B, frame carries {len(view)} B")
    return out


def decode_frame(buf: bytes) -> tuple:
    """(xfer_id, header, payload tensors) from one whole frame; raises
    :class:`TransportError` on any integrity failure."""
    if len(buf) < _PRE.size + _CRC.size:
        raise TransportError(f"short frame: {len(buf)} B")
    magic, xfer_id, hlen, plen = _PRE.unpack_from(buf)
    if magic != MAGIC:
        raise TransportError(f"bad magic {magic!r}")
    end = _PRE.size + hlen + plen
    if len(buf) != end + _CRC.size:
        raise TransportError("frame length mismatch")
    view = memoryview(buf)
    hdr_b, blob = view[_PRE.size:_PRE.size + hlen], view[_PRE.size + hlen:end]
    crc = zlib.crc32(hdr_b)
    crc = zlib.crc32(blob, crc)
    if crc != _CRC.unpack_from(buf, end)[0]:
        raise TransportError("CRC mismatch (torn or corrupted frame)")
    header = json.loads(bytes(hdr_b))
    return xfer_id, header, split_payload(header, blob)


# ---- sockets ---------------------------------------------------------------

def _read_exact(sock: socket.socket, n: int) -> Optional[bytearray]:
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        try:
            k = sock.recv_into(view[got:], min(n - got, 1 << 20))
        except OSError:
            return None
        if not k:
            return None
        got += k
    return buf


def _send_ctrl(sock: socket.socket, tag: bytes, xfer_id: int) -> None:
    try:
        sock.sendall(_CTRL.pack(tag, xfer_id))
    except OSError:
        pass                    # the peer is gone; outcomes don't change


def _read_ctrl(sock: socket.socket, want_id: int,
               timeout_s: float) -> Optional[bytes]:
    """Next control tag for ``want_id``, skipping stale messages from
    earlier (aborted/timed-out) transfers; None on timeout or close."""
    deadline = time.monotonic() + timeout_s
    while True:
        left = deadline - time.monotonic()
        if left <= 0:
            return None
        sock.settimeout(left)
        try:
            buf = _read_exact(sock, _CTRL.size)
        finally:
            try:
                sock.settimeout(None)
            except OSError:
                pass
        if buf is None:
            return None
        tag, got_id = _CTRL.unpack(buf)
        if got_id < want_id:
            continue            # a late ack for a transfer already resolved
        if got_id > want_id:
            return None         # protocol desync: treat as failure
        return tag


class HandoffSender:
    """The sending half of the delivery protocol, run inline on the
    engine thread: write the frame, wait for ACK, COMMIT, wait for FIN.
    ``send`` returns the outcome: "delivered" means the record is in the
    receiver's inbox already (FIN is sent after the enqueue); any other
    outcome means the receiver committed nothing and the caller must
    requeue."""

    def __init__(self, sock: socket.socket, *, ack_timeout_s: float = 2.0):
        self.sock = sock
        self.ack_timeout_s = ack_timeout_s

    def send(self, frame: bytes, xfer_id: int) -> str:
        fault = faults.handoff_fault(xfer_id)
        if fault == "crash":
            # a sender crash mid-write leaves a torn payload on the wire;
            # the length prefix went out first, so the receiver reads a
            # whole frame and the CRC rejects it
            pre, hlen, plen = _PRE.size, *_PRE.unpack_from(frame)[2:]
            tear = pre + hlen + plen // 2
            frame = (frame[:tear]
                     + bytes(b ^ 0xFF
                             for b in frame[tear:tear + _CRASH_TEAR_BYTES])
                     + frame[tear + _CRASH_TEAR_BYTES:])
        try:
            self.sock.sendall(frame)
        except OSError:
            return "dropped_link"
        tag = _read_ctrl(self.sock, xfer_id, self.ack_timeout_s)
        if tag != ACK:
            if tag is None:
                _send_ctrl(self.sock, ABT, xfer_id)
                return "dropped_timeout"
            return "dropped_nak"
        _send_ctrl(self.sock, CMT, xfer_id)
        if _read_ctrl(self.sock, xfer_id, self.ack_timeout_s) == FIN:
            return "delivered"
        # COMMIT sent, FIN lost: the receiver MAY have committed; the
        # inbox-side xfer_id dedup discards it
        return "dropped_timeout"


class ReceiverThread(threading.Thread):
    """The receiving half: reads frames off its socket end, runs the
    ACK/COMMIT exchange and enqueues (xfer_id, header, payload) records
    on ``inbox``. Bytes work only, no pool and no device: the receiver
    pool's allocation and scatter run on the engine's thread when the
    decode side takes the record. ``pin`` lands each leaf in pinned host
    memory (for a fast host-to-device scatter). Exits on socket close."""

    def __init__(self, sock: socket.socket, *, ack_timeout_s: float = 2.0,
                 pin: bool = False):
        super().__init__(daemon=True, name="handoff-recv")
        self.sock = sock
        self.ack_timeout_s = ack_timeout_s
        self.pin = pin
        self.inbox: queue_mod.SimpleQueue = queue_mod.SimpleQueue()

    def run(self) -> None:
        try:
            self._run()
        except OSError:
            return      # socket closed under us mid-exchange

    def _run(self) -> None:
        while True:
            pre = _read_exact(self.sock, _PRE.size)
            if pre is None:
                return
            magic, xfer_id, hlen, plen = _PRE.unpack(pre)
            if magic != MAGIC:
                return          # framing lost: the link is unrecoverable
            body = _read_exact(self.sock, hlen + plen + _CRC.size)
            if body is None:
                return
            if faults.handoff_fault(xfer_id) == "timeout":
                # injected stall: sit on the frame past the sender's ack
                # window (1.5x, so the retry under a fresh id finds the
                # receiver awake), then discard it unacked and absorb the
                # sender's ABORT before the next frame read
                time.sleep(self.ack_timeout_s * 1.5)
                _read_ctrl(self.sock, xfer_id, self.ack_timeout_s)
                continue
            view = memoryview(body)
            hdr_b, blob = view[:hlen], view[hlen:hlen + plen]
            crc = zlib.crc32(hdr_b)
            crc = zlib.crc32(blob, crc)
            if crc != _CRC.unpack(view[-_CRC.size:])[0]:
                _send_ctrl(self.sock, NAK, xfer_id)
                continue
            _send_ctrl(self.sock, ACK, xfer_id)
            tag = _read_ctrl(self.sock, xfer_id, self.ack_timeout_s)
            if tag != CMT:
                continue        # ABORT / timeout / desync: drop, no commit
            try:
                header = json.loads(bytes(hdr_b))
                payload = split_payload(header, blob, pin=self.pin)
            except (ValueError, TransportError):
                continue        # CRC passed but content is garbage: drop
            self.inbox.put((xfer_id, header, payload))
            _send_ctrl(self.sock, FIN, xfer_id)


def loopback_channel(*, ack_timeout_s: float = 2.0, pin: bool = False) \
        -> tuple:
    """A connected (sender, started receiver thread) pair over a
    socketpair: the one-process stand-in for two hosts that still runs
    every wire byte and protocol step."""
    a, b = socket.socketpair()
    sender = HandoffSender(a, ack_timeout_s=ack_timeout_s)
    receiver = ReceiverThread(b, ack_timeout_s=ack_timeout_s, pin=pin)
    receiver.start()
    return sender, receiver


# ---- cross-process echo ----------------------------------------------------

def run_echo_server(port: int = 0, expect: Optional[int] = None,
                    out=None) -> dict:
    """Listen on 127.0.0.1:``port``, accept ONE connection, run the
    receive-validate-commit protocol for ``expect`` frames (or until the
    peer closes), and return {frames, payload_bytes, sha256}: the digest
    the sending process compares against its own bytes."""
    srv = socket.create_server(("127.0.0.1", port))
    if out is not None:
        print(json.dumps({"port": srv.getsockname()[1]}), file=out,
              flush=True)
    conn, _ = srv.accept()
    receiver = ReceiverThread(conn)
    receiver.start()
    digest = hashlib.sha256()
    frames = payload_bytes = 0
    while expect is None or frames < expect:
        try:
            _, header, payload = receiver.inbox.get(timeout=30.0)
        except queue_mod.Empty:
            break
        for name in (leaf["name"] for leaf in header["leaves"]):
            buf = _raw_bytes(payload[name])
            digest.update(buf)
            payload_bytes += len(buf)
        frames += 1
    # the last frame's FIN may still be in the receiver thread's hands;
    # wait for the peer to close before tearing the socket down
    receiver.join(timeout=10.0)
    conn.close()
    srv.close()
    return {"frames": frames, "payload_bytes": payload_bytes,
            "sha256": digest.hexdigest()}


def main(argv=None) -> None:
    import argparse
    import sys

    parser = argparse.ArgumentParser(
        prog="python -m distributed_training_guide_tpu_torch.serve.transport",
        description="cross-process handoff echo endpoint")
    parser.add_argument("--echo", action="store_true", required=True)
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--expect", type=int, default=None)
    args = parser.parse_args(argv)
    result = run_echo_server(args.port, args.expect, out=sys.stdout)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
