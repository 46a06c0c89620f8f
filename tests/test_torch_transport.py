"""The port's KV-page wire (``serve/transport.py``) against the JAX
package's on the CPU: the frames of the same fp32 and int8 + scale
payloads are byte-equal to JAX's ``encode_frame`` and decode on either
side; a bf16 pool round-trips bitwise as raw 2-byte words, without
``ml_dtypes``; a torn frame, a NAK and an ack timeout resolve as
``tests/test_handoff.py`` and ``tests/test_chaos_serve.py`` pin them for
the JAX package (dropped, nothing committed, the retry delivered); the
echo endpoint's digest equals the JAX endpoint's. Tolerance: none, every
comparison is bitwise."""
import hashlib
import socket
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.serve import transport as jwire
from distributed_training_guide_tpu.train.precision import Quantized as JQ
from distributed_training_guide_tpu_torch.serve import transport as twire
from distributed_training_guide_tpu_torch.train.precision import \
    Quantized as TQ
from distributed_training_guide_tpu_torch.utils import faults
import torch_threads  # noqa: F401  (one torch thread a test process)

SHAPE = (2, 6, 4, 2, 16)        # [L, pages, page, kvh, hd]
PAGES = [2, 4, 1]
HEADER = {"request": {"request_id": 3, "prompt_ids": [1, 2]},
          "cache_len": 9, "generated": [5], "kv_dtype": "fp32"}


def _pools(kv_dtype: str, seed: int = 1):
    """The same pool contents for JAX (numpy-backed) and the port."""
    rng = np.random.default_rng(seed)

    def leaf():
        if kv_dtype == "int8":
            q = rng.integers(-127, 128, SHAPE).astype(np.int8)
            s = rng.random(SHAPE[:-1] + (1,)).astype(np.float32)
            return (JQ(jnp.asarray(q), jnp.asarray(s)),
                    TQ(torch.from_numpy(q.copy()), torch.from_numpy(s)))
        x = rng.normal(size=SHAPE).astype(np.float32)
        return jnp.asarray(x), torch.from_numpy(x.copy())

    k, v = leaf(), leaf()
    return {"k": k[0], "v": v[0]}, {"k": k[1], "v": v[1]}


def _bytes(t) -> bytes:
    return twire._raw_bytes(t)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_frames_byte_equal_to_jax(kv_dtype):
    jpages, tpages = _pools(kv_dtype)
    assert twire.pool_leaf_names(tpages) == jwire.pool_leaf_names(jpages)
    jpay = jwire.gather_payload(jpages, PAGES)
    tpay = twire.gather_payload(tpages, PAGES)
    assert twire.payload_nbytes(tpay) == jwire.payload_nbytes(jpay)
    assert twire.encode_frame(7, HEADER, tpay) == \
        jwire.encode_frame(7, HEADER, jpay)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_frames_decode_on_either_side(kv_dtype):
    jpages, tpages = _pools(kv_dtype, seed=2)
    jframe = jwire.encode_frame(5, HEADER, jwire.gather_payload(jpages,
                                                                PAGES))
    xid, header, got = twire.decode_frame(jframe)
    assert xid == 5 and header["cache_len"] == 9
    want = twire.gather_payload(tpages, PAGES)
    for name, t in want.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t)
    tframe = twire.encode_frame(6, HEADER, want)
    _, _, back = jwire.decode_frame(tframe)
    for name, t in want.items():
        assert np.array_equal(back[name], t.numpy())


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_scatter_reproduces_the_sender_pool_bitwise(kv_dtype):
    _, tpages = _pools(kv_dtype, seed=3)
    _, recv = _pools(kv_dtype, seed=4)
    payload = twire.gather_payload(tpages, PAGES)
    _, _, got = twire.decode_frame(twire.encode_frame(0, {}, payload))
    assert twire.scatter_payload(recv, [1, 2, 3], got) is recv
    back = twire.gather_payload(recv, [1, 2, 3])
    for name in payload:
        assert _bytes(back[name]) == _bytes(payload[name])


def _bf16_pool(seed):
    g = torch.Generator().manual_seed(seed)
    return {n: torch.randn(SHAPE, generator=g).to(torch.bfloat16)
            for n in ("k", "v")}


def test_bf16_pool_roundtrips_bitwise_over_the_channel():
    src, dst = _bf16_pool(0), _bf16_pool(1)
    payload = twire.gather_payload(src, PAGES)
    frame = twire.encode_frame(0, {"kv_dtype": "bf16"}, payload)
    sender, receiver = twire.loopback_channel(ack_timeout_s=2.0)
    try:
        assert sender.send(frame, 0) == "delivered"
        xid, header, got = receiver.inbox.get(timeout=5.0)
    finally:
        sender.sock.close()
        receiver.sock.close()
    assert xid == 0
    assert [leaf["dtype"] for leaf in header["leaves"]] == ["bfloat16"] * 2
    twire.scatter_payload(dst, [5, 0, 3], got)
    for name in ("k", "v"):
        assert torch.equal(dst[name][:, [5, 0, 3]].view(torch.int16),
                           src[name][:, PAGES].view(torch.int16))
    # the JAX package reads the same words under its bfloat16
    _, _, jgot = jwire.decode_frame(frame)
    assert jgot["k"].dtype.name == "bfloat16"
    assert np.array_equal(jgot["k"].view(np.uint16),
                          payload["k"].view(torch.int16).numpy().view(
                              np.uint16))


def test_the_port_never_imports_ml_dtypes():
    """A bf16 round trip and every fleet module, in a process that never
    imports JAX: ``ml_dtypes`` stays out of ``sys.modules``."""
    code = (
        "import sys, torch\n"
        "from distributed_training_guide_tpu_torch.serve import (transport,"
        " tiering, disagg, router, elastic, controller, loadgen)\n"
        "p = {n: torch.randn(1, 3, 2, 1, 4).bfloat16() for n in 'kv'}\n"
        "pay = transport.gather_payload(p, [2, 0])\n"
        "_, _, got = transport.decode_frame(transport.encode_frame(0, {},"
        " pay))\n"
        "assert torch.equal(got['k'], pay['k'])\n"
        "assert 'ml_dtypes' not in sys.modules, 'ml_dtypes imported'\n"
        "assert 'jax' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_corrupt_and_short_frames_are_refused():
    payload = {"k": torch.arange(12, dtype=torch.float32).reshape(
        1, 1, 3, 2, 2), "v": torch.ones(1, 1, 3, 2, 2)}
    frame = bytearray(twire.encode_frame(0, {}, payload))
    bad = bytearray(frame)
    bad[len(bad) // 2] ^= 0xFF
    with pytest.raises(twire.TransportError, match="CRC"):
        twire.decode_frame(bytes(bad))
    with pytest.raises(twire.TransportError, match="short|length"):
        twire.decode_frame(bytes(frame[:-8]))
    with pytest.raises(twire.TransportError, match="magic"):
        twire.decode_frame(b"XXXX" + bytes(frame[4:]))
    with pytest.raises(twire.TransportError, match="cast"):
        twire.scatter_payload({"k": torch.zeros(1, 2, 3, 2, 2,
                                                dtype=torch.bfloat16),
                               "v": torch.zeros(1, 2, 3, 2, 2,
                                                dtype=torch.bfloat16)},
                              [1], payload)


@pytest.mark.parametrize("knob,outcome", [
    (faults.ENV_HANDOFF_CRASH_XFER, "dropped_nak"),
    (faults.ENV_HANDOFF_TIMEOUT_XFER, "dropped_timeout"),
])
def test_torn_frame_and_ack_timeout_drop_then_deliver(monkeypatch, knob,
                                                      outcome):
    """Transfer 1 torn (the receiver's CRC NAKs it) or sat on past the
    ack window (the sender aborts): the receiver commits nothing, and the
    retry under the next id is delivered once."""
    monkeypatch.setenv(knob, "1")
    _, tpages = _pools("fp32", seed=5)
    payload = twire.gather_payload(tpages, PAGES)
    sender, receiver = twire.loopback_channel(ack_timeout_s=0.3)
    try:
        assert sender.send(twire.encode_frame(0, {}, payload), 0) == \
            "delivered"
        assert sender.send(twire.encode_frame(1, {}, payload), 1) == outcome
        assert sender.send(twire.encode_frame(2, {}, payload), 2) == \
            "delivered"
        got = [receiver.inbox.get(timeout=5.0)[0] for _ in range(2)]
        assert receiver.inbox.empty()
    finally:
        sender.sock.close()
        receiver.sock.close()
    assert got == [0, 2]


def test_closed_link_is_dropped_link():
    sender, receiver = twire.loopback_channel(ack_timeout_s=0.2)
    receiver.sock.close()
    sender.sock.close()
    assert sender.send(b"x" * 64, 0) == "dropped_link"


@pytest.mark.parametrize("server", ["port", "jax"])
def test_echo_digest_is_the_payload_bytes(server):
    """The port's sender against the port's or the JAX package's echo
    endpoint over TCP on 127.0.0.1: the same frames give the same
    digest, the sha256 of the raw leaf bytes."""
    run = (twire if server == "port" else jwire).run_echo_server
    box: dict = {}
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]
    srv.close()
    thread = threading.Thread(
        target=lambda: box.update(run(port, expect=2)), daemon=True)
    thread.start()
    for _ in range(200):
        try:
            conn = socket.create_connection(("127.0.0.1", port))
            break
        except OSError:
            thread.join(0.02)
    sender = twire.HandoffSender(conn)
    _, tpages = _pools("int8", seed=6)
    digest = hashlib.sha256()
    for xid, ids in enumerate(([1, 2], [5])):
        payload = twire.gather_payload(tpages, ids)
        assert sender.send(twire.encode_frame(xid, {}, payload), xid) == \
            "delivered"
        for t in payload.values():
            digest.update(_bytes(t))
    conn.close()
    thread.join(20.0)
    assert box["frames"] == 2 and box["sha256"] == digest.hexdigest()
