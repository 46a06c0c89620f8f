"""Shared helpers of the serve-fleet tests of the port
(``tests/test_torch_{transport,disagg,router,tiering,elastic_control}.py``):
llama-debug weights made by the JAX package and carried across by the
weight bridge (fp32), fresh copies of requests, batch-1 references, and
the per-iteration pool audits (refcount == holders, free + held + cached
== capacity, the host tier's own ledger)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from distributed_training_guide_tpu.models import get_model as jget_model
from distributed_training_guide_tpu_torch.models import from_jax, get_model
from distributed_training_guide_tpu_torch.serve import (ServeEngine,
                                                        generate_many)
from distributed_training_guide_tpu_torch.serve.disagg import DisaggEngine
from distributed_training_guide_tpu_torch.serve.kv_pages import pool_audit

_BRIDGED: dict = {}


def bridged(name: str = "llama-debug"):
    """(JAX bundle, JAX params, port bundle, port params), fp32."""
    if name not in _BRIDGED:
        jb = jget_model(name, dtype=jnp.float32)
        jparams = jb.init(jb.config, jax.random.key(0))
        tb = get_model(name, dtype=torch.float32)
        tparams = from_jax.params_from_numpy(
            jax.tree.map(np.asarray, jparams), device="cpu")
        _BRIDGED[name] = (jb, jparams, tb, tparams)
    return _BRIDGED[name]


def fresh(req):
    return dataclasses.replace(req, request_id=None)


def reference(tb, tparams, req, **kw):
    """The request alone through a batch-1 monolith, no prefix cache."""
    eng = ServeEngine(tb, tparams, n_slots=1, prefix_cache=False,
                      device="cpu", **kw)
    return generate_many(eng, [fresh(req)])[0]


def slot_holders(sched) -> dict:
    held: dict = {}
    for slot in sched.slots:
        if slot is None:
            continue
        assert 0 not in slot.pages, "trash page in a live table"
        for p in slot.pages:
            held[p] = held.get(p, 0) + 1
    return held


def cache_refs(sched) -> dict:
    refs: dict = {}
    if sched.cache is None:
        return refs
    stack = list(sched.cache._roots.values())
    while stack:
        node = stack.pop()
        for child in node.children.values():
            refs[child.page] = refs.get(child.page, 0) + 1
            stack.append(child)
    return refs


def audit(engine) -> None:
    """Every pool of a monolith or a disaggregated pair balances (in-transit
    records counted where they still hold pages), and a host tier's books
    balance. A router audits each live replica."""
    if hasattr(engine, "replicas"):
        for rep in engine.replicas.values():
            if rep.state == "live" and not rep.wedged:
                audit(rep.engine)
        return
    tier = getattr(engine, "host_tier", None)
    if isinstance(engine, DisaggEngine):
        transit: dict = {}
        for h in engine.handoff.pending:
            for p in h.pages:
                transit[p] = transit.get(p, 0) + 1
        p, d = engine.prefill.sched, engine.decode.sched
        if engine.transport == "cross_host":
            pool_audit(engine.pool, [slot_holders(p), cache_refs(p)])
            pool_audit(engine.decode_pool, [slot_holders(d), transit],
                       tier=tier)
        else:
            pool_audit(engine.pool, [slot_holders(p), slot_holders(d),
                                     cache_refs(p), transit], tier=tier)
    else:
        sched = engine.scheduler
        pool_audit(sched.pool, [slot_holders(sched), cache_refs(sched)],
                   tier=tier)


def drive(engine, reqs, *, audit_each: bool = True, limit: int = 3000):
    """Submit fresh copies of ``reqs`` and step to the end, auditing the
    pools after every iteration. Returns (ids, {id: result})."""
    ids = [engine.submit(fresh(r)) for r in reqs]
    done, it = {}, 0
    while engine.has_work:
        for res in engine.step():
            done[res.request_id] = res
        if audit_each:
            audit(engine)
        it += 1
        assert it < limit, "stalled"
    return ids, done
