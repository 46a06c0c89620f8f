"""Pipeline parallelism: the 1F1B schedule over the ``pp`` mesh axis.

Counterpart of ``distributed_training_guide_tpu/parallel/pipeline.py``,
schedule for schedule:

- the stacked ``[L]`` axis of every per-layer leaf is sharded over pp
  (``parallel/plans.py``'s rules): stage s owns layers [s L/pp, (s+1)
  L/pp) and runs them with the family's ``run_blocks``; the embedding
  runs on stage 0 only, the final norm, head and loss on the last stage
  only;
- M microbatches (2 pp by default) over C = M + pp - 1 forward ticks and
  as many backward ticks, the backward of microbatch m on stage s at tick
  m + pp - 1 - s, interleaved with the forwards (1F1B). In each tick a
  stage does its forward and its backward work, then one exchange passes
  activations downstream and cotangents upstream;
- hand-differentiated: the forward runs without autograd, and each
  stage's forward is recomputed from its saved input in the backward
  (``torch.autograd.grad`` against the saved input and the stage's
  leaves). The saved inputs are a ring of depth min(2 pp - 1, C), so
  activation memory is O(pp) stage inputs whatever M is;
- the loss is the mean of the microbatch means (each microbatch's the
  global mean over its tokens, as the plan's loss computes it), the
  head's grads and cotangent scaled by 1/M at the source; the grads
  accumulate in fp32. Under uneven ``-100`` labels this differs from a
  global token mean, as in the JAX package;
- bubble ticks issue no work, except under cp > 1 (``run_all``): there
  every tick runs the stage on every member and the outputs / cotangents
  are masked, as the JAX schedule does;
- a mixture of experts carries its router aux loss through the schedule
  with the JAX package's scaling: each stage adds ``aux_coef / n_layers``
  times its layers' aux for each microbatch to the loss, and seeds the aux
  cotangent of its recompute with ``aux_coef / (M n_layers)`` (the 1/tp
  of the JAX seed is the MoE layer's own: ``models/moe.py:_ShareGrad``).
  Dense stages carry none.

The stages run over a ``MemberExchange`` (``ops/collectives.py``): under
a process group one stage per rank, the hops neighbour send / receive on
the pp group (``PlanState`` in ``train/step.py``; every stage's grads of a
leaf it keeps whole are then summed over pp with ``LocalLayout.
grad_axes``, JAX's ``_grad_psum_axes``); or every stage in one process
(``LocalExchange``, ``make_pipeline_value_and_grad``), which runs the
pipeline over virtual stages on one card and holds it against the JAX
package on one CPU process.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.collectives import LocalExchange, MemberExchange
from ..ops.cross_entropy import causal_lm_loss


def _leaves(tree: dict, prefix: str = "") -> list:
    out = []
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.extend(_leaves(v, path + "/"))
        else:
            out.append((path, v))
    return out


def _refuse(bundle, pp: int) -> None:
    """The JAX package's refusals of a model under pp."""
    cfg = bundle.config
    if getattr(bundle, "lora_base", None) is not None:
        raise NotImplementedError(
            "LoRA under pipeline parallelism: the stages run the family's "
            "blocks on params['layers'], which a LoRA bundle wraps")
    if cfg.num_layers % pp:
        raise ValueError(f"num_layers={cfg.num_layers} not divisible by "
                         f"pp={pp}")
    if getattr(cfg, "layer_windows", None):
        raise ValueError(
            "per-layer sliding-window patterns (Gemma-2 layer_windows) "
            "are not implemented under pipeline parallelism; use dp/fsdp/"
            "tp/cp plans")


class Pipeline:
    """The 1F1B schedule of one model over the stages of ``exchange``.

    ``layout``: the plan's ``LocalLayout`` (fsdp gathers, tp, the plan's
    global-mean loss), or None for whole params on one device.
    ``attn_impl``: the attention (a context-parallel callable under cp).
    ``data_size``: the data ranks a microbatch's rows split over (for the
    JAX package's refusal of a microbatch they do not divide).
    ``head_loss(nl, hidden, labels)``: the last stage's loss of one
    microbatch in place of the plan's causal-LM loss (the fused loss under
    ``loss_chunks``, a custom loss on the microbatch's gathered logits);
    the JAX pipeline's ``head_loss_fn``."""

    def __init__(self, bundle, exchange: MemberExchange, *,
                 microbatches: Optional[int] = None, layout=None,
                 attn_impl="auto", remat: bool = False, remat_policy=None,
                 run_all: bool = False, data_size: int = 1,
                 head_loss=None):
        from ..models.registry import family_module

        self.pp = exchange.size
        _refuse(bundle, self.pp)
        self.bundle, self.cfg = bundle, bundle.config
        self.fam = family_module(bundle.family)
        self.exchange = exchange
        self.M = microbatches or 2 * self.pp
        self.layout = layout
        self.attn_impl = attn_impl
        self.remat, self.remat_policy = remat, remat_policy
        self.run_all = run_all
        self.data_size = data_size
        self.head_loss = head_loss
        self.layers_per_stage = self.cfg.num_layers // self.pp
        # MoE stages return (y, aux summed over their layers)
        self.moe = getattr(bundle, "apply_with_aux", None) is not None
        self.aux_coef = (getattr(self.cfg, "router_aux_coef", 0.0)
                         if self.moe else 0.0)

    # ---- the stage's pieces ------------------------------------------------
    def _kw(self):
        return {} if self.layout is None else {"layout": self.layout}

    def _stage(self, s: int, layers: dict, x, positions, seq_len):
        """(the stage's output, its layers' summed router aux or None)."""
        out = self.fam.run_blocks(
            self.cfg, layers, x, positions, attn_impl=self.attn_impl,
            remat=self.remat, remat_policy=self.remat_policy,
            first_layer=s * self.layers_per_stage, seq_len=seq_len,
            **self._kw())
        return (out[0], out[1]) if self.moe else (out, None)

    def _embed(self, nl: dict, ids, positions):
        return self.fam.embed_input(self.cfg, nl, ids, positions,
                                    **self._kw())

    def _head_loss(self, nl: dict, y, labels):
        hidden = self.fam.final_layer(self.cfg, nl, y, **self._kw())
        if self.head_loss is not None:
            return self.head_loss(nl, hidden, labels)
        if self.layout is not None:
            return self.layout.loss(self.cfg, nl, hidden, labels)
        return causal_lm_loss(self.fam.logits_of_hidden(self.cfg, nl, hidden),
                              labels)

    # ---- the schedule ------------------------------------------------------
    def value_and_grad(self, stages: list, ids: torch.Tensor,
                       labels: torch.Tensor) -> tuple:
        """(loss, grads) of this process's stages: ``stages`` holds one
        param tree per local stage ({"layers": the stage's slice of the
        stacked layers, and the leaves outside "layers"}, each leaf
        requiring grad); ``ids`` / ``labels`` [B, S] are this rank's rows,
        M consecutive microbatches (``data/loader.py:local_rows``;
        ``labels`` the shifted targets under cp). ``loss`` is the fp32 sum
        over the local stages of their share of the mean of microbatch
        means (the last stage's); ``grads`` one {path: fp32 grad} per local
        stage."""
        from ..models.llama import _WHOLE, model_positions

        pp, M = self.pp, self.M
        b, seq = ids.shape
        gb = b * self.data_size
        if gb % M:
            raise ValueError(f"global batch {gb} not divisible by "
                             f"microbatches={M}")
        if (gb // M) % self.data_size:
            raise ValueError(
                f"microbatch size {gb // M} not divisible by data-parallel "
                f"size {self.data_size}; raise the batch or lower "
                f"pp_microbatches")
        mb = b // M
        ids_mb = ids.reshape(M, mb, seq)
        labels_mb = labels.reshape(M, mb, seq)
        positions, seq_len, _ = model_positions(
            ids_mb[0], None, _WHOLE if self.layout is None else self.layout)
        C = M + pp - 1                    # forward (= backward) ticks
        K = min(2 * pp - 1, C)            # saved-input ring depth
        ex = self.exchange
        fwd_perm = [(i, i + 1) for i in range(pp - 1)]
        bwd_perm = [(i + 1, i) for i in range(pp - 1)]
        act = dict(dtype=self.cfg.dtype, device=ids.device)
        shape = (mb, seq, self.cfg.hidden_size)

        st = []
        for tree in stages:
            layers = tree["layers"]
            nl = {k: v for k, v in tree.items() if k != "layers"}
            st.append(dict(
                layers=layers, nl=nl, layer_leaves=_leaves(layers, "layers/"),
                nl_leaves=_leaves(nl), grads={},
                buf=torch.zeros(shape, **act), dy_recv=torch.zeros(shape, **act),
                dy_head=torch.zeros(shape, **act), saved=[None] * K,
                loss=torch.zeros((), dtype=torch.float32, device=ids.device)))

        def add(grads: dict, pairs, scale: float = 1.0):
            for (path, _), g in pairs:
                if g is None:
                    continue
                g = g.float() if scale == 1.0 else g.float() / scale
                grads[path] = g if path not in grads else grads[path] + g

        def fwd(pos: int, s: int, t: int):
            d = st[pos]
            if t < M and s == 0:
                with torch.no_grad():
                    x_in = self._embed(d["nl"], ids_mb[t], positions)
            else:
                x_in = d["buf"]
            d["saved"][t % K] = x_in
            valid = 0 <= t - s < M
            if valid or self.run_all:
                with torch.no_grad():
                    y, aux = self._stage(s, d["layers"], x_in, positions,
                                         seq_len)
                if not valid:       # run_all: the bubble's output masked
                    y = torch.zeros_like(y)
                elif aux is not None:
                    # this stage's router aux for its resident microbatch
                    d["loss"] = d["loss"] + aux.float() * (
                        self.aux_coef / self.cfg.num_layers)
            else:
                y = torch.zeros(shape, **act)
            o = t - (pp - 1)
            if s == pp - 1 and 0 <= o < M:
                # head + loss and their grads here, where y is live; the
                # paired backward tick takes the cotangent
                with torch.enable_grad():
                    y_d = y.detach().requires_grad_()
                    leaves = [t_ for _, t_ in d["nl_leaves"]]
                    loss = self._head_loss(d["nl"], y_d, labels_mb[o])
                    g = torch.autograd.grad(loss, leaves + [y_d],
                                            allow_unused=True)
                d["loss"] = d["loss"] + loss.detach().float()
                add(d["grads"], zip(d["nl_leaves"], g[:-1]), scale=M)
                d["dy_head"] = g[-1]
            return y

        def bwd(pos: int, s: int, u: int):
            d = st[pos]
            m = u - (pp - 1) + s
            valid = 0 <= m < M
            dy = d["dy_head"] / M if s == pp - 1 else d["dy_recv"]
            x_saved = d["saved"][(u - (pp - 1) + 2 * s) % K]
            if (valid or self.run_all) and x_saved is not None:
                leaves = [t_ for _, t_ in d["layer_leaves"]]
                with torch.enable_grad():
                    x = x_saved.detach().requires_grad_()
                    y, aux = self._stage(s, d["layers"], x, positions,
                                         seq_len)
                    cot = dy if valid else torch.zeros_like(dy)
                    outs, cots = [y], [cot]
                    if aux is not None:     # the aux loss's cotangent
                        outs.append(aux)
                        cots.append(torch.full_like(
                            aux, self.aux_coef / (M * self.cfg.num_layers)
                            if valid else 0.0))
                    g = torch.autograd.grad(outs, leaves + [x], cots,
                                            allow_unused=True)
                add(d["grads"], zip(d["layer_leaves"], g[:-1]))
                dx = g[-1]
            else:
                dx = torch.zeros(shape, **act)
            m0 = u - (pp - 1)
            if s == 0 and 0 <= m0 < M:
                with torch.enable_grad():
                    leaves = [t_ for _, t_ in d["nl_leaves"]]
                    x0 = self._embed(d["nl"], ids_mb[m0], positions)
                    g = torch.autograd.grad(x0, leaves, dx, allow_unused=True)
                add(d["grads"], zip(d["nl_leaves"], g))
            return dx

        for tick in range(C + pp - 1):
            t, u = tick, tick - (pp - 1)
            ys, dxs = [], []
            for pos, s in enumerate(ex.local):
                if t < C:
                    ys.append(fwd(pos, s, t))
                if 0 <= u < C:
                    dxs.append(bwd(pos, s, u))
            down = (ex.permute([[y] for y in ys], fwd_perm)
                    if t < C - 1 else None)
            up = (ex.permute([[dx] for dx in dxs], bwd_perm)
                  if 0 <= u < C - 1 else None)
            if down is not None:
                for d, (y,) in zip(st, down.wait()):
                    d["buf"] = y
            if up is not None:
                for d, (dx,) in zip(st, up.wait()):
                    d["dy_recv"] = dx
        loss = sum(d["loss"] for d in st) / M
        return loss, [d["grads"] for d in st]


# ---------------------------------------------------------------------------
# Virtual stages on one device
# ---------------------------------------------------------------------------

def virtual_stages(params: dict, pp: int) -> list:
    """``params`` split into ``pp`` stage trees: stage s's slice of each
    stacked layer leaf and every other leaf, each a leaf tensor of its own
    (sharing storage with ``params``) that requires grad."""
    def leaf(t):
        return t.detach().requires_grad_()

    def slice_tree(tree, lo, hi):
        if isinstance(tree, dict):
            return {k: slice_tree(v, lo, hi) for k, v in tree.items()}
        return leaf(tree[lo:hi])

    def alias(tree):
        if isinstance(tree, dict):
            return {k: alias(v) for k, v in tree.items()}
        return leaf(tree)

    n = next(iter(_leaves(params["layers"])))[1].shape[0]
    per = n // pp
    return [{"layers": slice_tree(params["layers"], s * per, (s + 1) * per),
             **{k: alias(v) for k, v in params.items() if k != "layers"}}
            for s in range(pp)]


def merge_virtual_grads(params: dict, grads: list) -> dict:
    """Per-stage grads -> one tree shaped as ``params``: each layer leaf's
    stage slices concatenated, every other leaf summed over the stages
    (the pp sum of a leaf every stage keeps)."""
    flat = {}
    for path, t in _leaves(params):
        if path.startswith("layers/"):
            flat[path] = torch.cat([g[path] if path in g
                                    else torch.zeros_like(t[:t.shape[0]
                                                            // len(grads)],
                                                          dtype=torch.float32)
                                    for g in grads], 0)
        else:
            parts = [g[path] for g in grads if path in g]
            flat[path] = (sum(parts) if parts
                          else torch.zeros_like(t, dtype=torch.float32))
    tree: dict = {}
    for path, g in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = g
    return tree


def make_pipeline_value_and_grad(bundle, *, pp: int,
                                 microbatches: Optional[int] = None,
                                 remat: bool = False, remat_policy=None,
                                 attn_impl="auto", loss_chunks: int = 0):
    """f(params, batch) -> (loss, grads) running the 1F1B schedule over
    ``pp`` virtual stages in this process (the JAX package's
    ``make_pipeline_value_and_grad`` on one device): ``batch`` holds
    ``input_ids`` / ``labels`` [B, S]; ``grads`` is fp32 and shaped as
    ``params``. ``loss_chunks`` > 0: the last stage's loss is the fused
    hidden->loss in that many chunks (``ops/overlap.py:make_fused_loss``),
    as the JAX head's chunked loss."""
    head_loss = None
    if loss_chunks > 0:
        from ..models.registry import family_module
        from ..ops.cross_entropy import validate_chunked_loss_support
        from ..ops.overlap import make_fused_loss

        fam = family_module(bundle.family)
        validate_chunked_loss_support(fam, bundle.family, causal_lm_loss)
        fused = make_fused_loss(None, num_chunks=loss_chunks, family_mod=fam)

        def head_loss(nl, hidden, labels):
            return fused(bundle.config, nl, hidden, labels)
    pipe = Pipeline(bundle, LocalExchange(pp), microbatches=microbatches,
                    attn_impl=attn_impl, remat=remat,
                    remat_policy=remat_policy, head_loss=head_loss)

    def value_and_grad(params: dict, batch: dict) -> tuple:
        stages = virtual_stages(params, pp)
        loss, grads = pipe.value_and_grad(stages, batch["input_ids"],
                                          batch["labels"])
        return loss, merge_virtual_grads(params, grads)

    value_and_grad.pipeline = pipe
    return value_and_grad
