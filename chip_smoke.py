#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and hold its CUDA kernels
against their plain PyTorch versions.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with one card. The
phases, each of which raises on failure:

1. device — the card's name and power limit; TF32 off for matmul and
   cuDNN, so fp32 references are full fp32;
2. build — every kernel under ``distributed_training_guide_tpu_torch/
   ops/csrc`` compiled by ``nvcc`` (one process per source, in parallel);
3. kernels — the paged-attention kernels (K4: the split-context body, the
   tensor-core body and the combine) against ``paged_attend_reference``
   at llama-3.1-8b's and qwen3-30b-a3b's attention shapes, and at head_dim
   96 (gpt-neox-20b's 64 heads and a GQA group of 4) on pages of 1, 16,
   24 and 128 positions, over query
   tiles 1 to 256, pool dtypes, windows, softcaps, pad tails and contexts
   on split edges, each body's partials against
   ``split_partials_reference`` and the combine against
   ``combine_partials_reference``, each error against a stated bound,
   rows bitwise equal between an 8-slot call and 1-slot calls, and
   (logged, not gated) whether each row of a T = k + 1 call equals a
   T = 1 call at its length on the same pages (k 4, 7, 15; llama-3.1-8b's
   and qwen3-30b-a3b's heads; fp32, bf16 and int8 pools);
4. timing — K4's kernels (device time from torch.profiler; the whole
   call with its host wrapper beside it), the plain versions and
   PyTorch's ``scaled_dot_product_attention`` (a yardstick the port never
   calls) at the llama-3.1-8b decode (context 4096 and 1024),
   qwen3-30b-a3b decode and prefill-chunk shapes, beside the
   bytes/operations bound;
5. flash — the flash-attention forward (K1) and its backward kernels
   (K2 dq, K3 dk/dv) against their plain versions at llama-3.2-1b's,
   llama-3.1-8b's and qwen3-30b-a3b's attention shapes, head_dim 256 and
   ragged lengths, fp32 and bf16, causal, windowed, softcapped and banded,
   and a q whose base lies off 16 bytes; every K1 launch through the body
   that ``_fwd_plan`` names; every bf16 Hopper-body launch (K1-K3 at
   head_dim 64 / 128) also against the plain version at its own
   arithmetic (K1: 64-key tiles with a running max, p rounded to bf16; K2
   / K3: p and ds rounded to bf16) and bitwise equal to a second launch;
6. flash timing — K1, K2 and K3 at both training paths' shapes
   (llama-3.2-1b and qwen3-30b-a3b) beside their plain versions, their
   bounds and SDPA forward / backward (device times, kernels and SDPA alike,
   with no host time: the calls queued behind a device-side sleep; the
   profiler's per-launch time beside them), and K3's causal tail (its time
   against its blocks' work at a non-causal launch's rate);
7. serve — ``ServeEngine`` on llama-3.1-8b at full width and depth in
   bf16 (random weights from a seed), once with bucketed prefill and once
   with 256-token chunks, checking that K4 carried both programs, that
   every K1 launch of the bucketed prefill ran the Hopper body with no
   operand copied, batch invariance of a greedy request, first-token
   logits against the plain full-context prefill, and a torch.profiler
   breakdown of a decode step;
8. train — chapter 01's ``run_training`` on llama-3.2-1b at full width
   and depth (bf16 compute, fp32 params and AdamW, synthetic data, 2048
   tokens x 4 sequences), checking finite falling loss, exactly 16
   launches of each of K1-K3 per step (32 of K1 under
   ``--checkpoint-activations``), every K1 launch through the Hopper body,
   no operand copied for the tensor maps, a torch.profiler breakdown of
   one step,
   and the loss and grad norm of a step through the kernels against the
   einsum attention (fp32 at 2 layers; bf16 loss at full depth);
9. grouped — the grouped matmul (K5) and its transposed form (K6) against
   their plain versions in fp32 and bf16 at qwen3-30b-a3b's decode, chunk
   and training shapes, moe-1b-8e's and qwen1.5-moe-a2.7b's widths, empty
   groups, a tail past ``sum(group_sizes)``, one group taking every row
   and widths off the tiles, the d_lhs form also at fp32 output within
   the fp32 bound, each K5 launch through the body that ``_gmm_plan``
   names (the Hopper body, WMMA, the split body and FMA each run), and the
   autograd Function's grads against plain autograd;
10. grouped timing — K5 at the decode and training shapes (forward and the
   backward's fp32 d_lhs, with the split body's two-pass bound beside the
   fp32 one) and K6 at the training shape beside their plain versions,
   bounds and ``torch._grouped_mm`` (a yardstick the port never calls),
   device times as in phase 6;
11. moe serve — ``ServeEngine`` on qwen3-30b-a3b at full width cut to
   ``MOE_SERVE_LAYERS`` layers
   in bf16 (random weights from a seed) with phase 7's traffic, bucketed
   and chunked: exactly 3 K5 launches a layer per forward (every one
   through the Hopper body) and one K4 launch a layer per decode step, every K1 launch of the
   bucketed prefill through the Hopper body with no operand copied,
   batch invariance of a greedy request, first-token logits
   against a plain prefill through the plain grouped matmul (bf16 full
   depth; fp32 at 2 layers), a torch.profiler breakdown of a decode step;
12. moe train — ``run_training`` on qwen3-30b-a3b at full width cut to 4
   layers with ``--moe-dispatch ragged`` (bf16 compute, fp32 params and
   AdamW, 2 x 2048 tokens, 6 steps): finite falling loss, no dropped
   pairs, exactly 6 K5 (3 forward through the Hopper body, 3 fp32 d_lhs
   through the split body), 3 K6 and 1 each of K1-K3 launches per layer per
   step (K1 through the Hopper body, no operand copied), a profiled step,
   an fp32 2-layer step through the kernels against
   one through the plain grouped matmul, and 2 dense-dispatch steps that
   launch no K5;
13. qmm — the block-dequant matmul of the int8 serve weights (K7)
   against ``quantized_matmul_reference`` at llama-3.1-8b's projection and
   head widths, M from 1 to 2048, block sizes 32, 128 and 24, a short last
   block, fp32 and bf16 x, fp32 and bf16 outputs, each launch through the
   body that ``_qmm_plan`` names (the tensor-core body and FMA each run),
   and rows bitwise the same whatever M;
14. qmm timing — K7 and its plain version at the gate decode, head decode
   and gate chunk shapes beside their bounds (fp32, and the tensor-core
   body's two passes), device times as in phase 10, with the bf16
   ``torch.mm`` on the unquantized weight as a control the port never
   calls;
15. int8 serve — ``ServeEngine(weight_dtype="int8")`` on llama-3.1-8b at
   full width cut to ``INT8_SERVE_LAYERS`` layers (bf16 compute) with phase 7's traffic, bucketed
   and chunked: exactly 7 K7 launches a layer and one for the head per
   forward, every one through the
   tensor-core body, and phase 7's K4 counts, batch invariance of a greedy request, the weight report
   against the resident bytes, first-token logits against the plain
   prefill over the snapped params (bf16 full depth; fp32 at 2 layers on
   llama-3.1-8b and on llama-3.2-1b, whose tied head runs the plain
   transpose form), and a torch.profiler breakdown of a decode step;
   the bf16 params are dropped once the engines' shared int8 programs
   hold the stored tree, as the serve CLI does;
16. chapter 01 — ``run_training`` through the CLI parser on llama-3.2-1b
   (B 4, S 2048): (a) at full width cut to 2 layers, a straight 4-step run
   saving every 2 steps (``-e``, keep 2: exactly 2 retained, every manifest
   verifies), the same with ``--async-checkpoint`` (the same losses, its
   checkpoints bitwise the synchronous ones, checkpoint-2 written while
   steps 3 and 4 updated the state in place), the fallback past a
   corrupted latest checkpoint, and a run crashed at step 3 by the
   exception drill and resumed to step 4 with steps 3-4's losses bitwise
   the straight run's; the bytes and seconds of every save; (b) 4 steps at
   full width cut to 4 layers under each precision policy (fp32,
   bf16-master, adam8bit, bf16-master+adam8bit): finite falling loss, a
   launch of each of K1-K3 a layer and step, the peak falling by at least
   80% of the state bytes the policy saves; (c) 3 steps at 4 layers under
   each remat policy: K1 2 / 2 / 1 / 1 a layer and step
   (all / dots / attn / attn_mlp), K2 / K3 1, the step-1 loss
   bitwise the run's without remat, peak(all) <= peak(attn) <=
   peak(attn_mlp); (d) adafactor and lion, 4 steps at 4 layers: finite
   falling loss,
   their state bytes; (e) the NaN drill under ``--guard-policy skip``
   (one step skipped); and qwen3-30b-a3b cut to 2 layers (ragged) without
   remat and under "all" / "attn": K1, K5 and K6 per layer, the loss
   bitwise the same;
17. plans — the distributed plans of chapters 02, 04, 06 and 07 through
   their entry points (``chapters/c02_ddp.py`` plain, ``--zero1`` and
   ``--zero2``, ``c04_fsdp.py``, ``c06_tp.py``, ``c07_tp_fsdp.py``) on a
   one-rank NCCL group from the torchrun env contract (a TCPStore) and a
   six-axis ``DeviceMesh`` of size 1, on llama-3.2-1b at full width and
   depth (B 4, S 2048, 3 steps; zero2 as 2 microbatches of 2, with its
   sharded accumulation buffer): every loss and grad norm within
   ``PLAN_LOSS_REL`` / ``PLAN_NORM_REL`` of the single plan's on the same
   weights and batch (each collective is a copy at one rank), exactly 16
   launches of each of K1-K3 per step (32 for zero2's two microbatches:
   the einsum attention never ran), the step ms, tokens/s and peak GB of
   each beside the single plan's, ``c07_tp_fsdp.py --zero1`` among them
   (the optimizer's embed dim on (dp, fsdp) beside the params' shards);
   a custom ``loss_fn`` (label smoothing) through the ``Trainer`` under
   chapter 04's plan (B 2: the global logits gathered) against no plan,
   2 steps, the losses within ``PLAN_LOSS_REL``; and a run under chapter
   04's plan at 2 layers saving at step 2 of 3, resumed under chapter
   07's plan, whose step-3 loss equals the fsdp run's; the same run with
   ``--async-checkpoint``, its checkpoint restored bitwise the
   synchronous one and its blocking seconds beside the synchronous
   save's; and the fp32 checkpoint resumed into ``bf16-master+adam8bit``
   under chapter 04's plan and without a plan (each re-encoding where it
   restores), their step-3 losses within ``PLAN_LOSS_REL``;
18. chapter 05 — through the chapter's entry points
   (``chapters/c05_convert_llama.py``, ``c05_llama405b.py``,
   ``engine_llm.py``, ``models/hf_export.py``'s CLI) on one-rank NCCL
   groups: (a) llama-3.2-1b built by ``transformers`` from its public
   card's shapes with random bf16 weights, saved in 3+ safetensors shards,
   converted (anonymous-RSS peak, GB/s), loaded with ``--pretrained``
   under fsdp (its step-1 loss within ``CH05_HF_LOSS_REL`` of transformers'
   on the same batch), trained 3 steps to a checkpoint, exported by the
   CLI and reloaded by transformers (fp32 logits within
   ``CH05_EXPORT_LOGIT_REL`` of the port's); (b) the preflight in a
   process of its own (a fake process group, the meta device):
   llama-3.1-405b at 64 GPUs as fsdp 8 x tp 8 (B 1 a rank, S 4096) under
   fp32 AdamW, bf16-master + adam8bit and bf16 params + adafactor, and at
   one layer on one card, each within 2% of the recipe's bytes a
   parameter, one layer of fp32 AdamW not fitting, and phase 24's
   post-training colocation priced under fsdp 8 (the policy's bytes an
   eighth of fsdp 1's, the engine's whole); (c) one full-width
   405B layer trained 4 steps (bf16 params, adafactor, remat): finite
   losses, exactly 2 / 1 / 1 launches of K1 / K2 / K3 a step, the peak
   beside the preflight's prediction, and K1-K3 at its attention shape
   (a GQA group of 16) against their plain versions and timed beside
   their bounds and SDPA; (d) llama-3.2-1b at 4 layers, 3 steps without offload,
   with the optimizer state and with both offloaded: bitwise losses and
   grad norms, the card holding less by exactly the offloaded bytes
   between steps; (e) the JSON engine at stage 3, bitwise phase 17's
   fsdp run;
19. dense families — (a) K1-K3 on q, k and v sliced from one fused
   [B, S, 3, H, D] projection at gpt2's training shape, bitwise the same
   launches on contiguous copies, no operand copied; (b) ``ServeEngine``
   at full width and depth in bf16 on gpt2 (prompts of 17-900 tokens) and
   pythia-1.4b (17-2000), phase 7's traffic shape, bucketed and chunked:
   one K4 launch a layer per decode step and per chunk, first-token
   logits against the plain prefill, batch invariance, TTFT / ITL; (c)
   ``run_training`` on gpt2 (B 8, S 1024, 8 steps) and pythia-1.4b (B 4, S
   2048, 6 steps) at full width and depth: one launch of each of K1-K3 per
   layer per step through the Hopper bodies, no operand copied, falling
   loss, tokens/s, MFU and the peak; (d) the sampler on gpt2 in fp32: the
   kv_cache mode's greedy tokens equal the recompute mode's for two
   prompts of 32 steps; (e) ``transformers``' GPT2LMHeadModel (gpt2's
   card) and GPTNeoXForCausalLM (pythia-160m's) with random weights,
   saved, converted, loaded (fp32 loss within ``DENSE_HF_LOSS_REL`` of
   transformers'), exported and reloaded (logits within
   ``CH05_EXPORT_LOGIT_REL``); (f) ``--lora-rank 8 --lora-targets wq,wv``
   on llama-3.2-1b at phase 16's 4 layers with phase 8's batch, 4 steps:
   the step-1 loss bitwise
   phase 16's fp32 run's, only the adapters in the optimizer, the peak;
   (g) gemma2-2b served at full depth in bf16 (chunked, phase 7's traffic
   plus a 6000-token prompt, so that the 4096 window binds inside K4 at
   head_dim 256) and trained at full width cut to 4 layers (2 windowed,
   2 global; B 1, S 8192, 3 steps: K1-K3's WMMA bodies with softcap and
   window); (h) K1-K3 timed at the gpt2 and pythia-1.4b training shapes,
   and at gemma2-2b's against their plain versions, and K4 at gpt2's
   decode (one live row of four) and gemma2-2b's, each beside its plain
   version, its bound and SDPA;
20. context and pipeline (chapters 08, 09) — phase 5's cases also hold
   K1-K3's bf16 bodies at the ring's calls (``causal=False`` at S 512 and
   2048; an 8B chunk pair and gemma2-2b's cp-4 chunk pair whose keys lie
   partly below the 4096 band, global offsets on the band, q as drawn and
   x 12); (b) the zigzag ring over 4 virtual members on one card
   (``LocalExchange``) on llama-3.2-1b's attention, forward and backward
   through its autograd op: at S 4096 against the plain version, at S
   32768 against whole-sequence K1-K3, exactly cp (2 cp + 1) = 36
   launches of each kernel; gemma2-2b's banded ring at S 16384 (softcap,
   scale, q as drawn and x 12) against whole-sequence K1-K3, its launches
   the ``_pair_live`` count; (c) Ulysses over 4 virtual members at S
   32768, one K1 launch a member, against whole-sequence K1 (bitwise or
   not, logged), and where cp does not divide the kv heads (llama-3.1-8b
   on a tp-4 rank: q, k, v gathered, K1-K3 once a member on the whole
   sequence) forward and backward against whole-sequence K1-K3; (d) the 1F1B pipeline over 2 and 4 virtual stages on
   llama-3.2-1b at full width and depth (B 8, S 2048, M = 2 pp) against
   the single device's forward and backward of each microbatch: the loss,
   every grad, K1 2 L M and K2 / K3 L M launches, the step time and the
   memory each held beyond the params beside the single device's; and
   ``--loss-chunks 8`` there: the pipeline at pp 2 with the fused loss
   on its last stage against its whole loss (4 layers), and the fused
   loss on 4 contiguous sequence shards of the model's hidden states
   against their shifted targets (the cp plan's form) against the whole
   sequence's loss and grads; (e) chapters 08 and 09 through their
   ``main`` at world 1 against phase 17's single plan; (f) K1-K3 timed at
   the ring's chunk-pair shapes (past, diagonal, banded) and the
   pipeline's microbatch beside their plain versions, bounds and SDPA;
21. chapter 10 under a plan — (a) ``chapters/c10_moe.py`` through its
   ``main`` at world 1 (the ep plan on a one-rank NCCL group) on
   qwen3-30b-a3b at full width cut to 4 layers, ragged and dense: the
   first step bitwise the single plan's, a finite loss (falling under
   ragged), exactly 6 K5 and 3 K6 launches a layer a ragged step; (b)
   ``make_ragged_ep_dispatch`` over 4 virtual members (4 x 4096 tokens,
   E 128, top-8, D 2048, F 768, bf16, one layer) against the single
   device's ragged dispatch on the 16384 tokens, both through K5 / K6:
   the output and the grads of x, the router and the three expert stacks
   within 1e-2 relative L2, every member's launches through the bodies
   the plans name (12 K5 Hopper, 12 K5 split, 12 K6 split), the peak
   memory of each; and ep 2 x fsdp 2 over the same 4 virtual members
   (the experts' embed dim gathered over fsdp inside the exchange, its
   ``embed`` a ``LocalExchange``): bitwise the ep 2 exchange on the
   gathered weights, within 1e-2 of the single device, 24 K5 and 12 K6
   launches; (c) the dense dispatch over the 4 members at capacity
   factor 0.75 against the single device's on the global batch: the same
   dropped fraction (at least 10%), the same tokens with no kept pair, y
   within 1e-2; (d) K5 (forward, fp32-dy d_lhs) and K6 on a member's
   ep-local window (M 131072, about a quarter live) against their plain
   versions, NaN past the local total ignored in both operands, and timed
   beside the live rows alone, their bounds and ``torch._grouped_mm``;
22. overlap — the overlap schedule and the fused hidden->loss: (a)
   chapter 04 at world 1 with and without ``--overlap-schedule``, (b) the
   fused loss on the single plan, (c) ``--loss-chunks`` under tp and
   tp_fsdp, (d) the double-buffered expert ring over 4 virtual members
   against the bulk exchange and the single device, and K5 / K6 on the
   ring's hop window (one member's 4096 tokens x top-8, M 32768) held and
   timed as phase 21 (d) times the ep window, (e) chapter 10 scheduled;
23. spec / horizon — (a) llama-3.1-8b at full width cut to
   ``SPEC_LAYERS`` layers (the script's time limit), bf16: the verify
   forward's logits at every position of T = k + 1 (k 4, 7, 15) against
   k + 1 sequential decode steps on cloned pools (bitwise or max abs
   error, logged), and a verify forward's time beside a decode step's;
   (b) *serve*'s 8 requests plus two repetitive prompts with speculation
   off, ``ngram`` at k 4, a self-draft ``DraftModelDrafter`` and a
   random-weight llama-3.2-1b drafter: tokens/s, ITL, acceptance,
   tokens per verify, K4 launches by body and by T, and every stream
   against spec off (identical, or its first divergence at a position
   whose spec-off decision margin is within twice the measured logit
   error); (c) the same with int8 weights (K7) and ``ngram``, with its
   peak; (d) qwen3-30b-a3b at full width cut to ``SPEC_MOE_LAYERS``
   layers (K5 in the verify), ``ngram`` against spec off; (e)
   ``decode_horizon`` 1, 4 and 8, greedy: tokens bitwise K 1's, wall ms
   and host reads per decode token, the device's idle share, the pools'
   storage kept; (f) ``serve_http`` on 127.0.0.1 (an OS-chosen port):
   three requests, one streamed, each equal to ``generate_many``'s,
   ``/healthz`` and ``/readyz``;
24. tenants and post-training — (a) K5 (fp32 operands, the FMA body) at
   the multi-LoRA shapes (llama-3.1-8b's wq / wv a and b products at
   decode, M 8 over 5 adapter slots, and at a 256-token chunk) and the
   post objective's (M 8 x 127, K = N = 1, empty groups) and its d_lhs,
   against ``gmm_reference`` within ``GMM_FP32_REL`` of its largest
   value, timed beside the plain version, the bound and
   ``torch._grouped_mm`` on bf16 copies; (b) *serve*'s 8 requests on
   llama-3.1-8b bf16 at full width cut to ``TENANT_LAYERS`` layers (the
   script's time limit) with a pool of 4 seeded random tenants
   (r 8, wq / wv): adapter 0 gives the adapter-free engine's tokens and
   logits bit for bit, alone and co-batched with tenants; each tenant's
   stream co-batched is bitwise its solo stream; 4 K5 launches a layer
   in a forward, all the FMA body; two tenants against engines on their merged
   weights (a divergence only at a margin within twice the logit error
   measured on the shared positions); tokens/s, TTFT and ITL beside the
   adapter-free run; a republish mid-stream keeps the stacks' storage;
   the int8 base (K7 and K5); (c) the post-training loop on llama-3.2-1b
   at full width and depth (LoRA r 8, 8 rollouts of 64 new tokens after
   prompts of 16-64, 3 iterations): REINFORCE with merged publishing (decode
   after the publishes bitwise a fresh engine on the final policy), with
   adapter publishing, distillation KL against a seed-1 teacher, a NaN
   step gating the publish; per iteration the reward, loss, rollout
   tokens/s, update and publish ms and K1-K6 launches (K6 none), the peak
   beside ``price_post_colocation``'s bytes, and the llama-3.1-8b
   colocation priced; one post update of that policy (REINFORCE, group
   baseline, one packed batch) under chapter 04's fsdp plan at world 1
   (``post_loss`` on the gathered logits) bitwise the same update without
   a plan, 2 K5 launches each, no K6; (a) also times one PyTorch call on the fp32
   operands (``torch._grouped_mm`` where this torch takes fp32, else an
   fp32 ``torch.bmm`` over each row's gathered adapter matrix, the gather
   timed inside);
25. fleet — llama-3.1-8b in bf16 at full width and depth on *serve*'s 8
   requests (page 16, 8 slots), one ``ModelPrograms`` shared by every
   engine: (a) the KV-page wire: a served sequence's cached pages, from
   a bf16 pool and from an int8 pool, gathered to pinned host memory,
   framed, sent over ``loopback_channel`` (a socketpair: "cross host" on
   one card is a loopback socket on one host) and scattered into a second
   pool arrive bitwise; D2H, wire and H2D GB/s (warm: each leg's second
   pass, the first's ms beside it); (b) ``DisaggEngine``
   same-host and cross-host against the monolith at the same geometry:
   tokens, and every logits row bitwise (same programs, same shapes);
   bytes moved, handoff ms, TTFT p50, ITL; one injected handoff crash
   (requeued, the same tokens); (c) ``local_fleet(2)`` on the 8 requests
   plus 4 prompts sharing a 512-token prefix (affinity hits), and a
   replica killed at a router step: fenced, its requests replayed to the
   uninterrupted tokens, the ms from the fence to the first replayed
   token; (d) a host tier under a pool too small for the batch: preempted
   sequences and an evicted prefix spill and restore to the tier-free
   tokens, spill and restore ms; a 5-slot adapter pool spills and
   restores one tenant bitwise and serves it (K5); (e) a pool-capacity
   generation swap at the same n_slots seats its residents bitwise; an
   n_slots 8 -> 16 swap (the decode GEMMs' M changes): its streams
   against the monolith's, a divergence only at a margin within twice the
   measured logit error; the SLO controller over ``run_open_loop`` at a
   Poisson rate that overloads one replica, as a check: exactly one
   scale-up and every submitted request completed (the short window's
   goodput and tails are logged as the check's, not a workload's; the
   spawn's ms excludes weight load and kernel build).

27. serve plan (run after phase 4, on a card nothing else holds yet) —
   (a) gpt-neox-20b at full width and depth (64 heads of
   96, 44 layers, bf16) serving phase 7's 8 requests in 256-token chunks
   through K4 at head_dim 96 (both bodies), its prefill and first decode
   logits against ``models/neox.py:apply`` over the same tokens within 32
   ulps of the largest logit; (b) llama-3.1-8b at full width, 8 layers,
   with no plan and under the tp and fsdp plans at world 1 over NCCL: the
   plans' tokens bitwise the plain engine's, K4's launches equal; (c) tp 2
   with ``shard_kv`` as two ranks on the one card over gloo (a
   ``launch.local`` subprocess; gloo's collectives on CUDA tensors probed
   first): each rank's pool holds 4 of the 8 kv heads, the first-token
   logits within phase 7's bound of (b)'s, every request served, an int8
   pool and int8 weights (K7 on each rank's shards).

Every line it logs carries ``t_s``, the script's seconds so far. It ends
with a ``{"kernels": [...]}`` line, the card's name and power limit, and
``{"ok": true, "device": {...}}`` as the last line. Without a
card, or without the repository beside it, it exits non-zero first.
"""
from __future__ import annotations

import atexit
import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3 (data sheet)
PEAK_FLOPS = {"bfloat16": 989e12,    # dense tensor-core bf16
              "float32": 67e12}      # fp32 outside the tensor cores (TF32 off)
TOL = {"fp32": 2e-5, "bf16": 3e-2, "int8": 3e-2}
# K4's partials against ``split_partials_reference`` at the body's own
# arithmetic (the split-context body dequantizes int8 in fp32, the
# tensor-core body rounds it to bf16 as the plain version does): m
# (absolute) and l (relative) are fp32 sums of the same products in
# another order; acc / l per row in relative L2, where the split-context
# body keeps fp32 to the end and the tensor-core body rounds p / l to
# bf16 for P V (2**-9 relative per probability, up to ~5e-3 per row where
# a few keys cancel). One key more or less in a split of 256 to 512 keys
# moves l by ~2e-3 to 4e-3 and acc / l by ~4e-2 to 6e-2.
PART_M_ABS = 1e-4
PART_L_REL = 1e-4
PART_ACC_REL_L2 = {"split": 1e-4, "mma": 2e-2}
# a bf16 output against the fp32 combine of its partials: rounded once,
# so within one bf16 ulp, plus the fp32 error of summing the splits'
# terms in another order (2**-24 of terms up to |v| ~ 5, a few times),
# which exceeds the ulp where an element cancels to |o| < ~5e-4
OUT_BF16_ULPS = 1.0
OUT_FLOOR = 2e-6
# relative L2 error of first-token logits against the plain prefill:
# bf16 through 32 random layers (rounding in another order and shape
# compounds layer by layer), and fp32 through 2 layers (order only)
LOGIT_REL_L2_BF16 = 1e-1
LOGIT_REL_L2_FP32 = 1e-4
SEED = 0


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


T_START = time.perf_counter()


def log(**kw) -> None:
    """One JSON line, stamped with the script's seconds so far (``t_s``:
    the time between two lines is what the part between them took)."""
    print(json.dumps({**kw, "t_s": round(time.perf_counter() - T_START,
                                         1)}), flush=True)


def smi_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call from CUDA events around ``iters`` calls,
    after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------

HQ, HKV, D, PAGE, S = 32, 8, 128, 16, 8      # llama-3.1-8b attention
QWEN3_HEADS = (32, 4)                        # qwen3-30b-a3b: Hq, Hkv (D 128)
D96, NEOX20B_HEADS = 96, (64, 64)            # gpt-neox-20b: D, Hq, Hkv
MAX_CTX = 4096


def paged_case(torch, gen, *, t, pool, lengths, m, hq=HQ, hkv=HKV,
               page=PAGE, d=D):
    """Shuffled physical pages per slot, 0-filled (trash) table tails."""
    dev = torch.device("cuda")
    s = len(lengths)
    p = s * m + 1
    perm = torch.randperm(p - 1, generator=gen, device=dev).int() + 1
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    tables = torch.zeros(s, m, dtype=torch.int32, device=dev)
    for i, n in enumerate(lengths):
        own = min(m, (n + t - 1) // page + 1)
        tables[i, :own] = perm[i * m:i * m + own]
    kf = torch.randn(p, page, hkv, d, generator=gen, device=dev)
    vf = torch.randn(p, page, hkv, d, generator=gen, device=dev)
    qdt = torch.float32 if pool == "fp32" else torch.bfloat16
    q = torch.randn(s, t, hq, d, generator=gen, device=dev).to(qdt)
    kn = torch.randn(s, t, hkv, d, generator=gen, device=dev).to(qdt)
    vn = torch.randn(s, t, hkv, d, generator=gen, device=dev).to(qdt)
    if pool == "int8":
        from distributed_training_guide_tpu_torch.serve.kv_pages import (
            quantize_kv)
        kp, vp = quantize_kv(kf), quantize_kv(vf)
    else:
        kp, vp = kf.to(qdt), vf.to(qdt)
    return q, kn, vn, kp, vp, tables, lens


def partials_err(torch, got, want) -> dict:
    """A body's partials against the plain ones on the (row, split) pairs
    with a live key (the pairs' liveness must agree): m absolute, l
    relative, and each split's normalised output acc / l, max absolute
    and per row in relative L2."""
    (m, l, acc), (rm, rl, racc) = got, want
    live = rl > 0
    check(torch.equal(live, l > 0), "partials: live splits differ")
    o, ro = acc[live] / l[live][:, None], racc[live] / rl[live][:, None]
    return dict(m_abs=(m - rm)[live].abs().max().item(),
                l_rel=(l / rl - 1)[live].abs().max().item(),
                acc_abs=(o - ro).abs().max().item(),
                acc_rel_l2=((o - ro).norm(dim=-1)
                            / ro.norm(dim=-1)).max().item())


def bf16_ulps(torch, got, want, floor=OUT_FLOOR) -> float:
    """max |got - want| in units of (one bf16 ulp of max(|got|, |want|)
    plus ``floor``)."""
    big = torch.maximum(got.float().abs(), want.float().abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    return ((got.float() - want.float()).abs() / (ulp + floor)).max().item()


def phase_kernels(torch) -> dict:
    """Every K4 call against ``paged_attend_reference`` and, in bf16,
    within an ulp of the fp32 combine of its body's partials; the body
    alone (its partials) against ``split_partials_reference`` at the
    body's own arithmetic and the combine alone against
    ``combine_partials_reference`` on the same partials; and rows bitwise
    equal between an S = 8 call and S = 1 calls. Returns the worst max
    abs error of the whole call, of each body (acc / l) and of the
    combine."""
    from distributed_training_guide_tpu_torch.ops import paged_decode as pd
    from distributed_training_guide_tpu_torch.serve import kv_pages as kv

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    counts = (pd.LAUNCHES, pd.SPLIT_LAUNCHES, pd.MMA_LAUNCHES,
              pd.COMBINE_LAUNCHES)
    worst = {"call": 0.0, "split": 0.0, "mma": 0.0, "combine": 0.0}
    tight = {b: {"m_abs": 0.0, "l_rel": 0.0, "acc_rel_l2": 0.0,
                 "out_ulps": 0.0} for b in ("split", "mma")}
    n_cases = 0
    # llama-3.1-8b at every tile and variant; qwen3-30b-a3b's attention
    # shape at every tile without window and softcap
    cases = [(t, HQ, HKV, w, c) for t in (1, 5, 16, 64, 256)
             for w in (None, 1024) for c in (None, 50.0)]
    cases += [(t, *QWEN3_HEADS, None, None) for t in (1, 5, 16, 64, 256)]

    def k4_case(t, hq, hkv, window, softcap, pool, page, d):
        nonlocal n_cases
        m = MAX_CTX // page + max(1, 256 // page)
        # mixed contexts up to 4096, one slot starting empty, and the
        # newest row on either side of a split edge of each body (256
        # tokens of the split-context body, 512 of the tensor-core one, at
        # page 16)
        lengths = [MAX_CTX - t, 0, 17, max(0, 256 - t), 257, 512 - t, 512,
                   3000 - t]
        q, kn, vn, kp, vp, tables, lens = paged_case(
            torch, gen, t=t, pool=pool, lengths=lengths, m=m, hq=hq,
            hkv=hkv, page=page, d=d)
        # a pad tail on every other slot for T > 1 (its writes go to
        # the trash page; its query rows are computed and ignored)
        n_valid = torch.tensor([t - (i % 2) * (t // 2)
                                for i in range(S)],
                               dtype=torch.int32, device="cuda")
        out, (kp, vp) = kv.paged_attend(
            q, kn, vn, kp, vp, tables, lens, window=window,
            softcap=softcap, impl="flash",
            n_valid=n_valid if t > 1 else None)
        torch.cuda.synchronize()
        scales = ({} if pool != "int8" else dict(
            k_scale=kp.scale[..., 0], v_scale=vp.scale[..., 0]))
        pools = ((kp.q, vp.q) if pool == "int8" else (kp, vp))
        kw = dict(window=window, softcap=softcap, **scales)
        ref = pd.paged_attend_reference(q, *pools, tables, lens, **kw)
        check(out.shape == q.shape and out.dtype == q.dtype,
              f"kernel output {out.shape} {out.dtype}")
        check(bool(torch.isfinite(out.float()).all()),
              "non-finite kernel output")
        err = (out.float() - ref.float()).abs().max().item()
        plan = pd._plan(t, hq // hkv, d, q.dtype, pools[0].dtype, m)
        parts = pd.split_partials(q, *pools, tables, lens, **kw)
        perr = partials_err(torch, parts, pd.split_partials_reference(
            q.float() if plan.body == "split" else q, *pools, tables,
            lens, pages_per_split=plan.pages_per_split, **kw))
        # the combine in fp32 out: a bf16 out would differ by an ulp
        # wherever ~1e-7 of reordering crosses a rounding edge
        comb = pd.combine_partials(
            *parts, lens, page=page, table_pages=m,
            pages_per_split=plan.pages_per_split, window=window)
        comb_ref = pd.combine_partials_reference(*parts)
        comb_err = (comb - comb_ref).abs().max().item()
        # the call is the body and the combine, rounded once to q's
        # dtype
        out_ulps = (bf16_ulps(torch, out, comb_ref) if pool != "fp32"
                    else None)
        ok = dict(
            call=err <= TOL[pool],
            m=perr["m_abs"] <= PART_M_ABS,
            l=perr["l_rel"] <= PART_L_REL,
            acc=perr["acc_abs"] <= TOL[pool]
            and perr["acc_rel_l2"] <= PART_ACC_REL_L2[plan.body],
            combine=comb_err <= TOL["fp32"],
            out=out_ulps is None or out_ulps <= OUT_BF16_ULPS)
        log(phase="kernels", kernel="paged_attend", body=plan.body,
            T=t, heads=[hq, hkv], head_dim=d, page=page, pool=pool,
            window=window,
            softcap=softcap, max_abs_err=err, bound=TOL[pool],
            partials=perr, combine_err=comb_err, out_ulps=out_ulps,
            ok=all(ok.values()))
        check(all(ok.values()),
              f"paged_attend T={t} heads {hq}/{hkv} D {d} page {page} "
              f"{pool} "
              f"window={window} softcap={softcap}: error {err} (bound "
              f"{TOL[pool]}), partials {perr}, combine {comb_err}, "
              f"{out_ulps} ulps; failed: "
              f"{[k for k, v in ok.items() if not v]}")
        worst["call"] = max(worst["call"], err)
        worst[plan.body] = max(worst[plan.body], perr["acc_abs"])
        worst["combine"] = max(worst["combine"], comb_err)
        for k, v in dict(perr, out_ulps=out_ulps or 0.0).items():
            if k in tight[plan.body]:
                tight[plan.body][k] = max(tight[plan.body][k], v)
        n_cases += 1
        del q, kn, vn, kp, vp, tables, lens, out, ref, parts, comb
        del comb_ref

    # gpt-neox-20b's head_dim 96 (its 64 heads: a group of 1) and a GQA
    # group of 4 at D 96, both bodies, on pages of 16 and 128 positions,
    # and pages of 1 and 24 on the split-context body
    d96 = [(t, hq, hkv, w, c, page,
            ("fp32", "bf16", "int8") if t == 1 else ("bf16", "int8"))
           for page in (16, 128)
           for t, hq, hkv in ((1, *NEOX20B_HEADS), (256, *NEOX20B_HEADS),
                              (5, 8, 2), (64, 8, 2))
           for w, c in ((None, None), (1024, 50.0))]
    d96 += [(t, 8, 2, None, None, page, ("bf16", "int8"))
            for page in (1, 24) for t in (1, 16)]
    for t, hq, hkv, window, softcap in cases:
        for pool in ("fp32", "bf16", "int8"):
            k4_case(t, hq, hkv, window, softcap, pool, PAGE, D)
    for t, hq, hkv, window, softcap, page, pools in d96:
        for pool in pools:
            k4_case(t, hq, hkv, window, softcap, pool, page, D96)
    # the plan reads no batch: each row of an S = 8 call equals the same
    # slot's row in an S = 1 call, bit for bit, through both bodies
    m = MAX_CTX // PAGE + 16
    for t, pool, d, hq, hkv in (
            (1, "bf16", D, HQ, HKV), (1, "int8", D, HQ, HKV),
            (1, "fp32", D, HQ, HKV), (64, "bf16", D, HQ, HKV),
            (256, "int8", D, HQ, HKV), (1, "bf16", D96, *NEOX20B_HEADS),
            (256, "bf16", D96, *NEOX20B_HEADS)):
        q, _, _, kp, vp, tables, lens = paged_case(
            torch, gen, t=t, pool=pool, lengths=[MAX_CTX - t, 0, 17, 255,
                                                 257, 511, 513, 2000],
            m=m, hq=hq, hkv=hkv, d=d)
        pools, kw = (kp, vp), {}
        if pool == "int8":
            pools = (kp.q, vp.q)
            kw = dict(k_scale=kp.scale[..., 0], v_scale=vp.scale[..., 0])
        batched = pd.paged_flash_attend(q, *pools, tables, lens, **kw)
        same = all(torch.equal(batched[i], pd.paged_flash_attend(
            q[i:i + 1], *pools, tables[i:i + 1], lens[i:i + 1], **kw)[0])
            for i in range(S))
        log(phase="kernels", check="rows bitwise equal, S = 8 vs S = 1",
            T=t, pool=pool, head_dim=d, ok=same)
        check(same, f"T={t} {pool}: a row differs between S = 8 and S = 1")
    worst["verify_rows"] = verify_rows_check(torch, pd, kv, gen, m)
    (pd.LAUNCHES, pd.SPLIT_LAUNCHES, pd.MMA_LAUNCHES,
     pd.COMBINE_LAUNCHES) = counts    # checking launches are not main path
    torch.cuda.empty_cache()
    log(phase="kernels", cases=n_cases, max_abs_err=worst, worst=tight)
    return worst


SPEC_KS = (4, 7, 15)        # speculation depths: verify tiles T = k + 1


def verify_rows_check(torch, pd, kv, gen, m: int) -> dict:
    """Row j of a T = k + 1 call (a speculative verify: the k + 1 new
    tokens written at lengths .. lengths + k, then attended) against a
    T = 1 call at ``lengths + j`` on the same pages, which hold the k/v
    of every row before j: bitwise equal or not, and the max abs error,
    for each k of ``SPEC_KS``, both models' heads and every pool dtype.
    Logged, not gated: the two calls may run different bodies (``_plan``
    folds T x groups rows). Returns, per case, the bodies, bitwise and
    the error."""
    out = {}
    for hq, hkv in ((HQ, HKV), QWEN3_HEADS):
        for k in SPEC_KS:
            t = k + 1
            for pool in ("bf16", "int8", "fp32"):
                q, kn, vn, kp, vp, tables, lens = paged_case(
                    torch, gen, t=t, pool=pool,
                    lengths=[MAX_CTX - t, 0, 17, 255, 257, 511, 513, 2000],
                    m=m, hq=hq, hkv=hkv)
                verify, (kp, vp) = kv.paged_attend(
                    q, kn, vn, kp, vp, tables, lens, impl="flash")
                pools, kw = (kp, vp), {}
                if pool == "int8":
                    pools = (kp.q, vp.q)
                    kw = dict(k_scale=kp.scale[..., 0],
                              v_scale=vp.scale[..., 0])
                single = torch.cat([pd.paged_flash_attend(
                    q[:, j:j + 1].contiguous(), *pools, tables, lens + j,
                    **kw) for j in range(t)], dim=1)
                torch.cuda.synchronize()
                bodies = [pd._plan(n, hq // hkv, D, q.dtype, pools[0].dtype,
                                   m).body for n in (t, 1)]
                row = {"bodies_T_k1_T_1": bodies,
                       "bitwise": bool(torch.equal(verify, single)),
                       "max_abs_err": (verify.float() - single.float()
                                       ).abs().max().item()}
                out[f"{hq}/{hkv} k{k} {pool}"] = row
                log(phase="kernels", check="verify rows T = k + 1 vs T = 1",
                    heads=[hq, hkv], k=k, pool=pool, **row)
                del q, kn, vn, kp, vp, tables, lens, verify, single
    return out


# ---------------------------------------------------------------------------
# phase 4: timing beside the bound
# ---------------------------------------------------------------------------

def attend_bound(q, hkv, lengths, t, itemsize, extra_bytes=0):
    """(bound_ms, bound_by, bytes, flops) from this call's inputs: each
    live page read once (k and v), q read and out written once (plus
    ``extra_bytes``, a body's partials); 4 * D operations per (query row,
    key) pair inside the causal band."""
    s = len(lengths)
    hq, d = q.shape[2], q.shape[3]
    pages = sum((n + t - 1) // PAGE + 1 for n in lengths)
    nbytes = (pages * PAGE * hkv * d * itemsize * 2
              + 2 * q.numel() * q.element_size() + s * 4 + extra_bytes)
    pairs = sum(n * t + t * (t + 1) // 2 for n in lengths)
    flops = 4 * d * hq * pairs
    return _bound(nbytes, flops, str(q.dtype).replace("torch.", ""))


def _live_splits(lengths, t, pages_per_split) -> int:
    """(slot, split) pairs a body writes partials for: the splits up to
    the one holding each slot's newest row."""
    return sum((n + t - 1) // PAGE // pages_per_split + 1 for n in lengths)


def _device_us(event) -> float:
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def _kernel_ms(torch, fn, iters: int) -> dict:
    """kernel name -> mean device milliseconds per call of ``fn``, from
    torch.profiler over ``iters`` calls after a warm-up. Each kernel's time
    is its mean per recorded launch times its launches per call (its
    recorded count over ``iters``, rounded), since a profile can miss a few
    launches' records; a kernel whose count is not a whole multiple of
    ``iters`` is logged. A profile that recorded no device time at all
    (its records can all go missing) is taken again, up to three times;
    after that the result is empty and ``device_ms`` times by CUDA
    events instead."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if _device_us(e) > 0 and e.count > 0]
        if events:
            break
        log(phase="profiler", attempt=attempt + 1,
            note="no device time recorded: profiling again")
    out = {}
    for e in events:
        per_call = max(1, round(e.count / iters))
        if e.count != per_call * iters:
            log(phase="profiler", kernel=e.key[:60], events=e.count,
                iters=iters, note="launch records missing or extra: the "
                "time is the mean per recorded launch")
        out[e.key] = _device_us(e) / e.count * per_call / 1e3
    return out


def queued_ms(torch, fn, iters: int) -> float:
    """Mean device milliseconds per call of ``fn`` with no host time in
    it: the calls are queued behind a device-side sleep longer than the
    host takes to issue them, then timed by CUDA events as they run back
    to back. Phases 6 and 10 time kernels and library calls (SDPA's
    backward, ``torch._grouped_mm``: several kernels a call) alike this
    way; torch.profiler can miss launch records."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # cycles at 2 GHz: 8x the issue time plus 10 ms, as the host's second
    # pass can issue slower than its first (a tiny kernel's queue is short)
    torch.cuda._sleep(int(8 * issue_s * 2e9) + 20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    check(start.query() is False, "queued_ms: the device caught up with "
          "the host before the last call was issued")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int, names, parts=None) -> dict:
    """Mean device milliseconds per call of ``fn`` spent in the kernels
    whose name holds each of ``names`` (``_kernel_ms``). A call that is
    host-bound (a ctypes wrapper around a few-microsecond kernel) reads its
    kernels' own time here, where CUDA events around back-to-back calls
    would read the host's. Where the profiler records no device time at
    all, each name is timed by ``queued_ms`` instead: the whole call for a
    single name, or ``parts[name]``, a call that launches that kernel
    alone. The result's "timed_by" says which: "profiler" or
    "cuda_events"."""
    per_kernel = _kernel_ms(torch, fn, iters)
    if not per_kernel:
        log(phase="profiler", names=list(names), note="no device time "
            "recorded in three profiles: timed by CUDA events (queued_ms)")
        check(len(names) == 1 or parts is not None,
              f"the profiler reports no device time for {names}")
        return {**{n: queued_ms(torch, fn if parts is None else parts[n],
                                iters) for n in names},
                "timed_by": "cuda_events"}
    out = {n: sum(ms for key, ms in per_kernel.items() if n in key)
           for n in names}
    check(all(v > 0 for v in out.values()),
          f"the profiler reports no device time for {names}")
    return {**out, "timed_by": "profiler"}


def profiler_ms(torch, fn, iters: int, name: str):
    """torch.profiler's device milliseconds per call of ``fn`` in the
    kernels named ``name``, or None where the profiler recorded no device
    time: ``device_ms`` would then time the whole call by CUDA events,
    which the callers already log as "ms"."""
    dm = device_ms(torch, fn, iters, [name])
    return dm[name] if dm["timed_by"] == "profiler" else None


def k4_parts(torch, pd, plan, body, q, kp, vp, tables, lens, **kw) -> dict:
    """K4's two kernels launched alone, for ``device_ms``'s CUDA-event
    fallback: the body (``split_partials``, which also fills its scratch
    with the neutral partials) and the combine over its partials."""
    parts = pd.split_partials(q, kp, vp, tables, lens, **kw)
    window = kw.get("window")
    return {body: lambda: pd.split_partials(q, kp, vp, tables, lens, **kw),
            "paged_attend_combine": lambda: pd.combine_partials(
                *parts, lens, page=kp.shape[1], table_pages=tables.shape[1],
                pages_per_split=plan.pages_per_split, window=window)}


def phase_timing(torch) -> dict:
    """K4 at the serve shapes: each kernel's device time in the whole call
    (body + combine, as the serve path runs it; torch.profiler), the
    call's time with its host wrapper (CUDA events), the plain versions
    and SDPA, each beside its bound."""
    import torch.nn.functional as F

    from distributed_training_guide_tpu_torch.ops import paged_decode as pd

    out = {}
    dev = torch.device("cuda")
    counts = (pd.LAUNCHES, pd.SPLIT_LAUNCHES, pd.MMA_LAUNCHES,
              pd.COMBINE_LAUNCHES)
    for name, s, t, (hq, hkv), ctx, d in (
            ("decode", S, 1, (HQ, HKV), MAX_CTX, D),
            ("chunk", 1, 256, (HQ, HKV), MAX_CTX, D),
            # the speculative verify at k 4 (T 5: 8 rows a block at a
            # group of 4, where decode runs 4)
            ("verify", S, SPEC_K + 1, (HQ, HKV), MAX_CTX, D),
            ("decode-qwen3", S, 1, QWEN3_HEADS, MAX_CTX, D),
            ("decode-1k", S, 1, (HQ, HKV), 1024, D),
            # gpt-neox-20b (64 heads of 96, its 2048-token context)
            ("decode-neox20b", S, 1, NEOX20B_HEADS, 2048, D96),
            ("chunk-neox20b", 1, 256, NEOX20B_HEADS, 2048, D96)):
        lengths = [ctx - t] * s
        m = MAX_CTX // PAGE
        n_pages = s * m + 1
        tables = (torch.arange(s * m, dtype=torch.int32, device=dev)
                  .reshape(s, m) + 1)
        tables = tables[:, torch.randperm(m, device=dev)].contiguous()
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        kp = torch.randn(n_pages, PAGE, hkv, d, device=dev,
                         dtype=torch.bfloat16)
        vp = torch.randn_like(kp)
        q = torch.randn(s, t, hq, d, device=dev, dtype=torch.bfloat16)
        plan = pd._plan(t, hq // hkv, d, q.dtype, kp.dtype, m)
        body = f"paged_attend_{plan.body}"
        dev_ms = device_ms(torch, lambda: pd.paged_flash_attend(
            q, kp, vp, tables, lens), 50, (body, "paged_attend_combine"),
            parts=k4_parts(torch, pd, plan, body, q, kp, vp, tables, lens))
        body_ms, combine_ms = dev_ms[body], dev_ms["paged_attend_combine"]
        ms = body_ms + combine_ms
        call_ms = cuda_ms(lambda: pd.paged_flash_attend(
            q, kp, vp, tables, lens), iters=100)
        plain_ms = cuda_ms(lambda: pd.paged_attend_reference(
            q, kp, vp, tables, lens), iters=10, warmup=2)
        body_plain_ms = cuda_ms(lambda: pd.split_partials_reference(
            q, kp, vp, tables, lens, pages_per_split=plan.pages_per_split),
            iters=5, warmup=1)
        parts = pd.split_partials(q, kp, vp, tables, lens)
        combine_plain_ms = cuda_ms(lambda: pd.combine_partials_reference(
            *parts), iters=10, warmup=2)
        # the library yardstick: SDPA over an already contiguous cache of
        # the same live length, bottom-right causal for the chunk
        kc = kp[tables.long()].reshape(s, m * PAGE, hkv, d)[:, :ctx]
        vc = vp[tables.long()].reshape(s, m * PAGE, hkv, d)[:, :ctx]
        kc, vc = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
        qc = q.transpose(1, 2).contiguous()
        mask = None
        if t > 1:
            qpos = torch.arange(t, device=dev)[:, None] + (ctx - t)
            mask = torch.arange(ctx, device=dev)[None, :] <= qpos
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qc, kc, vc, attn_mask=mask, enable_gqa=True), iters=50)
        bound = attend_bound(q, hkv, lengths, t, 2)
        # a body writes m, l and acc (fp32) for each live (slot, split)
        # pair of each row; the combine reads them and writes out
        part_bytes = (_live_splits(lengths, t, plan.pages_per_split)
                      * t * hq * (d + 2) * 4)
        body_bound = attend_bound(q, hkv, lengths, t, 2, part_bytes)
        body_bound["bytes"] -= q.numel() * q.element_size()  # writes no out
        body_bound = _bound(body_bound["bytes"], body_bound["flops"],
                            "bfloat16")
        combine_bound = _bound(part_bytes + q.numel() * q.element_size()
                               + s * 4, 0, "float32")
        out[name] = dict(
            S=s, T=t, heads=[hq, hkv], head_dim=d, context=ctx, dtype="bf16",
            plan=plan._asdict(), ms=ms, call_ms=call_ms, plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=bound["bound_ms"],
            bound_by=bound["bound_by"], bytes=bound["bytes"],
            flops=bound["flops"], share_of_bound=bound["bound_ms"] / ms,
            body_ms=body_ms, body_plain_ms=body_plain_ms,
            body_bound_ms=body_bound["bound_ms"],
            body_bound_by=body_bound["bound_by"],
            combine_ms=combine_ms, combine_plain_ms=combine_plain_ms,
            combine_bound_ms=combine_bound["bound_ms"],
            timed_by=dev_ms["timed_by"])
        log(phase="timing", shape=name, **out[name])
        del kp, vp, kc, vc, q, qc, parts
        torch.cuda.empty_cache()
    (pd.LAUNCHES, pd.SPLIT_LAUNCHES, pd.MMA_LAUNCHES,
     pd.COMBINE_LAUNCHES) = counts   # timing launches are not main path
    return out


# ---------------------------------------------------------------------------
# phase 7: serving llama-3.1-8b
# ---------------------------------------------------------------------------

def phase_serve(torch, card: str) -> dict:
    import numpy as np

    from distributed_training_guide_tpu_torch.models import get_model, llama
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa
    from distributed_training_guide_tpu_torch.ops import paged_decode as pd
    from distributed_training_guide_tpu_torch.serve import (
        Request, ServeEngine, generate_many, throughput_stats)

    class RecordingEngine(ServeEngine):
        """Keeps each request's first-token logits (what the last prefill
        forward produced) for the check against the plain prefill."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.first_logits = {}

        def _on_prefill_complete(self, adm, logit):
            self.first_logits[adm.request.request_id] = logit.float()
            return super()._on_prefill_complete(adm, logit)

    t0 = time.perf_counter()
    bundle = get_model("llama-3.1-8b", dtype=torch.bfloat16,
                       param_dtype=torch.bfloat16)
    params = bundle.init(bundle.config, SEED, device="cuda")
    torch.cuda.synchronize()
    log(phase="serve", model="llama-3.1-8b", params=bundle.num_params(),
        layers=bundle.config.num_layers, dtype="bf16",
        init_s=time.perf_counter() - t0)
    vocab = bundle.config.vocab_size
    rng = np.random.default_rng(SEED)
    lens = [17, 2000] + [int(x) for x in rng.integers(17, 2001, 6)]
    specs = [dict(prompt_ids=[int(x) for x in rng.integers(0, vocab, n)],
                  max_new_tokens=32, seed=i,
                  **({"temperature": 0.8, "top_p": 0.9} if i >= 6 else {}))
             for i, n in enumerate(lens)]
    common = dict(n_slots=8, page_size=16, max_len=4096)
    results = {}
    (pd.LAUNCHES, pd.SPLIT_LAUNCHES, pd.MMA_LAUNCHES,
     pd.COMBINE_LAUNCHES) = (0, 0, 0, 0)      # the main path starts here
    reset_moe_counts()
    copies = fa.ALIGN_COPIES
    for mode, chunk in (("bucketed", None), ("chunked", 256)):
        eng = RecordingEngine(bundle, params, prefill_chunk=chunk, **common)
        torch.cuda.reset_peak_memory_stats()
        before = pd.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = generate_many(eng, [Request(**r) for r in specs])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = pd.LAUNCHES - before
        for r in res:
            check(r.finish_reason == "length" and len(r.generated_ids) == 32,
                  f"{mode}: request {r.request_id} ended "
                  f"{r.finish_reason} after {len(r.generated_ids)} tokens")
            check(all(0 <= x < vocab for x in r.generated_ids),
                  f"{mode}: token id out of range")
        decode_launches = bundle.config.num_layers * eng.decode_steps
        prefill_launches = launches - decode_launches
        check(launches > 0 and eng.decode_steps > 0,
              f"{mode}: the decode program launched no kernel")
        if chunk is None:
            check(prefill_launches == 0, "bucketed prefill must not use "
                  "the paged kernel (it runs the plain causal prefill)")
        else:
            check(prefill_launches == bundle.config.num_layers
                  * eng.programs.prefill_calls and prefill_launches > 0,
                  f"chunked: {prefill_launches} chunk launches for "
                  f"{eng.programs.prefill_calls} chunk forwards")
        stats = throughput_stats(res, wall, eng)
        results[mode] = dict(
            engine=eng, res=res, launches=launches,
            decode_launches=decode_launches,
            prefill_launches=prefill_launches)
        log(phase="serve", mode=mode, card=card, wall_s=wall,
            tokens_per_s=stats["tokens_per_s"],
            ttft_s_p50=stats["ttft_s_p50"],
            latency_s_p50=stats["latency_s_p50"],
            itl_s_avg=eng.stats()["itl_s_avg"],
            decode_steps=eng.decode_steps,
            prefill_forwards=eng.programs.prefill_calls,
            kernel_launches=launches,
            kernel_launches_per_decode_step=(decode_launches
                                             / eng.decode_steps),
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        if mode == "bucketed":
            results[mode]["logits1"] = eng.first_logits[res[1].request_id]
            del eng
            results[mode].pop("engine")
        torch.cuda.empty_cache()
    main_path_launches = pd.LAUNCHES          # ... and ends here
    body_launches = {"split": pd.SPLIT_LAUNCHES, "mma": pd.MMA_LAUNCHES,
                     "combine": pd.COMBINE_LAUNCHES}
    k1 = check_hopper_path("serve", copies)["flash_fwd"]
    log(phase="serve", k4_calls=main_path_launches, k1_launches_by_body=k1,
        **{f"{k}_launches": v for k, v in body_launches.items()})
    for k, v in body_launches.items():
        check(v > 0, f"serve: the main path launched no {k} kernel")

    # one greedy request served alone gives the tokens it got co-batched
    alone = generate_many(ServeEngine(bundle, params, **common),
                          [Request(**specs[0])])[0]
    check(alone.token_ids == results["bucketed"]["res"][0].token_ids,
          "greedy request 0: alone and co-batched tokens differ")
    torch.cuda.empty_cache()

    agree = sum(a.token_ids == b.token_ids
                for a, b in zip(results["bucketed"]["res"],
                                results["chunked"]["res"]))
    log(phase="serve", requests_identical_bucketed_vs_chunked=agree,
        of=len(specs))

    # first-token logits of the 2000-token prompt from the kernel's last
    # chunk (chunked engine) and from the bucketed engine, against the
    # plain full-context prefill of the same prompt
    ids = torch.tensor([specs[1]["prompt_ids"]], device="cuda")
    cache = llama.init_cache(bundle.config, 1, ids.shape[1], device="cuda")
    ref = llama.prefill(bundle.config, params, ids, cache)[0][0].float()
    del cache
    for mode in ("chunked", "bucketed"):
        got = (results["chunked"]["engine"].first_logits[
            results["chunked"]["res"][1].request_id]
            if mode == "chunked" else results["bucketed"]["logits1"])
        check(bool(torch.isfinite(got).all()) and got.shape == (vocab,),
              f"{mode} first-token logits not finite / wrong shape")
        rel = ((got - ref).norm() / ref.norm()).item()
        log(phase="serve", check=f"first-token logits, {mode} vs plain "
            f"prefill, bf16 full depth", prompt_tokens=ids.shape[1],
            rel_l2=rel, bound=LOGIT_REL_L2_BF16,
            max_abs=(got - ref).abs().max().item(),
            argmax_equal=bool(got.argmax() == ref.argmax()))
        check(rel <= LOGIT_REL_L2_BF16, f"{mode} first-token logits rel L2 "
              f"{rel} > {LOGIT_REL_L2_BF16}")
    del results, ref
    torch.cuda.empty_cache()
    log(phase="serve", profile="decode step, bucketed engine, 8 slots",
        card=card, **profile_decode(torch, bundle, params, specs))
    del params
    torch.cuda.empty_cache()
    check_fp32_chunk_path(torch, specs[1]["prompt_ids"])
    return dict(launches=main_path_launches, body_launches=body_launches,
                per_step=bundle.config.num_layers)


def profile_decode(torch, bundle, params, specs, **engine_kw) -> dict:
    """Device time of steady decode steps, by kernel, from torch.profiler:
    8 slots decoding at prompt lengths of the main run, 4 steps after
    every slot is admitted. Returns per-step device ms, the K4 share, the
    device's idle share of the window (host clock, profiler on), or
    "not measured" when the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_training_guide_tpu_torch.serve import (Request,
                                                            ServeEngine)

    eng = ServeEngine(bundle, params, n_slots=8, page_size=16, max_len=4096,
                      **engine_kw)
    for r in specs:
        eng.submit(Request(**{**r, "max_new_tokens": 16}))
    eng.step()                       # admission + every prefill + 1 decode
    check(len(eng.scheduler.active_indices()) == 8, "profile: 8 decoding")
    eng.step()                       # warm
    steps = 4
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    dev_us = _device_us
    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events) / 1e3
    if busy == 0:
        return {"device_ms_per_step": "not measured"}
    k4 = sum(dev_us(e) for e in events if "paged_attend" in e.key) / 1e3
    k5 = sum(dev_us(e) for e in events if "gmm_" in e.key) / 1e3
    k7 = sum(dev_us(e) for e in events if "qmm_" in e.key) / 1e3
    gemm = sum(dev_us(e) for e in events       # cuBLAS / cuBLASLt GEMMs
               if any(w in e.key.lower() for w in ("gemm", "nvjet", "xmma",
                                                   "cutlass"))) / 1e3
    dtoh = sum(e.count for e in events if "DtoH" in e.key)
    top = sorted(events, key=dev_us, reverse=True)[:6]
    out = {"wall_ms_per_step": wall * 1e3 / steps,
           "device_ms_per_step": busy / steps,
           "paged_attend_ms_per_step": k4 / steps,
           "grouped_matmul_ms_per_step": k5 / steps,
           "quantized_matmul_ms_per_step": k7 / steps,
           "gemm_ms_per_step": gemm / steps,
           "device_to_host_copies_per_step": dtoh / steps,
           "device_idle_share": max(0.0, 1 - busy / (wall * 1e3)),
           "kernels_per_step": sum(e.count for e in events) / steps,
           "top": [(e.key[:60], dev_us(e) / 1e3 / steps) for e in top]}
    del eng
    torch.cuda.empty_cache()
    return out


def check_fp32_chunk_path(torch, prompt) -> None:
    """llama-3.1-8b at full width, cut to 2 layers, in fp32: the chunked
    engine's first-token logits (every chunk through the kernel) against
    the plain full-context prefill. In fp32 only the summation order
    differs, so this carries the correctness claim the bf16 comparison
    cannot make tightly."""
    from distributed_training_guide_tpu_torch.models import get_model, llama
    from distributed_training_guide_tpu_torch.serve import (
        Request, ServeEngine, generate_many)

    bundle = get_model("llama-3.1-8b", dtype=torch.float32,
                       param_dtype=torch.float32, num_layers=2)
    params = bundle.init(bundle.config, SEED + 1, device="cuda")
    logits = {}

    class Recording(ServeEngine):
        def _on_prefill_complete(self, adm, logit):
            logits[adm.request.request_id] = logit.float()
            return super()._on_prefill_complete(adm, logit)

    eng = Recording(bundle, params, n_slots=1, page_size=16, max_len=4096,
                    prefill_chunk=256)
    rid = generate_many(eng, [Request(prompt_ids=prompt,
                                      max_new_tokens=1)])[0].request_id
    ids = torch.tensor([prompt], device="cuda")
    cache = llama.init_cache(bundle.config, 1, ids.shape[1], device="cuda")
    ref = llama.prefill(bundle.config, params, ids, cache)[0][0].float()
    got = logits[rid]
    rel = ((got - ref).norm() / ref.norm()).item()
    log(phase="serve", check="first-token logits, chunked vs plain "
        "prefill, fp32, full width, 2 layers", prompt_tokens=len(prompt),
        rel_l2=rel, bound=LOGIT_REL_L2_FP32,
        max_abs=(got - ref).abs().max().item(),
        argmax_equal=bool(got.argmax() == ref.argmax()))
    check(bool(torch.isfinite(got).all()), "fp32 logits not finite")
    check(rel <= LOGIT_REL_L2_FP32, f"fp32 chunked logits rel L2 {rel} > "
          f"{LOGIT_REL_L2_FP32}")
    del eng, params, cache
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: the flash kernels (K1-K3) against their plain versions
# ---------------------------------------------------------------------------

# fp32 max abs error: the same fp32 arithmetic summed in another order over
# up to 2048 keys (x the GQA group for dk/dv) on O(1)-O(10) values; bf16
# relative L2 per output: the kernels round p (and ds) to bf16 before the
# tensor-core products that follow and the outputs to bf16, where the plain
# version keeps fp32 to the end (ulp 2**-8 relative, about 3e-3 rel L2)
FLASH_TOL_FP32 = {"o": 2e-5, "lse": 2e-5, "dq": 1e-4, "dk": 1e-4,
                  "dv": 1e-4}
FLASH_TOL_BF16_REL_L2 = 1e-2
# the Hopper bodies (bf16, D 64 / 128) against the plain version at their
# own arithmetic (K1 ``round_p``: 64-key tiles, a running max, p rounded to
# bf16 before P V; K2 / K3 ``round_p_ds``: p and ds rounded to bf16 before
# the products): only the fp32 summation order of the scores and products
# and the exp differ (~1e-6 relative), which flips the bf16 rounding of a
# few p / ds elements and outputs by one ulp (2**-8), about 1e-4 in
# relative L2 over a sum of hundreds of terms; 1e-3 leaves 10x room and is
# 10x below the fp32 bound
FLASH_TOL_KERNEL_ARITH_REL_L2 = 1e-3
# (name, B, Sq, Sk, Hq, Hkv, D, dtype, causal, window, softcap, scale, band
# offsets): llama-3.2-1b (the training path's shape first), llama-3.1-8b,
# head_dim 256 with Gemma-2's scale and cap, ragged lengths, qwen3-30b-a3b
# (the moe-train path's attention)
FLASH_CASES = [
    ("1b-main", 4, 2048, 2048, 32, 8, 64, "bf16", True, None, None, None,
     None),
    ("1b", 1, 2048, 2048, 32, 8, 64, "fp32", True, None, None, None, None),
    ("1b-window", 1, 2048, 2048, 32, 8, 64, "fp32", True, 1024, None, None,
     None),
    ("1b-softcap", 1, 2048, 2048, 32, 8, 64, "bf16", True, None, 50.0, None,
     None),
    ("1b-noncausal", 1, 2048, 2048, 32, 8, 64, "fp32", False, None, None,
     None, None),
    ("8b", 1, 2048, 2048, 32, 8, 128, "fp32", True, None, None, None, None),
    ("8b-bf16", 2, 2048, 2048, 32, 8, 128, "bf16", True, None, None, None,
     None),
    ("8b-band", 1, 2048, 2048, 32, 8, 128, "fp32", True, 1024, None, None,
     (512, 0)),
    ("8b-window-softcap", 1, 2048, 2048, 32, 8, 128, "bf16", True, 1024,
     50.0, None, None),
    ("d256", 1, 1024, 1024, 8, 4, 256, "fp32", True, None, 50.0,
     256 ** -0.5, None),
    ("d256-window", 1, 1024, 1024, 8, 4, 256, "bf16", True, 512, None, None,
     None),
    ("ragged", 1, 1000, 1000, 32, 8, 64, "fp32", True, None, None, None,
     None),
    ("ragged-cross", 2, 777, 1000, 16, 4, 128, "bf16", False, None, None,
     None, None),
    ("qwen3-moe", 2, 2048, 2048, 32, 4, 128, "bf16", True, None, None, None,
     None),
    ("ragged-bf16", 2, 1000, 1000, 32, 8, 64, "bf16", True, None, None, None,
     None),
    ("ragged-off16", 2, 1000, 1000, 32, 4, 128, "bf16", True, None, None,
     None, None),
    # the bf16 bodies at the calls the ring makes (phase 20): llama-3.2-1b's
    # past chunk pairs (non-causal), llama-3.1-8b's chunk pair whose keys
    # lie partly below the 4096 band (global offsets on the band), and
    # gemma2-2b's cp-4 chunk pair at S 16384 (chunks 5 and 3: WMMA, scale
    # 1/16, softcap 50), on q as drawn and on q x GEMMA2_Q_CAP_SCALE
    ("ring-past-512", 1, 512, 512, 32, 8, 64, "bf16", False, None, None,
     None, None),
    ("ring-past-2048", 1, 2048, 2048, 32, 8, 64, "bf16", False, None, None,
     None, None),
    ("ring-8b-band", 1, 2048, 2048, 32, 8, 128, "bf16", True, 4096, None,
     None, (6144, 2048)),
    ("ring-gemma2-band", 1, 2048, 2048, 8, 4, 256, "bf16", True, 4096, 50.0,
     1 / 16, (10240, 6144)),
    ("ring-gemma2-band-x12", 1, 2048, 2048, 8, 4, 256, "bf16", True, 4096,
     50.0, 1 / 16, (10240, 6144)),
]
# cases whose q is scaled by GEMMA2_Q_CAP_SCALE (the softcap then bites)
FLASH_Q_CAP_SCALED = ("ring-gemma2-band-x12",)
# the case whose q lies 8 bytes off 16: the Hopper bodies' wrappers copy it
# for their tensor maps (counted in ALIGN_COPIES)
FLASH_OFF16 = "ragged-off16"


def flash_case(torch, gen, b, sq, sk, hq, hkv, d, dtype):
    dt = torch.float32 if dtype == "fp32" else torch.bfloat16

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    return (rand(b, sq, hq, d), rand(b, sk, hkv, d), rand(b, sk, hkv, d),
            rand(b, sq, hq, d))


def off16(torch, x):
    """``x``'s values in a tensor of its shape whose base lies 8 bytes past
    a 16-byte boundary."""
    flat = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
    out = flat[4:].view(x.shape)
    out.copy_(x)
    check(out.data_ptr() % 16 == 8, "off16: base on 16 bytes")
    return out


def check_fwd_arith(torch, fa, name, args, kw, got) -> float:
    """bf16 K1 (the Hopper body) against the plain version at its own
    arithmetic, and a second launch bitwise equal to the first; returns
    the relative L2 error of o."""
    want, _ = fa.flash_attention_reference(*args, **kw, round_p=True)
    again = fa.flash_fwd(*args, **kw)
    torch.cuda.synchronize()
    for key, g, a in zip(("o", "lse"), got, again):
        check(torch.equal(g, a), f"flash {name} {key}: two launches differ")
    err = ((got[0].float() - want.float()).norm() / want.float().norm()).item()
    check(err <= FLASH_TOL_KERNEL_ARITH_REL_L2, f"flash {name} o: {err} from "
          f"the plain version at the kernel's arithmetic > "
          f"{FLASH_TOL_KERNEL_ARITH_REL_L2}")
    return err


def check_kernel_arith(torch, fa, name, args, kw, got) -> dict:
    """bf16 K2 / K3 outputs against the plain version at the kernels' own
    arithmetic, and a second launch of each bitwise equal to the first;
    returns the relative L2 errors."""
    want = (fa.flash_dq_reference(*args, **kw, round_p_ds=True),
            *fa.flash_dkv_reference(*args, **kw, round_p_ds=True))
    again = (fa.flash_bwd_dq(*args, **kw), *fa.flash_bwd_dkv(*args, **kw))
    torch.cuda.synchronize()
    errs = {}
    for key, g, w, a in zip(("dq", "dk", "dv"), got, want, again):
        check(torch.equal(g, a), f"flash {name} {key}: two launches differ")
        errs[key] = ((g.float() - w.float()).norm() / w.float().norm()).item()
        check(errs[key] <= FLASH_TOL_KERNEL_ARITH_REL_L2,
              f"flash {name} {key}: {errs[key]} from the plain version at "
              f"the kernel's arithmetic > {FLASH_TOL_KERNEL_ARITH_REL_L2}")
    return errs


def phase_flash(torch) -> dict:
    """Each case through K1, then K2 and K3 from the plain forward's lse
    and delta; returns the worst fp32 max abs error per kernel and, under
    "kernel_arith", the Hopper bodies' worst bf16 relative L2 error against
    the plain version at their own arithmetic. Every K1 launch runs the
    body that ``_fwd_plan`` names, and copies an operand for its tensor
    maps only in the case off 16 bytes."""
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0}
    arith = {"flash_fwd": 0.0, "flash_dq": 0.0,   # bf16, rel L2
             "flash_dkv": 0.0}
    counts = (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    for (name, b, sq, sk, hq, hkv, d, dtype, causal, window, softcap, scale,
         offs) in FLASH_CASES:
        q, k, v, do = flash_case(torch, gen, b, sq, sk, hq, hkv, d, dtype)
        if name == FLASH_OFF16:
            q = off16(torch, q)
        q_scale = GEMMA2_Q_CAP_SCALE if name in FLASH_Q_CAP_SCALED else 1.0
        if q_scale != 1.0:
            q = (q.float() * q_scale).to(q.dtype)
        kw = dict(causal=causal, softcap=softcap, scale=scale)
        if offs is None:
            kw["window"] = window
        else:
            kw["band"] = fa.pack_band(window, *offs)
        before = (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
        fwd_plan = fa._fwd_plan(d, q.dtype)
        bodies, copies = dict(fa.FWD_BODY_LAUNCHES), fa.ALIGN_COPIES
        o, lse = fa.flash_fwd(q, k, v, **kw)
        check(fa.FWD_BODY_LAUNCHES[fwd_plan] == bodies[fwd_plan] + 1,
              f"{name}: K1 did not run the {fwd_plan} body")
        want_copies = int(name == FLASH_OFF16)
        check(fa.ALIGN_COPIES - copies == want_copies, f"{name}: K1 copied "
              f"{fa.ALIGN_COPIES - copies} operands, want {want_copies}")
        ro, rlse = fa.flash_attention_reference(q, k, v, **kw)
        delta = torch.einsum("bshd,bshd->bhs", do.float(),
                             ro.float()).contiguous()
        dq = fa.flash_bwd_dq(q, k, v, do, rlse, delta, **kw)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, rlse, delta, **kw)
        torch.cuda.synchronize()
        check((fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
              == tuple(x + 1 for x in before), f"{name}: a kernel did not "
              f"launch")
        fwd_arith = (check_fwd_arith(torch, fa, name, (q, k, v), kw, (o, lse))
                     if fwd_plan == "wgmma" else None)
        if fwd_arith is not None:
            arith["flash_fwd"] = max(arith["flash_fwd"], fwd_arith)
        rdq = fa.flash_dq_reference(q, k, v, do, rlse, delta, **kw)
        rdk, rdv = fa.flash_dkv_reference(q, k, v, do, rlse, delta, **kw)
        if dtype == "bf16":
            tight = check_kernel_arith(torch, fa, name, (q, k, v, do, rlse,
                                                         delta), kw,
                                       (dq, dk, dv))
            arith["flash_dq"] = max(arith["flash_dq"], tight["dq"])
            arith["flash_dkv"] = max(arith["flash_dkv"], tight["dk"],
                                     tight["dv"])
        pairs = {"o": (o, ro), "lse": (lse, rlse), "dq": (dq, rdq),
                 "dk": (dk, rdk), "dv": (dv, rdv)}
        errs = {}
        for key, (got, want) in pairs.items():
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"{name} {key}: {got.shape} {got.dtype} vs "
                  f"{want.shape} {want.dtype}")
            check(bool(torch.isfinite(got.float()).all()),
                  f"{name} {key}: non-finite kernel output")
            diff = got.float() - want.float()
            if dtype == "fp32" or key == "lse":
                # lse grows with the scores: q scaled by c scales its bound
                err = diff.abs().max().item()
                bound = FLASH_TOL_FP32[key] * (q_scale if key == "lse"
                                               else 1.0)
            else:
                err = (diff.norm() / want.float().norm()).item()
                bound = FLASH_TOL_BF16_REL_L2
            errs[key] = err
            check(err <= bound, f"flash {name} {key}: error {err} > {bound}")
        log(phase="flash", case=name, B=b, Sq=sq, Sk=sk, Hq=hq, Hkv=hkv,
            D=d, dtype=dtype, causal=causal, window=window, softcap=softcap,
            band_offsets=offs, q_scale=q_scale, fwd_body=fwd_plan,
            body=fa._bwd_plan(d, q.dtype), q_base_off16=name == FLASH_OFF16,
            metric="max_abs" if dtype == "fp32" else "rel_l2 (lse max_abs)",
            **errs, **({"kernel_arith_rel_l2": {"o": fwd_arith, **tight},
                        "bitwise_repeat": True}
                       if dtype == "bf16" else {}))
        if dtype == "fp32":
            worst["flash_fwd"] = max(worst["flash_fwd"], errs["o"],
                                     errs["lse"])
            worst["flash_dq"] = max(worst["flash_dq"], errs["dq"])
            worst["flash_dkv"] = max(worst["flash_dkv"], errs["dk"],
                                     errs["dv"])
        del q, k, v, do, o, lse, ro, rlse, delta, dq, dk, dv, rdq, rdk, rdv
        torch.cuda.empty_cache()
    # checking launches are not main-path launches
    fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES = counts
    log(phase="flash", cases=len(FLASH_CASES), worst_fp32_max_abs=worst,
        worst_bf16_kernel_arith_rel_l2=arith)
    return {**worst, "kernel_arith": arith}


# ---------------------------------------------------------------------------
# phase 6: flash timing at the training path's shape
# ---------------------------------------------------------------------------

def flash_bounds(b, s, hq, hkv, d, itemsize) -> dict:
    """(bound_ms, bound_by) per kernel from this shape, causal: the live
    (query, key) pairs of the causal band (``pair_bounds``)."""
    return pair_bounds(b, s, s, hq, hkv, d, itemsize,
                       b * hq * s * (s + 1) // 2)


def pair_bounds(b, sq, sk, hq, hkv, d, itemsize, pairs: int) -> dict:
    """(bound_ms, bound_by) per kernel for ``pairs`` live (query, key)
    pairs: 2 * D operations per product per live pair (K1 two products,
    K2 three, K3 four); each input read and output written once (lse /
    delta fp32)."""
    q_bytes = b * sq * hq * d * itemsize
    kv_bytes = b * sk * hkv * d * itemsize
    stat = b * hq * sq * 4
    work = {"flash_fwd": (4 * d * pairs, 2 * q_bytes + 2 * kv_bytes + stat),
            "flash_dq": (6 * d * pairs,
                         3 * q_bytes + 2 * kv_bytes + 2 * stat),
            "flash_dkv": (8 * d * pairs,
                          2 * q_bytes + 4 * kv_bytes + 2 * stat)}
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = dict(bound_ms=max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes
                         else "bytes", flops=flops, bytes=nbytes)
    return out


# (B, S, Hq, Hkv, D) of the two training paths' attention, bf16, causal
FLASH_TIMING_SHAPES = {"1b-main": (4, 2048, 32, 8, 64),      # llama-3.2-1b
                       "moe-train": (2, 2048, 32, 4, 128)}   # qwen3-30b-a3b


def phase_flash_timing(torch) -> dict:
    """shape -> kernel -> times at each training path's shape: the
    kernels' device time ("ms", by ``queued_ms``, as SDPA's
    "library_ms"; torch.profiler's mean per launch as "profiler_ms", None
    where the profiler recorded nothing),
    CUDA events around back-to-back wrapper calls ("call_ms", SDPA's
    "library_call_ms"), the plain versions, the bound and K3's causal
    tail."""
    return {name: flash_timing_at(torch, *shape)
            for name, shape in FLASH_TIMING_SHAPES.items()}


def flash_timing_at(torch, b, s, hq, hkv, d) -> dict:
    import torch.nn.functional as F

    from distributed_training_guide_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    q, k, v, do = flash_case(torch, gen, b, s, s, hq, hkv, d, "bf16")
    counts = (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v)
    delta = torch.einsum("bshd,bshd->bhs", do.float(), o.float()).contiguous()
    args = (q, k, v, do, lse, delta)
    calls = {"flash_fwd": lambda: fa.flash_fwd(q, k, v),
             "flash_dq": lambda: fa.flash_bwd_dq(*args),
             "flash_dkv": lambda: fa.flash_bwd_dkv(*args)}
    out = {name: {"call_ms": cuda_ms(fn, iters=10),
                  "ms": queued_ms(torch, fn, 10),
                  "profiler_ms": profiler_ms(torch, fn, 10, name)}
           for name, fn in calls.items()}
    fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES = counts
    out["flash_fwd"]["plain_ms"] = cuda_ms(
        lambda: fa.flash_attention_reference(q, k, v), iters=3, warmup=1)
    out["flash_dq"]["plain_ms"] = cuda_ms(
        lambda: fa.flash_dq_reference(*args), iters=3, warmup=1)
    out["flash_dkv"]["plain_ms"] = cuda_ms(
        lambda: fa.flash_dkv_reference(*args), iters=3, warmup=1)
    torch.cuda.empty_cache()
    # the library yardstick: SDPA on [B, H, S, D], forward, and forward +
    # backward minus forward for K2 and K3 together
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    def both():
        return torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

    with torch.no_grad():
        fwd_ms = queued_ms(torch, sdpa, 10)
        fwd_call_ms = cuda_ms(sdpa, iters=10)
    both_ms = queued_ms(torch, both, 10)
    both_call_ms = cuda_ms(both, iters=10)
    out["flash_fwd"]["library_ms"] = fwd_ms
    out["flash_fwd"]["library_call_ms"] = fwd_call_ms
    for name in ("flash_dq", "flash_dkv"):
        out[name]["library_ms"] = both_ms - fwd_ms
        out[name]["library_call_ms"] = both_call_ms - fwd_call_ms
        out[name]["library_note"] = ("SDPA forward+backward minus forward "
                                     "(device time): dq, dk and dv "
                                     "together")
    out["flash_dkv"]["causal_tail"] = k3_tail(
        torch, fa, q, k, v, do, out["flash_dkv"]["ms"])
    fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES = counts
    for name, bound in flash_bounds(b, s, hq, hkv, d, 2).items():
        out[name].update(bound)
        out[name]["share_of_bound"] = bound["bound_ms"] / out[name]["ms"]
        out[name]["body"] = (fa._fwd_plan if name == "flash_fwd"
                             else fa._bwd_plan)(d, q.dtype)
        log(phase="flash_timing", kernel=name, B=b, S=s, Hq=hq, Hkv=hkv, D=d,
            dtype="bf16", causal=True, **out[name])
    del q, k, v, do, o, lse, delta, qt, kt, vt, dot
    torch.cuda.empty_cache()
    return out


def k3_tail(torch, fa, q, k, v, do, causal_ms: float) -> dict:
    """K3's causal tail at this shape (Sq = Sk, a multiple of 64): its
    device time against the sum of its blocks' work, priced at the rate
    of a non-causal launch, where every block does the same work (each
    group head's T = S / 64 q tiles). The causal blocks hold T (T + 1) / 2
    of the non-causal T^2 tiles; ``tail_share`` is the part of the causal
    time beyond that sum. ``heaviest_over_mean_slot`` is the heaviest
    block's tiles over the mean tiles per block slot (2 per SM): above 1,
    one block outlasts the even share of the card."""
    b, s, hq, _ = q.shape
    hkv = k.shape[2]
    tiles = s // 64
    o, lse = fa.flash_fwd(q, k, v, causal=False)
    delta = torch.einsum("bshd,bshd->bhs", do.float(), o.float()).contiguous()
    full_ms = queued_ms(torch, lambda: fa.flash_bwd_dkv(
        q, k, v, do, lse, delta, causal=False), 10)
    even_ms = full_ms * (tiles + 1) / (2 * tiles)
    slots = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    heaviest = (hq // hkv) * tiles
    mean_slot = b * hq * tiles * (tiles + 1) / 2 / slots
    return {"noncausal_ms": full_ms, "even_ms": even_ms,
            "tail_share": 1 - even_ms / causal_ms,
            "heaviest_over_mean_slot": heaviest / mean_slot}


# ---------------------------------------------------------------------------
# phase 8: chapter 01's training loop on llama-3.2-1b
# ---------------------------------------------------------------------------

TRAIN_STEPS = 8
REMAT_STEPS = 2
TRAIN_ARGS = ["-m", "llama-3.2-1b", "-d", "synthetic:400000", "-s", "2048",
              "-b", "4", "--lr", "3e-4", "--seed", str(SEED)]
# one fp32 step through the kernels against one through the einsum
# attention, from the same params and batch: only the summation order
# differs (2 layers, full width)
TRAIN_FP32_REL = 1e-4
# the bf16 loss at full depth, kernels against the einsum attention:
# bf16 rounds at other places on the two paths, through 16 layers
TRAIN_BF16_LOSS_REL = 1e-2


def flash_counts():
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa

    return {"flash_fwd": fa.FWD_LAUNCHES, "flash_dq": fa.DQ_LAUNCHES,
            "flash_dkv": fa.DKV_LAUNCHES}


def reset_flash_counts() -> None:
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa

    fa.FWD_LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0
    fa.FWD_BODY_LAUNCHES.update({k: 0 for k in fa.FWD_BODY_LAUNCHES})


def check_hopper_path(where: str, copies: int) -> dict:
    """Every K1 launch since the counts were last reset ran the Hopper body
    and no operand was copied for a tensor map since ``copies`` was read;
    no K5 launch ran the WMMA body (bf16 forwards run the Hopper body,
    fp32-dy d_lhs the split body, fp32 operands the FMA body).
    Returns the launches by body."""
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa
    from distributed_training_guide_tpu_torch.ops import grouped_matmul as gm

    fwd, gmm = dict(fa.FWD_BODY_LAUNCHES), dict(gm.GMM_BODY_LAUNCHES)
    check(fwd["wgmma"] == fa.FWD_LAUNCHES, f"{where}: K1 launches by body "
          f"{fwd}, {fa.FWD_LAUNCHES} in all: not all the Hopper body")
    check(fa.ALIGN_COPIES == copies, f"{where}: {fa.ALIGN_COPIES - copies} "
          f"operands copied for the TMA bodies' 16-byte rule")
    check(gmm["wmma"] == 0 and sum(gmm.values()) == gm.GMM_LAUNCHES,
          f"{where}: K5 launches by body {gmm}, {gm.GMM_LAUNCHES} in all")
    return {"flash_fwd": fwd, "grouped_matmul": gmm}


def phase_train(torch, card: str) -> dict:
    from distributed_training_guide_tpu_torch.train import cli

    layers = 16
    args = cli.get_parser().parse_args(
        TRAIN_ARGS + ["--max-steps", str(TRAIN_STEPS), "--log-freq", "2"])
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa

    reset_moe_counts()                        # the main path starts here
    copies = fa.ALIGN_COPIES
    t0 = time.perf_counter()
    out = cli.run_training(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_counts()                 # ... and ends here
    bodies = check_hopper_path("train", copies)
    want = layers * TRAIN_STEPS
    check(launches == {k: want for k in launches},
          f"train: launches {launches}, want {want} of each "
          f"({layers} per step)")
    infos = out["infos"]
    losses = [i["running_loss"] for i in infos]
    check(len(infos) == TRAIN_STEPS // 2 and all(
        map(math.isfinite, losses)), f"train: losses {losses}")
    check(losses[-1] < losses[0], f"train: loss did not fall: {losses}")
    for info in infos:
        log(phase="train", model="llama-3.2-1b", card=card,
            **{k: info[k] for k in ("global_step", "running_loss",
                                    "grad_norm", "tokens_per_s", "mfu",
                                    "time/step", "time/data",
                                    "peak_alloc_gb")})
    log(phase="train", steps=TRAIN_STEPS, wall_s=wall,
        launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
        k1_launches_by_body=bodies["flash_fwd"], alignment_copies=0,
        batch=4, seq=2048, layers=layers)
    state = out["state"]
    from distributed_training_guide_tpu_torch.models import get_model

    profile = profile_train_step(torch, state, get_model("llama-3.2-1b"), 4,
                                 2048)
    log(phase="train", profile="one step, llama-3.2-1b, B 4, S 2048",
        card=card, **profile)
    check_bf16_loss(torch, state.params)
    del out, state
    torch.cuda.empty_cache()

    args = cli.get_parser().parse_args(
        TRAIN_ARGS + ["--max-steps", str(REMAT_STEPS), "--log-freq", "1",
                      "--checkpoint-activations"])
    reset_flash_counts()
    copies = fa.ALIGN_COPIES
    remat = cli.run_training(args)
    remat_counts = flash_counts()
    check_hopper_path("remat", copies)
    want_remat = {"flash_fwd": 2 * layers * REMAT_STEPS,
                  "flash_dq": layers * REMAT_STEPS,
                  "flash_dkv": layers * REMAT_STEPS}
    check(remat_counts == want_remat, f"remat: launches {remat_counts}, "
          f"want {want_remat}")
    log(phase="train", remat="all", steps=REMAT_STEPS, launches=remat_counts,
        losses=[i["running_loss"] for i in remat["infos"]],
        peak_alloc_gb=remat["last_info"]["peak_alloc_gb"],
        tokens_per_s=remat["last_info"]["tokens_per_s"])
    del remat
    torch.cuda.empty_cache()
    check_fp32_train_step(torch)
    return {"launches": launches, "per_step": layers, "infos": infos,
            "profile": profile}


def _train_batch(torch, vocab: int, b: int, s: int, seed: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(0, vocab, (b, s), generator=gen, device="cuda")
    return {"input_ids": ids, "labels": ids}


def profile_train_step(torch, state, bundle, b: int, s: int) -> dict:
    """Device time of one optimizer step by kernel, from torch.profiler,
    on the trained state: K1-K3, K5 / K6, cuBLAS GEMMs, the device's idle
    share (host clock, profiler on); "not measured" when the profiler
    reports no device time."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_training_guide_tpu_torch.train.optimizer import (
        adamw_cosine)
    from distributed_training_guide_tpu_torch.train.step import Trainer

    trainer = Trainer(bundle=bundle, optimizer=adamw_cosine(3e-4),
                      device="cuda")
    batch = _train_batch(torch, 259, b, s, SEED + 4)
    trainer.step_fn(state, batch)             # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step_fn(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    dev_us = _device_us
    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events) / 1e3
    if busy == 0:
        return {"device_ms_per_step": "not measured", "wall_ms": wall * 1e3}

    def ms_of(*words, exclude=None):
        return sum(dev_us(e) for e in events
                   if any(w in e.key.lower() for w in words)
                   and not (exclude and exclude in e.key.lower())) / 1e3

    top = sorted(events, key=dev_us, reverse=True)[:12]
    return {"wall_ms": wall * 1e3, "device_ms": busy,
            "flash_fwd_ms": ms_of("flash_fwd"),
            "flash_dq_ms": ms_of("flash_dq"),
            "flash_dkv_ms": ms_of("flash_dkv"),
            "grouped_matmul_ms": ms_of("gmm_tc", "gmm_fma", "gmm_hopper",
                                       "gmm_split", exclude="tgmm"),
            "tgmm_ms": ms_of("tgmm_kernel", "tgmm_split"),
            "gemm_ms": ms_of("gemm", "nvjet", "xmma", "cutlass"),
            "device_idle_share": max(0.0, 1 - busy / (wall * 1e3)),
            "kernels": sum(e.count for e in events),
            "top": [(e.key[:60], dev_us(e) / 1e3) for e in top]}


def check_bf16_loss(torch, params) -> None:
    """The full-depth bf16 loss of one batch through the kernels against
    the einsum attention, from the trained params (forward only)."""
    from distributed_training_guide_tpu_torch.models import get_model, llama
    from distributed_training_guide_tpu_torch.ops.cross_entropy import (
        causal_lm_loss)

    cfg = get_model("llama-3.2-1b").config
    batch = _train_batch(torch, 259, 4, 2048, SEED + 5)
    losses = {}
    with torch.no_grad():
        for impl in ("flash", "xla"):
            logits = llama.apply(cfg, params, batch["input_ids"],
                                 attn_impl=impl)
            losses[impl] = causal_lm_loss(logits, batch["labels"]).item()
            del logits
            torch.cuda.empty_cache()
    rel = abs(losses["flash"] - losses["xla"]) / abs(losses["xla"])
    log(phase="train", check="loss, kernels vs einsum attention, bf16, "
        "full depth, trained params", **losses, rel=rel,
        bound=TRAIN_BF16_LOSS_REL)
    check(rel <= TRAIN_BF16_LOSS_REL, f"bf16 loss rel {rel} > "
          f"{TRAIN_BF16_LOSS_REL}")


def check_fp32_train_step(torch) -> None:
    """llama-3.2-1b at full width cut to 2 layers, fp32 compute: one
    Trainer step through the kernels against one through the einsum
    attention, same params and batch: loss and global grad norm."""
    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.train.optimizer import (
        adamw_cosine)
    from distributed_training_guide_tpu_torch.train.step import Trainer

    bundle = get_model("llama-3.2-1b", dtype=torch.float32, num_layers=2)
    params = bundle.init(bundle.config, SEED + 6, device="cuda")
    batch = _train_batch(torch, bundle.config.vocab_size, 2, 2048, SEED + 7)
    got, wq_grad = {}, {}
    for impl in ("flash", "xla"):
        trainer = Trainer(bundle=bundle, optimizer=adamw_cosine(3e-4),
                          attn_impl=impl, device="cuda")
        state = trainer.init_state_from_params(params, SEED)
        before = flash_counts()["flash_fwd"]
        _, metrics = trainer.step_fn(state, batch)
        check((flash_counts()["flash_fwd"] - before)
              == (2 if impl == "flash" else 0),
              f"fp32 step ({impl}): K1 launches")
        got[impl] = {k: v.item() for k, v in metrics.items()}
        # the q projection's grad reaches the loss only through the
        # attention backward (K2 on the kernel path)
        wq_grad[impl] = state.params["layers"]["attn"]["wq"].grad.clone()
        del trainer, state, metrics
        torch.cuda.empty_cache()
    rel = {k: abs(got["flash"][k] - got["xla"][k]) / abs(got["xla"][k])
           for k in ("loss", "grad_norm")}
    rel["wq_grad_rel_l2"] = ((wq_grad["flash"] - wq_grad["xla"]).norm()
                             / wq_grad["xla"].norm()).item()
    log(phase="train", check="one step, kernels vs einsum attention, fp32, "
        "full width, 2 layers, B 2, S 2048", flash=got["flash"],
        xla=got["xla"], rel=rel, bound=TRAIN_FP32_REL)
    for k, r in rel.items():
        check(r <= TRAIN_FP32_REL, f"fp32 train step {k} rel {r} > "
              f"{TRAIN_FP32_REL}")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 9: the grouped matmul kernels (K5, K6) against their plain versions
# ---------------------------------------------------------------------------

# relative L2 error against the plain version: in fp32 the same products
# summed in another order; with bf16 operands both sides sum exact fp32
# products in fp32 and round the result once to bf16 (half an ulp, 2**-9
# relative per element, about 2e-3 in L2), so the bound leaves 5x room
GMM_REL_L2 = {"fp32": 1e-5, "bf16": 1e-2}
QWEN3_G, QWEN3_TOPK, QWEN3_E, QWEN3_F = 128, 8, 2048, 768


def routed_sizes(torch, gen, tokens: int, experts: int, topk: int):
    """group_sizes [experts] int32 of a top-k routing of random scores."""
    idx = torch.rand(tokens, experts, generator=gen,
                     device="cuda").topk(topk, dim=-1).indices.flatten()
    return torch.zeros(experts, dtype=torch.int32, device="cuda").scatter_add_(
        0, idx, torch.ones_like(idx, dtype=torch.int32))


def fixed_sizes(torch, sizes):
    return torch.tensor(sizes, dtype=torch.int32, device="cuda")


def gmm_cases(torch, gen):
    """(name, M, K, N, group_sizes): qwen3-30b-a3b at decode (8 slots x
    top-8), a 256-token chunk and training (B 2 x S 2048), gate/up and
    down widths; moe-1b-8e (K 1024, N 2816, top-2 of 8) and
    qwen1.5-moe-a2.7b (G 60, N 1408, top-4) with a tail; empty groups,
    one group taking all rows, widths off every tile."""
    g, k8, e, f = QWEN3_G, QWEN3_TOPK, QWEN3_E, QWEN3_F
    dec = routed_sizes(torch, gen, 8, g, k8)
    chunk = routed_sizes(torch, gen, 256, g, k8)
    train = routed_sizes(torch, gen, 4096, g, k8)
    q15 = routed_sizes(torch, gen, 512, 60, 4)
    return [
        ("qwen3-decode-gate", 64, e, f, dec),
        ("qwen3-decode-down", 64, f, e, dec),
        ("qwen3-chunk-gate", 2048, e, f, chunk),
        ("qwen3-chunk-down", 2048, f, e, chunk),
        ("qwen3-train-gate", 32768, e, f, train),
        ("qwen3-train-down", 32768, f, e, train),
        ("moe-1b-8e", 4096, 1024, 2816, routed_sizes(torch, gen, 2048, 8, 2)),
        ("qwen1.5-moe-tail", 2048 + 37, 2048, 1408, q15),
        ("empty-groups-tail", 777, 256, 320,
         fixed_sizes(torch, [0, 100, 0, 0, 250, 0, 3, 0, 300, 0, 0, 0])),
        ("one-group", 1000, 256, 192, fixed_sizes(torch, [0, 0, 1000, 0])),
        ("off-tile", 1000, 100, 72, fixed_sizes(torch, [333, 0, 400, 17])),
    ]


def rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp_min(1e-30)).item()


def phase_grouped(torch) -> dict:
    """Every case through K5 in fp32 and bf16 (the forward), the
    backward's d_lhs form (fp32 dy against an fp32 or bf16 rhs^T view: the
    FMA and the split body) in the operands' dtype and in fp32, and K6
    (bf16 or fp32 lhs, fp32 dy: the split and the FMA body) in the
    operands' dtype and in fp32, each launch through the body that
    ``_gmm_plan`` / ``_tgmm_plan`` names and each body reached; K6 over a
    NaN tail and a group moved among others; the autograd Function's
    grads against plain autograd. Returns the worst errors."""
    from distributed_training_guide_tpu_torch.ops import grouped_matmul as gm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    counts = (gm.GMM_LAUNCHES, gm.TGMM_LAUNCHES)
    worst = {"grouped_matmul": 0.0, "tgmm": 0.0}        # fp32 max abs
    worst_rel = {"fp32": 0.0, "bf16": 0.0}
    n_checks = 0
    bodies_seen, tgmm_seen = set(), set()
    for name, m, k, n, sizes in gmm_cases(torch, gen):
        total = int(sizes.sum())
        g = sizes.shape[0]
        errs = {}
        for dtype in ("fp32", "bf16"):
            dt = torch.float32 if dtype == "fp32" else torch.bfloat16
            lhs = torch.randn(m, k, generator=gen, device="cuda").to(dt)
            rhs = torch.randn(g, k, n, generator=gen, device="cuda").to(dt)
            dy = torch.randn(m, n, generator=gen, device="cuda")
            before = (gm.GMM_LAUNCHES, gm.TGMM_LAUNCHES)
            plans = [gm._gmm_plan(lhs, rhs),
                     gm._gmm_plan(dy, rhs.transpose(1, 2))]
            bodies = dict(gm.GMM_BODY_LAUNCHES)
            tplans = [gm._tgmm_plan(lhs, dy, dt),
                      gm._tgmm_plan(lhs, dy, torch.float32)]
            tbodies = dict(gm.TGMM_BODY_LAUNCHES)
            out = gm.gmm(lhs, rhs, sizes)
            dlhs = gm.gmm(dy, rhs.transpose(1, 2), sizes, dt)
            # the d_lhs form at fp32 output too: the split body (bf16 rhs)
            # is held to the fp32 bound, not only to bf16's
            dlhs32 = gm.gmm(dy, rhs.transpose(1, 2), sizes, torch.float32)
            plans.append(plans[1])
            drhs = gm.tgmm(lhs, dy, sizes, g, dt)
            # K6 at fp32 output too: the split body (bf16 lhs) is held to
            # the fp32 bound, not only to bf16's
            drhs32 = gm.tgmm(lhs, dy, sizes, g, torch.float32)
            torch.cuda.synchronize()
            check((gm.GMM_LAUNCHES, gm.TGMM_LAUNCHES)
                  == (before[0] + 3, before[1] + 2),
                  f"{name} {dtype}: a kernel did not launch")
            for body in set(tplans):
                check(gm.TGMM_BODY_LAUNCHES[body] - tbodies[body]
                      == tplans.count(body), f"{name} {dtype}: K6 did not "
                      f"run the bodies {tplans} that _tgmm_plan names")
            tgmm_seen |= set(tplans)
            errs[f"drhs_body_{dtype}"] = tplans[0]
            for body in set(plans):
                check(gm.GMM_BODY_LAUNCHES[body] - bodies[body]
                      == plans.count(body), f"{name} {dtype}: K5 did not "
                      f"run the bodies {plans} that _gmm_plan names")
            bodies_seen |= set(plans)
            errs[f"body_{dtype}"] = plans[0]
            errs[f"dlhs_body_{dtype}"] = plans[1]
            refs = {"out": gm.gmm_reference(lhs, rhs, sizes, dt),
                    "dlhs": gm.gmm_reference(dy, rhs.float().transpose(1, 2),
                                             sizes, dt),
                    "dlhs32": gm.gmm_reference(
                        dy, rhs.float().transpose(1, 2), sizes,
                        torch.float32),
                    "drhs32": gm.tgmm_reference(lhs.float(), dy, sizes, g,
                                                torch.float32)}
            refs["drhs"] = refs["drhs32"].to(dt)
            for key, got in (("out", out), ("dlhs", dlhs), ("dlhs32", dlhs32),
                             ("drhs", drhs), ("drhs32", drhs32)):
                want = refs[key]
                check(got.shape == want.shape and got.dtype == want.dtype,
                      f"{name} {key}: {got.shape} {got.dtype}")
                check(bool(torch.isfinite(got.float()).all()),
                      f"{name} {key}: non-finite kernel output")
                if not key.startswith("drhs"):
                    check(not bool(got[total:].any()),
                          f"{name} {key}: rows past the total not zero")
                else:
                    check(not bool(got[sizes == 0].any()),
                          f"{name} {key}: an empty group's grad not zero")
                # the backward's two products are fp32 arithmetic whatever
                # the output dtype; a bf16 output rounds once
                err = rel_l2(got, want)
                kind = "fp32" if key in ("dlhs32", "drhs32") else dtype
                bound = GMM_REL_L2[kind]
                errs[f"{key}_{dtype}"] = err
                check(err <= bound, f"grouped {name} {key} {dtype}: rel L2 "
                      f"{err} > {bound}")
                worst_rel[kind] = max(worst_rel[kind], err)
                if kind == "fp32":
                    kern = ("tgmm" if key.startswith("drhs")
                            else "grouped_matmul")
                    worst[kern] = max(worst[kern], (got - want).abs().max()
                                      .item())
                n_checks += 1
            if tplans[1] == "split":  # the split body at its own arithmetic
                err = rel_l2(drhs32, gm.tgmm_reference(
                    lhs, dy, sizes, g, torch.float32, split_dy=True))
                errs["drhs32_vs_split_dy"] = err
                check(err <= TGMM_VS_SPLIT_REL_L2, f"grouped {name} K6 split "
                      f"body vs split_dy plain version: rel L2 {err}")
                n_checks += 1
            del lhs, rhs, dy, out, dlhs, dlhs32, drhs, drhs32, refs
            torch.cuda.empty_cache()
        log(phase="grouped", case=name, M=m, K=k, N=n, G=g, rows=total,
            metric="rel_l2", bound=GMM_REL_L2, **errs)
    check(bodies_seen == set(gm.GMM_BODY_LAUNCHES), f"grouped: the cases "
          f"ran the bodies {bodies_seen}, not each of {set(gm.GMM_BODY_LAUNCHES)}")
    check(tgmm_seen == set(gm.TGMM_BODY_LAUNCHES), f"grouped: K6 ran the "
          f"bodies {tgmm_seen}, not each of {set(gm.TGMM_BODY_LAUNCHES)}")
    invariant = check_gmm_rows_invariant(torch, gm, gen)
    nan_tail = check_tgmm_nan_tail(torch, gm, gen)
    moved = check_tgmm_group_invariant(torch, gm, gen)
    drift = tc_sum_drift(torch, gm, gen)
    # the autograd Function against torch autograd through the plain scan
    # at moe-1b-8e's widths, fp32
    sizes = routed_sizes(torch, gen, 1024, 8, 2)
    lhs = torch.randn(2048 + 5, 1024, generator=gen, device="cuda")
    rhs = torch.randn(8, 1024, 2816, generator=gen, device="cuda") * 0.03
    cot = torch.randn(2048 + 5, 2816, generator=gen, device="cuda")

    def run(impl):
        lv, rv = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
        out = gm.grouped_matmul(lv, rv, sizes, impl=impl)
        torch.sum(out * cot).backward()
        return out.detach(), lv.grad, rv.grad

    got, want = run("auto"), run("scan")
    grad_errs = {key: rel_l2(a, b) for key, a, b in
                 zip(("out", "dlhs", "drhs"), got, want)}
    log(phase="grouped", check="autograd Function vs plain autograd, fp32, "
        "M 2053, K 1024, N 2816, G 8", rel_l2=grad_errs,
        bound=GMM_REL_L2["fp32"])
    for key, err in grad_errs.items():
        check(err <= GMM_REL_L2["fp32"], f"Function {key} rel L2 {err}")
    del lhs, rhs, cot, got, want
    torch.cuda.empty_cache()
    gm.GMM_LAUNCHES, gm.TGMM_LAUNCHES = counts   # checks are not main path
    log(phase="grouped", checks=n_checks, worst_fp32_max_abs=worst,
        worst_rel_l2=worst_rel, rows_bitwise_equal_across_m=invariant,
        tgmm_nan_tail=nan_tail, tgmm_groups_bitwise_equal_moved=moved)
    return {**worst, "tc_sum_drift": drift, "worst_rel_l2": worst_rel}


# the split bodies against their own arithmetic summed in fp64: fp32
# rounding of a sum whose pieces of 128 k the tensor cores add up
SPLIT_VS_FP64_REL_L2 = 1e-6
# K6's split body against its plain version at its arithmetic
# (``split_dy``): the same products, both sums fp32 in other orders
TGMM_VS_SPLIT_REL_L2 = 2e-6


def check_tgmm_nan_tail(torch, gm, gen) -> dict:
    """K6's split body at qwen1.5-moe-a2.7b's widths (M 2085, K 2048, N
    1408, G 60 top-4) with the 37 rows past the total NaN in lhs and dy:
    d_rhs finite, within ``TGMM_VS_SPLIT_REL_L2`` of the plain version at
    its arithmetic and within the fp32 bound of the fp32 plain version
    (both mask the rows outside each group)."""
    m, k, n = 2048 + 37, 2048, 1408
    sizes = routed_sizes(torch, gen, 512, 60, 4)
    total = int(sizes.sum())
    lhs = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
    dy = torch.randn(m, n, generator=gen, device="cuda")
    lhs[total:], dy[total:] = float("nan"), float("nan")
    check(gm._tgmm_plan(lhs, dy, torch.float32) == "split",
          "tgmm nan tail: plan")
    got = gm.tgmm(lhs, dy, sizes, 60, torch.float32)
    check(bool(torch.isfinite(got).all()), "tgmm nan tail: a non-finite "
          "d_rhs")
    out = {"tail_rows": m - total,
           "rel_l2_vs_split_dy": rel_l2(got, gm.tgmm_reference(
               lhs, dy, sizes, 60, torch.float32, split_dy=True)),
           "rel_l2_vs_fp32": rel_l2(got, gm.tgmm_reference(
               lhs, dy, sizes, 60, torch.float32))}
    check(out["rel_l2_vs_split_dy"] <= TGMM_VS_SPLIT_REL_L2
          and out["rel_l2_vs_fp32"] <= GMM_REL_L2["fp32"],
          f"tgmm nan tail: {out}")
    del lhs, dy, got
    torch.cuda.empty_cache()
    return out


def check_tgmm_group_invariant(torch, gm, gen) -> list:
    """K6's split body at qwen3-30b-a3b's training gate shape: groups 1,
    64 and 127 of a routed M = 32768 call, each copied into a second call
    whose other groups have other sizes and rows (so that the group starts
    elsewhere) and whose rows past the total are NaN, come out bitwise
    equal. Returns the moved groups' (size, old start, new start)."""
    g, k8, e, f = QWEN3_G, QWEN3_TOPK, QWEN3_E, QWEN3_F
    sizes = routed_sizes(torch, gen, 4096, g, k8)
    lhs = torch.randn(4096 * k8, e, generator=gen, device="cuda").bfloat16()
    dy = torch.randn(4096 * k8, f, generator=gen, device="cuda")
    full = gm.tgmm(lhs, dy, sizes, g, torch.bfloat16)
    offs = [0] + torch.cumsum(sizes, 0).tolist()
    moved = []
    for grp in (1, g // 2, g - 1):
        other = routed_sizes(torch, gen, 3000, g, k8)
        other[grp] = sizes[grp]
        if int(other[:grp].sum()) == offs[grp]:   # the group must move
            other[0] += 1
        starts = [0] + torch.cumsum(other, 0).tolist()
        m2 = starts[-1] + 100
        lhs2 = torch.randn(m2, e, generator=gen, device="cuda").bfloat16()
        dy2 = torch.randn(m2, f, generator=gen, device="cuda")
        lhs2[starts[-1]:], dy2[starts[-1]:] = float("nan"), float("nan")
        lo, lo2, rows = offs[grp], starts[grp], int(sizes[grp])
        check(lo != lo2, f"tgmm: group {grp} did not move")
        lhs2[lo2:lo2 + rows] = lhs[lo:lo + rows]
        dy2[lo2:lo2 + rows] = dy[lo:lo + rows]
        again = gm.tgmm(lhs2, dy2, other, g, torch.bfloat16)
        check(torch.equal(again[grp], full[grp]), f"tgmm: group {grp} "
              f"({rows} rows) moved from row {lo} to {lo2} differs")
        moved.append((rows, lo, lo2))
        del lhs2, dy2, again
    del lhs, dy, full
    torch.cuda.empty_cache()
    return moved


def tc_sum_drift(torch, gm, gen) -> dict:
    """What the tensor cores' own fp32 sum does over a long K, and what the
    split body's fp32 register sum makes of it: one group of 2048 rows, K
    8192, N 256. K5's bf16 Hopper body keeps one wgmma accumulator over K
    (exact bf16 products): its relative L2 error against fp64 and its bias
    (the mean error in the direction of each output's sign, over the mean
    magnitude; negative: toward zero) are logged. The split body (fp32 dy
    against the bf16 rhs^T), whose tensor cores sum 128 k at a time, is
    held within ``SPLIT_VS_FP64_REL_L2`` of its arithmetic (``split_bf16``
    dy) summed in fp64."""
    m, k, n = 2048, 8192, 256
    sizes = fixed_sizes(torch, [m])
    lhs = torch.randn(m, k, generator=gen, device="cuda")
    rhs = (torch.randn(1, k, n, generator=gen, device="cuda") * 0.05
           ).bfloat16()
    out = {}
    for name, a, b in (("wgmma", lhs.bfloat16(), rhs),
                       ("split", lhs, rhs.transpose(1, 2).contiguous()
                        .transpose(1, 2))):
        check(gm._gmm_plan(a, b) == name, f"tc_sum_drift: {name} plan")
        got = gm.gmm(a, b, sizes, torch.float32).double()
        exact = (gm.split_bf16(a.float()) if name == "split"
                 else a.float()).double() @ b[0].double()
        out[name] = {"rel_l2": rel_l2(got, exact), "bias": (
            ((got - exact) * exact.sign()).mean() / exact.abs().mean()
        ).item()}
    log(phase="grouped", check="tensor-core fp32 sum over K 8192 vs fp64: "
        "one accumulator (wgmma body) and 128-k pieces (split body)",
        M=m, K=k, N=n, **out, bound_split=SPLIT_VS_FP64_REL_L2)
    check(out["split"]["rel_l2"] <= SPLIT_VS_FP64_REL_L2, f"split body vs "
          f"fp64 rel L2 {out['split']['rel_l2']}")
    del lhs, rhs
    torch.cuda.empty_cache()
    return out


def check_gmm_rows_invariant(torch, gm, gen) -> list:
    """The bf16 Hopper body at qwen3-30b-a3b's training gate shape: the
    first rows (at most 200) of a few groups, run alone (decode-sized M:
    64 x 128 tiles), come out bitwise equal to the same rows of the full
    M = 32768 product (128 x 256 tiles). Returns the row counts."""
    g, k8, e, f = QWEN3_G, QWEN3_TOPK, QWEN3_E, QWEN3_F
    sizes = routed_sizes(torch, gen, 4096, g, k8)
    lhs = torch.randn(4096 * k8, e, generator=gen, device="cuda").bfloat16()
    rhs = (torch.randn(g, e, f, generator=gen, device="cuda") * 0.02
           ).bfloat16()
    full = gm.gmm(lhs, rhs, sizes)
    offs = [0] + torch.cumsum(sizes, 0).tolist()
    checked = []
    for grp in (0, g // 2, g - 1):
        rows = min(int(sizes[grp]), 200)      # a decode-sized M
        alone = torch.zeros_like(sizes)
        alone[grp] = rows
        lo = offs[grp]
        few = gm.gmm(lhs[lo:lo + rows].contiguous(), rhs, alone)
        check(torch.equal(few, full[lo:lo + rows]), f"grouped: group "
              f"{grp}'s first {rows} rows alone differ from the same rows "
              f"at M {full.shape[0]}")
        checked.append(rows)
    return checked


# ---------------------------------------------------------------------------
# phase 10: grouped matmul timing
# ---------------------------------------------------------------------------

def gmm_bound(m, k, n, sizes, lhs_b, rhs_b, out_b, peak) -> dict:
    """K5: lhs read once, the rhs slices of the non-empty groups read
    once, out written once; 2 K N operations per row below the total."""
    total = int(sizes.sum())
    live = int((sizes > 0).sum())
    nbytes = m * k * lhs_b + live * k * n * rhs_b + m * n * out_b
    return _bound(nbytes, 2 * total * k * n, peak)


def tgmm_bound(m, k, n, sizes, lhs_b, dy_b, out_b, peak) -> dict:
    """K6: lhs and dy read once, every group's [K, N] written once."""
    total = int(sizes.sum())
    g = sizes.shape[0]
    nbytes = m * k * lhs_b + m * n * dy_b + g * k * n * out_b
    return _bound(nbytes, 2 * total * k * n, peak)


def _bound(nbytes, flops, peak) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[peak] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops)


def tc_bound(nbytes, flops) -> float:
    """The least time of a product whose fp32 operand is split into two
    bf16 parts: twice its operations against the bf16 tensor-core peak,
    or its bytes, whichever is larger (ms)."""
    return max(nbytes / HBM_BYTES_PER_S, 2 * flops / PEAK_FLOPS["bfloat16"]
               ) * 1e3


def split_body_bound(row: dict) -> None:
    """K5's and K6's split bodies and K7's tensor-core body run their fp32
    operand as two bf16 passes on the tensor cores, so their bound is
    ``tc_bound``; the bound of the same
    work at the fp32 rate outside the tensor cores (which the split body
    beats) stays beside it as "bound_fma_ms". Sets "share_of_bound"."""
    t_bytes = row["bytes"] / HBM_BYTES_PER_S * 1e3
    row["bound_fma_ms"] = row["bound_ms"]
    row["bound_ms"] = tc_bound(row["bytes"], row["flops"])
    row["bound_by"] = "bytes" if t_bytes >= row["bound_ms"] else "operations"
    row["share_of_bound"] = row["bound_ms"] / row["ms"]


def library_grouped_mm(torch, lhs, rhs, sizes):
    """``torch._grouped_mm`` on the same bf16 operands (offsets = the
    cumsum of the group sizes), as a yardstick: (device ms, CUDA-event ms,
    its output), or (None, None, why) where this torch lacks it or refuses
    the layout."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, None, "torch._grouped_mm is absent from this torch"
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    errors = []
    for b in (rhs, rhs.transpose(1, 2).contiguous().transpose(1, 2)):
        try:
            out = fn(lhs, b, offs=offs)
            torch.cuda.synchronize()
        except RuntimeError as exc:        # layout refused: try the next
            errors.append(str(exc).splitlines()[0][:120])
            continue
        call = lambda: fn(lhs, b, offs=offs)      # noqa: E731
        return (queued_ms(torch, call, 20), cuda_ms(call, iters=20),
                out)
    return None, None, "; ".join(errors)


def phase_grouped_timing(torch) -> dict:
    """K5 at the decode and training shapes (forward and the fp32 d_lhs)
    and K6 at the training gate / up and down shapes: each kernel's device
    time ("ms", by ``queued_ms``, as ``torch._grouped_mm``'s "library_ms";
    torch.profiler's mean per launch as "profiler_ms", None where it
    recorded nothing; CUDA events around
    back-to-back calls as "call_ms"), the plain versions and the bound
    (for the split bodies their two-pass bound, ``split_body_bound``; for
    K6 the FMA body's time on the same values, ``tgmm_timing_at``)."""
    from distributed_training_guide_tpu_torch.ops import grouped_matmul as gm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    counts = (gm.GMM_LAUNCHES, gm.TGMM_LAUNCHES)
    bf, f32 = torch.bfloat16, torch.float32
    g, k8, e, f = QWEN3_G, QWEN3_TOPK, QWEN3_E, QWEN3_F
    out = {}
    # "verify": the qwen3 verify forward at k 4 (8 slots x 5 rows = 40
    # tokens, each routed to its top-8 experts)
    for name, tokens in (("decode", 8), ("verify", S * (SPEC_K + 1)),
                         ("train", 4096)):
        m = tokens * k8
        sizes = routed_sizes(torch, gen, tokens, g, k8)
        lhs = torch.randn(m, e, generator=gen, device="cuda").to(bf)
        rhs = (torch.randn(g, e, f, generator=gen, device="cuda") * 0.02
               ).to(bf)
        call = lambda: gm.gmm(lhs, rhs, sizes)   # noqa: E731
        ms = queued_ms(torch, call, 20)
        prof_ms = profiler_ms(torch, call, 20, "gmm_")
        call_ms = cuda_ms(call, iters=20)
        plain_ms = cuda_ms(lambda: gm.gmm_reference(lhs, rhs, sizes, bf),
                           iters=3, warmup=1)
        lib_ms, lib_call_ms, lib = library_grouped_mm(torch, lhs, rhs, sizes)
        row = dict(kernel="grouped_matmul", shape=name, M=m, K=e, N=f, G=g,
                   rows=int(sizes.sum()),
                   groups_nonempty=int((sizes > 0).sum()), dtype="bf16",
                   body=gm._gmm_plan(lhs, rhs), ms=ms,
                   profiler_ms=prof_ms, call_ms=call_ms,
                   plain_ms=plain_ms, library_ms=lib_ms,
                   library_call_ms=lib_call_ms,
                   **gmm_bound(m, e, f, sizes, 2, 2, 2, "bfloat16"))
        if lib_ms is None:
            row["library_note"] = lib
        else:
            total = int(sizes.sum())
            row["library_rel_l2_vs_kernel"] = rel_l2(
                lib[:total], gm.gmm(lhs, rhs, sizes)[:total])
        row["share_of_bound"] = row["bound_ms"] / ms
        out[name] = row
        log(phase="grouped_timing", **row)
        if name == "train":
            # the backward: fp32 d_lhs = dy @ rhs^T (K5, split body) and
            # d_rhs = lhs^T dy (K6), bf16 outputs as on the training path
            dy = torch.randn(m, f, generator=gen, device="cuda")
            rt = rhs.transpose(1, 2)
            call = lambda: gm.gmm(dy, rt, sizes, bf)   # noqa: E731
            ms = queued_ms(torch, call, 5)
            prof_ms = profiler_ms(torch, call, 5, "gmm_")
            call_ms = cuda_ms(call, iters=5)
            plain_ms = cuda_ms(lambda: gm.gmm_reference(
                dy, rhs.float().transpose(1, 2), sizes, bf), iters=2,
                warmup=1)
            row = dict(kernel="grouped_matmul", shape="train-dlhs", M=m, K=f,
                       N=e, G=g, dtype="fp32 dy, bf16 rhs^T, bf16 out",
                       body=gm._gmm_plan(dy, rt), ms=ms,
                       profiler_ms=prof_ms, call_ms=call_ms,
                       plain_ms=plain_ms, library_ms=None,
                       library_note="no PyTorch call takes fp32 dy against "
                       "a bf16 rhs", **gmm_bound(m, f, e, sizes, 4, 2, 2,
                                                 "float32"))
            check(row["body"] == "split", f"train d_lhs: {row['body']}")
            split_body_bound(row)
            out["train-dlhs"] = row
            log(phase="grouped_timing", **row)
            out["tgmm-train"] = tgmm_timing_at(torch, gm, lhs, dy, sizes,
                                               "gate")
            # the down projection's d_rhs: its input [M, F] against its
            # fp32 dy [M, E]
            lhs_down = torch.randn(m, f, generator=gen, device="cuda").to(bf)
            dy_down = torch.randn(m, e, generator=gen, device="cuda")
            out["tgmm-train-down"] = tgmm_timing_at(torch, gm, lhs_down,
                                                    dy_down, sizes, "down")
            del lhs_down, dy_down
            del dy, rt
        del lhs, rhs, lib
        torch.cuda.empty_cache()
    gm.GMM_LAUNCHES, gm.TGMM_LAUNCHES = counts
    return out


def modelled_chunk_spread(sizes, k: int, n: int, blocks: int) -> dict:
    """How K6's split body's schedule deals its chunks to ``blocks``
    persistent blocks, by arithmetic alone (nothing is timed): its static
    grid of G x ceil(K / 128) x ceil(N / 128) tiles, group-major, block b
    taking tiles b, b + blocks, ...; a tile counted as its group's 64-row
    chunks (its epilogue and an empty group's zero stores left out). The
    largest block's chunks against the mean."""
    import numpy as np

    chunks = -(-np.maximum(sizes.cpu().numpy().astype(np.int64), 0) // 64)
    tiles = -(-k // 128) * -(-n // 128)
    cost = np.repeat(chunks, tiles)
    per_block = np.bincount(np.arange(cost.size) % blocks, weights=cost,
                            minlength=blocks)
    return {"blocks": blocks, "tiles": int(cost.size),
            "chunks_max": float(per_block.max()),
            "chunks_mean": float(per_block.mean()),
            "max_over_mean": float(per_block.max() / per_block.mean())}


def tgmm_timing_at(torch, gm, lhs, dy, sizes, shape: str) -> dict:
    """K6 (bf16 lhs [M, K], fp32 dy [M, N], bf16 out, as the training
    backward calls it) through the body ``_tgmm_plan`` names: device time
    by ``queued_ms`` ("ms"), torch.profiler ("profiler_ms"), CUDA events
    around back-to-back calls ("call_ms"); the plain version; the fp32 and
    the two-pass bound; the FMA body on the same values ("fma_ms": lhs
    through a row stride off 16 bytes, which ``_tgmm_plan`` sends to it);
    the all-bf16 ``torch._grouped_mm`` as a control (it takes no fp32
    dy); how the schedule deals the chunks to the SMs, by arithmetic
    (``modelled_chunk_spread``, kept out of the ``kernels`` line)."""
    bf = torch.bfloat16
    m, k = lhs.shape
    n, g = dy.shape[1], sizes.shape[0]
    call = lambda: gm.tgmm(lhs, dy, sizes, g, bf)   # noqa: E731
    ms = queued_ms(torch, call, 5)
    prof_ms = profiler_ms(torch, call, 5, "tgmm")
    call_ms = cuda_ms(call, iters=5)
    plain_ms = cuda_ms(lambda: gm.tgmm_reference(lhs, dy, sizes, g, bf),
                       iters=2, warmup=1)
    fma_lhs = torch.empty(m, k + 1, dtype=bf, device="cuda")[:, :k]
    fma_lhs.copy_(lhs)
    check(gm._tgmm_plan(fma_lhs, dy, bf) == "fma", "tgmm timing: FMA plan")
    fma_ms = queued_ms(
        torch, lambda: gm.tgmm(fma_lhs, dy, sizes, g, bf), 3)
    # the two bodies on the same values, fp32 out: the same products
    # summed in another order, and dy split in one of them
    bodies_rel_l2 = rel_l2(gm.tgmm(lhs, dy, sizes, g, torch.float32),
                           gm.tgmm(fma_lhs, dy, sizes, g, torch.float32))
    check(bodies_rel_l2 <= GMM_REL_L2["fp32"], f"tgmm {shape}: split vs FMA "
          f"body rel L2 {bodies_rel_l2}")
    row = dict(kernel="tgmm", shape=f"train-{shape}", M=m, K=k, N=n, G=g,
               rows=int(sizes.sum()), dtype="bf16 lhs, fp32 dy, bf16 out",
               body=gm._tgmm_plan(lhs, dy, bf), ms=ms, profiler_ms=prof_ms,
               call_ms=call_ms, plain_ms=plain_ms, fma_ms=fma_ms,
               split_vs_fma_rel_l2=bodies_rel_l2, library_ms=None,
               library_note="no PyTorch call takes fp32 dy against bf16 "
               "lhs (torch._grouped_mm is bf16 only)",
               modelled_chunk_spread=modelled_chunk_spread(
                   sizes, k, n,
                   torch.cuda.get_device_properties(0).multi_processor_count),
               **tgmm_bound(m, k, n, sizes, 2, 4, 2, "float32"))
    check(row["body"] == "split", f"tgmm {shape}: {row['body']}")
    split_body_bound(row)
    fn = getattr(torch, "_grouped_mm", None)
    if fn is not None:      # a control: the all-bf16 variant
        offs = torch.cumsum(sizes, 0, dtype=torch.int32)
        dyb = dy.to(bf)
        try:
            row["library_bf16_dy_ms"] = queued_ms(
                torch, lambda: fn(lhs.t(), dyb, offs=offs), 5)
        except RuntimeError as exc:
            row["library_bf16_dy_note"] = str(exc).splitlines()[0][:120]
    log(phase="grouped_timing", **row)
    del fma_lhs
    return row


# ---------------------------------------------------------------------------
# phase 11: serving qwen3-30b-a3b
# ---------------------------------------------------------------------------

MOE_LOGIT_REL_L2_BF16 = 1e-1   # as phase 7: bf16 rounding through 48 layers


def serve_specs(np, vocab: int) -> list:
    """Phase 7's traffic: prompts of 17, 2000 and six seeded lengths in
    [17, 2000], 32 new tokens, 6 greedy and 2 at temperature 0.8 / top-p
    0.9."""
    rng = np.random.default_rng(SEED)
    lens = [17, 2000] + [int(x) for x in rng.integers(17, 2001, 6)]
    return [dict(prompt_ids=[int(x) for x in rng.integers(0, vocab, n)],
                 max_new_tokens=32, seed=i,
                 **({"temperature": 0.8, "top_p": 0.9} if i >= 6 else {}))
            for i, n in enumerate(lens)]


def recording_engine(logits: dict):
    """A ServeEngine that keeps each request's first-token logits (what
    the last prefill forward produced) in ``logits``."""
    from distributed_training_guide_tpu_torch.serve import ServeEngine

    class Recording(ServeEngine):
        def _on_prefill_complete(self, adm, logit):
            logits[adm.request.request_id] = logit.float()
            return super()._on_prefill_complete(adm, logit)

    return Recording


MOE_SERVE_LAYERS = 12      # qwen3-30b-a3b cut to 12 of 48 layers (time)
INT8_SERVE_LAYERS = 16     # llama-3.1-8b cut to 16 of 32 layers (time)


def phase_moe_serve(torch, card: str) -> dict:
    import numpy as np

    from distributed_training_guide_tpu_torch.models import get_model, moe
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa
    from distributed_training_guide_tpu_torch.ops import grouped_matmul as gm
    from distributed_training_guide_tpu_torch.ops import paged_decode as pd
    from distributed_training_guide_tpu_torch.serve import (
        Request, ServeEngine, generate_many, throughput_stats)

    t0 = time.perf_counter()
    bundle = get_model("qwen3-30b-a3b", dtype=torch.bfloat16,
                       param_dtype=torch.bfloat16,
                       num_layers=MOE_SERVE_LAYERS)
    cfg = bundle.config
    params = bundle.init(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    layers = cfg.num_layers
    log(phase="moe_serve", model="qwen3-30b-a3b", params=bundle.num_params(),
        active_params=bundle.num_active_params(), layers=layers,
        dtype="bf16", init_s=time.perf_counter() - t0,
        params_gib=torch.cuda.memory_allocated() / 2 ** 30)
    specs = serve_specs(np, cfg.vocab_size)
    common = dict(n_slots=8, page_size=16, max_len=4096)
    results, first = {}, {}
    gm.GMM_LAUNCHES = pd.LAUNCHES = 0         # the main path starts here
    reset_moe_counts()
    copies = fa.ALIGN_COPIES
    for mode, chunk in (("bucketed", None), ("chunked", 256)):
        logits: dict = {}
        eng = recording_engine(logits)(bundle, params, prefill_chunk=chunk,
                                       **common)
        torch.cuda.reset_peak_memory_stats()
        k5, k4 = gm.GMM_LAUNCHES, pd.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = generate_many(eng, [Request(**r) for r in specs])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k5, k4 = gm.GMM_LAUNCHES - k5, pd.LAUNCHES - k4
        for r in res:
            check(r.finish_reason == "length" and len(r.generated_ids) == 32,
                  f"moe {mode}: request {r.request_id} ended "
                  f"{r.finish_reason} after {len(r.generated_ids)} tokens")
            check(all(0 <= x < cfg.vocab_size for x in r.generated_ids),
                  f"moe {mode}: token id out of range")
        forwards = eng.decode_steps + eng.programs.prefill_calls
        check(k5 == 3 * layers * forwards and eng.decode_steps > 0,
              f"moe {mode}: {k5} K5 launches for {forwards} forwards "
              f"(want {3 * layers} each)")
        want_k4 = layers * (eng.decode_steps
                            + (eng.programs.prefill_calls if chunk else 0))
        check(k4 == want_k4, f"moe {mode}: {k4} K4 launches, want {want_k4}")
        stats = throughput_stats(res, wall, eng)
        results[mode] = dict(res=res, k5=k5, k4=k4)
        first[mode] = logits[res[1].request_id]
        log(phase="moe_serve", mode=mode, card=card, wall_s=wall,
            tokens_per_s=stats["tokens_per_s"],
            ttft_s_p50=stats["ttft_s_p50"],
            latency_s_p50=stats["latency_s_p50"],
            itl_s_avg=eng.stats()["itl_s_avg"],
            decode_steps=eng.decode_steps,
            prefill_forwards=eng.programs.prefill_calls,
            k5_launches=k5, k5_per_forward=k5 / forwards, k4_launches=k4,
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del eng
        torch.cuda.empty_cache()
    main_path = (gm.GMM_LAUNCHES, pd.LAUNCHES)  # ... and ends here
    bodies = check_hopper_path("moe serve", copies)
    check(bodies["grouped_matmul"]["wgmma"] == main_path[0],
          f"moe serve: K5 launches by body {bodies['grouped_matmul']}")
    log(phase="moe_serve", launches_by_body=bodies)

    alone = generate_many(ServeEngine(bundle, params, **common),
                          [Request(**specs[0])])[0]
    check(alone.token_ids == results["bucketed"]["res"][0].token_ids,
          "moe greedy request 0: alone and co-batched tokens differ")
    agree = sum(a.token_ids == b.token_ids
                for a, b in zip(results["bucketed"]["res"],
                                results["chunked"]["res"]))
    log(phase="moe_serve", greedy_alone_equals_cobatched=True,
        requests_identical_bucketed_vs_chunked=agree, of=len(specs))
    torch.cuda.empty_cache()

    # the 2000-token prompt's first-token logits against a plain prefill
    # through the plain grouped matmul and the einsum attention
    ids = torch.tensor([specs[1]["prompt_ids"]], device="cuda")
    cache = moe.init_cache(cfg, 1, ids.shape[1], device="cuda")
    before = gm.GMM_LAUNCHES
    ref = moe.prefill(cfg, params, ids, cache, gmm_impl="scan")[0][0].float()
    check(gm.GMM_LAUNCHES == before, "the plain prefill launched K5")
    del cache
    for mode, got in first.items():
        check(bool(torch.isfinite(got).all()) and got.shape == (
            cfg.vocab_size,), f"moe {mode} first-token logits")
        rel = ((got - ref).norm() / ref.norm()).item()
        log(phase="moe_serve", check=f"first-token logits, {mode} vs plain "
            f"prefill (plain grouped matmul), bf16 full depth",
            prompt_tokens=ids.shape[1], rel_l2=rel,
            bound=MOE_LOGIT_REL_L2_BF16,
            max_abs=(got - ref).abs().max().item(),
            argmax_equal=bool(got.argmax() == ref.argmax()))
        check(rel <= MOE_LOGIT_REL_L2_BF16, f"moe {mode} first-token logits "
              f"rel L2 {rel} > {MOE_LOGIT_REL_L2_BF16}")
    del results, ref, first
    torch.cuda.empty_cache()
    profile = profile_decode(torch, bundle, params, specs)
    log(phase="moe_serve", profile="decode step, bucketed engine, 8 slots",
        card=card, **profile)
    del params
    torch.cuda.empty_cache()
    check_moe_fp32_chunk_path(torch, specs[1]["prompt_ids"])
    return dict(launches=main_path[0], k4_launches=main_path[1],
                per_forward=3 * layers)


def check_moe_fp32_chunk_path(torch, prompt) -> None:
    """qwen3-30b-a3b at full width cut to 2 layers, fp32: the chunked
    engine's first-token logits (K4 and K5 in every chunk) against the
    plain prefill through the plain grouped matmul."""
    from distributed_training_guide_tpu_torch.models import get_model, moe
    from distributed_training_guide_tpu_torch.serve import (Request,
                                                            generate_many)

    bundle = get_model("qwen3-30b-a3b", dtype=torch.float32,
                       param_dtype=torch.float32, num_layers=2)
    params = bundle.init(bundle.config, SEED + 1, device="cuda")
    logits: dict = {}
    eng = recording_engine(logits)(bundle, params, n_slots=1, page_size=16,
                                   max_len=4096, prefill_chunk=256)
    rid = generate_many(eng, [Request(prompt_ids=prompt,
                                      max_new_tokens=1)])[0].request_id
    ids = torch.tensor([prompt], device="cuda")
    cache = moe.init_cache(bundle.config, 1, ids.shape[1], device="cuda")
    ref = moe.prefill(bundle.config, params, ids, cache,
                      gmm_impl="scan")[0][0].float()
    got = logits[rid]
    rel = ((got - ref).norm() / ref.norm()).item()
    log(phase="moe_serve", check="first-token logits, chunked vs plain "
        "prefill, fp32, full width, 2 layers", prompt_tokens=len(prompt),
        rel_l2=rel, bound=LOGIT_REL_L2_FP32,
        max_abs=(got - ref).abs().max().item(),
        argmax_equal=bool(got.argmax() == ref.argmax()))
    check(bool(torch.isfinite(got).all()), "moe fp32 logits not finite")
    check(rel <= LOGIT_REL_L2_FP32, f"moe fp32 chunked logits rel L2 {rel} "
          f"> {LOGIT_REL_L2_FP32}")
    del eng, params, cache
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 12: chapter 10's training loop on qwen3-30b-a3b, 4 layers
# ---------------------------------------------------------------------------

MOE_TRAIN_LAYERS = 4
MOE_TRAIN_STEPS = 6
MOE_DENSE_STEPS = 2
MOE_TRAIN_ARGS = ["-m", "qwen3-30b-a3b", "-d", "synthetic:400000", "-s",
                  "2048", "-b", "2", "--lr", "3e-4", "--seed", str(SEED)]
# one fp32 step through the kernels against one through the plain grouped
# matmul, same params and batch: only the summation order differs
MOE_TRAIN_FP32_REL = 1e-5


def moe_counts() -> dict:
    from distributed_training_guide_tpu_torch.ops import grouped_matmul as gm

    return {**flash_counts(), "grouped_matmul": gm.GMM_LAUNCHES,
            "tgmm": gm.TGMM_LAUNCHES}


def reset_moe_counts() -> None:
    from distributed_training_guide_tpu_torch.ops import grouped_matmul as gm

    reset_flash_counts()
    gm.GMM_LAUNCHES = gm.TGMM_LAUNCHES = 0
    gm.GMM_BODY_LAUNCHES.update({k: 0 for k in gm.GMM_BODY_LAUNCHES})
    gm.TGMM_BODY_LAUNCHES.update({k: 0 for k in gm.TGMM_BODY_LAUNCHES})


def phase_moe_train(torch, card: str) -> dict:
    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.ops import grouped_matmul as gm
    from distributed_training_guide_tpu_torch.train import cli

    layers = MOE_TRAIN_LAYERS
    over = {"num_layers": layers}
    args = cli.get_parser().parse_args(
        MOE_TRAIN_ARGS + ["--moe-dispatch", "ragged", "--max-steps",
                          str(MOE_TRAIN_STEPS), "--log-freq", "2"])
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa

    reset_moe_counts()                        # the main path starts here
    copies = fa.ALIGN_COPIES
    t0 = time.perf_counter()
    out = cli.run_training(args, model_overrides=over)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = moe_counts()                   # ... and ends here
    bodies = check_hopper_path("moe train", copies)
    tgmm_bodies = dict(gm.TGMM_BODY_LAUNCHES)
    per_step = {"flash_fwd": layers, "flash_dq": layers, "flash_dkv": layers,
                "grouped_matmul": 6 * layers, "tgmm": 3 * layers}
    want = {k: v * MOE_TRAIN_STEPS for k, v in per_step.items()}
    check(launches == want, f"moe train: launches {launches}, want {want}")
    # the forward's three products per layer run the Hopper body, the
    # backward's fp32-dy d_lhs the split body
    half = 3 * layers * MOE_TRAIN_STEPS
    check(bodies["grouped_matmul"] == {"fma": 0, "wmma": 0, "wgmma": half,
                                       "split": half},
          f"moe train: K5 launches by body {bodies['grouped_matmul']}")
    # every d_rhs (bf16 expert inputs against fp32 dy) the split body
    check(tgmm_bodies == {"fma": 0, "split": half},
          f"moe train: K6 launches by body {tgmm_bodies}")
    infos = out["infos"]
    losses = [i["running_loss"] for i in infos]
    check(len(infos) == MOE_TRAIN_STEPS // 2 and all(
        map(math.isfinite, losses)), f"moe train: losses {losses}")
    check(losses[-1] < losses[0], f"moe train: loss did not fall: {losses}")
    check(all(i["moe_dropped_frac"] == 0.0 for i in infos),
          "moe train: ragged dispatch dropped pairs")
    for info in infos:
        log(phase="moe_train", model="qwen3-30b-a3b", layers=layers,
            card=card, **{k: info[k] for k in (
                "global_step", "running_loss", "grad_norm",
                "moe_dropped_frac", "tokens_per_s", "mfu", "time/step",
                "time/data", "peak_alloc_gb")})
    bundle = get_model("qwen3-30b-a3b", moe_dispatch="ragged", **over)
    log(phase="moe_train", steps=MOE_TRAIN_STEPS, wall_s=wall,
        launches_per_step={k: v / MOE_TRAIN_STEPS
                           for k, v in launches.items()},
        launches_by_body={**bodies, "tgmm": tgmm_bodies},
        batch=2, seq=2048, params=bundle.num_params(),
        active_params=bundle.num_active_params())
    state = out["state"]
    profile = profile_train_step(torch, state, bundle, 2, 2048)
    log(phase="moe_train", profile="one step, qwen3-30b-a3b 4 layers, B 2, "
        "S 2048", card=card, **profile)
    del out, state
    torch.cuda.empty_cache()
    check_moe_fp32_train_step(torch)

    args = cli.get_parser().parse_args(
        MOE_TRAIN_ARGS + ["--moe-dispatch", "dense", "--max-steps",
                          str(MOE_DENSE_STEPS), "--log-freq", "1"])
    reset_moe_counts()
    dense = cli.run_training(args, model_overrides=over)
    dense_counts = moe_counts()
    check(dense_counts["grouped_matmul"] == 0 and dense_counts["tgmm"] == 0,
          f"dense dispatch launched K5 / K6: {dense_counts}")
    dense_losses = [i["running_loss"] for i in dense["infos"]]
    check(all(map(math.isfinite, dense_losses)),
          f"dense losses {dense_losses}")
    log(phase="moe_train", dispatch="dense", steps=MOE_DENSE_STEPS,
        launches=dense_counts, losses=dense_losses,
        moe_dropped_frac=[i["moe_dropped_frac"] for i in dense["infos"]],
        tokens_per_s=dense["last_info"]["tokens_per_s"],
        peak_alloc_gb=dense["last_info"]["peak_alloc_gb"])
    del dense
    torch.cuda.empty_cache()
    return {"launches": launches, "per_step": per_step, "infos": infos,
            "profile": profile, "launches_by_body": bodies["grouped_matmul"],
            "tgmm_launches_by_body": tgmm_bodies}


def check_moe_fp32_train_step(torch) -> None:
    """qwen3-30b-a3b at full width cut to 2 layers, fp32 compute, ragged
    dispatch: the loss and global grad norm of one batch (B 1, S 512)
    through K5 / K6 against the same through the plain grouped matmul
    (whose autograd keeps a masked copy of the rows per expert, hence the
    short sequence)."""
    from distributed_training_guide_tpu_torch.models import get_model, moe
    from distributed_training_guide_tpu_torch.ops import grouped_matmul as gm
    from distributed_training_guide_tpu_torch.ops.cross_entropy import (
        causal_lm_loss)

    bundle = get_model("qwen3-30b-a3b", dtype=torch.float32, num_layers=2,
                       moe_dispatch="ragged")
    cfg = bundle.config
    params = bundle.init(cfg, SEED + 6, device="cuda")
    leaves = []

    def collect(tree):
        for v in tree.values():
            if isinstance(v, dict):
                collect(v)
            else:
                v.requires_grad_(True)
                leaves.append(v)

    collect(params)
    batch = _train_batch(torch, cfg.vocab_size, 1, 512, SEED + 7)
    got = {}
    for impl in ("auto", "scan"):
        reset_moe_counts()
        logits, aux = moe.apply_with_aux(cfg, params, batch["input_ids"],
                                         gmm_impl=impl)
        loss = (causal_lm_loss(logits, batch["labels"])
                + cfg.router_aux_coef * aux)
        del logits
        loss.backward()
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
            [p.grad for p in leaves])))
        counts = moe_counts()
        want = (12, 6) if impl == "auto" else (0, 0)
        check((counts["grouped_matmul"], counts["tgmm"]) == want,
              f"fp32 step ({impl}): K5 / K6 launches {counts}")
        check(gm.TGMM_BODY_LAUNCHES == {"fma": want[1], "split": 0},
              f"fp32 step ({impl}): K6 by body {gm.TGMM_BODY_LAUNCHES}")
        got[impl] = {"loss": loss.item(), "grad_norm": norm.item()}
        for p in leaves:
            p.grad = None
        torch.cuda.empty_cache()
    rel = {k: abs(got["auto"][k] - got["scan"][k]) / abs(got["scan"][k])
           for k in ("loss", "grad_norm")}
    log(phase="moe_train", check="one step, kernels vs plain grouped "
        "matmul, fp32, full width, 2 layers, B 1, S 512",
        kernels=got["auto"], plain=got["scan"], rel=rel,
        bound=MOE_TRAIN_FP32_REL)
    for k, r in rel.items():
        check(r <= MOE_TRAIN_FP32_REL, f"moe fp32 step {k} rel {r} > "
              f"{MOE_TRAIN_FP32_REL}")
    reset_moe_counts()
    del params, leaves
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 13: the block-dequant matmul (K7) against its plain version
# ---------------------------------------------------------------------------

# relative L2 error against the plain version: an fp32 output is the same
# fp32 products summed in another order; a bf16 output rounds that fp32
# sum once (half an ulp, 2**-9 relative)
QMM_REL_L2 = {"fp32": 1e-5, "bf16": 1e-2}
# llama-3.1-8b's widths: wq / wo, wk / wv, gate / up, down, the head
QMM_SHAPES = {"wq": (4096, 4096), "wk": (4096, 1024), "gate": (4096, 14336),
              "down": (14336, 4096), "head": (4096, 128256)}


def qmm_weight(torch, gen, k, n, bs):
    from distributed_training_guide_tpu_torch.train.precision import (
        quantize_blockwise)

    w = torch.randn(k, n, generator=gen, device="cuda") * 0.02
    return quantize_blockwise(w, block_size=bs)


def qmm_cases():
    """(shape name, K, N, bs, M list, x dtypes): every width at the engine's
    block size over decode and prefill rows (the head only at the rows the
    engine gives it), bs 128 and 24, a short last block with N % 4 != 0."""
    rows = (1, 8, 37, 256, 2048)
    out = [(name, k, n, 32, rows if name != "head" else (1, 8, 37),
            ("bf16", "fp32") if name in ("wq", "down", "head") else ("bf16",))
           for name, (k, n) in QMM_SHAPES.items()]
    out += [("gate-bs128", 4096, 14336, 128, (8, 256), ("bf16",)),
            ("wq-bs24", 4096, 4096, 24, (8, 37), ("bf16", "fp32")),
            ("tail", 4096, 4096 + 17, 32, (8, 256), ("bf16", "fp32"))]
    return out


def phase_qmm(torch) -> float:
    """Every case through K7 in both output dtypes, each launch through the
    body that ``_qmm_plan`` names and both bodies reached; rows of M = 37
    and M = 2048 products against the M = 1 product of the same row,
    bitwise. Returns the worst fp32-output max abs error."""
    from distributed_training_guide_tpu_torch.ops import quantized_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    count = qm.LAUNCHES
    worst, worst_rel, n_checks = 0.0, {"fp32": 0.0, "bf16": 0.0}, 0
    bodies_seen = set()
    for name, k, n, bs, rows, xdts in qmm_cases():
        qt = qmm_weight(torch, gen, k, n, bs)
        errs = {}
        for xdt in xdts:
            dt = torch.float32 if xdt == "fp32" else torch.bfloat16
            for m in rows:
                x = torch.randn(m, k, generator=gen, device="cuda").to(dt)
                want = qm.quantized_matmul_reference(x, qt.q, qt.scale)
                plan = qm._qmm_plan(x, qt.q, qt.scale)
                bodies_seen.add(plan)
                errs[f"body-x{xdt}"] = plan
                for odt in ("fp32", "bf16"):
                    out_dtype = (torch.float32 if odt == "fp32"
                                 else torch.bfloat16)
                    before = qm.LAUNCHES
                    by_body = dict(qm.BODY_LAUNCHES)
                    got = qm.dequant_matmul(x, qt.q, qt.scale, out_dtype)
                    torch.cuda.synchronize()
                    check(qm.LAUNCHES == before + 1, f"qmm {name}: no launch")
                    check(qm.BODY_LAUNCHES[plan] == by_body[plan] + 1,
                          f"qmm {name}: the launch did not run the body "
                          f"{plan} that _qmm_plan names")
                    check(got.shape == (m, n) and got.dtype == out_dtype,
                          f"qmm {name}: {got.shape} {got.dtype}")
                    check(bool(torch.isfinite(got.float()).all()),
                          f"qmm {name}: non-finite kernel output")
                    err = rel_l2(got, want)
                    check(err <= QMM_REL_L2[odt], f"qmm {name} M {m} x {xdt} "
                          f"out {odt}: rel L2 {err} > {QMM_REL_L2[odt]}")
                    errs[f"M{m}-x{xdt}-out{odt}"] = err
                    worst_rel[odt] = max(worst_rel[odt], err)
                    if odt == "fp32":
                        worst = max(worst, (got - want).abs().max().item())
                    n_checks += 1
                    del got
                if xdt == "bf16" and m in (37, 2048):
                    full = qm.dequant_matmul(x, qt.q, qt.scale)
                    for r in (0, m // 2, m - 1):
                        one = qm.dequant_matmul(x[r:r + 1].contiguous(), qt.q,
                                                qt.scale)
                        check(torch.equal(one[0], full[r]), f"qmm {name}: "
                              f"row {r} of M {m} differs from its M = 1 "
                              f"product")
                    errs[f"M{m}-rows-bitwise-as-M1"] = True
                    del full, one
                del x, want
        log(phase="qmm", case=name, K=k, N=n, bs=bs,
            splits={b: qm.kernel_splits(k, n, b) for b in qm.BODY_LAUNCHES},
            metric="rel_l2", bound=QMM_REL_L2, **errs)
        del qt
        torch.cuda.empty_cache()
    check(bodies_seen == set(qm.BODY_LAUNCHES), f"qmm: the cases ran the "
          f"bodies {bodies_seen}, not each of {set(qm.BODY_LAUNCHES)}")
    qm.LAUNCHES = count               # checking launches are not main path
    log(phase="qmm", checks=n_checks, worst_fp32_max_abs=worst,
        worst_rel_l2=worst_rel)
    return worst


# ---------------------------------------------------------------------------
# phase 14: K7 timing
# ---------------------------------------------------------------------------

def qmm_bound(m, k, n, bs, x_b, out_b) -> dict:
    """q and its fp32 scales read once, x read once, out written once;
    2 M K N fp32 operations."""
    nb = -(-n // bs)
    return _bound(k * n + k * nb * 4 + m * k * x_b + m * n * out_b,
                  2 * m * k * n, "float32")


def phase_qmm_timing(torch) -> dict:
    """K7 at the main path's shapes: a gate/up projection of a decode step
    (M 8) and of a 256-token chunk, bf16 x and output; the untied head of
    a decode step (fp32 logits). Copies of the weight rotate so that the
    weight comes from device memory, as it does in a forward, where each
    layer has its own. Device time ("ms") by ``queued_ms``, CUDA events
    around back-to-back calls beside it ("call_ms"); the tensor-core
    body's two-pass bound (``split_body_bound``, the fp32 one beside it).
    The control is the bf16 ``torch.mm`` of the same x against the
    unquantized bf16 weight, timed alike: a yardstick of the unquantized
    path, which the port does not call for int8 weights; no PyTorch call
    computes K7's function (``library_ms`` null)."""
    from distributed_training_guide_tpu_torch.ops import quantized_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    count = qm.LAUNCHES
    out = {}
    for name, m, (k, n), out_dtype, copies in (
            ("gate-decode", 8, QMM_SHAPES["gate"], torch.bfloat16, 4),
            # the int8 verify forward at k 4: 8 slots x 5 rows
            ("gate-verify", S * (SPEC_K + 1), QMM_SHAPES["gate"],
             torch.bfloat16, 4),
            ("head-decode", 8, QMM_SHAPES["head"], torch.float32, 1),
            ("gate-chunk", 256, QMM_SHAPES["gate"], torch.bfloat16, 4)):
        ws = [(torch.randn(k, n, generator=gen, device="cuda") * 0.02)
              .to(torch.bfloat16) for _ in range(copies)]
        qts = [qmm_weight(torch, gen, k, n, 32) for _ in range(copies)]
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        it = {"i": 0}

        def nxt(seq):
            it["i"] = (it["i"] + 1) % len(seq)
            return seq[it["i"]]

        def kern():
            qt = nxt(qts)
            return qm.dequant_matmul(x, qt.q, qt.scale, out_dtype)

        iters = 50 if m <= 8 else 10
        ms = queued_ms(torch, kern, iters)
        call_ms = cuda_ms(kern, iters=iters)
        plain_ms = cuda_ms(lambda: qm.quantized_matmul_reference(
            x, qts[0].q, qts[0].scale).to(out_dtype), iters=3, warmup=1)
        control = lambda: x @ nxt(ws)   # noqa: E731
        control_ms = queued_ms(torch, control, iters)
        control_call_ms = cuda_ms(control, iters=iters)
        body = qm._qmm_plan(x, qts[0].q, qts[0].scale)
        row = dict(kernel="quantized_matmul", shape=name, M=m, K=k, N=n,
                   bs=32, dtype="bf16 x, " + ("bf16" if out_dtype ==
                                              torch.bfloat16 else "fp32")
                   + " out", body=body, splits=qm.kernel_splits(k, n, body),
                   ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                   library_ms=None,
                   library_note="no PyTorch call computes a block-dequant "
                   "matmul with per-(row, 32-column block) scales",
                   control_ms=control_ms, control_call_ms=control_call_ms,
                   control_note="bf16 torch.mm on the unquantized weight "
                   "(cuBLAS), a control the port never calls",
                   **qmm_bound(m, k, n, 32, 2, out_dtype.itemsize))
        check(body == "wgmma", f"qmm {name}: {body}")
        split_body_bound(row)
        out[name] = row
        log(phase="qmm_timing", **row)
        del ws, qts, x
        torch.cuda.empty_cache()
    qm.LAUNCHES = count
    return out


# ---------------------------------------------------------------------------
# phase 15: serving llama-3.1-8b with int8 weights
# ---------------------------------------------------------------------------

def snapped(torch, stored, dtype):
    """Each quantized leaf replaced by its dequantized copy in ``dtype``."""
    from distributed_training_guide_tpu_torch.train.precision import (
        Quantized, dequantize_blockwise)

    if isinstance(stored, dict):
        return {k: snapped(torch, v, dtype) for k, v in stored.items()}
    if not isinstance(stored, Quantized):
        return stored
    if stored.q.ndim < 3:
        return dequantize_blockwise(stored, dtype=dtype)
    out = torch.empty(stored.q.shape, dtype=dtype, device=stored.q.device)
    for i in range(out.shape[0]):             # one layer's fp32 transient
        out[i] = dequantize_blockwise(
            Quantized(q=stored.q[i], scale=stored.scale[i]), dtype=dtype)
    return out


def phase_int8_serve(torch, card: str) -> dict:
    import numpy as np

    from distributed_training_guide_tpu_torch.models import get_model, llama
    from distributed_training_guide_tpu_torch.ops import paged_decode as pd
    from distributed_training_guide_tpu_torch.ops import quantized_matmul as qm
    from distributed_training_guide_tpu_torch.serve import (
        ModelPrograms, Request, ServeEngine, generate_many, throughput_stats)
    from distributed_training_guide_tpu_torch.serve.engine import (
        build_weight_report)
    from distributed_training_guide_tpu_torch.serve.weights import (
        params_nbytes)

    t0 = time.perf_counter()
    bundle = get_model("llama-3.1-8b", dtype=torch.bfloat16,
                       param_dtype=torch.bfloat16,
                       num_layers=INT8_SERVE_LAYERS)
    cfg = bundle.config
    layers = cfg.num_layers
    params = bundle.init(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    per_forward = 7 * layers + 1
    specs = serve_specs(np, cfg.vocab_size)
    # the 2000-token prompt's first-token logits under the bf16 weights,
    # before they go (ungated, beside the gated check below)
    ids = torch.tensor([specs[1]["prompt_ids"]], device="cuda")

    def plain_prefill(p):
        cache = llama.init_cache(cfg, 1, ids.shape[1], device="cuda")
        return llama.prefill(cfg, p, ids, cache)[0][0].float()

    bf16_ref = plain_prefill(params)
    # the weights the engine keeps: the stored tree's own allocations
    # (norms are shared with the bf16 params), against the report
    base = torch.cuda.memory_allocated()
    programs = ModelPrograms(bundle, params, weight_dtype="int8")
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - base
    # the bf16 tree goes as the serve CLI drops it: every engine below
    # shares these programs, so only the int8 weights stay resident
    del params
    gc.collect()
    torch.cuda.empty_cache()
    stored = programs.params
    leaves = []

    def collect(tree):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            if isinstance(v, (dict, tuple)):
                collect(v)
            else:
                leaves.append(v)

    collect(stored)
    storage = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
               for t in leaves}
    shared = sum(t.element_size() * t.numel() for t in leaves
                 if t.dtype != torch.int8 and t.dtype != torch.float32)
    report = build_weight_report(programs)
    wbytes = report["weight_bytes"]
    check(sum(storage.values()) == wbytes == params_nbytes(stored),
          f"int8: weight_report {wbytes} B, resident storages "
          f"{sum(storage.values())} B")
    # the caching allocator rounds each allocation up to 512 bytes
    check(abs(grown - (wbytes - shared)) <= 512 * len(leaves) + 2 ** 20,
          f"int8: the stored weights allocated {grown} B, the report says "
          f"{wbytes} B ({shared} B of norms shared)")
    log(phase="int8_serve", model="llama-3.1-8b", layers=layers,
        init_and_quantize_s=time.perf_counter() - t0, weight_report=report,
        allocated_by_store=grown, norm_bytes_shared=shared,
        resident_after_drop_gib=torch.cuda.memory_allocated() / 2 ** 30)
    common = dict(n_slots=8, page_size=16, max_len=4096, programs=programs)
    results, first = {}, {}
    qm.LAUNCHES = pd.LAUNCHES = 0             # the main path starts here
    qm.BODY_LAUNCHES.update({b: 0 for b in qm.BODY_LAUNCHES})
    for mode, chunk in (("bucketed", None), ("chunked", 256)):
        logits: dict = {}
        eng = recording_engine(logits)(bundle, None, prefill_chunk=chunk,
                                       **common)
        torch.cuda.reset_peak_memory_stats()
        # the programs are shared: their prefill count runs on
        k7, k4, pc = qm.LAUNCHES, pd.LAUNCHES, programs.prefill_calls
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = generate_many(eng, [Request(**r) for r in specs])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k7, k4 = qm.LAUNCHES - k7, pd.LAUNCHES - k4
        prefills = programs.prefill_calls - pc
        for r in res:
            check(r.finish_reason == "length" and len(r.generated_ids) == 32,
                  f"int8 {mode}: request {r.request_id} ended "
                  f"{r.finish_reason} after {len(r.generated_ids)} tokens")
            check(all(0 <= x < cfg.vocab_size for x in r.generated_ids),
                  f"int8 {mode}: token id out of range")
        forwards = eng.decode_steps + prefills
        check(k7 == per_forward * forwards and eng.decode_steps > 0,
              f"int8 {mode}: {k7} K7 launches for {forwards} forwards "
              f"(want {per_forward} each)")
        want_k4 = layers * (eng.decode_steps + (prefills if chunk else 0))
        check(k4 == want_k4, f"int8 {mode}: {k4} K4 launches, want {want_k4}")
        check(eng.weight_report() == report, f"int8 {mode}: weight report")
        stats = throughput_stats(res, wall, eng)
        results[mode] = dict(res=res, k7=k7, k4=k4)
        first[mode] = logits[res[1].request_id]
        log(phase="int8_serve", mode=mode, card=card, wall_s=wall,
            tokens_per_s=stats["tokens_per_s"],
            ttft_s_p50=stats["ttft_s_p50"],
            latency_s_p50=stats["latency_s_p50"],
            itl_s_avg=eng.stats()["itl_s_avg"],
            decode_steps=eng.decode_steps, prefill_forwards=prefills,
            k7_launches=k7, k7_per_forward=k7 / forwards, k4_launches=k4,
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del eng
        torch.cuda.empty_cache()
    main_path = (qm.LAUNCHES, pd.LAUNCHES)    # ... and ends here
    k7_bodies = dict(qm.BODY_LAUNCHES)
    # bf16 x at every product, every operand on 16 bytes: the tensor-core
    # body carried every K7 launch of the path
    check(k7_bodies == {"fma": 0, "wgmma": main_path[0]}, f"int8: K7 "
          f"launches by body {k7_bodies}, {main_path[0]} in all")
    log(phase="int8_serve", k7_launches_by_body=k7_bodies)

    alone = generate_many(ServeEngine(bundle, None, **common),
                          [Request(**specs[0])])[0]
    check(alone.token_ids == results["bucketed"]["res"][0].token_ids,
          "int8 greedy request 0: alone and co-batched tokens differ")
    agree = sum(a.token_ids == b.token_ids
                for a, b in zip(results["bucketed"]["res"],
                                results["chunked"]["res"]))
    log(phase="int8_serve", greedy_alone_equals_cobatched=True,
        requests_identical_bucketed_vs_chunked=agree, of=len(specs))
    del results
    torch.cuda.empty_cache()

    # the 2000-token prompt's first-token logits against the plain prefill
    # over the snapped params (no K7), and (ungated) against bf16 weights
    before = qm.LAUNCHES
    snap = snapped(torch, stored, cfg.dtype)
    ref = plain_prefill(snap)
    del snap
    check(qm.LAUNCHES == before, "the snapped plain prefill launched K7")
    for mode, got in first.items():
        check(bool(torch.isfinite(got).all()) and got.shape == (
            cfg.vocab_size,), f"int8 {mode} first-token logits")
        rel = rel_l2(got, ref)
        log(phase="int8_serve", check=f"first-token logits, {mode} vs plain "
            f"prefill over the snapped params, bf16 full depth",
            prompt_tokens=ids.shape[1], rel_l2=rel, bound=LOGIT_REL_L2_BF16,
            max_abs=(got - ref).abs().max().item(),
            argmax_equal=bool(got.argmax() == ref.argmax()),
            int8_vs_bf16_weights_rel_l2=rel_l2(got, bf16_ref),
            int8_vs_bf16_weights_argmax_equal=bool(
                got.argmax() == bf16_ref.argmax()))
        check(rel <= LOGIT_REL_L2_BF16, f"int8 {mode} first-token logits "
              f"rel L2 {rel} > {LOGIT_REL_L2_BF16}")
    del ref, bf16_ref, first, stored
    torch.cuda.empty_cache()
    profile = profile_decode(torch, bundle, None, specs, programs=programs)
    log(phase="int8_serve", profile="decode step, bucketed engine, 8 slots, "
        "int8 weights", card=card, **profile)
    del programs
    torch.cuda.empty_cache()
    prompt = specs[1]["prompt_ids"]
    check_int8_fp32_path(torch, "llama-3.1-8b", prompt)
    check_int8_fp32_path(torch, "llama-3.2-1b", prompt)
    return dict(launches=main_path[0], k4_launches=main_path[1],
                per_forward=per_forward, profile=profile,
                launches_by_body=k7_bodies)


def check_int8_fp32_path(torch, model: str, prompt) -> None:
    """A model at full width cut to 2 layers, fp32, int8 weights: the
    engine's first-token logits, bucketed (K7 in every projection) and
    chunked (K7 and K4), against the plain prefill over the snapped
    params. In fp32 only the summation order differs. llama-3.1-8b's head
    is a standard-form product through K7; llama-3.2-1b's tied head runs
    the plain transpose form on the card."""
    from distributed_training_guide_tpu_torch.models import get_model, llama
    from distributed_training_guide_tpu_torch.ops import quantized_matmul as qm
    from distributed_training_guide_tpu_torch.serve import (Request,
                                                            generate_many)

    bundle = get_model(model, dtype=torch.float32, param_dtype=torch.float32,
                       num_layers=2)
    cfg = bundle.config
    params = bundle.init(cfg, SEED + 1, device="cuda")
    per_forward = 7 * 2 + (0 if cfg.tie_word_embeddings else 1)
    logits: dict = {}
    errs = {}
    ref = None
    for mode, chunk in (("bucketed", None), ("chunked", 256)):
        eng = recording_engine(logits)(bundle, params, n_slots=1,
                                       page_size=16, max_len=4096,
                                       prefill_chunk=chunk,
                                       weight_dtype="int8")
        before = qm.LAUNCHES
        rid = generate_many(eng, [Request(prompt_ids=prompt,
                                          max_new_tokens=1)])[0].request_id
        forwards = eng.programs.prefill_calls + eng.decode_steps
        check(qm.LAUNCHES - before == per_forward * forwards,
              f"{model} fp32 int8 {mode}: K7 launches")
        if ref is None:
            ids = torch.tensor([prompt], device="cuda")
            cache = llama.init_cache(cfg, 1, ids.shape[1], device="cuda")
            before = qm.LAUNCHES
            ref = llama.prefill(cfg, snapped(torch, eng.params, torch.float32),
                                ids, cache)[0][0].float()
            check(qm.LAUNCHES == before, "the snapped prefill launched K7")
            del cache
        got = logits[rid]
        check(bool(torch.isfinite(got).all()), f"{model} fp32 int8 logits")
        errs[mode] = rel_l2(got, ref)
        del eng
        torch.cuda.empty_cache()
    log(phase="int8_serve", check=f"first-token logits vs plain prefill over "
        f"the snapped params, fp32, {model} full width, 2 layers, "
        f"{'tied head (plain transpose form)' if cfg.tie_word_embeddings else 'head through K7'}",
        prompt_tokens=len(prompt), rel_l2=errs, bound=LOGIT_REL_L2_FP32)
    for mode, rel in errs.items():
        check(rel <= LOGIT_REL_L2_FP32, f"{model} fp32 int8 {mode} logits "
              f"rel L2 {rel} > {LOGIT_REL_L2_FP32}")
    del params, ref
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 16: chapter 01 — checkpoints and resume, precision policies, remat
# policies, the other optimizers, the NaN drill
# ---------------------------------------------------------------------------

CH01_RESUME_LAYERS = 2      # llama-3.2-1b at full width cut to 2 layers
CH01_RESUME_STEPS = 4       # saves at steps 2 and 4 (each 4.61 GB)
CH01_POLICY_LAYERS = 4     # (b)-(d) at full width cut to 4 layers (time)
CH01_PRECISION_STEPS = 4
CH01_REMAT_STEPS = 3
CH01_POLICIES = ("fp32", "bf16-master", "adam8bit", "bf16-master+adam8bit")
# K1 launches per layer per step under each remat policy: the flash forward
# is one custom op, so "attn" / "attn_mlp" keep its (o, lse)
CH01_REMAT_K1 = {"all": 2, "dots": 2, "attn": 1, "attn_mlp": 1}
# the peak must fall by this share of the state bytes a policy saves
CH01_PEAK_SHARE = 0.8
CH01_MOE_LAYERS = 2
CH01_LAUNCHES: dict = {}    # each kernel's launches over phase 16's runs


def ch01_run(torch, extra: list, *, layers=None, env=None, base=None,
             log_freq: int = 1):
    """``run_training`` through the CLI parser on llama-3.2-1b (B 4, S
    2048; ``base`` replaces those arguments), with ``env`` set for the
    run; returns (its output, the K1-K3 launches of the run)."""
    import os

    from distributed_training_guide_tpu_torch.train import cli

    args = cli.get_parser().parse_args(
        (base or TRAIN_ARGS) + ["--log-freq", str(log_freq), *extra])
    reset_moe_counts()                        # each run's path starts here
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        out = cli.run_training(
            args, model_overrides={"num_layers": layers} if layers else None)
        torch.cuda.synchronize()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        counts = moe_counts()                 # ... and ends here
        for k, v in counts.items():
            CH01_LAUNCHES[k] = CH01_LAUNCHES.get(k, 0) + v
    return out, counts


def ch01_losses(out) -> dict:
    return {i["global_step"]: i["running_loss"] for i in out["infos"]}


def ch01_rates(out) -> dict:
    """Tokens/s and step ms (host clock), each the mean over the steps
    after the first (which pays the warm-up), and the run's peak."""
    later = out["infos"][1:]
    return {"tokens_per_s": sum(i["tokens_per_s"] for i in later)
            / len(later),
            "time_step_ms": sum(i["time/step"] for i in later) / len(later),
            "peak_alloc_gb": out["last_info"]["peak_alloc_gb"]}


def ch01_free(torch, *outs) -> None:
    import gc

    for out in outs:
        if isinstance(out, dict):
            out.clear()
    gc.collect()
    torch.cuda.empty_cache()


def ch01_restored(torch, exp_dir, layers: int) -> tuple:
    """The newest verifiable checkpoint of ``exp_dir`` read into a fresh
    fp32 state of llama-3.2-1b at ``layers`` layers: (tensors by name,
    host_state)."""
    from distributed_training_guide_tpu_torch.checkpoint import CheckpointIO
    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.train.optimizer import (
        adamw_cosine)
    from distributed_training_guide_tpu_torch.train.state import (
        state_tensors)
    from distributed_training_guide_tpu_torch.train.step import Trainer

    trainer = Trainer(bundle=get_model("llama-3.2-1b", num_layers=layers),
                      optimizer=adamw_cosine(3e-4), device="cuda")
    state, host = CheckpointIO(exp_dir).restore(trainer.init_state(SEED + 9))
    return state_tensors(state), host


def ch01_same(torch, a: dict, b: dict) -> list:
    """Names whose tensors differ (bitwise) between two restored states."""
    check(a.keys() == b.keys(), "restored states hold other names")
    return [k for k in a if not torch.equal(a[k], b[k])]


def ch01_resume(torch, root: Path, card: str) -> dict:
    """(a): a straight 4-step run saving asynchronously every 2 steps
    against a run saving synchronously (keep 2) that the crash drill kills
    at step 3 and that resumes to step 4, at 2 layers: the resumed
    losses, and each step's checkpoint of the two, bitwise (then each
    one's fallback past a corrupted checkpoint-4)."""
    import json
    import shutil

    from distributed_training_guide_tpu_torch.checkpoint import manifest
    from distributed_training_guide_tpu_torch.utils import faults

    layers = CH01_RESUME_LAYERS
    exp = ["--save-dir", str(root), "--ckpt-freq", "2", "--max-steps", str(CH01_RESUME_STEPS)]
    run, counts = ch01_run(torch, ["-e", "C", "--keep-checkpoints", "3",
                                   "--async-checkpoint", *exp],
                           layers=layers)
    golden = ch01_losses(run)
    check(set(golden) == set(range(1, CH01_RESUME_STEPS + 1)) and all(
        map(math.isfinite, golden.values())), f"resume: losses {golden}")
    check(counts["flash_fwd"] == layers * CH01_RESUME_STEPS, f"resume: launches {counts}")
    async_saves = run["checkpoint_saves"]
    ch01_free(torch, run)

    sync = ["-e", "A", "--keep-checkpoints", "2", *exp]
    crash = {faults.ENV_CRASH_STEP: "3", faults.ENV_CRASH_MODE: "exc"}
    try:
        ch01_run(torch, sync, layers=layers, env=crash)
        check(False, "the crash drill did not crash")
    except RuntimeError as exc:
        check("injected fault" in str(exc), f"crash drill: {exc}")
    ch01_free(torch)
    resumed, _ = ch01_run(torch, sync, layers=layers)
    got = ch01_losses(resumed)
    check(resumed["resumed"] and got == {3: golden[3], 4: golden[4]},
          f"resume: steps 3-4 {got}, straight {golden}")
    sync_saves = resumed["checkpoint_saves"]
    ch01_free(torch, resumed)
    chain = json.loads((root / "A" / "state.json").read_text())["retained"]
    kept = sorted(p.name for p in (root / "A").iterdir() if p.is_dir())
    check(chain == ["checkpoint-4", "checkpoint-2"]
          and kept == ["checkpoint-2", "checkpoint-4"],
          f"retention: chain {chain}, dirs {kept}")
    for name in chain:
        m = manifest.load_manifest(root / "A", name)
        problems = manifest.verify_manifest(root / "A" / name, m)
        check(m is not None and not problems,
              f"manifest of {name}: {problems}")
    sync4, host = ch01_restored(torch, root / "A", layers)
    async4, _ = ch01_restored(torch, root / "C", layers)
    diff = ch01_same(torch, sync4, async4)
    check(host["global_step"] == 4 and not diff,
          f"async checkpoint-4 differs from the resumed sync one: "
          f"{diff[:4]}")
    del sync4, async4
    # the fallback past a corrupted latest checkpoint, in both: A's
    # checkpoint-2 was written synchronously before the crash, C's while
    # steps 3 and 4 updated the state in place
    victim = faults.corrupt_checkpoint_dir(root / "A" / "checkpoint-4")
    faults.corrupt_checkpoint_dir(root / "C" / "checkpoint-4")
    fallback, host = ch01_restored(torch, root / "A", layers)
    async2, host_c = ch01_restored(torch, root / "C", layers)
    diff = ch01_same(torch, fallback, async2)
    check(host["global_step"] == 2 and host_c["global_step"] == 2
          and not diff, f"fallback / async snapshot: step {host} / "
          f"{host_c}, differing {diff[:4]}")
    del fallback, async2
    ch01_free(torch)
    shutil.rmtree(root / "A")
    shutil.rmtree(root / "C")
    out = {"losses": golden, "resumed_losses": got,
           "saves_sync": sync_saves, "saves_async": async_saves,
           "corrupted": victim}
    log(phase="chapter01", part="resume", layers=layers, card=card, **out)
    return out


def ch01_state_bytes(out) -> int:
    """Bytes of params, their grads and the optimizer state as stored."""
    from distributed_training_guide_tpu_torch.train.state import (
        named_leaves, state_tensors)

    state = out["state"]
    flat = state_tensors(state)
    grads = sum(p.numel() * p.element_size()
                for _, p in named_leaves(state.params))
    return grads + sum(t.numel() * t.element_size() for k, t in flat.items()
                       if k.startswith(("params/", "opt_state/")))


def ch01_precision(torch, card: str) -> dict:
    """(b): 4 steps at ``CH01_POLICY_LAYERS`` layers under each policy:
    finite falling loss, a launch of each of K1-K3 a layer and step, and
    the peak against the fp32 run."""
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa

    layers, steps = CH01_POLICY_LAYERS, CH01_PRECISION_STEPS
    res = {}
    for policy in CH01_POLICIES:
        copies = fa.ALIGN_COPIES
        out, counts = ch01_run(torch, ["--max-steps", str(steps),
                                       "--precision-policy", policy],
                               layers=layers)
        check_hopper_path(f"precision {policy}", copies)
        want = layers * steps
        check(counts["flash_fwd"] == counts["flash_dq"] == counts[
            "flash_dkv"] == want, f"precision {policy}: launches {counts}")
        losses = ch01_losses(out)
        vals = [losses[s] for s in sorted(losses)]
        check(all(map(math.isfinite, vals)) and vals[-1] < vals[0],
              f"precision {policy}: losses {vals}")
        res[policy] = {"losses": vals, **ch01_rates(out),
                       "state_gb": ch01_state_bytes(out) / 1e9,
                       "launches": counts}
        log(phase="chapter01", part="precision", policy=policy, card=card,
            **res[policy])
        ch01_free(torch, out)
    base = res["fp32"]
    for policy in CH01_POLICIES[1:]:
        saved = base["state_gb"] - res[policy]["state_gb"]
        drop = base["peak_alloc_gb"] - res[policy]["peak_alloc_gb"]
        res[policy]["peak_drop_gb"] = drop
        res[policy]["state_saved_gb"] = saved
        check(drop >= CH01_PEAK_SHARE * saved,
              f"precision {policy}: peak fell {drop:.2f} GB, the state "
              f"saves {saved:.2f} GB")
    log(phase="chapter01", part="precision peaks", card=card,
        **{p: {k: res[p].get(k) for k in ("peak_alloc_gb", "state_gb",
                                          "peak_drop_gb", "state_saved_gb")}
           for p in CH01_POLICIES})
    return res


def ch01_remat(torch, card: str, no_remat_step1: float) -> dict:
    """(c): 3 steps at ``CH01_POLICY_LAYERS`` layers under each remat
    policy: K1 per step, the step-1 loss bitwise the run's without remat,
    peaks in order."""
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa

    layers, steps = CH01_POLICY_LAYERS, CH01_REMAT_STEPS
    res = {}
    for policy, k1 in CH01_REMAT_K1.items():
        copies = fa.ALIGN_COPIES
        out, counts = ch01_run(torch, ["--max-steps", str(steps),
                                       "--checkpoint-activations",
                                       "--remat-policy", policy],
                               layers=layers)
        check_hopper_path(f"remat {policy}", copies)
        per_step = {k: counts[k] / steps for k in ("flash_fwd", "flash_dq",
                                                    "flash_dkv")}
        check(per_step == {"flash_fwd": k1 * layers, "flash_dq": layers,
                           "flash_dkv": layers},
              f"remat {policy}: launches per step {per_step}")
        losses = ch01_losses(out)
        check(losses[1] == no_remat_step1, f"remat {policy}: step-1 loss "
              f"{losses[1]!r}, without remat {no_remat_step1!r}")
        res[policy] = {"launches_per_step": per_step,
                       "losses": [losses[s] for s in sorted(losses)],
                       **ch01_rates(out)}
        log(phase="chapter01", part="remat", policy=policy, card=card,
            **res[policy])
        ch01_free(torch, out)
    peaks = [res[p]["peak_alloc_gb"] for p in ("all", "attn", "attn_mlp")]
    check(peaks[0] <= peaks[1] <= peaks[2],
          f"remat peaks all / attn / attn_mlp: {peaks}")
    return res


def ch01_optimizers(torch, card: str) -> dict:
    """(d): adafactor and lion, 4 steps at ``CH01_POLICY_LAYERS``
    layers."""
    res = {}
    for name in ("adafactor", "lion"):
        out, counts = ch01_run(torch, ["--max-steps", "4", "--optimizer",
                                       name], layers=CH01_POLICY_LAYERS)
        losses = ch01_losses(out)
        vals = [losses[s] for s in sorted(losses)]
        check(all(map(math.isfinite, vals)) and vals[-1] < vals[0],
              f"{name}: losses {vals}")
        res[name] = {"losses": vals,
                     "opt_state_gb": sum(
                         t.numel() * t.element_size() for slots in
                         out["state"].opt_state.optimizer.state.values()
                         for t in slots.values()) / 1e9,
                     **ch01_rates(out)}
        log(phase="chapter01", part="optimizer", optimizer=name, card=card,
            **res[name])
        ch01_free(torch, out)
    return res


def ch01_nan_drill(torch, card: str) -> dict:
    """(e): a NaN loss injected at the third step under ``--guard-policy
    skip``, at 2 layers: the run finishes and skips exactly that step."""
    from distributed_training_guide_tpu_torch.utils import faults

    out, _ = ch01_run(torch, ["--max-steps", "4", "--guard-policy", "skip"],
                      layers=CH01_RESUME_LAYERS,
                      env={faults.ENV_NAN_LOSS_STEP: "2"})
    flags = {i["global_step"]: i["notfinite"] for i in out["infos"]}
    skipped = out["last_info"]["guard_skipped"]
    check(skipped == 1 and flags == {1: 0.0, 2: 0.0, 3: 1.0, 4: 0.0},
          f"nan drill: skipped {skipped}, notfinite by step {flags}")
    log(phase="chapter01", part="nan drill", card=card, guard_skipped=skipped,
        notfinite=flags)
    ch01_free(torch, out)
    return {"guard_skipped": skipped}


def ch01_moe_remat(torch, card: str) -> dict:
    """qwen3-30b-a3b at full width cut to 2 layers (ragged dispatch), one
    step without remat and under "all" / "attn": K1 per layer once, twice,
    once; K5 6 per layer without remat and 9 with (the forward's three
    grouped products are recomputed under every policy: their outputs feed
    the backward), K6 3 per layer; the loss bitwise the same."""
    layers = CH01_MOE_LAYERS
    base = MOE_TRAIN_ARGS + ["--moe-dispatch", "ragged", "--max-steps", "1"]
    res, first = {}, None
    for policy, (k1, k5) in {None: (1, 6), "all": (2, 9),
                             "attn": (1, 9)}.items():
        extra = ([] if policy is None else ["--checkpoint-activations",
                                            "--remat-policy", policy])
        out, counts = ch01_run(torch, extra, layers=layers, base=base)
        want = {"flash_fwd": k1 * layers, "flash_dq": layers,
                "flash_dkv": layers, "grouped_matmul": k5 * layers,
                "tgmm": 3 * layers}
        check(counts == want, f"moe remat {policy}: launches {counts}, "
              f"want {want}")
        loss = out["infos"][0]["running_loss"]
        first = loss if first is None else first
        check(loss == first, f"moe remat {policy}: loss {loss!r}, without "
              f"remat {first!r}")
        res[str(policy)] = {"launches": counts,
                            "peak_alloc_gb": out["last_info"]["peak_alloc_gb"]}
        ch01_free(torch, out)
    log(phase="chapter01", part="moe remat", layers=layers, card=card, **res)
    return res


def phase_chapter01(torch, card: str) -> dict:
    import shutil
    import tempfile

    root = Path(tempfile.mkdtemp(prefix="chapter01-"))
    try:
        resume = ch01_resume(torch, root, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    precision = ch01_precision(torch, card)
    remat = ch01_remat(torch, card, precision["fp32"]["losses"][0])
    optimizers = ch01_optimizers(torch, card)
    nan = ch01_nan_drill(torch, card)
    moe_remat = ch01_moe_remat(torch, card)
    check(all(CH01_LAUNCHES.get(k, 0) > 0 for k in (
        "flash_fwd", "flash_dq", "flash_dkv", "grouped_matmul", "tgmm")),
        f"chapter 01: a kernel of the path never launched: {CH01_LAUNCHES}")
    log(phase="chapter01", launches=CH01_LAUNCHES)
    return {"launches": dict(CH01_LAUNCHES), "resume": resume,
            "precision": precision, "remat": remat,
            "optimizers": optimizers, "nan": nan, "moe_remat": moe_remat}


# ---------------------------------------------------------------------------
# phase 17: the distributed plans of chapters 02, 04, 06 and 07, at world 1
# ---------------------------------------------------------------------------

PLAN_STEPS = 3
# (strategy, chapter module, its flags, the run's own arguments); zero2 takes
# two microbatches of 2 so that its sharded accumulation buffer exists, held
# to a single-plan run of the same microbatches
PLAN_RUNS = (("ddp", "c02_ddp", [], []),
             ("zero1", "c02_ddp", ["--zero1"], []),
             ("zero2", "c02_ddp", ["--zero2"], ["-b", "2", "--grad-accum", "2"]),
             ("fsdp", "c04_fsdp", [], []),
             ("tp", "c06_tp", [], []),
             ("tp_fsdp", "c07_tp_fsdp", [], []),
             # ZeRO-1 beside tp / fsdp: the optimizer's embed dim on (dp,
             # fsdp), each slot cut from the param's shards
             ("tp_fsdp_zero1", "c07_tp_fsdp", ["--zero1"], []))
# one rank: every collective is a copy on a one-rank NCCL group, and the
# vocab-parallel loss of tp and tp_fsdp computes and differentiates the
# logsumexp as torch.logsumexp does, so every plan runs the single plan's
# arithmetic: bitwise is expected, and these bounds are what the check allows
PLAN_LOSS_REL = 1e-5
PLAN_NORM_REL = 1e-4
PLAN_RESUME_LAYERS = 2
PLAN_LAUNCHES: dict = {}    # each kernel's launches over the strategies' runs
PLAN_CUSTOM_BATCH = 2       # the custom loss's [B, S, V] fp32 logits: 2.1 GB
PLAN_CUSTOM_STEPS = 2
PLAN_POLICY = "bf16-master+adam8bit"    # the fp32 checkpoint re-encoded


def plan_custom_loss_fn(logits, labels):
    """A custom loss: label smoothing 0.1 over the next-token
    log-probabilities, reading every vocab entry of every position."""
    import torch

    lp = torch.log_softmax(logits[:, :-1].float(), -1)
    t = labels[:, 1:].long()
    nll = -torch.gather(lp, -1, t[..., None])[..., 0]
    return (0.9 * nll - 0.1 * lp.mean(-1)).mean()


def plan_env() -> dict:
    """The torchrun env contract for a world of one: rank 0 of 1 on a
    TCPStore at a free local port."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
            "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"}


def with_env(env: dict, fn):
    import os

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def plan_run(torch, chapter, argv: list) -> tuple:
    """One run through a chapter's ``main`` (or chapter 01's CLI when
    ``chapter`` is None) with the K1-K3 launches of the run."""
    import importlib

    from distributed_training_guide_tpu_torch.train import cli

    reset_flash_counts()                      # the run's path starts here
    torch.cuda.reset_peak_memory_stats()
    if chapter is None:
        out = cli.run_training(cli.get_parser().parse_args(argv))
    else:
        mod = importlib.import_module(
            f"distributed_training_guide_tpu_torch.chapters.{chapter}")
        out = with_env(plan_env(), lambda: mod.main(argv))
    torch.cuda.synchronize()
    counts = flash_counts()                   # ... and ends here
    return out, counts


def plan_summary(out) -> dict:
    infos = out["infos"]
    later = infos[1:]
    return {"losses": [i["running_loss"] for i in infos],
            "grad_norms": [i["grad_norm"] for i in infos],
            "time_step_ms": sum(i["time/step"] for i in later) / len(later),
            "tokens_per_s": sum(i["tokens_per_s"] for i in later)
            / len(later),
            "peak_alloc_gb": out["last_info"]["peak_alloc_gb"]}


def plan_compare(name: str, got: dict, want: dict) -> dict:
    """A strategy's losses and grad norms against the single plan's."""
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(got["losses"], want["losses"]))
    norm_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(got["grad_norms"], want["grad_norms"]))
    check(len(got["losses"]) == PLAN_STEPS
          and all(map(math.isfinite, got["losses"])),
          f"plans {name}: losses {got['losses']}")
    check(loss_rel <= PLAN_LOSS_REL, f"plans {name}: losses {got['losses']} "
          f"against the single plan's {want['losses']}: rel {loss_rel}")
    check(norm_rel <= PLAN_NORM_REL, f"plans {name}: grad norms "
          f"{got['grad_norms']} against {want['grad_norms']}: rel "
          f"{norm_rel}")
    return {"loss_max_rel": loss_rel, "grad_norm_max_rel": norm_rel,
            "losses_bitwise": got["losses"] == want["losses"],
            "grad_norms_bitwise": got["grad_norms"] == want["grad_norms"]}


def plan_resume(torch, root: Path) -> dict:
    """Chapter 04's plan (fsdp) saves at step 2 of 3 at 2 layers; chapter
    07's plan (tp_fsdp) resumes from it and takes step 3, whose loss must
    equal the fsdp run's own step 3."""
    import torch.distributed as dist

    from distributed_training_guide_tpu_torch.launch import (
        maybe_initialize_distributed)
    from distributed_training_guide_tpu_torch.parallel import (make_mesh,
                                                               make_plan)
    from distributed_training_guide_tpu_torch.train import cli

    def run(strategy):
        args = cli.get_parser().parse_args(
            TRAIN_ARGS + ["--log-freq", "1", "--max-steps", str(PLAN_STEPS),
                          "-e", "plans", "--save-dir", str(root),
                          "--ckpt-freq", "2"])

        def go():
            maybe_initialize_distributed("cuda")
            try:
                return cli.run_training(
                    args, lambda: make_plan(strategy, make_mesh()),
                    model_overrides={"num_layers": PLAN_RESUME_LAYERS})
            finally:
                dist.destroy_process_group()
        return with_env(plan_env(), go)

    straight = run("fsdp")
    want = {i["global_step"]: i["running_loss"] for i in straight["infos"]}
    saves = straight["checkpoint_saves"]
    ch01_free(torch, straight)
    resumed = run("tp_fsdp")
    got = {i["global_step"]: i["running_loss"] for i in resumed["infos"]}
    check(resumed["resumed"] and list(got) == [PLAN_STEPS],
          f"plans resume: resumed={resumed['resumed']}, steps {list(got)}")
    rel = abs(got[PLAN_STEPS] - want[PLAN_STEPS]) / abs(want[PLAN_STEPS])
    check(rel <= PLAN_LOSS_REL, f"plans resume: step {PLAN_STEPS} loss "
          f"{got[PLAN_STEPS]} under tp_fsdp, {want[PLAN_STEPS]} under fsdp")
    ch01_free(torch, resumed)
    return {"fsdp_losses": want, "tp_fsdp_loss": got[PLAN_STEPS],
            "rel": rel, "bitwise": got[PLAN_STEPS] == want[PLAN_STEPS],
            "layers": PLAN_RESUME_LAYERS,
            "saves": [{k: v for k, v in s.items()
                       if k in ("step", "bytes", "write_s", "blocking_s")}
                      for s in saves]}


def phase_plans(torch, card: str) -> dict:
    import shutil
    import tempfile

    layers = 16
    base = TRAIN_ARGS + ["--max-steps", str(PLAN_STEPS), "--log-freq", "1"]
    refs, results, per_step = {}, {}, {}
    for extra in ([], ["-b", "2", "--grad-accum", "2"]):
        out, counts = plan_run(torch, None, base + extra)
        refs[tuple(extra)] = plan_summary(out)
        ch01_free(torch, out)
        log(phase="plans", strategy="single", extra=extra, card=card,
            launches=counts, **refs[tuple(extra)])
    for strategy, chapter, flags, extra in PLAN_RUNS:
        out, counts = plan_run(torch, chapter, base + extra + flags)
        summary = plan_summary(out)
        ch01_free(torch, out)
        accum = 2 if "--grad-accum" in extra else 1
        want = {k: layers * accum * PLAN_STEPS for k in counts}
        check(counts == want, f"plans {strategy}: launches {counts}, want "
              f"{want} ({layers * accum} of each per step: the einsum "
              f"attention ran)")
        for k, v in counts.items():
            PLAN_LAUNCHES[k] = PLAN_LAUNCHES.get(k, 0) + v
        per_step[strategy] = {k: v // PLAN_STEPS for k, v in counts.items()}
        ref = refs[tuple(extra)]
        results[strategy] = {**summary, **plan_compare(strategy, summary,
                                                       ref),
                             "single_time_step_ms": ref["time_step_ms"],
                             "single_tokens_per_s": ref["tokens_per_s"],
                             "single_peak_alloc_gb": ref["peak_alloc_gb"]}
        log(phase="plans", strategy=strategy, chapter=chapter, flags=flags,
            extra=extra, card=card, launches_per_step=per_step[strategy],
            **results[strategy])
    custom = plan_custom(torch, card)
    root = Path(tempfile.mkdtemp(prefix="plans-"))
    try:
        resume = plan_resume(torch, root)
        log(phase="plans", resume=resume, card=card)
        ckpts = plan_async_reencode(torch, root, resume, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"launches": dict(PLAN_LAUNCHES), "per_step": per_step,
            "results": results, "single": refs[()], "resume": resume,
            "custom": custom, "checkpoints": ckpts}


def plan_custom(torch, card: str) -> dict:
    """A custom ``loss_fn`` on llama-3.2-1b at 16 layers (B 2 x S 2048),
    two steps under chapter 04's fsdp plan at world 1 (the loss on the
    global logits, gathered over the one-rank group) against two without
    a plan: the losses within ``PLAN_LOSS_REL``, 16 launches of each of
    K1-K3 a step on both."""
    import torch.distributed as dist

    from distributed_training_guide_tpu_torch.launch import (
        maybe_initialize_distributed)
    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.parallel import (make_mesh,
                                                               make_plan)
    from distributed_training_guide_tpu_torch.train.optimizer import (
        adamw_cosine)
    from distributed_training_guide_tpu_torch.train.step import Trainer

    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    ids = torch.randint(0, 128256, (PLAN_CUSTOM_BATCH, 2048), device="cuda",
                        generator=gen)
    batch = {"input_ids": ids, "labels": ids}

    def run(plan):
        t = Trainer(bundle=get_model("llama-3.2-1b"),
                    optimizer=adamw_cosine(3e-4), plan=plan, device="cuda",
                    loss_fn=plan_custom_loss_fn)
        state = t.init_state(SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_flash_counts()                  # the run's path starts here
        losses, ms = [], []
        for _ in range(PLAN_CUSTOM_STEPS):
            t0 = time.perf_counter()
            state, m = t.step_fn(state, batch)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        counts = flash_counts()               # ... and ends here
        peak = torch.cuda.max_memory_allocated() / 1e9
        del state, t
        gc.collect()
        torch.cuda.empty_cache()
        return {"losses": losses, "step_ms": ms, "peak_alloc_gb": peak,
                "launches": counts}

    single = run(None)

    def under_fsdp():
        maybe_initialize_distributed("cuda")
        try:
            return run(make_plan("fsdp", make_mesh(device="cuda")))
        finally:
            dist.destroy_process_group()

    fsdp = with_env(plan_env(), under_fsdp)
    want = {k: 16 * PLAN_CUSTOM_STEPS for k in fsdp["launches"]}
    for name, r in (("single", single), ("fsdp", fsdp)):
        check(r["launches"] == want, f"plans custom loss {name}: launches "
              f"{r['launches']}, want {want}")
        check(all(map(math.isfinite, r["losses"])),
              f"plans custom loss {name}: losses {r['losses']}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(fsdp["losses"],
                                                   single["losses"]))
    check(rel <= PLAN_LOSS_REL, f"plans custom loss: fsdp {fsdp['losses']} "
          f"against no plan {single['losses']}: rel {rel}")
    for k, v in fsdp["launches"].items():
        PLAN_LAUNCHES[k] = PLAN_LAUNCHES.get(k, 0) + v
    out = {"single": single, "fsdp": fsdp, "loss_max_rel": rel,
           "bitwise": fsdp["losses"] == single["losses"],
           "batch": PLAN_CUSTOM_BATCH}
    log(phase="plans", part="custom loss", card=card, **out)
    return out


def plan_cli(torch, root: Path, strategy, exp: str, extra: list,
             layers: int = PLAN_RESUME_LAYERS) -> dict:
    """Chapter 01's CLI on phase 17's model at ``layers`` layers, under
    ``strategy``'s plan at world 1 (None: no plan), ``PLAN_STEPS`` steps,
    a checkpoint every 2 into ``root / exp``."""
    import torch.distributed as dist

    from distributed_training_guide_tpu_torch.launch import (
        maybe_initialize_distributed)
    from distributed_training_guide_tpu_torch.parallel import (make_mesh,
                                                               make_plan)
    from distributed_training_guide_tpu_torch.train import cli

    args = cli.get_parser().parse_args(
        TRAIN_ARGS + ["--log-freq", "1", "--max-steps", str(PLAN_STEPS),
                      "-e", exp, "--save-dir", str(root), "--ckpt-freq",
                      "2", *extra])
    over = {"num_layers": layers}
    if strategy is None:
        return cli.run_training(args, model_overrides=over)

    def go():
        maybe_initialize_distributed("cuda")
        try:
            return cli.run_training(
                args, lambda: make_plan(strategy, make_mesh()),
                model_overrides=over)
        finally:
            dist.destroy_process_group()
    return with_env(plan_env(), go)


def plan_async_reencode(torch, root: Path, resume: dict,
                        card: str) -> dict:
    """(i) ``plan_resume``'s fsdp run again with ``--async-checkpoint``:
    its step-2 checkpoint restores bitwise the synchronous one, and save()
    blocks only for the staging (its seconds beside the synchronous
    save's). (ii) the synchronous fp32 checkpoint resumed into
    ``PLAN_POLICY`` under fsdp and without a plan (each re-encoded where
    it restores): the step-3 losses agree within ``PLAN_LOSS_REL``."""
    out = plan_cli(torch, root, "fsdp", "plans_async",
                   ["--async-checkpoint"])
    losses = {i["global_step"]: i["running_loss"] for i in out["infos"]}
    saves = out["checkpoint_saves"]
    ch01_free(torch, out)
    check(losses == resume["fsdp_losses"], f"plans async: losses {losses} "
          f"against the synchronous run's {resume['fsdp_losses']}")
    sync, _ = ch01_restored(torch, root / "plans", PLAN_RESUME_LAYERS)
    got, _ = ch01_restored(torch, root / "plans_async", PLAN_RESUME_LAYERS)
    differ = ch01_same(torch, sync, got)
    check(not differ, f"plans async: the restored tensors {differ[:5]} "
          f"differ from the synchronous checkpoint's")
    n_tensors = len(sync)
    del sync, got
    torch.cuda.empty_cache()
    check(len(saves) == 1 and saves[0]["async"], f"plans async: saves "
          f"{saves}")
    async_save = {k: saves[0].get(k) for k in ("bytes", "blocking_s",
                                               "write_s", "wait_s")}
    encoded = {}
    for name, strategy in (("fsdp", "fsdp"), ("none", None)):
        run = plan_cli(torch, root, strategy, "plans",
                       ["--precision-policy", PLAN_POLICY])
        check(run["resumed"] and len(run["infos"]) == 1,
              f"plans re-encode {name}: resumed={run['resumed']}, "
              f"{len(run['infos'])} steps")
        encoded[name] = run["infos"][0]["running_loss"]
        ch01_free(torch, run)
    rel = abs(encoded["fsdp"] - encoded["none"]) / abs(encoded["none"])
    check(math.isfinite(encoded["fsdp"]) and rel <= PLAN_LOSS_REL,
          f"plans re-encode: step {PLAN_STEPS} loss {encoded['fsdp']} under "
          f"fsdp, {encoded['none']} without a plan: rel {rel}")
    result = {"async": {"restored_bitwise": True, "tensors": n_tensors,
                        **async_save},
              "sync_save": resume["saves"][0],
              "reencode": {"policy": PLAN_POLICY, "losses": encoded,
                           "rel": rel,
                           "bitwise": encoded["fsdp"] == encoded["none"]},
              "layers": PLAN_RESUME_LAYERS}
    log(phase="plans", part="async save and re-encode under fsdp",
        card=card, **result)
    return result


# ---------------------------------------------------------------------------
# phase 18: chapter 05 — weight logistics, preflight, one 405B layer,
# offload, the JSON engine
# ---------------------------------------------------------------------------

# llama-3.2-1b's public model card, as a transformers config: the train
# model, here with random bf16 weights from SEED, saved and converted; at
# full width, cut to 4 of its 16 layers (the script's time limit: the
# conversion, export and reload scale with the bytes)
CH05_HF_CONFIG = dict(
    vocab_size=128256, hidden_size=2048, intermediate_size=8192,
    num_hidden_layers=4, num_attention_heads=32, num_key_value_heads=8,
    max_position_embeddings=131072, rope_theta=500000.0, rms_norm_eps=1e-5,
    tie_word_embeddings=True, attention_bias=False, mlp_bias=False,
    rope_scaling={"rope_type": "llama3", "factor": 32.0,
                  "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                  "original_max_position_embeddings": 8192})
CH05_STEPS = 3
CH05_OFFLOAD_LAYERS = 4    # (d) at full width cut to 4 layers (time)
CH05_ARGS = ["-d", "synthetic:400000", "-s", "2048", "-b", "2", "--lr",
             "3e-4", "--seed", str(SEED), "--log-freq", "1",
             "--no-checkpoint-activations"]
# the port's step-1 loss (bf16 compute through K1-K3, fp32 logits) against
# transformers' bf16 model on the same batch: bf16 rounds at other places
# through its 4 layers, as TRAIN_BF16_LOSS_REL allows kernels against einsum
CH05_HF_LOSS_REL = 1e-2
# the exported checkpoint reloaded by transformers in fp32 against the
# port's fp32 forward on the trained params (TF32 off): the same fp32
# math through its 4 layers, summed in another order
CH05_EXPORT_LOGIT_REL = 1e-4
# the preflight's byte counts against the arithmetic of the chapter's
# recipe (16 B a parameter for fp32 AdamW, ~6 for bf16-master + adam8bit,
# ~4 for bf16 params + adafactor)
CH05_PREFLIGHT_REL = 0.02
CH05_405B = ["-m", "llama-3.1-405b", "-s", "4096", "-b", "1"]
CH05_405B_TRAIN = CH05_405B + ["-d", "synthetic:100000", "--param-dtype",
                               "bfloat16", "--optimizer", "adafactor",
                               "--log-freq", "1", "--seed", str(SEED)]
CH05_405B_STEPS = 4
CH05_405B_SHAPE = (1, 4096, 128, 8, 128)    # B, S, Hq, Hkv, D (a group of 16)
# the preflight runs: (name, flags, model overrides, B/param of the recipe)
CH05_PREFLIGHTS = (
    ("64gpu-fp32-adamw", ["--tensor-parallel", "8", "--preflight-world",
                          "64"], None, 16),
    ("64gpu-bf16-master+adam8bit",
     ["--tensor-parallel", "8", "--preflight-world", "64",
      "--precision-policy", "bf16-master+adam8bit"], None, 6),
    ("64gpu-bf16-adafactor",
     ["--tensor-parallel", "8", "--preflight-world", "64", "--param-dtype",
      "bfloat16", "--optimizer", "adafactor"], None, 4),
    ("1gpu-1layer-bf16-adafactor",
     ["--param-dtype", "bfloat16", "--optimizer", "adafactor"], 1, 4),
    ("1gpu-1layer-fp32-adamw", [], 1, 16))

_PREFLIGHT_SCRIPT = """
import json, sys
sys.path.insert(0, sys.argv[1])
from distributed_training_guide_tpu_torch.chapters import c05_llama405b
runs = json.loads(sys.argv[2])
out = {}
for name, flags, layers, _ in runs:
    kw = {"model_overrides": {"num_layers": layers}} if layers else {}
    out[name] = c05_llama405b.main(json.loads(sys.argv[3]) + flags
                                   + ["--preflight"], **kw)
# the post-training colocation of phase 24's policy under fsdp 8
from distributed_training_guide_tpu_torch.models import get_model
from distributed_training_guide_tpu_torch.parallel import make_mesh, make_plan
from distributed_training_guide_tpu_torch.train.optimizer import adamw_cosine
from distributed_training_guide_tpu_torch.train.preflight import (
    fake_group, price_post_colocation)
from distributed_training_guide_tpu_torch.train.step import Trainer
for world in (1, 8):
    with fake_group(world):
        t = Trainer(bundle=get_model("llama-3.2-1b"), device="meta",
                    optimizer=adamw_cosine(1e-5),
                    plan=make_plan("fsdp", make_mesh(device="cpu",
                                                     fsdp=world)))
        out[f"post_colocation_fsdp{world}"] = price_post_colocation(
            t, n_slots=8, page_size=16, max_len=2048)
print("PREFLIGHT:" + json.dumps(out))
"""


def ch05_preflight_start():
    """The preflight in a process of its own (its fake process group must
    be the only one of its process), started first so its CPU work runs
    beside the card's."""
    return subprocess.Popen(
        [sys.executable, "-c", _PREFLIGHT_SCRIPT, str(ROOT),
         json.dumps(CH05_PREFLIGHTS), json.dumps(CH05_405B)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def ch05_preflight_finish(proc, card: str) -> dict:
    from distributed_training_guide_tpu_torch.models import get_model

    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    check(proc.returncode == 0, f"preflight: exit {proc.returncode}: "
          f"{stderr[-2000:]}")
    line = next(x for x in stdout.splitlines() if x.startswith("PREFLIGHT:"))
    reports = json.loads(line[len("PREFLIGHT:"):])
    out = {}
    for name, _, layers, per_param in CH05_PREFLIGHTS:
        r = reports[name]
        n = get_model("llama-3.1-405b",
                      **({"num_layers": layers} if layers else {})
                      ).num_params()
        want = per_param * n / r["n_devices"]
        rel = abs(r["per_device_total_bytes"] - want) / want
        check(r["lowered"], f"preflight {name}: the step did not run")
        check(rel <= CH05_PREFLIGHT_REL, f"preflight {name}: "
              f"{r['per_device_total_bytes']} bytes a GPU, the recipe's "
              f"{per_param} B a parameter gives {want:.0f}: rel {rel}")
        out[name] = {
            "n_devices": r["n_devices"], "mesh": r["mesh"],
            "params_gb": r["per_device_param_bytes"] / 1e9,
            "opt_state_gb": r["per_device_opt_state_bytes"] / 1e9,
            "grads_gb": r["per_device_grad_bytes_transient"] / 1e9,
            "total_gb": r["per_device_total_bytes"] / 1e9,
            "recipe_gb": want / 1e9, "rel_to_recipe": rel,
            "limit_gb": r["device_bytes_limit"] / 1e9,
            "limit_source": r["device_bytes_limit_source"],
            "fits": r["fits"], "optimizer_on_meta": r["optimizer_on_meta"],
            "largest_leaf_fp32_gb": r["largest_leaf_fp32_bytes"] / 1e9,
            "comm": {k: r["comm"][k] for k in (
                "per_collective_bytes_per_chip", "t_compute_s", "t_comm_s",
                "mfu_ceiling_overlapped", "mfu_ceiling_serial", "target",
                "figures")}}
        log(phase="chapter05", part="preflight", run=name, card=card,
            **out[name])
    # the post colocation under fsdp 8: the policy's per-device bytes an
    # eighth of fsdp 1's (its norms, replicated, the difference), the
    # engine's copy and pool whole
    post = {w: reports[f"post_colocation_fsdp{w}"] for w in (1, 8)}
    share = {k: post[8][k] / post[1][k] for k in (
        "policy_param_bytes", "policy_opt_state_bytes")}
    check(all(abs(v - 1 / 8) <= CH05_PREFLIGHT_REL / 8
              for v in share.values())
          and post[8]["engine_param_bytes"] == post[1]["engine_param_bytes"]
          and post[8]["engine_pool_bytes"] == post[1]["engine_pool_bytes"],
          f"preflight post colocation: fsdp 8 against fsdp 1 {share}, "
          f"{post}")
    out["post_colocation_fsdp8"] = {
        "total_gb": post[8]["total_bytes"] / 1e9,
        "policy_gb": (post[8]["policy_param_bytes"]
                      + post[8]["policy_opt_state_bytes"]
                      + post[8]["policy_grad_bytes_transient"]) / 1e9,
        "fsdp1_total_gb": post[1]["total_bytes"] / 1e9,
        "policy_share_of_fsdp1": share}
    log(phase="chapter05", part="preflight", run="post-colocation-fsdp8",
        card=card, **out["post_colocation_fsdp8"])
    check(not out["1gpu-1layer-fp32-adamw"]["fits"]
          and out["1gpu-1layer-bf16-adafactor"]["fits"],
          f"preflight: one 405B layer should not fit under fp32 AdamW and "
          f"should under bf16 + adafactor: {out}")
    return out


def _rss_anon() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("RssAnon"):
                return int(line.split()[1]) * 1024
    return -1


def ch05_convert(hf_dir: Path, conv: Path, name: str) -> dict:
    """``c05_convert_llama`` with this process's anonymous RSS sampled
    every 5 ms: the peak over the baseline, seconds, GB/s."""
    import threading

    from distributed_training_guide_tpu_torch.chapters import (
        c05_convert_llama)

    baseline = _rss_anon()
    peak = [baseline]
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            peak[0] = max(peak[0], _rss_anon())
            time.sleep(0.005)

    t = threading.Thread(target=sample, daemon=True)
    t.start()
    t0 = time.perf_counter()
    try:
        c05_convert_llama.main([str(hf_dir), str(conv), name])
    finally:
        stop.set()
        t.join()
    seconds = time.perf_counter() - t0
    read = sum(p.stat().st_size for p in hf_dir.glob("*.safetensors"))
    written = sum(p.stat().st_size for p in conv.glob("*.npy"))
    return {"seconds": seconds, "read_gb": read / 1e9,
            "written_gb": written / 1e9, "read_gb_per_s": read / 1e9 / seconds,
            "written_gb_per_s": written / 1e9 / seconds,
            "rss_anon_peak_delta_gb": (peak[0] - baseline) / 1e9}


def ch05_first_batch(torch, name: str) -> dict:
    """The first batch ``run_training`` gives ``CH05_ARGS`` (its loader's,
    rebuilt)."""
    from distributed_training_guide_tpu_torch.data import (
        BatchLoader, get_tokenizer, load_and_preprocess_data)

    data = load_and_preprocess_data(
        "synthetic:400000", get_tokenizer(name), 2048,
        max_position_embeddings=CH05_HF_CONFIG["max_position_embeddings"],
        seed=SEED)
    loader = BatchLoader(data, 2, device="cuda", seed=SEED)
    return next(loader.epoch_batches())


def ch05_weights(torch, root: Path, card: str) -> dict:
    """(a): llama-3.2-1b as an HF checkpoint in 3+ shards -> converted ->
    loaded with ``--pretrained`` under fsdp -> 3 steps -> a checkpoint ->
    the export CLI -> reloaded by transformers."""
    import transformers

    from distributed_training_guide_tpu_torch.chapters import c05_llama405b
    from distributed_training_guide_tpu_torch.models import (get_model,
                                                             hf_export)
    from distributed_training_guide_tpu_torch.models.auto import (
        config_from_hf)
    from distributed_training_guide_tpu_torch.models.llama import PRESETS

    hf_dir, conv, exported = root / "hf", root / "conv", root / "exported"
    torch.manual_seed(SEED)
    with torch.device("cuda"):
        model = transformers.LlamaForCausalLM(
            transformers.LlamaConfig(**CH05_HF_CONFIG))
    model = model.to(torch.bfloat16).eval()
    t0 = time.perf_counter()
    model.save_pretrained(hf_dir, safe_serialization=True,
                          max_shard_size="400MB")
    save_s = time.perf_counter() - t0
    shards = sorted(p.name for p in hf_dir.glob("*.safetensors"))
    check(len(shards) >= 3, f"chapter05: {len(shards)} safetensors shards")
    name = f"hf:{hf_dir}"
    _, cfg = config_from_hf(hf_dir)
    preset = PRESETS["llama-3.2-1b"]
    check(all(getattr(cfg, f) == getattr(preset, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_heads",
        "num_kv_heads", "rope_theta", "rope_scaling",
        "tie_word_embeddings", "rms_norm_eps"))
        and cfg.num_layers == CH05_HF_CONFIG["num_hidden_layers"],
        f"chapter05: hf: config {cfg} differs from llama-3.2-1b's")
    batch = ch05_first_batch(torch, name)
    with torch.no_grad():
        hf_loss = float(model(batch["input_ids"],
                              labels=batch["labels"]).loss)
    del model
    torch.cuda.empty_cache()

    convert = ch05_convert(hf_dir, conv, name)
    log(phase="chapter05", part="convert", card=card, shards=len(shards),
        hf_save_s=save_s, **convert)

    reset_flash_counts()                      # this path starts here
    out = with_env(plan_env(), lambda: c05_llama405b.main(
        ["-m", name, "--pretrained", str(conv), "--max-steps",
         str(CH05_STEPS), "-e", "ch05", "--save-dir", str(root),
         "--ckpt-freq", str(CH05_STEPS), "--optimizer", "adafactor"]
        + CH05_ARGS))
    torch.cuda.synchronize()
    launches = flash_counts()                 # ... and ends here
    losses = [i["running_loss"] for i in out["infos"]]
    rel = abs(losses[0] - hf_loss) / abs(hf_loss)
    check(len(losses) == CH05_STEPS and all(map(math.isfinite, losses)),
          f"chapter05: losses {losses}")
    check(rel <= CH05_HF_LOSS_REL, f"chapter05: the step-1 loss "
          f"{losses[0]} after --pretrained, transformers' {hf_loss} on the "
          f"same batch: rel {rel}")
    check(launches == {k: CH05_HF_CONFIG["num_hidden_layers"] * CH05_STEPS
                       for k in launches},
          f"chapter05: launches {launches}")
    params = out["state"].params
    load_s = out["pretrained_load_s"]
    saves = out["checkpoint_saves"]
    ch01_free(torch, out)

    t0 = time.perf_counter()
    hf_export.main(["-m", name, "-e", str(root / "ch05"), "-o",
                    str(exported), "--optimizer", "adafactor"])
    export_s = time.perf_counter() - t0
    back = transformers.AutoModelForCausalLM.from_pretrained(
        exported, dtype=torch.float32).cuda().eval()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    ids = torch.randint(0, 259, (1, 512), device="cuda", generator=gen)
    bundle = get_model(name, dtype=torch.float32)
    with torch.no_grad():
        theirs = back(ids).logits.float()
        ours = bundle.apply(bundle.config, params, ids)
    scale = float(theirs.abs().max())
    err = float((ours - theirs).abs().max())
    check(err <= CH05_EXPORT_LOGIT_REL * scale, f"chapter05: exported "
          f"logits {err} off the port's (max logit {scale})")
    del back, params, theirs, ours
    torch.cuda.empty_cache()
    result = {"hf_loss": hf_loss, "losses": losses, "loss_rel": rel,
              "export_logit_max_abs_err": err, "export_max_logit": scale,
              "convert_s": convert["seconds"], "load_s": load_s,
              "export_s": export_s, "save_s": [s.get("write_s")
                                               for s in saves],
              "launches": launches, "shards": len(shards)}
    log(phase="chapter05", part="weights", card=card, **result)
    return result


def ch05_layer(torch, card: str, predicted: dict) -> dict:
    """(c): one full-width llama-3.1-405b layer trained on the card, and
    K1-K3 at its attention shape."""
    from distributed_training_guide_tpu_torch.chapters import c05_llama405b
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa

    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()                      # this path starts here
    copies = fa.ALIGN_COPIES
    out = with_env(plan_env(), lambda: c05_llama405b.main(
        CH05_405B_TRAIN + ["--max-steps", str(CH05_405B_STEPS)],
        model_overrides={"num_layers": 1}))
    torch.cuda.synchronize()
    launches = flash_counts()                 # ... and ends here
    check_hopper_path("chapter05 405b layer", copies)
    want = {"flash_fwd": 2 * CH05_405B_STEPS, "flash_dq": CH05_405B_STEPS,
            "flash_dkv": CH05_405B_STEPS}
    check(launches == want, f"chapter05 405b layer: launches {launches}, "
          f"want {want} (remat all: K1 twice a layer)")
    infos = out["infos"]
    losses = [i["running_loss"] for i in infos]
    check(len(losses) == CH05_405B_STEPS and all(map(math.isfinite,
                                                     losses)),
          f"chapter05 405b layer: losses {losses}")
    later = infos[1:]
    pred = predicted["1gpu-1layer-bf16-adafactor"]
    result = {"losses": losses, "launches": launches,
              "launches_per_step": {k: v // CH05_405B_STEPS
                                    for k, v in launches.items()},
              "tokens_per_s": sum(i["tokens_per_s"] for i in later)
              / len(later),
              "mfu": sum(i["mfu"] for i in later) / len(later),
              "step_ms": sum(i["time/step"] for i in later) / len(later),
              "peak_alloc_gb": out["last_info"]["peak_alloc_gb"],
              "predicted_state_gb": pred["total_gb"],
              "predicted_largest_leaf_fp32_gb":
                  pred["largest_leaf_fp32_gb"]}
    ch01_free(torch, out)
    log(phase="chapter05", part="405b-layer", card=card, batch=1, seq=4096,
        **result)
    result["kernels"] = ch05_flash(torch, card)
    return result


def ch05_flash(torch, card: str) -> dict:
    """K1-K3 at the 405B attention shape against their plain versions
    (bf16 bound and the kernels' own arithmetic), then timed beside their
    bounds and SDPA (``flash_timing_at``, K3's causal tail with it)."""
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa

    b, s, hq, hkv, d = CH05_405B_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    q, k, v, do = flash_case(torch, gen, b, s, s, hq, hkv, d, "bf16")
    counts = (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v)
    ro, rlse = fa.flash_attention_reference(q, k, v)
    delta = torch.einsum("bshd,bshd->bhs", do.float(),
                         ro.float()).contiguous()
    args = (q, k, v, do, rlse, delta)
    got = dict(zip(("dq", "dk", "dv"), fa.flash_bwd_with_stats(*args)))
    fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES = counts
    errs = {"o": rel_l2(o, ro)}
    ao, _ = fa.flash_attention_reference(q, k, v, round_p=True)
    arith = {"o": rel_l2(o, ao)}
    del ao, ro
    torch.cuda.empty_cache()
    plain = dict(zip(("dq", "dk", "dv"), fa.flash_bwd_reference(*args)))
    errs.update({key: rel_l2(got[key], plain[key]) for key in plain})
    del plain
    torch.cuda.empty_cache()
    arith["dq"] = rel_l2(got["dq"], fa.flash_dq_reference(
        *args, round_p_ds=True))
    dk, dv = fa.flash_dkv_reference(*args, round_p_ds=True)
    arith.update(dk=rel_l2(got["dk"], dk), dv=rel_l2(got["dv"], dv))
    check(max(errs.values()) <= FLASH_TOL_BF16_REL_L2
          and max(arith.values()) <= FLASH_TOL_KERNEL_ARITH_REL_L2,
          f"chapter05: K1-K3 at the 405B shape: rel L2 {errs}, at their "
          f"arithmetic {arith}")
    del q, k, v, do, o, lse, delta, got, dk, dv, args
    torch.cuda.empty_cache()
    timing = flash_timing_at(torch, *CH05_405B_SHAPE)
    log(phase="chapter05", part="flash-405b", card=card,
        B_S_Hq_Hkv_D=CH05_405B_SHAPE, rel_l2=errs, kernel_arith_rel_l2=arith)
    return {"rel_l2": errs, "kernel_arith_rel_l2": arith, "timing": timing}


def ch05_offload(torch, card: str) -> dict:
    """(d): llama-3.2-1b at full width cut to ``CH05_OFFLOAD_LAYERS``, 3
    steps without offload, with the optimizer state offloaded and with
    both, through chapter 05's flags."""
    from distributed_training_guide_tpu_torch.chapters import c05_llama405b

    runs = {}
    for name, flags in (("none", []), ("opt", ["--offload-opt-state"]),
                        ("both", ["--offload-opt-state",
                                  "--offload-params"])):
        reset_flash_counts()                  # this path starts here
        out = with_env(plan_env(), lambda: c05_llama405b.main(
            ["-m", "llama-3.2-1b", "--max-steps", str(CH05_STEPS)]
            + CH05_ARGS + flags,
            model_overrides={"num_layers": CH05_OFFLOAD_LAYERS}))
        torch.cuda.synchronize()
        launches = flash_counts()             # ... and ends here
        check(launches == {k: CH05_OFFLOAD_LAYERS * CH05_STEPS
                           for k in launches},
              f"chapter05 offload {name}: launches {launches}")
        state = out["state"]
        infos = out["infos"]
        if state.offload is not None:
            state.offload.wait()
        torch.cuda.synchronize()
        runs[name] = {
            "losses": [i["running_loss"] for i in infos],
            "grad_norms": [i["grad_norm"] for i in infos],
            # after the last step, the state alive: between steps
            "between_steps_gb": torch.cuda.memory_allocated() / 1e9,
            "info_curr_alloc_gb": [i["curr_alloc_gb"] for i in infos],
            "step_ms": [i["time/step"] for i in infos],
            "peak_alloc_gb": out["last_info"]["peak_alloc_gb"],
            "host_gb": (0.0 if state.offload is None
                        else state.offload.host_bytes(state) / 1e9),
            "on_host": (state.offload is None
                        or state.offload.on_host(state)),
            "launches": launches}
        ch01_free(torch, out)
        del state
        log(phase="chapter05", part="offload", run=name, card=card,
            **runs[name])
    base = runs["none"]
    for name in ("opt", "both"):
        r = runs[name]
        check(r["losses"] == base["losses"]
              and r["grad_norms"] == base["grad_norms"],
              f"chapter05 offload {name}: losses {r['losses']} / grad norms "
              f"{r['grad_norms']} against {base['losses']} / "
              f"{base['grad_norms']}: not bitwise")
        check(r["on_host"], f"chapter05 offload {name}: a tensor off the "
              f"pinned host buffers between steps")
        fell = base["between_steps_gb"] - r["between_steps_gb"]
        # the allocator rounds each tensor up to 512 bytes: < 1 MB here
        check(abs(fell - r["host_gb"]) <= 1e-3, f"chapter05 offload "
              f"{name}: between steps the card holds {fell} GB less, "
              f"{r['host_gb']} GB were offloaded")
        r["fell_gb"] = fell
    return runs


def ch05_engine(torch, root: Path, card: str, fsdp: dict) -> dict:
    """(e): the JSON engine at stage 3 on llama-3.2-1b against phase 17's
    fsdp run (chapter 04) on the same batches: bitwise."""
    from distributed_training_guide_tpu_torch.chapters import engine_llm

    config = {"model": "llama-3.2-1b", "zero_optimization": {"stage": 3},
              "train_micro_batch_size_per_gpu": 4,
              "optimizer": {"type": "AdamW", "params": {"lr": 3e-4}},
              "bf16": {"enabled": True}, "seed": SEED}
    path = root / "engine.json"
    path.write_text(json.dumps(config))
    reset_flash_counts()                      # this path starts here
    out = with_env(plan_env(), lambda: engine_llm.main(
        ["--config", str(path), "-d", "synthetic:400000", "-s", "2048",
         "--max-steps", str(PLAN_STEPS), "--log-freq", "1"]))
    torch.cuda.synchronize()
    launches = flash_counts()                 # ... and ends here
    check(launches == {k: 16 * PLAN_STEPS for k in launches},
          f"chapter05 engine: launches {launches}")
    bitwise = (out["losses"] == fsdp["losses"]
               and out["grad_norms"] == fsdp["grad_norms"])
    check(bitwise, f"chapter05 engine: losses {out['losses']} / grad norms "
          f"{out['grad_norms']}, chapter 04's fsdp {fsdp['losses']} / "
          f"{fsdp['grad_norms']}")
    result = {"strategy": out["strategy"], "losses": out["losses"],
              "grad_norms": out["grad_norms"], "bitwise_fsdp": bitwise,
              "step_ms": [i["step_ms"] for i in out["infos"]],
              "launches": launches}
    log(phase="chapter05", part="engine", card=card, **result)
    return result


def phase_chapter05(torch, card: str, plans: dict, proc=None) -> dict:
    """Phase 18; ``proc``: the preflight's process, started by the caller
    ahead of the phase (its CPU work runs beside the card's), else here."""
    import shutil
    import tempfile

    proc = proc or ch05_preflight_start()
    root = Path(tempfile.mkdtemp(prefix="ch05-"))
    launches = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}

    def count(result):
        for k, v in result["launches"].items():
            launches[k] += v
    try:
        try:
            weights = ch05_weights(torch, root, card)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        count(weights)
        preflight = ch05_preflight_finish(proc, card)
        layer = ch05_layer(torch, card, preflight)
        count(layer)
        offload = ch05_offload(torch, card)
        for r in offload.values():
            count(r)
        root.mkdir()
        engine = ch05_engine(torch, root, card, plans["results"]["fsdp"])
        count(engine)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        shutil.rmtree(root, ignore_errors=True)
    return {"weights": weights, "preflight": preflight, "layer": layer,
            "offload": offload, "engine": engine, "launches": launches}


# ---------------------------------------------------------------------------
# phase 19: the dense families, the sampler, HF round trips, LoRA and
# Gemma-2's head_dim 256
# ---------------------------------------------------------------------------

# (model, longest prompt) served with phase 7's traffic shape; (model, B, S,
# steps) trained through the CLI, full width and depth
DENSE_SERVE = (("gpt2", 900), ("pythia-1.4b", 2000))
DENSE_TRAIN = (("gpt2", 8, 1024, 8), ("pythia-1.4b", 4, 2048, 6))
DENSE_TRAIN_ARGS = ["-d", "synthetic:400000", "--lr", "3e-4", "--seed",
                    str(SEED), "--log-freq", "1"]
# K1-K3 / K4 timing shapes of the new paths: (B, S, Hq, Hkv, D), bf16
DENSE_FLASH_SHAPES = {"gpt2-train": (8, 1024, 12, 12, 64),
                      "pythia-1.4b-train": (4, 2048, 16, 16, 128)}
# gemma2-2b's attention: Hq 8, Hkv 4, D 256, softcap 50, the
# query_pre_attn_scalar scale, the 4096 window of its sliding layers
GEMMA2 = dict(hq=8, hkv=4, d=256, softcap=50.0, scale=256.0 ** -0.5,
              window=4096)
# q scaled by this in a second check of K1-K4 at gemma2-2b's shape: the
# scores' std goes from 1 to 12 and a band's largest reach ~45, where the
# cap 50 * tanh(s / 50) takes ~10 off them (an unscaled score of std 1
# never comes near the cap, so a kernel that skipped it would pass; scaled,
# the plain output without the cap lies ~0.2-0.3 in relative L2 from the
# one with it)
GEMMA2_Q_CAP_SCALE = 12.0
GEMMA2_TRAIN_LAYERS, GEMMA2_TRAIN_STEPS, GEMMA2_SEQ = 4, 3, 8192
GEMMA2_LONG_PROMPT = 6000
SAMPLER_PROMPTS, SAMPLER_STEPS = (20, 101), 32
LORA_STEPS = 4
LORA_ARGS = ["--lora-rank", "8", "--lora-targets", "wq,wv"]
# JAX's num_trainable_params for llama-3.2-1b at rank 8 on wq, wv (a
# layer: wq's A [2048, 8] and B [8, 2048], wv's A [2048, 8] and B [8, 512]);
# tests/test_torch_lora.py holds the port's count to JAX's
LORA_TRAINABLE = CH01_POLICY_LAYERS * (2048 * 8 + 8 * 2048 + 2048 * 8
                                       + 8 * 512)
# the port's fp32 loss through K1 (its FMA body) and converted weights
# against transformers' fp32 loss on the same batch: the same fp32 math,
# summed in another order
DENSE_HF_LOSS_REL = 1e-4


def dense_counts() -> dict:
    from distributed_training_guide_tpu_torch.ops import paged_decode as pd

    return {**flash_counts(), "paged_attend": pd.LAUNCHES,
            "paged_attend_split": pd.SPLIT_LAUNCHES,
            "paged_attend_mma": pd.MMA_LAUNCHES,
            "paged_attend_combine": pd.COMBINE_LAUNCHES}


def reset_dense_counts() -> None:
    from distributed_training_guide_tpu_torch.ops import paged_decode as pd

    reset_flash_counts()
    (pd.LAUNCHES, pd.SPLIT_LAUNCHES, pd.MMA_LAUNCHES,
     pd.COMBINE_LAUNCHES) = (0, 0, 0, 0)


def dense_serve_specs(np, vocab: int, longest: int, extra=()) -> list:
    """Phase 7's traffic shape: 8 requests, prompts of 17 to ``longest``
    tokens, 32 new tokens each (the last two sampled); ``extra`` adds
    prompts of those lengths."""
    rng = np.random.default_rng(SEED)
    lens = [17, longest] + [int(x) for x in rng.integers(17, longest + 1, 6)]
    lens += list(extra)
    return [dict(prompt_ids=[int(x) for x in rng.integers(0, vocab, n)],
                 max_new_tokens=32, seed=i,
                 **({"temperature": 0.8, "top_p": 0.9} if i in (6, 7)
                    else {}))
            for i, n in enumerate(lens)]


def dense_serve(torch, name: str, card: str, specs, modes, *,
                max_len: int, check_prompt: int,
                gate_logits: bool = True) -> dict:
    """``ServeEngine`` on ``name`` at full width and depth in bf16 (random
    weights from the seed) with ``specs``, in each of ``modes`` (bucketed:
    chunk None, or chunked): every request ends by length, K4 carries every
    decode step (one launch a layer) and every chunk, a greedy request
    alone equal to co-batched, TTFT / ITL / tokens/s, and the first-token
    logits of request ``check_prompt`` against the plain prefill, within
    ``LOGIT_REL_L2_BF16`` where ``gate_logits`` (gemma2-2b's random layers
    amplify bf16 rounding far past it: it is logged there, and
    ``gemma2_fp32_chunk_check`` holds the path in fp32)."""
    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.models.registry import (
        family_module)
    from distributed_training_guide_tpu_torch.ops import paged_decode as pd
    from distributed_training_guide_tpu_torch.serve import (
        Request, ServeEngine, generate_many, throughput_stats)

    class Recording(ServeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.first_logits = {}

        def _on_prefill_complete(self, adm, logit):
            self.first_logits[adm.request.request_id] = logit.float()
            return super()._on_prefill_complete(adm, logit)

    bundle = get_model(name, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    cfg = bundle.config
    params = bundle.init(cfg, SEED, device="cuda")
    vocab, layers = cfg.vocab_size, cfg.num_layers
    common = dict(n_slots=8, page_size=16, max_len=max_len)
    out, first = {}, {}
    for mode, chunk in modes:
        eng = Recording(bundle, params, prefill_chunk=chunk, **common)
        torch.cuda.reset_peak_memory_stats()
        before = pd.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = generate_many(eng, [Request(**r) for r in specs])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = pd.LAUNCHES - before
        for r in res:
            check(r.finish_reason == "length" and len(r.generated_ids) == 32
                  and all(0 <= x < vocab for x in r.generated_ids),
                  f"{name} {mode}: request {r.request_id} ended "
                  f"{r.finish_reason} after {len(r.generated_ids)} tokens")
        decode = layers * eng.decode_steps
        prefill = launches - decode
        want_prefill = 0 if chunk is None else layers * eng.programs.prefill_calls
        check(eng.decode_steps > 0 and prefill == want_prefill,
              f"{name} {mode}: {launches} K4 launches, {eng.decode_steps} "
              f"decode steps, {eng.programs.prefill_calls} prefill forwards")
        stats = throughput_stats(res, wall, eng)
        out[mode] = dict(
            wall_s=wall, tokens_per_s=stats["tokens_per_s"],
            ttft_s_p50=stats["ttft_s_p50"],
            latency_s_p50=stats["latency_s_p50"],
            itl_s_avg=eng.stats()["itl_s_avg"],
            decode_steps=eng.decode_steps,
            prefill_forwards=eng.programs.prefill_calls,
            k4_launches=launches, k4_launches_per_decode_step=decode
            / eng.decode_steps,
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        log(phase="dense", model=name, serve=mode, card=card, **out[mode])
        first[mode] = eng.first_logits[res[check_prompt].request_id]
        out[mode]["tokens"] = [r.token_ids for r in res]
        del eng
        torch.cuda.empty_cache()
    # the plain full-context prefill of the checked prompt
    mod = family_module(bundle.family)
    ids = torch.tensor([specs[check_prompt]["prompt_ids"]], device="cuda")
    cache = mod.init_cache(cfg, 1, ids.shape[1], device="cuda")
    ref = mod.prefill(cfg, params, ids, cache)[0][0].float()
    del cache
    for mode, got in first.items():
        check(bool(torch.isfinite(got).all()) and got.shape == (vocab,),
              f"{name} {mode}: first-token logits not finite / wrong shape")
        rel = ((got - ref).norm() / ref.norm()).item()
        out[mode]["first_logits_rel_l2"] = rel
        log(phase="dense", model=name, check=f"first-token logits, {mode} "
            f"vs plain prefill, bf16 full depth", prompt_tokens=ids.shape[1],
            rel_l2=rel, bound=LOGIT_REL_L2_BF16,
            argmax_equal=bool(got.argmax() == ref.argmax()))
        check(rel <= LOGIT_REL_L2_BF16 or not gate_logits,
              f"{name} {mode} first-token logits rel L2 {rel} > "
              f"{LOGIT_REL_L2_BF16}")
    mode0 = modes[0][0]
    alone = generate_many(ServeEngine(bundle, params, prefill_chunk=modes[0][1],
                                      **common), [Request(**specs[0])])[0]
    check(alone.token_ids == out[mode0]["tokens"][0],
          f"{name}: greedy request 0 alone and co-batched differ")
    for mode in out:
        out[mode].pop("tokens")
    del params, ref
    torch.cuda.empty_cache()
    return out


def gemma2_fp32_chunk_check(torch, prompt, card: str) -> dict:
    """gemma2-2b at full width cut to 2 layers (one windowed, one global)
    in fp32: the chunked engine's first-token logits for ``prompt`` (past
    the 4096 window, every chunk through K4 at head_dim 256) and the
    bucketed engine's against the plain full-context prefill, within
    ``LOGIT_REL_L2_FP32`` (only the summation order differs). At full
    depth in bf16 the comparison is only logged (``dense_serve``): the
    random layers amplify bf16 rounding far past ``LOGIT_REL_L2_BF16``."""
    from distributed_training_guide_tpu_torch.models import get_model, llama
    from distributed_training_guide_tpu_torch.serve import (
        Request, ServeEngine, generate_many)

    class First(ServeEngine):
        def _on_prefill_complete(self, adm, logit):
            self.first = logit.float()
            return super()._on_prefill_complete(adm, logit)

    bundle = get_model("gemma2-2b", dtype=torch.float32, num_layers=2)
    params = bundle.init(bundle.config, SEED, device="cuda")
    ids = torch.tensor([prompt], device="cuda")
    ref = llama.prefill(bundle.config, params, ids, llama.init_cache(
        bundle.config, 1, len(prompt), device="cuda"))[0][0].float()
    out = {}
    for mode, chunk in (("chunked", 256), ("bucketed", None)):
        eng = First(bundle, params, n_slots=1, page_size=16, max_len=8192,
                    prefill_chunk=chunk)
        generate_many(eng, [Request(prompt_ids=list(prompt),
                                    max_new_tokens=2)])
        out[mode] = ((eng.first - ref).norm() / ref.norm()).item()
        check(out[mode] <= LOGIT_REL_L2_FP32, f"gemma2 fp32 {mode}: "
              f"first-token logits rel L2 {out[mode]}")
        del eng
    log(phase="dense", check="gemma2-2b fp32, 2 layers: first-token logits "
        "vs plain prefill", prompt_tokens=len(prompt), card=card,
        bound=LOGIT_REL_L2_FP32, **out)
    del params, ref
    torch.cuda.empty_cache()
    return out


def dense_train(torch, name: str, card: str, b: int, s: int, steps: int,
                *, extra=(), overrides=None, fwd_body="wgmma") -> dict:
    """``run_training`` through the CLI parser at full width (``overrides``
    may cut depth): finite falling loss, one launch of each of K1-K3 per
    layer per step, every K1 launch through ``fwd_body`` and, for the
    Hopper bodies, no operand copied (q, k and v are read in place from
    the fused QKV projection); tokens/s, MFU and the peak."""
    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa
    from distributed_training_guide_tpu_torch.train import cli

    args = cli.get_parser().parse_args(
        ["-m", name, "-s", str(s), "-b", str(b), "--max-steps", str(steps),
         *DENSE_TRAIN_ARGS, *extra])
    before, bodies0 = flash_counts(), dict(fa.FWD_BODY_LAUNCHES)
    copies = fa.ALIGN_COPIES
    t0 = time.perf_counter()
    out = cli.run_training(args, model_overrides=overrides)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in flash_counts().items()}
    layers = (overrides or {}).get("num_layers") or get_model(
        name).config.num_layers
    want = layers * steps
    check(launches == {k: want for k in launches},
          f"{name} train: launches {launches}, want {want} of each")
    bodies = {k: v - bodies0[k] for k, v in fa.FWD_BODY_LAUNCHES.items()}
    check(bodies[fwd_body] == want, f"{name} train: K1 bodies {bodies}")
    if fwd_body == "wgmma":
        check(fa.ALIGN_COPIES == copies, f"{name} train: "
              f"{fa.ALIGN_COPIES - copies} operands copied for the tensor "
              f"maps")
    losses = [i["running_loss"] for i in out["infos"]]
    check(len(losses) == steps and all(map(math.isfinite, losses))
          and losses[-1] < losses[0], f"{name} train: losses {losses}")
    later = out["infos"][1:]
    res = dict(model=name, B=b, S=s, layers=layers, steps=steps,
               losses=losses, wall_s=wall,
               tokens_per_s=sum(i["tokens_per_s"] for i in later)
               / len(later),
               mfu=sum(i["mfu"] for i in later) / len(later),
               time_step_ms=sum(i["time/step"] for i in later) / len(later),
               peak_alloc_gb=out["last_info"]["peak_alloc_gb"],
               launches_per_step={k: v / steps for k, v in launches.items()},
               k1_launches_by_body=bodies, launches=launches)
    log(phase="dense", train=name, card=card, **res)
    ch01_free(torch, out)
    return res


def fused_qkv_check(torch, card: str) -> dict:
    """K1-K3 at the training shapes of gpt2 and pythia-1.4b (causal MHA,
    bf16) on q, k and v sliced from one fused [B, S, 3, H * D] projection,
    the layout the gpt2 and neox forwards hand them: against their plain
    versions (relative L2 within ``FLASH_TOL_BF16_REL_L2``, lse within
    ``FLASH_TOL_FP32``) and at the kernels' own arithmetic
    (``FLASH_TOL_KERNEL_ARITH_REL_L2``, with a second launch bitwise
    equal), and bitwise equal to the same launches on contiguous copies,
    with no operand copied for the tensor maps."""
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa

    out = {}
    counts = (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    for i, (name, (b, s, h, _, d)) in enumerate(DENSE_FLASH_SHAPES.items()):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 19 + i)
        qkv = torch.randn(b, s, 3, h * d, generator=gen, device="cuda").to(
            torch.bfloat16)
        q, k, v = (qkv[:, :, j].reshape(b, s, h, d) for j in range(3))
        do = torch.randn(b, s, h, d, generator=gen, device="cuda").to(
            torch.bfloat16)
        copies = fa.ALIGN_COPIES
        o, lse = fa.flash_fwd(q, k, v)
        ro, rlse = fa.flash_attention_reference(q, k, v)
        delta = torch.einsum("bshd,bshd->bhs", do.float(),
                             ro.float()).contiguous()
        dq, dk, dv = fa.flash_bwd_with_stats(q, k, v, do, rlse, delta)
        strided_copies = fa.ALIGN_COPIES - copies
        errs = {}
        for key, got, want in (
                ("o", o, ro),
                ("dq", dq, fa.flash_dq_reference(q, k, v, do, rlse, delta)),
                *zip(("dk", "dv"), (dk, dv), fa.flash_dkv_reference(
                    q, k, v, do, rlse, delta))):
            check(got.shape == want.shape and got.dtype == want.dtype
                  and bool(torch.isfinite(got.float()).all()),
                  f"{name} {key}: {got.shape} {got.dtype} vs {want.shape} "
                  f"{want.dtype}, or non-finite")
            errs[key] = ((got.float() - want.float()).norm()
                         / want.float().norm()).item()
            check(errs[key] <= FLASH_TOL_BF16_REL_L2, f"{name} flash {key}: "
                  f"{errs[key]} from the plain version > "
                  f"{FLASH_TOL_BF16_REL_L2}")
        errs["lse_max_abs"] = (lse - rlse).abs().max().item()
        check(errs["lse_max_abs"] <= FLASH_TOL_FP32["lse"],
              f"{name} flash lse: {errs['lse_max_abs']}")
        del ro
        arith = check_kernel_arith(torch, fa, name,
                                   (q, k, v, do, rlse, delta), {},
                                   (dq, dk, dv))
        if fa._fwd_plan(d, q.dtype) == "wgmma":
            arith["o"] = check_fwd_arith(torch, fa, name, (q, k, v), {},
                                         (o, lse))
        qc, kc, vc = (x.contiguous() for x in (q, k, v))
        want = (*fa.flash_fwd(qc, kc, vc),
                *fa.flash_bwd_with_stats(qc, kc, vc, do, rlse, delta))
        torch.cuda.synchronize()
        equal = {key: torch.equal(g, w) for key, g, w in zip(
            ("o", "lse", "dq", "dk", "dv"), (o, lse, dq, dk, dv), want)}
        log(phase="dense", check="K1-K3 on fused-QKV slices vs plain and "
            "vs contiguous copies", shape=name, B=b, S=s, Hq=h, Hkv=h, D=d,
            dtype="bf16", card=card, strides=list(q.stride()),
            rel_l2=errs, bound=FLASH_TOL_BF16_REL_L2,
            kernel_arith_rel_l2=arith,
            kernel_arith_bound=FLASH_TOL_KERNEL_ARITH_REL_L2,
            bitwise_contiguous=equal, alignment_copies=strided_copies)
        check(all(equal.values()) and strided_copies == 0,
              f"{name} fused QKV slices: bitwise {equal}, copies "
              f"{strided_copies}")
        out[name] = dict(rel_l2=errs, kernel_arith_rel_l2=arith,
                         bitwise_contiguous=equal)
        del qkv, q, k, v, do, qc, kc, vc, o, lse, rlse, delta, dq, dk, dv
        del want
        torch.cuda.empty_cache()
    # checking launches are not main-path launches
    fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES = counts
    return out


def banded_pairs(b: int, hq: int, sq: int, window) -> int:
    """Live (query, key) pairs of a causal self-attention over ``sq``
    tokens whose keys lie within ``window`` of the query."""
    w = sq if window is None else min(window, sq)
    return b * hq * (w * (w + 1) // 2 + (sq - w) * w)


def gemma2_flash_errors(torch, fa, q, k, v, do, kw, lse_bound) -> dict:
    """K1-K3 at gemma2-2b's shape against their plain versions: o, dq, dk
    and dv in relative L2 (``FLASH_TOL_BF16_REL_L2``), lse within
    ``lse_bound``, and dq, dk and dv at the kernels' own arithmetic
    (``FLASH_TOL_KERNEL_ARITH_REL_L2``). Returns the errors, the kernel's
    lse and the plain forward's delta."""
    bodies = dict(fa.FWD_BODY_LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    check(fa.FWD_BODY_LAUNCHES["wmma"] == bodies["wmma"] + 1,
          "gemma2: K1 did not run the WMMA body")
    ro, rlse = fa.flash_attention_reference(q, k, v, **kw)
    delta = torch.einsum("bshd,bshd->bhs", do.float(), ro.float()).contiguous()
    dq, dk, dv = fa.flash_bwd_with_stats(q, k, v, do, rlse, delta, **kw)
    rdq = fa.flash_dq_reference(q, k, v, do, rlse, delta, **kw)
    rdk, rdv = fa.flash_dkv_reference(q, k, v, do, rlse, delta, **kw)
    errs = {}
    for key, got, want in (("o", o, ro), ("dq", dq, rdq), ("dk", dk, rdk),
                           ("dv", dv, rdv)):
        check(bool(torch.isfinite(got.float()).all()), f"gemma2 {key}: "
              f"non-finite")
        errs[key] = rel_l2(got, want)
        check(errs[key] <= FLASH_TOL_BF16_REL_L2, f"gemma2 flash {key}: "
              f"{errs[key]} > {FLASH_TOL_BF16_REL_L2}")
    errs["lse_max_abs"] = (lse - rlse).abs().max().item()
    check(errs["lse_max_abs"] <= lse_bound,
          f"gemma2 flash lse: {errs['lse_max_abs']} > {lse_bound}")
    del ro, rdq, rdk, rdv
    errs["kernel_arith_rel_l2"] = check_kernel_arith(
        torch, fa, "gemma2", (q, k, v, do, rlse, delta), kw, (dq, dk, dv))
    del o, dq, dk, dv, rlse
    torch.cuda.empty_cache()
    return errs, lse, delta


def gemma2_flash(torch, card: str) -> dict:
    """K1, K2 and K3 at gemma2-2b's training shape (B 1, S 8192, Hq 8, Hkv
    4, D 256, bf16, causal, softcap 50, scale 256**-0.5, window 4096: the
    WMMA bodies) against their plain versions (``gemma2_flash_errors``)
    on q as drawn and on q scaled by ``GEMMA2_Q_CAP_SCALE``, where the
    softcap moves the output (its plain version without the cap is logged
    and checked to lie far outside the bound), then timed beside their
    plain versions, their bounds (the banded pairs only) and SDPA with the
    band as a mask and no softcap (SDPA has none)."""
    import torch.nn.functional as F

    from distributed_training_guide_tpu_torch.ops import flash_attention as fa

    g = GEMMA2
    b, s = 1, GEMMA2_SEQ
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    q, k, v, do = flash_case(torch, gen, b, s, s, g["hq"], g["hkv"], g["d"],
                             "bf16")
    kw = dict(window=g["window"], softcap=g["softcap"], scale=g["scale"])
    counts = (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    qcap = (q.float() * GEMMA2_Q_CAP_SCALE).to(q.dtype)
    # the fp32 rounding of a score grows with its size: the scaled case's
    # lse bound scales with q
    errs_cap, _, _ = gemma2_flash_errors(
        torch, fa, qcap, k, v, do, kw,
        FLASH_TOL_FP32["lse"] * GEMMA2_Q_CAP_SCALE)
    no_cap = {**kw, "softcap": None}
    errs_cap["plain_without_softcap_rel_l2"] = rel_l2(
        fa.flash_attention_reference(qcap, k, v, **no_cap)[0],
        fa.flash_attention_reference(qcap, k, v, **kw)[0])
    check(errs_cap["plain_without_softcap_rel_l2"]
          > 10 * FLASH_TOL_BF16_REL_L2, f"gemma2 flash: the softcap moves "
          f"the scaled case's output by only "
          f"{errs_cap['plain_without_softcap_rel_l2']}")
    del qcap
    torch.cuda.empty_cache()
    errs, lse, delta = gemma2_flash_errors(torch, fa, q, k, v, do, kw,
                                           FLASH_TOL_FP32["lse"])
    errs["q_scaled"] = errs_cap
    args = (q, k, v, do, lse, delta)
    calls = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, **kw),
             "flash_dq": lambda: fa.flash_bwd_dq(*args, **kw),
             "flash_dkv": lambda: fa.flash_bwd_dkv(*args, **kw)}
    plains = {"flash_fwd": lambda: fa.flash_attention_reference(q, k, v, **kw),
              "flash_dq": lambda: fa.flash_dq_reference(*args, **kw),
              "flash_dkv": lambda: fa.flash_dkv_reference(*args, **kw)}
    out = {}
    for name, fn in calls.items():
        out[name] = {"ms": queued_ms(torch, fn, 5),
                     "plain_ms": cuda_ms(plains[name], iters=2, warmup=1)}
        torch.cuda.empty_cache()
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    pos = torch.arange(s, device="cuda")
    band = ((pos[:, None] >= pos[None, :])
            & (pos[:, None] - pos[None, :] < g["window"]))

    def sdpa():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=band, scale=g["scale"], enable_gqa=True)

    with torch.no_grad():
        fwd_ms = queued_ms(torch, sdpa, 5)
    both_ms = queued_ms(torch, lambda: torch.autograd.grad(
        sdpa(), (qt, kt, vt), dot), 5)
    fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES = counts
    pairs = banded_pairs(b, g["hq"], s, g["window"])
    qb = b * s * g["hq"] * g["d"] * 2
    kvb = b * s * g["hkv"] * g["d"] * 2
    stat = b * g["hq"] * s * 4
    work = {"flash_fwd": (4 * g["d"] * pairs, 2 * qb + 2 * kvb + stat),
            "flash_dq": (6 * g["d"] * pairs, 3 * qb + 2 * kvb + 2 * stat),
            "flash_dkv": (8 * g["d"] * pairs, 2 * qb + 4 * kvb + 2 * stat)}
    for name, (flops, nbytes) in work.items():
        out[name].update(_bound(nbytes, flops, "bfloat16"))
        out[name]["share_of_bound"] = out[name]["bound_ms"] / out[name]["ms"]
        out[name]["library_ms"] = (fwd_ms if name == "flash_fwd"
                                   else both_ms - fwd_ms)
        out[name]["library_note"] = (
            "SDPA with the band as a boolean mask and no softcap"
            + ("" if name == "flash_fwd" else "; forward+backward minus "
               "forward: dq, dk and dv together"))
        out[name]["body"] = "wmma"
        log(phase="dense", gemma2_flash=name, B=b, S=s, Hq=g["hq"],
            Hkv=g["hkv"], D=g["d"], window=g["window"], softcap=g["softcap"],
            dtype="bf16", card=card, **out[name])
    log(phase="dense", check="gemma2 K1-K3 vs plain (bf16 rel L2)",
        bound=FLASH_TOL_BF16_REL_L2,
        kernel_arith_bound=FLASH_TOL_KERNEL_ARITH_REL_L2,
        q_cap_scale=GEMMA2_Q_CAP_SCALE, **errs)
    del q, k, v, do, lse, delta, qt, kt, vt, dot, band
    torch.cuda.empty_cache()
    return {"timing": out, "errors": errs}


def k4_check(torch, pd, plan, q, kp, vp, tables, lens, kw) -> dict:
    """K4 on one input held as phase 1 holds it, at the body's own
    arithmetic: its partials against ``split_partials_reference`` (m, l
    and acc / l within ``PART_M_ABS``, ``PART_L_REL`` and
    ``PART_ACC_REL_L2``), the bf16 output within ``OUT_BF16_ULPS`` of the
    fp32 combine of those partials; and the whole call against
    ``paged_attend_reference`` in relative L2 (``FLASH_TOL_BF16_REL_L2``:
    the tensor-core body rounds p / l to bf16 for P V, ~5e-3 per row at
    worst, and both round the output to bf16). Returns the errors."""
    got = pd.paged_flash_attend(q, kp, vp, tables, lens, **kw)
    want = pd.paged_attend_reference(q, kp, vp, tables, lens, **kw)
    check(got.shape == q.shape and got.dtype == q.dtype
          and bool(torch.isfinite(got.float()).all()),
          f"K4 output {got.shape} {got.dtype}, or non-finite")
    parts = pd.split_partials(q, kp, vp, tables, lens, **kw)
    perr = partials_err(torch, parts, pd.split_partials_reference(
        q.float() if plan.body == "split" else q, kp, vp, tables, lens,
        pages_per_split=plan.pages_per_split, **kw))
    errs = dict(rel_l2=rel_l2(got, want),
                max_abs_err=(got.float() - want.float()).abs().max().item(),
                partials=perr, out_ulps=bf16_ulps(
                    torch, got, pd.combine_partials_reference(*parts)))
    ok = dict(call=errs["rel_l2"] <= FLASH_TOL_BF16_REL_L2,
              m=perr["m_abs"] <= PART_M_ABS, l=perr["l_rel"] <= PART_L_REL,
              acc=perr["acc_rel_l2"] <= PART_ACC_REL_L2[plan.body],
              out=errs["out_ulps"] <= OUT_BF16_ULPS)
    check(all(ok.values()), f"K4 {errs}; failed: "
          f"{[key for key, v in ok.items() if not v]}")
    return errs


def dense_k4_timing(torch, card: str) -> dict:
    """K4 at gpt2's decode (8 slots at context 1024, Hq = Hkv = 12, D 64:
    one live row in the split body's four), pythia-1.4b's (8 slots at
    context 2048, Hq = Hkv = 16, D 128) and gemma2-2b's (8 slots at
    context 6000, Hq 8, Hkv 4, D 256, softcap 50, window 4096), bf16 pools
    of page 16: each held to its plain version by ``k4_check`` (gemma2's
    also on q scaled by ``GEMMA2_Q_CAP_SCALE``, where the softcap bites),
    timed beside the plain version, SDPA over a contiguous cache and the
    bound (the pages inside each row's band read once)."""
    import torch.nn.functional as F

    from distributed_training_guide_tpu_torch.ops import paged_decode as pd

    dev = torch.device("cuda")
    counts = (pd.LAUNCHES, pd.SPLIT_LAUNCHES, pd.MMA_LAUNCHES,
              pd.COMBINE_LAUNCHES)
    out = {}
    for name, s, ctx, hq, hkv, d, kw in (
            ("gpt2-decode", 8, 1024, 12, 12, 64, {}),
            ("pythia-1.4b-decode", 8, 2048, 16, 16, 128, {}),
            ("gemma2-decode", 8, GEMMA2_LONG_PROMPT, GEMMA2["hq"],
             GEMMA2["hkv"], GEMMA2["d"],
             dict(window=GEMMA2["window"], softcap=GEMMA2["softcap"],
                  scale=GEMMA2["scale"]))):
        m = -(-ctx // PAGE)
        tables = (torch.arange(s * m, dtype=torch.int32, device=dev)
                  .reshape(s, m) + 1)
        tables = tables[:, torch.randperm(m, device=dev)].contiguous()
        lengths = [ctx - 1] * s
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        kp = torch.randn(s * m + 1, PAGE, hkv, d, device=dev,
                         dtype=torch.bfloat16)
        vp = torch.randn_like(kp)
        q = torch.randn(s, 1, hq, d, device=dev, dtype=torch.bfloat16)
        plan = pd._plan(1, hq // hkv, d, q.dtype, kp.dtype, m)
        errs = k4_check(torch, pd, plan, q, kp, vp, tables, lens, kw)
        if "softcap" in kw:
            qcap = (q.float() * GEMMA2_Q_CAP_SCALE).to(q.dtype)
            errs["q_scaled"] = k4_check(torch, pd, plan, qcap, kp, vp,
                                        tables, lens, kw)
            errs["q_scaled"]["plain_without_softcap_rel_l2"] = rel_l2(
                pd.paged_attend_reference(qcap, kp, vp, tables, lens,
                                          **{**kw, "softcap": None}),
                pd.paged_attend_reference(qcap, kp, vp, tables, lens, **kw))
            check(errs["q_scaled"]["plain_without_softcap_rel_l2"]
                  > 10 * FLASH_TOL_BF16_REL_L2, f"{name}: the softcap moves "
                  f"the scaled case's output by only {errs['q_scaled']}")
            del qcap
        body = f"paged_attend_{plan.body}"
        dev_ms = device_ms(torch, lambda: pd.paged_flash_attend(
            q, kp, vp, tables, lens, **kw), 50,
            (body, "paged_attend_combine"),
            parts=k4_parts(torch, pd, plan, body, q, kp, vp, tables, lens,
                           **kw))
        ms = dev_ms[body] + dev_ms["paged_attend_combine"]
        plain_ms = cuda_ms(lambda: pd.paged_attend_reference(
            q, kp, vp, tables, lens, **kw), iters=5, warmup=1)
        kc = kp[tables.long()].reshape(s, m * PAGE, hkv, d)[:, :ctx]
        vc = vp[tables.long()].reshape(s, m * PAGE, hkv, d)[:, :ctx]
        kc, vc = (x.transpose(1, 2).contiguous() for x in (kc, vc))
        qc = q.transpose(1, 2).contiguous()
        mask = None
        if "window" in kw:     # [1, ctx]: the decode row's band
            mask = (torch.arange(ctx, device=dev)
                    > ctx - 1 - kw["window"])[None, :]
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qc, kc, vc, attn_mask=mask, scale=kw.get("scale"),
            enable_gqa=True), iters=50)
        band = min(ctx, kw.get("window", ctx))
        pages = s * (-(-band // PAGE) + 1)
        nbytes = pages * PAGE * hkv * d * 2 * 2 + 2 * q.numel() * 2 + s * 4
        bound = _bound(nbytes, 4 * d * hq * s * band, "bfloat16")
        out[name] = dict(S=s, T=1, heads=[hq, hkv], D=d, context=ctx,
                         dtype="bf16", plan=plan._asdict(),
                         live_rows=hq // hkv, rows=plan.rows, ms=ms,
                         body_ms=dev_ms[body],
                         combine_ms=dev_ms["paged_attend_combine"],
                         plain_ms=plain_ms, library_ms=lib_ms,
                         library_note="SDPA over a contiguous cache"
                         + (" with the window as a mask, no softcap"
                            if "window" in kw else ""),
                         max_abs_err=errs["max_abs_err"], errors=errs,
                         error_bounds=dict(
                             rel_l2=FLASH_TOL_BF16_REL_L2, m_abs=PART_M_ABS,
                             l_rel=PART_L_REL,
                             acc_rel_l2=PART_ACC_REL_L2[plan.body],
                             out_ulps=OUT_BF16_ULPS),
                         timed_by=dev_ms["timed_by"], **bound,
                         share_of_bound=bound["bound_ms"] / ms, **kw)
        log(phase="dense", k4=name, card=card, **out[name])
        del kp, vp, kc, vc, q, qc
        torch.cuda.empty_cache()
    (pd.LAUNCHES, pd.SPLIT_LAUNCHES, pd.MMA_LAUNCHES,
     pd.COMBINE_LAUNCHES) = counts    # timing launches are not main path
    return out


def dense_sampler(torch, card: str) -> dict:
    """``models/sample.py`` on gpt2 in fp32 (random weights from the seed):
    for two prompts of 32 steps, the greedy tokens of the kv_cache mode
    (the engine, K4 on every step) equal the recompute mode's."""
    import numpy as np

    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.models import sample
    from distributed_training_guide_tpu_torch.ops import paged_decode as pd

    bundle = get_model("gpt2", dtype=torch.float32)
    params = bundle.init(bundle.config, SEED, device="cuda")
    rng = np.random.default_rng(SEED + 21)
    res = []
    for n in SAMPLER_PROMPTS:
        prompt = [int(x) for x in rng.integers(0, bundle.config.vocab_size, n)]
        before = pd.LAUNCHES
        t0 = time.perf_counter()
        cached = sample.make_sampler(bundle, kv_cache=True)(
            params, prompt, SAMPLER_STEPS)
        cached_s = time.perf_counter() - t0
        k4 = pd.LAUNCHES - before
        t0 = time.perf_counter()
        full = sample.make_sampler(bundle)(params, prompt, SAMPLER_STEPS)
        full_s = time.perf_counter() - t0
        check(cached == full and len(full) == n + SAMPLER_STEPS,
              f"sampler: prompt {n}: kv_cache and recompute tokens differ")
        check(k4 >= bundle.config.num_layers * (SAMPLER_STEPS - 1),
              f"sampler: {k4} K4 launches")
        res.append(dict(prompt=n, steps=SAMPLER_STEPS, equal=True,
                        k4_launches=k4, kv_cache_s=cached_s,
                        recompute_s=full_s))
        log(phase="dense", sampler="gpt2 fp32 greedy", card=card, **res[-1])
    del params
    torch.cuda.empty_cache()
    return {"prompts": res}


def dense_hf(torch, root: Path, card: str) -> dict:
    """``transformers`` builds GPT2LMHeadModel (gpt2's card) and a
    GPTNeoXForCausalLM (pythia-160m's card) in process with random weights;
    each is saved, converted (``models/hf_convert.py``), loaded on the card,
    its fp32 loss on a batch held to transformers' within
    ``DENSE_HF_LOSS_REL``, exported (``models/hf_export.py``) and reloaded
    by transformers, whose fp32 logits are held to the port's within
    ``CH05_EXPORT_LOGIT_REL`` of the largest (phase 18's bound)."""
    import transformers

    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.models.hf_convert import (
        convert_hf_checkpoint, load_pretrained)
    from distributed_training_guide_tpu_torch.models.hf_export import (
        export_hf_checkpoint)
    from distributed_training_guide_tpu_torch.ops.cross_entropy import (
        causal_lm_loss)

    torch.manual_seed(SEED)
    with torch.device("cuda"):
        models = {
            "gpt2": transformers.GPT2LMHeadModel(transformers.GPT2Config()),
            "pythia-160m": transformers.GPTNeoXForCausalLM(
                transformers.GPTNeoXConfig(
                    vocab_size=50304, hidden_size=768,
                    intermediate_size=3072, num_hidden_layers=12,
                    num_attention_heads=12, max_position_embeddings=2048,
                    tie_word_embeddings=False))}
    out = {}
    for name, model in models.items():
        model = model.float().eval()
        hf, conv, exp = (root / f"{name}-{x}" for x in ("hf", "conv", "out"))
        model.save_pretrained(hf, safe_serialization=True)
        bundle = get_model(f"hf:{hf}", dtype=torch.float32)
        same_config = bundle.config == get_model(
            name, dtype=torch.float32).config
        convert_hf_checkpoint(hf, conv, bundle=bundle)
        params = load_pretrained(bundle, None, conv, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
        ids = torch.randint(0, bundle.config.vocab_size, (2, 256),
                            generator=gen, device="cuda")
        with torch.no_grad():
            theirs = float(model(ids, labels=ids).loss)
            ours = float(causal_lm_loss(
                bundle.apply(bundle.config, params, ids), ids))
        loss_rel = abs(ours - theirs) / abs(theirs)
        check(loss_rel <= DENSE_HF_LOSS_REL, f"{name}: port loss {ours} vs "
              f"transformers {theirs}")
        export_hf_checkpoint(bundle, params, exp)
        back = transformers.AutoModelForCausalLM.from_pretrained(
            exp, dtype=torch.float32).cuda().eval()
        check(type(back) is type(model), f"{name}: reloaded as {type(back)}")
        with torch.no_grad():
            got = back(ids).logits.float()
            want = bundle.apply(bundle.config, params, ids)
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        check(err <= CH05_EXPORT_LOGIT_REL * scale, f"{name}: exported "
              f"logits {err} off the port's (max logit {scale})")
        out[name] = dict(loss_port=ours, loss_transformers=theirs,
                         loss_rel=loss_rel, export_logit_max_abs_err=err,
                         export_max_logit=scale, params=bundle.num_params(),
                         hf_config_equals_preset=same_config)
        log(phase="dense", hf_round_trip=name, card=card,
            transformers=transformers.__version__, **out[name])
        del model, back, params, got, want
        torch.cuda.empty_cache()
    return out


def dense_lora(torch, card: str, ch01: dict) -> dict:
    """``--lora-rank 8 --lora-targets wq,wv`` on llama-3.2-1b at phase
    16's ``CH01_POLICY_LAYERS`` layers with phase 8's batch, 4 steps: the
    step-1 loss bitwise phase 16's fp32 run's (B starts at zero), the
    optimizer holding only the adapters (JAX's ``num_trainable_params``),
    a launch of each of K1-K3 a layer and step, the peak and the
    optimizer-state bytes beside the full run's."""
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa
    from distributed_training_guide_tpu_torch.train.optimizer import (
        state_slots)

    copies = fa.ALIGN_COPIES
    before = flash_counts()                   # ch01_run resets the counts
    out, counts = ch01_run(torch, ["--max-steps", str(LORA_STEPS),
                                   *LORA_ARGS], layers=CH01_POLICY_LAYERS)
    check_hopper_path("lora", copies)
    fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES = (
        before[k] + counts[k] for k in ("flash_fwd", "flash_dq",
                                        "flash_dkv"))
    check(all(counts[k] == CH01_POLICY_LAYERS * LORA_STEPS for k in (
        "flash_fwd", "flash_dq", "flash_dkv")), f"lora: launches {counts}")
    losses = ch01_losses(out)
    vals = [losses[s] for s in sorted(losses)]
    base_step1 = ch01["precision"]["fp32"]["losses"][0]
    check(vals[0] == base_step1, f"lora: step-1 loss {vals[0]}, the base "
          f"run's {base_step1}")
    check(all(map(math.isfinite, vals)), f"lora: losses {vals}")
    state = out["state"]
    opt = state.opt_state.optimizer
    held = [p for g in opt.param_groups for p in g["params"]]
    trainable = sum(p.numel() for p in held)
    check(trainable == LORA_TRAINABLE, f"lora: {trainable} trainable, "
          f"want {LORA_TRAINABLE}")
    opt_bytes = sum(t.numel() * t.element_size() for p in held
                    for t in state_slots(opt, p).values())
    res = dict(losses=vals, trainable_params=trainable,
               optimizer_state_gb=opt_bytes / 1e9, **ch01_rates(out),
               full_run_peak_gb=ch01["precision"]["fp32"]["peak_alloc_gb"],
               launches=counts)
    log(phase="dense", lora="llama-3.2-1b r8 wq,wv", card=card, **res)
    ch01_free(torch, out)
    return res


def phase_dense(torch, card: str, ch01: dict) -> dict:
    import shutil
    import tempfile

    import numpy as np

    res = {"fused_qkv": fused_qkv_check(torch, card)}
    reset_dense_counts()                      # the main paths start here
    serve = {}
    for name, longest in DENSE_SERVE:
        from distributed_training_guide_tpu_torch.models import get_model

        vocab = get_model(name).config.vocab_size
        serve[name] = dense_serve(
            torch, name, card, dense_serve_specs(np, vocab, longest),
            (("bucketed", None), ("chunked", 256)),
            max_len=min(2048, get_model(name).config.max_position_embeddings),
            check_prompt=1)
    train = {name: dense_train(torch, name, card, b, s, steps)
             for name, b, s, steps in DENSE_TRAIN}
    res["sampler"] = dense_sampler(torch, card)
    root = Path(tempfile.mkdtemp(prefix="dense-hf-"))
    try:
        res["hf"] = dense_hf(torch, root, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["lora"] = dense_lora(torch, card, ch01)
    gemma_vocab = 256000
    gemma_specs = dense_serve_specs(np, gemma_vocab, 2000,
                                    extra=(GEMMA2_LONG_PROMPT,))
    serve["gemma2-2b"] = dense_serve(
        torch, "gemma2-2b", card, gemma_specs, (("chunked", 256),),
        max_len=8192, check_prompt=8, gate_logits=False)
    serve["gemma2-2b"]["fp32_2_layers"] = gemma2_fp32_chunk_check(
        torch, gemma_specs[8]["prompt_ids"], card)
    train["gemma2-2b"] = dense_train(
        torch, "gemma2-2b", card, 1, GEMMA2_SEQ, GEMMA2_TRAIN_STEPS,
        overrides={"num_layers": GEMMA2_TRAIN_LAYERS}, fwd_body="wmma")
    launches = dense_counts()                 # ... and end here
    for k in ("flash_fwd", "flash_dq", "flash_dkv", "paged_attend",
              "paged_attend_split", "paged_attend_combine"):
        check(launches[k] > 0, f"dense families: {k} never launched: "
              f"{launches}")
    res.update(serve=serve, train=train, launches=launches,
               flash_timing={name: flash_timing_at(torch, *shape)
                             for name, shape in DENSE_FLASH_SHAPES.items()},
               gemma2_flash=gemma2_flash(torch, card),
               k4_timing=dense_k4_timing(torch, card))
    log(phase="dense", launches=launches)
    return res


# ---------------------------------------------------------------------------
# phase 20: context and pipeline parallelism (chapters 08 and 09)
# ---------------------------------------------------------------------------

CP = 4                               # virtual ring / Ulysses members
NEG_INF_KERNELS = -1e30              # K1's lse of a row with no live key
RING_HEADS = (32, 8, 64)             # llama-3.2-1b's attention: Hq, Hkv, D
RING_CHECK_SEQ = 4096                # held against the plain version
RING_LONG_SEQ = 32768                # chapter 08's long context
RING_BAND_SEQ = 16384                # gemma2-2b's banded ring
# llama-3.1-8b's attention on a rank of tp 4: cp 4 does not divide its kv
# heads, so Ulysses gathers q, k and v and runs the whole sequence
ULYSSES_GATHERED_HEADS = (8, 2, 128)
# the ring's merged lse against the plain version's fp32 lse at S 4096 (the
# bf16 rows' bound), and against whole-sequence K1's at S 32768, where lse
# reaches ~11 and both sides carry a bf16 kernel's rounding (~40 ulps)
RING_LSE_ABS = {RING_CHECK_SEQ: FLASH_TOL_FP32["lse"], RING_LONG_SEQ: 5e-5,
                RING_BAND_SEQ: 5e-5}
PP_MODEL = "llama-3.2-1b"
PP_LAYERS = 4              # full width cut to 4 layers (the time limit)
PP_STAGES = (2, 4)
PP_BATCH = 8
PP_SEQ = 2048
# the pipeline's loss and grads against the single-device forward and
# backward on each microbatch, averaged: the same kernels on the same
# microbatches, the forward recomputed bitwise, the head's 1/M a power of
# two; only the fp32 order of the grad sums over ticks differs (the tied
# embedding's head and embed parts). Read on an H100: the loss bitwise,
# the grads within 5.6e-9; a bf16 accumulation over microbatches would
# miss these by orders of magnitude
PP_LOSS_REL = 1e-6
PP_GRAD_REL_L2 = 1e-6
# the timed K1-K3 calls of this phase's paths: (B, Sq, Sk, Hq, Hkv, D,
# causal, band (window, q_off, k_off) or None, scale, softcap)
CP_PP_TIMING_SHAPES = {
    # chunks of S 32768 at cp 4: 4096 rows each
    "ring-past": (1, 4096, 4096, 32, 8, 64, False, None, None, None),
    "ring-diagonal": (1, 4096, 4096, 32, 8, 64, True, None, None, None),
    "ring-band": (1, 2048, 2048, 8, 4, 256, True, (4096, 10240, 6144),
                  1 / 16, 50.0),
    "pp-microbatch": (2, PP_SEQ, PP_SEQ, 32, 8, 64, True, None, None, None),
}


def ring_members(torch, fn, *xs) -> list:
    """Each whole-sequence tensor [B, S, ...] as CP sequence shards, and a
    ``LocalExchange`` of CP members: ``fn(ex, *shards)``."""
    from distributed_training_guide_tpu_torch.ops.collectives import (
        LocalExchange)

    return fn(LocalExchange(CP), *(list(torch.chunk(x, CP, dim=1))
                                  for x in xs))


def ring_run(torch, q, k, v, do, **kw) -> dict:
    """The ring over CP virtual members, forward and backward through the
    autograd op (the training path), with the K1-K3 launches of the run;
    then its sequence-layout lse (a second forward, not counted)."""
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa
    from distributed_training_guide_tpu_torch.ops import ring_attention as ra

    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    copies = fa.ALIGN_COPIES
    reset_flash_counts()                      # the ring's path starts here
    outs = ring_members(torch, lambda ex, *sh: ra.ring_attention(
        ex, *sh, **kw), *leaves)
    o = torch.cat(outs, dim=1)
    grads = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    counts = flash_counts()                   # ... and ends here
    check(fa.ALIGN_COPIES == copies, f"ring: {fa.ALIGN_COPIES - copies} "
          f"operands copied for the tensor maps")
    with torch.no_grad():
        lse = torch.cat(ring_members(torch, lambda ex, *sh: ra.ring_forward(
            ex, *sh, **kw)[1], q, k, v), dim=1)
    return {"o": o.detach(), "grads": grads, "lse": lse, "counts": counts}


def ring_errors(torch, got: dict, want: tuple, lse_bound: float) -> dict:
    """o / dq / dk / dv in relative L2 and lse in max abs against ``want``
    (o, lse [B, H, S], dq, dk, dv)."""
    o, lse, dq, dk, dv = want
    errs = {key: rel_l2(g, w) for key, g, w in
            zip(("o", "dq", "dk", "dv"), (got["o"], *got["grads"]),
                (o, dq, dk, dv))}
    for key, err in errs.items():
        check(err <= FLASH_TOL_BF16_REL_L2, f"ring {key}: {err} > "
              f"{FLASH_TOL_BF16_REL_L2}")
    live = lse > NEG_INF_KERNELS / 2
    errs["lse"] = (got["lse"].transpose(1, 2) - lse).abs()[live].max().item()
    check(errs["lse"] <= lse_bound, f"ring lse: {errs['lse']} > "
          f"{lse_bound}")
    return errs


def whole_sequence(torch, q, k, v, do, plain: bool, **kw) -> tuple:
    """(o, lse, dq, dk, dv) over the whole sequence: the plain versions, or
    K1-K3 (their launches not counted: a comparison, not a path)."""
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa

    counts = (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    if plain:
        o, lse = fa.flash_attention_reference(q, k, v, **kw)
    else:
        o, lse = fa.flash_fwd(q, k, v, **kw)
    delta = torch.einsum("bshd,bshd->bhs", do.float(), o.float()).contiguous()
    grads = (fa.flash_bwd_reference if plain else fa.flash_bwd_with_stats)(
        q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES = counts
    return (o, lse, *grads)


def wall_and_device_ms(torch, fn, iters: int) -> dict:
    """A call's wall milliseconds (CUDA events around calls issued back to
    back: the host's issue time where it is the longer), its device
    milliseconds (the sum over its kernels of ``_kernel_ms``: each
    kernel's mean per recorded launch times its launches per call; a call
    of ~1000 launches fills the launch queue, so ``queued_ms`` cannot run
    ahead of it) and the device's idle share of the wall time; "not
    measured" where the profiler recorded nothing. The K1-K3 launches of
    the timing runs are not counted."""
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa

    counts = flash_counts()
    wall = cuda_ms(fn, iters=iters, warmup=1)
    kernels = _kernel_ms(torch, fn, iters)
    fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES = (
        counts["flash_fwd"], counts["flash_dq"], counts["flash_dkv"])
    if not kernels:
        return {"wall_ms": wall, "device_ms": "not measured"}
    dev = sum(kernels.values())
    return {"wall_ms": wall, "device_ms": dev,
            "idle_share": max(0.0, 1 - dev / wall),
            "distinct_kernels": len(kernels)}


def ring_times(torch, q, k, v, do) -> dict:
    """The ring's forward and backward over CP members (through the
    autograd op) beside one whole-sequence attention's (K1-K3 through
    ``flash_attention``): the same live pairs, so the difference is the
    ring's merges, relayouts and launches."""
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa
    from distributed_training_guide_tpu_torch.ops import ring_attention as ra

    def ring_step():
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        o = torch.cat(ring_members(torch, lambda ex, *sh: ra.ring_attention(
            ex, *sh), *leaves), dim=1)
        torch.autograd.grad(o, leaves, do)

    def whole_step():
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        torch.autograd.grad(fa.flash_attention(*leaves), leaves, do)

    ring = wall_and_device_ms(torch, ring_step, 3)
    whole = wall_and_device_ms(torch, whole_step, 3)
    return {"ring_fwd_bwd": ring, "whole_sequence_fwd_bwd": whole}


def cp_ring(torch, card: str) -> dict:
    """The ring at CP virtual members on llama-3.2-1b's attention (bf16,
    causal): at S 4096 against the plain version, at S 32768 against
    whole-sequence K1-K3, cp (2 cp + 1) launches of each kernel; and
    gemma2-2b's banded ring at S 16384 (q as drawn and x 12), whose pairs
    below the band issue no launch."""
    from distributed_training_guide_tpu_torch.ops import ring_attention as ra

    hq, hkv, d = RING_HEADS
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    want_launches = ra.live_pairs(CP)
    out = {"launches": {k: 0 for k in ("flash_fwd", "flash_dq",
                                       "flash_dkv")}}
    for s in (RING_CHECK_SEQ, RING_LONG_SEQ):
        q, k, v, do = flash_case(torch, gen, 1, s, s, hq, hkv, d, "bf16")
        got = ring_run(torch, q, k, v, do)
        check(got["counts"] == {n: want_launches for n in got["counts"]},
              f"ring S {s}: launches {got['counts']}, want {want_launches} "
              f"of each (cp (2cp + 1))")
        want = whole_sequence(torch, q, k, v, do, plain=s == RING_CHECK_SEQ)
        errs = ring_errors(torch, got, want, RING_LSE_ABS[s])
        out[f"S{s}"] = {"against": "plain" if s == RING_CHECK_SEQ
                        else "whole-sequence K1-K3",
                        "launches": got["counts"], **errs}
        if s == RING_LONG_SEQ:
            for n, c in got["counts"].items():
                out["launches"][n] += c
            out[f"S{s}"].update(ring_times(torch, q, k, v, do))
        log(phase="cp_pp", part="ring", S=s, cp=CP, Hq=hq, Hkv=hkv, D=d,
            card=card, **out[f"S{s}"])
        del q, k, v, do, got, want
        torch.cuda.empty_cache()
    g = GEMMA2
    s = RING_BAND_SEQ
    s_c = s // (2 * CP)
    kw = dict(window=g["window"], scale=g["scale"], softcap=g["softcap"])
    band_launches = ra.live_pairs(CP, True, g["window"], s_c)
    check(band_launches < want_launches, "ring band: no pair below the band")
    q0, k, v, do = flash_case(torch, gen, 1, s, s, g["hq"], g["hkv"], g["d"],
                              "bf16")
    for c in (1.0, GEMMA2_Q_CAP_SCALE):
        q = (q0.float() * c).to(q0.dtype)
        got = ring_run(torch, q, k, v, do, **kw)
        check(got["counts"] == {n: band_launches for n in got["counts"]},
              f"ring band: launches {got['counts']}, want {band_launches} "
              f"of each (_pair_live)")
        for n, cnt in got["counts"].items():
            out["launches"][n] += cnt
        want = whole_sequence(torch, q, k, v, do, plain=False, causal=True,
                              **kw)
        errs = ring_errors(torch, got, want, RING_LSE_ABS[s] * c)
        out[f"band-x{c:g}"] = {"launches": got["counts"],
                               "dead_pairs_skipped":
                                   want_launches - band_launches, **errs}
        log(phase="cp_pp", part="ring-band", S=s, cp=CP, q_scale=c,
            window=g["window"], softcap=g["softcap"], card=card,
            against="whole-sequence K1-K3", **out[f"band-x{c:g}"])
        del got, want
    del q0, k, v, do
    torch.cuda.empty_cache()
    return out


def cp_ulysses(torch, card: str) -> dict:
    """Ulysses at CP virtual members on llama-3.2-1b's attention at S 32768
    (8 kv heads: 2 a member): one K1 launch a member, on the full sequence
    of its heads, against whole-sequence K1."""
    from distributed_training_guide_tpu_torch.ops import ulysses_attention as ul

    hq, hkv, d = RING_HEADS
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    q, k, v, _ = flash_case(torch, gen, 1, RING_LONG_SEQ, RING_LONG_SEQ, hq,
                            hkv, d, "bf16")
    reset_flash_counts()                      # Ulysses' path starts here
    with torch.no_grad():
        outs = ring_members(torch, lambda ex, *sh: ul.ulysses_members(
            ex, *sh, impl="flash"), q, k, v)
    torch.cuda.synchronize()
    counts = flash_counts()                   # ... and ends here
    check(counts["flash_fwd"] == CP, f"ulysses: {counts['flash_fwd']} K1 "
          f"launches, want {CP} (one a member)")
    o = torch.cat(outs, dim=1)
    whole = whole_sequence(torch, q, k, v, torch.zeros_like(q),
                           plain=False)[0]
    res = {"launches": counts, "bitwise": bool(torch.equal(o, whole)),
           "rel_l2": rel_l2(o, whole),
           "max_abs": (o.float() - whole.float()).abs().max().item()}
    check(res["rel_l2"] <= FLASH_TOL_BF16_REL_L2, f"ulysses: {res}")
    log(phase="cp_pp", part="ulysses", S=RING_LONG_SEQ, cp=CP, card=card,
        against="whole-sequence K1 on the same heads", **res)
    del q, k, v, outs, o, whole
    torch.cuda.empty_cache()
    res["gathered"] = cp_ulysses_gathered(torch, card, gen)
    res["launches"] = {n: c + res["gathered"]["launches"][n]
                       for n, c in counts.items()}
    return res


def cp_ulysses_gathered(torch, card: str, gen) -> dict:
    """Ulysses where cp does not divide the kv heads: llama-3.1-8b's
    attention on a tp-4 rank (ULYSSES_GATHERED_HEADS) at S 32768 over CP
    virtual members under impl 'auto' (the Trainer's). q, k and v are
    gathered, each member runs K1-K3 on the whole sequence and keeps its
    rows, forward and backward, against whole-sequence K1-K3; then its
    wall and device times beside one whole-sequence K1-K3 pass."""
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa
    from distributed_training_guide_tpu_torch.ops import ulysses_attention as ul

    hq, hkv, d = ULYSSES_GATHERED_HEADS
    check(hkv % CP != 0, "ulysses gathered: cp divides the kv heads")
    q, k, v, do = flash_case(torch, gen, 1, RING_LONG_SEQ, RING_LONG_SEQ, hq,
                             hkv, d, "bf16")
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    reset_flash_counts()                      # the gathered path starts here
    o = torch.cat(ring_members(torch, lambda ex, *sh: ul.ulysses_members(
        ex, *sh, impl="auto"), *leaves), dim=1)
    grads = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    counts = flash_counts()                   # ... and ends here
    check(counts == {n: CP for n in counts}, f"ulysses gathered: launches "
          f"{counts}, want {CP} of each (one whole sequence a member)")
    o_w, _, *grads_w = whole_sequence(torch, q, k, v, do, plain=False)
    res = {"launches": counts, "o_bitwise": bool(torch.equal(o, o_w)),
           **{key: rel_l2(g, w) for key, g, w in zip(
               ("o", "dq", "dk", "dv"), (o, *grads), (o_w, *grads_w))}}
    for key in ("o", "dq", "dk", "dv"):
        check(res[key] <= FLASH_TOL_BF16_REL_L2, f"ulysses gathered {key}: "
              f"{res[key]} > {FLASH_TOL_BF16_REL_L2}")
    del leaves, o, grads, o_w, grads_w

    def gathered_step():
        lv = [x.detach().requires_grad_() for x in (q, k, v)]
        o = torch.cat(ring_members(torch, lambda ex, *sh: ul.ulysses_members(
            ex, *sh, impl="auto"), *lv), dim=1)
        torch.autograd.grad(o, lv, do)

    def whole_step():
        lv = [x.detach().requires_grad_() for x in (q, k, v)]
        torch.autograd.grad(fa.flash_attention(*lv), lv, do)

    res["times"] = {
        "gathered_fwd_bwd": wall_and_device_ms(torch, gathered_step, 3),
        "whole_sequence_fwd_bwd": wall_and_device_ms(torch, whole_step, 3)}
    log(phase="cp_pp", part="ulysses-gathered", S=RING_LONG_SEQ, cp=CP,
        Hq=hq, Hkv=hkv, D=d, card=card, against="whole-sequence K1-K3",
        **res)
    del q, k, v, do
    torch.cuda.empty_cache()
    return res


def cp_pipeline(torch, card: str) -> dict:
    """The 1F1B pipeline over pp 2 and pp 4 virtual stages on llama-3.2-1b
    at full width cut to ``PP_LAYERS`` (bf16 compute, fp32 params; B 8, S
    2048, M =
    2 pp) against the single-device forward and backward of each
    microbatch, averaged: the loss, every grad, the K1-K3 launches (K1
    twice per layer and microbatch: the stage's forward recomputed), the
    step time and the memory held beyond what was allocated before (the
    grads and activations) beside the single device's."""
    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.ops.cross_entropy import (
        causal_lm_loss)
    from distributed_training_guide_tpu_torch.parallel.pipeline import (
        make_pipeline_value_and_grad)
    from distributed_training_guide_tpu_torch.train.state import named_leaves

    bundle = get_model(PP_MODEL, num_layers=PP_LAYERS)
    cfg = bundle.config
    layers = cfg.num_layers
    params = bundle.init(cfg, SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    ids = torch.randint(0, cfg.vocab_size, (PP_BATCH, PP_SEQ), generator=gen,
                        device="cuda")
    leaves = dict(named_leaves(params))
    out = {"launches": {k: 0 for k in ("flash_fwd", "flash_dq",
                                       "flash_dkv")}}

    def extra_peak_gb(base: int) -> float:
        """The memory a run held beyond what was allocated before it."""
        return (torch.cuda.max_memory_allocated() - base) / 1e9

    for pp in PP_STAGES:
        m_count = 2 * pp
        mb = PP_BATCH // m_count
        vag = make_pipeline_value_and_grad(bundle, pp=pp, attn_impl="flash")
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_flash_counts()                  # the pipeline's path starts
        t0 = time.perf_counter()
        loss, grads = vag(params, {"input_ids": ids, "labels": ids})
        torch.cuda.synchronize()
        pp_ms = (time.perf_counter() - t0) * 1e3
        counts = flash_counts()               # ... and ends here
        pp_peak = extra_peak_gb(base)
        want = {"flash_fwd": 2 * layers * m_count,
                "flash_dq": layers * m_count, "flash_dkv": layers * m_count}
        check(counts == want, f"pipeline pp {pp}: launches {counts}, want "
              f"{want}")
        for n, c in counts.items():
            out["launches"][n] += c
        # the single device: each microbatch's forward and backward, its
        # loss / M, the grads summed in fp32 .grad
        for t in leaves.values():
            t.requires_grad_(True)
            t.grad = None
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        ref_loss = torch.zeros((), device="cuda")
        for m in range(m_count):
            rows = ids[m * mb:(m + 1) * mb]
            mb_loss = causal_lm_loss(bundle.apply(cfg, params, rows,
                                                  attn_impl="flash"),
                                     rows) / m_count
            mb_loss.backward()
            ref_loss += mb_loss.detach()
        torch.cuda.synchronize()
        ref_ms = (time.perf_counter() - t0) * 1e3
        ref_peak = extra_peak_gb(base)
        ref = {p: t.grad for p, t in leaves.items()}
        for t in leaves.values():
            t.grad = None
            t.requires_grad_(False)
        loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        got = dict(named_leaves(grads))
        grad_rel = {p: rel_l2(got[p], ref[p]) for p in ref}
        worst = max(grad_rel, key=grad_rel.get)
        check(loss_rel <= PP_LOSS_REL, f"pipeline pp {pp}: loss "
              f"{float(loss)} against {float(ref_loss)}: rel {loss_rel}")
        check(grad_rel[worst] <= PP_GRAD_REL_L2, f"pipeline pp {pp}: "
              f"{worst} grad {grad_rel[worst]} from the single device's")
        batch = {"input_ids": ids, "labels": ids}

        def single_step():
            for t in leaves.values():
                t.grad = None
            for m in range(m_count):
                rows = ids[m * mb:(m + 1) * mb]
                (causal_lm_loss(bundle.apply(cfg, params, rows,
                                             attn_impl="flash"), rows)
                 / m_count).backward()

        times = {"pipeline": wall_and_device_ms(
            torch, lambda: vag(params, batch), 2)}
        for t in leaves.values():
            t.requires_grad_(True)
        times["single_device"] = wall_and_device_ms(torch, single_step, 2)
        for t in leaves.values():
            t.grad = None
            t.requires_grad_(False)
        res = {"M": m_count, "microbatch": mb, "launches": counts,
               "times": times,
               "loss": float(loss), "single_loss": float(ref_loss),
               "loss_rel": loss_rel,
               "loss_bitwise": float(loss) == float(ref_loss),
               "grad_max_rel_l2": grad_rel[worst], "grad_worst": worst,
               "grads_bitwise": all(torch.equal(got[p], ref[p].float())
                                    for p in ref),
               "step_ms": pp_ms, "single_ms": ref_ms,
               "extra_peak_gb": pp_peak, "single_extra_peak_gb": ref_peak,
               "params_gb": sum(t.numel() * t.element_size()
                                for t in leaves.values()) / 1e9}
        out[f"pp{pp}"] = res
        log(phase="cp_pp", part="pipeline", pp=pp, B=PP_BATCH, S=PP_SEQ,
            layers=layers, card=card, **res)
        del grads, got, ref, loss, ref_loss
        torch.cuda.empty_cache()
    del params, leaves
    torch.cuda.empty_cache()
    return out


CHUNKS = 8                 # --loss-chunks under cp and pp
CP_CHUNK_MEMBERS = 4
# the fused loss's values against the whole loss: fp32 sums of the same
# products in another order
CHUNK_LOSS_REL = 1e-5
# its grads: dh is bf16 (one ulp apart where a GEMM tiled otherwise rounds
# a row another way), dW an fp32 sum over other chunks
CHUNK_GRAD_REL_L2 = 1e-2


def cp_pp_chunks(torch, card: str) -> dict:
    """``--loss-chunks 8`` under pp 2 and the cp-4 shards, on
    llama-3.2-1b at full width cut to ``PP_LAYERS`` (B 8, S 2048):
    (i) the 1F1B pipeline over 2 virtual stages with the fused loss on its
    last stage against the same pipeline's whole loss: the loss, every
    grad, K1-K3's launches; (ii) the fused loss as the cp plan runs it on
    4 contiguous sequence shards of the model's final hidden states, each
    against its targets shifted before the sharding, the (nll, count)
    pairs summed: the loss and the grads of the hidden states and the head
    against the whole-sequence loss."""
    from distributed_training_guide_tpu_torch.data.loader import (
        seq_shard, shift_targets)
    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.models.llama import (
        output_weights)
    from distributed_training_guide_tpu_torch.ops.cross_entropy import (
        causal_lm_loss, fused_linear_cross_entropy)
    from distributed_training_guide_tpu_torch.ops.matmul import (
        matmul_f32_out)
    from distributed_training_guide_tpu_torch.parallel.pipeline import (
        make_pipeline_value_and_grad)
    from distributed_training_guide_tpu_torch.train.state import named_leaves

    bundle = get_model(PP_MODEL, num_layers=PP_LAYERS)
    cfg = bundle.config
    params = bundle.init(cfg, SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    ids = torch.randint(0, cfg.vocab_size, (PP_BATCH, PP_SEQ), generator=gen,
                        device="cuda")
    batch = {"input_ids": ids, "labels": ids}
    out = {"launches": {k: 0 for k in ("flash_fwd", "flash_dq",
                                       "flash_dkv")}}
    runs = {}
    for chunks in (0, CHUNKS):
        vag = make_pipeline_value_and_grad(bundle, pp=2, attn_impl="flash",
                                           loss_chunks=chunks)
        reset_flash_counts()                  # the pipeline's path starts
        loss, grads = vag(params, batch)
        torch.cuda.synchronize()
        counts = flash_counts()               # ... and ends here
        want = {"flash_fwd": 2 * PP_LAYERS * 4, "flash_dq": PP_LAYERS * 4,
                "flash_dkv": PP_LAYERS * 4}
        check(counts == want, f"pp 2 loss_chunks {chunks}: launches "
              f"{counts}, want {want}")
        if chunks:
            for n, c in counts.items():
                out["launches"][n] += c
        runs[chunks] = (float(loss), dict(named_leaves(grads)))
    (l0, g0), (l8, g8) = runs[0], runs[CHUNKS]
    rel = abs(l8 - l0) / abs(l0)
    grad_rel = {p: rel_l2(g8[p], g0[p]) for p in g0}
    worst = max(grad_rel, key=grad_rel.get)
    check(rel <= CHUNK_LOSS_REL and grad_rel[worst] <= CHUNK_GRAD_REL_L2,
          f"pp 2 loss_chunks {CHUNKS}: loss {l8} against {l0} (rel {rel}), "
          f"{worst} grad rel L2 {grad_rel[worst]}")
    out["pp2"] = {"loss": l8, "whole_loss": l0, "loss_rel": rel,
                  "grad_max_rel_l2": grad_rel[worst], "grad_worst": worst,
                  "launches": counts}
    log(phase="cp_pp", part="loss chunks pp 2", chunks=CHUNKS,
        layers=PP_LAYERS, card=card, **out["pp2"])
    del runs, g0, g8, grads
    torch.cuda.empty_cache()
    with torch.no_grad():
        hidden = bundle.apply(cfg, params, ids, attn_impl="flash",
                              return_hidden=True)
    w = output_weights(cfg, params).detach()
    cp = CP_CHUNK_MEMBERS

    def whole():
        h = hidden.clone().requires_grad_()
        wt = w.clone().requires_grad_()
        loss = causal_lm_loss(matmul_f32_out(h, wt), ids)
        return (float(loss), *torch.autograd.grad(loss, [h, wt]))

    def shards():
        h = hidden.clone().requires_grad_()
        wt = w.clone().requires_grad_()
        targets = shift_targets(ids)
        nll = cnt = 0
        for r in range(cp):
            n, c = fused_linear_cross_entropy(
                seq_shard(h.transpose(1, 2), r, cp).transpose(1, 2), wt,
                seq_shard(targets, r, cp), num_chunks=CHUNKS, shifted=True)
            nll, cnt = nll + n, cnt + c
        loss = nll / cnt
        return (float(loss), *torch.autograd.grad(loss, [h, wt]))

    want, got = whole(), shards()
    res = {"loss": got[0], "whole_loss": want[0],
           "loss_rel": abs(got[0] - want[0]) / abs(want[0]),
           "dh_rel_l2": rel_l2(got[1], want[1]),
           "dw_rel_l2": rel_l2(got[2], want[2]), "members": cp}
    check(res["loss_rel"] <= CHUNK_LOSS_REL
          and max(res["dh_rel_l2"], res["dw_rel_l2"]) <= CHUNK_GRAD_REL_L2,
          f"cp {cp} loss_chunks {CHUNKS}: {res}")
    out["cp4"] = res
    log(phase="cp_pp", part="loss chunks on cp-4 shards", chunks=CHUNKS,
        card=card, **res)
    del params, hidden, w, want, got
    torch.cuda.empty_cache()
    return out


def cp_pp_chapters(torch, card: str, plans: dict) -> dict:
    """Chapters 08 and 09 through their ``main`` at world 1 (cp 1, pp 1)
    on phase 17's model and batch, against phase 17's single plan."""
    base = TRAIN_ARGS + ["--max-steps", str(PLAN_STEPS), "--log-freq", "1"]
    out = {"launches": {}}
    for name, chapter, flags in (
            ("c08", "c08_context_parallel", []),
            ("c09", "c09_pipeline_parallel", ["--pipeline-parallel", "1"])):
        run, counts = plan_run(torch, chapter, base + flags)
        summary = plan_summary(run)
        ch01_free(torch, run)
        want = {k: 16 * PLAN_STEPS for k in counts}
        check(counts == want, f"chapter {name}: launches {counts}, want "
              f"{want}")
        for k, v in counts.items():
            out["launches"][k] = out["launches"].get(k, 0) + v
        out[name] = {**summary, **plan_compare(name, summary,
                                               plans["single"])}
        log(phase="cp_pp", part="chapter", chapter=chapter, card=card,
            launches=counts, **out[name])
    return out


def cp_pp_timing(torch, card: str) -> dict:
    """K1-K3 at the ring's chunk-pair shapes (a past pair non-causal, a
    diagonal pair, gemma2-2b's banded pair) and the pipeline's microbatch,
    each beside its plain version, its bound and SDPA on the same pair
    (non-causal, causal, the band as a boolean mask: SDPA has no softcap)."""
    import torch.nn.functional as F

    from distributed_training_guide_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    out = {}
    counts = (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    for shape, (b, sq, sk, hq, hkv, d, causal, band, scale,
                cap) in CP_PP_TIMING_SHAPES.items():
        q, k, v, do = flash_case(torch, gen, b, sq, sk, hq, hkv, d, "bf16")
        kw = dict(causal=causal, scale=scale, softcap=cap)
        if band is not None:
            kw["band"] = band
        live = fa._live(sq, sk, causal, band or (fa.NO_WINDOW, 0, 0),
                        q.device)
        pairs = b * hq * (sq * sk if live is None else int(live.sum()))
        o, lse = fa.flash_fwd(q, k, v, **kw)
        delta = torch.einsum("bshd,bshd->bhs", do.float(),
                             o.float()).contiguous()
        args = (q, k, v, do, lse, delta)
        calls = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, **kw),
                 "flash_dq": lambda: fa.flash_bwd_dq(*args, **kw),
                 "flash_dkv": lambda: fa.flash_bwd_dkv(*args, **kw)}
        plain = {"flash_fwd": lambda: fa.flash_attention_reference(q, k, v,
                                                                   **kw),
                 "flash_dq": lambda: fa.flash_dq_reference(*args, **kw),
                 "flash_dkv": lambda: fa.flash_dkv_reference(*args, **kw)}
        res = {name: {"ms": queued_ms(torch, fn, 10),
                      "plain_ms": cuda_ms(plain[name], iters=3, warmup=1)}
               for name, fn in calls.items()}
        torch.cuda.empty_cache()
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        mask = live if band is not None else None

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None, scale=scale,
                enable_gqa=True)

        def both():
            return torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

        with torch.no_grad():
            fwd_ms = queued_ms(torch, sdpa, 10)
        both_ms = queued_ms(torch, both, 10)
        res["flash_fwd"]["library_ms"] = fwd_ms
        for name in ("flash_dq", "flash_dkv"):
            res[name]["library_ms"] = both_ms - fwd_ms
            res[name]["library_note"] = ("SDPA forward+backward minus "
                                         "forward: dq, dk and dv together")
        if cap:
            for r in res.values():
                r["library_note"] = (r.get("library_note", "SDPA forward")
                                     + "; the band as a boolean mask and no "
                                     "softcap (SDPA has none)")
        for name, bound in pair_bounds(b, sq, sk, hq, hkv, d, 2,
                                       pairs).items():
            res[name].update(bound)
            res[name]["share_of_bound"] = bound["bound_ms"] / res[name]["ms"]
            res[name]["body"] = (fa._fwd_plan if name == "flash_fwd"
                                 else fa._bwd_plan)(d, q.dtype)
            log(phase="cp_pp_timing", shape=shape, kernel=name, B=b, Sq=sq,
                Sk=sk, Hq=hq, Hkv=hkv, D=d, causal=causal, band=band,
                live_pairs=pairs, card=card, **res[name])
        out[shape] = {"B_Sq_Sk_Hq_Hkv_D": (b, sq, sk, hq, hkv, d),
                      "causal": causal, "band": band, "live_pairs": pairs,
                      **res}
        del q, k, v, do, o, lse, delta, qt, kt, vt, dot, mask, live
        torch.cuda.empty_cache()
    fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES = counts
    return out


def ring_pair_kinds(cp: int) -> dict:
    """Per layer and step, the ring's K1 (= K2 = K3) launches by pair
    kind: past (non-causal) and diagonal (causal)."""
    from distributed_training_guide_tpu_torch.ops import ring_attention as ra

    kinds = {"past": 0, "diagonal": 0}
    for m in range(cp):
        for hop in range(cp):
            for _, _, kw in ra._pairs(cp, m, hop, True, None, 1):
                kinds["diagonal" if kw["causal"] else "past"] += 1
    return kinds


def phase_cp_pp(torch, card: str, plans: dict) -> dict:
    """Phase 20: the ring, Ulysses, the pipeline, chapters 08 and 09 at
    world 1, and K1-K3 timed at this phase's shapes."""
    t0 = time.perf_counter()
    ring = cp_ring(torch, card)
    ulysses = cp_ulysses(torch, card)
    pipeline = cp_pipeline(torch, card)
    chunks = cp_pp_chunks(torch, card)
    chapters = cp_pp_chapters(torch, card, plans)
    timing = cp_pp_timing(torch, card)
    kinds = ring_pair_kinds(CP)
    launches = {k: ring["launches"][k] + ulysses["launches"][k]
                + pipeline["launches"][k] + chunks["launches"][k]
                for k in ring["launches"]}
    per_step = {
        "ring-past": {"per_layer": kinds["past"],
                      "llama-3.2-1b_step": kinds["past"] * 16},
        "ring-diagonal": {"per_layer": kinds["diagonal"],
                          "llama-3.2-1b_step": kinds["diagonal"] * 16},
        "ring-band": {"per_sliding_layer": ring["band-x1"]["launches"][
            "flash_fwd"]},
        "pp-microbatch": {"pp2_step": pipeline["pp2"]["launches"]}}
    log(phase="cp_pp", seconds=time.perf_counter() - t0, launches=launches,
        launches_per_step=per_step, card=card)
    return {"ring": ring, "ulysses": ulysses, "pipeline": pipeline,
            "chunks": chunks, "chapters": chapters, "timing": timing,
            "launches": launches, "per_step": per_step}


# ---------------------------------------------------------------------------
# phase 21: chapter 10 under a plan — c10_moe at world 1, the ragged
# expert exchange over 4 virtual members at qwen3-30b-a3b's full width,
# the dense dispatch over 4 members at a dropping capacity, K5 / K6 on the
# ep-local window
# ---------------------------------------------------------------------------

EP_MEMBERS = 4
EP_TOKENS = 4096          # a member's tokens (B 2 x S 2048)
EP_CHAPTER_STEPS = 3
# bf16: the exchange sums each token's members' partial combines (bf16) in
# another order than the single device's one sum over its k choices, and
# d_x sums the same products' grads in another order
EP_REL_L2 = 1e-2
# d_router (fp32) sums the same products in another order: 1.1e-7 read
EP_ROUTER_REL_L2 = 1e-6
# the expert stacks' grads are held bitwise: each member's window holds
# exactly its experts' rows, and K6 counts its chunks from each group's
# first row, so a group's d_rhs does not depend on where it starts
EP_EXACT = ("dgate", "dup", "ddown")
# the dense dispatch: capacity factor 0.75 over 16384 tokens x top-8 of
# 128 (C 768 a slot against ~1024 pairs an expert): about a quarter drop
EP_DENSE_CF = 0.75
EP_DENSE_MIN_DROP = 0.1
# K5 / K6 on the window against their plain versions: K5's forward at bf16
# (GMM_REL_L2), the split bodies at their own arithmetic
EP_SPLIT_REL_L2 = 2e-6


def ep_chapter(torch, card: str) -> dict:
    """Chapter 10's ``main`` at world 1 (a one-rank NCCL group, the ep
    plan: every collective a copy) on qwen3-30b-a3b at full width cut to
    4 layers, under the ragged and the dense dispatch: the first step
    bitwise the single plan's, the loss finite (falling under ragged),
    and exactly 6 K5 and 3 K6 a layer a ragged step, none dense."""
    from distributed_training_guide_tpu_torch.chapters import c10_moe
    from distributed_training_guide_tpu_torch.train import cli

    layers = MOE_TRAIN_LAYERS
    over = {"num_layers": layers}
    out = {"launches": {}}
    for dispatch in ("ragged", "dense"):
        argv = MOE_TRAIN_ARGS + ["--moe-dispatch", dispatch, "--log-freq",
                                 "1"]
        single = cli.run_training(cli.get_parser().parse_args(
            argv + ["--max-steps", "1"]), model_overrides=over)
        first = single["infos"][0]
        ch01_free(torch, single)
        reset_moe_counts()                    # the main path starts here
        run = with_env(plan_env(), lambda: c10_moe.main(
            argv + ["--max-steps", str(EP_CHAPTER_STEPS)],
            model_overrides=over))
        torch.cuda.synchronize()
        counts = moe_counts()                 # ... and ends here
        plan = run["state"].sharding.plan_state.plan
        check(plan.strategy == "ep" and plan.size() == 1,
              f"chapter 10: plan {plan.strategy} of {plan.size()}")
        infos = run["infos"]
        losses = [i["running_loss"] for i in infos]
        check(len(losses) == EP_CHAPTER_STEPS
              and all(map(math.isfinite, losses)),
              f"chapter 10 {dispatch}: losses {losses}")
        bitwise = (infos[0]["running_loss"] == first["running_loss"]
                   and infos[0]["grad_norm"] == first["grad_norm"])
        check(bitwise, f"chapter 10 {dispatch}: first step "
              f"{infos[0]['running_loss']} / {infos[0]['grad_norm']}, the "
              f"single plan's {first['running_loss']} / "
              f"{first['grad_norm']}")
        per_step = {"flash_fwd": layers, "flash_dq": layers,
                    "flash_dkv": layers,
                    "grouped_matmul": 6 * layers if dispatch == "ragged"
                    else 0, "tgmm": 3 * layers if dispatch == "ragged"
                    else 0}
        want = {k: v * EP_CHAPTER_STEPS for k, v in per_step.items()}
        check(counts == want, f"chapter 10 {dispatch}: launches {counts}, "
              f"want {want}")
        if dispatch == "ragged":
            check(losses[-1] < losses[0], f"chapter 10: loss did not fall: "
                  f"{losses}")
            check(all(i["moe_dropped_frac"] == 0.0 for i in infos),
                  "chapter 10: the ragged dispatch dropped pairs")
        for k, v in counts.items():
            out["launches"][k] = out["launches"].get(k, 0) + v
        later = infos[1:]
        out[dispatch] = {
            "losses": losses, "first_step_bitwise_single": bitwise,
            "launches": counts, "launches_per_step": per_step,
            "moe_dropped_frac": [i["moe_dropped_frac"] for i in infos],
            "time_step_ms": sum(i["time/step"] for i in later)
            / len(later),
            "tokens_per_s": sum(i["tokens_per_s"] for i in later)
            / len(later),
            "peak_alloc_gb": run["last_info"]["peak_alloc_gb"]}
        log(phase="chapter10", part="world 1", model="qwen3-30b-a3b",
            layers=layers, dispatch=dispatch, card=card, **out[dispatch])
        ch01_free(torch, run)
    return out


def ep_inputs(torch, gen, cfg):
    """One layer at qwen3-30b-a3b's widths, bf16: the rows of 4 members x
    4096 tokens, an fp32 router, bf16 expert stacks and a cotangent."""
    bf = torch.bfloat16
    e, f, g = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    n = EP_MEMBERS * EP_TOKENS
    x = torch.randn(n, e, generator=gen, device="cuda").to(bf)
    router = torch.randn(e, g, generator=gen, device="cuda") * 0.02
    w = [(torch.randn(g, *shape, generator=gen, device="cuda") * 0.02
          ).to(bf) for shape in ((e, f), (e, f), (f, e))]
    cot = torch.randn(n, e, generator=gen, device="cuda").to(bf)
    return x, router, w, cot


def ep_route(torch, cfg, x, router):
    probs = torch.softmax(x.float() @ router, dim=-1)
    tp, ti = torch.topk(probs, cfg.experts_per_token, dim=-1)
    return ti, tp / tp.sum(-1, keepdim=True)


def ep_exchange(torch, card: str, gen) -> dict:
    """``make_ragged_ep_dispatch`` over ``LocalExchange(4)`` against the
    single device's ragged dispatch on the 16384 tokens, both through the
    kernels: the output and the grad of x within ``EP_REL_L2``, the
    router's within ``EP_ROUTER_REL_L2``, the three expert stacks' grads
    bitwise (``EP_EXACT``); every member's K5 / K6 launch
    through the body ``_gmm_plan`` / ``_tgmm_plan`` names, the exact
    counts; the peak memory of each."""
    from distributed_training_guide_tpu_torch.models import get_model, moe
    from distributed_training_guide_tpu_torch.ops import grouped_matmul as gm
    from distributed_training_guide_tpu_torch.ops.collectives import (
        LocalExchange)

    cfg = get_model("qwen3-30b-a3b", dtype=torch.bfloat16,
                    moe_dispatch="ragged").config
    x, router, w, cot = ep_inputs(torch, gen, cfg)
    g, n = cfg.num_experts, EP_MEMBERS
    e_loc = g // n

    def run(mode):
        leaves = [t.clone().requires_grad_() for t in (x, router, *w)]
        xv, rv, gate, up, down = leaves
        ti, tp = ep_route(torch, cfg, xv, rv)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        if mode == "ep":
            disp = moe.make_ragged_ep_dispatch(LocalExchange(n), cfg)
            ws = [[t[m * e_loc:(m + 1) * e_loc] for m in range(n)]
                  for t in (gate, up, down)]
            y = torch.cat(disp(list(torch.chunk(xv, n)),
                               list(torch.chunk(ti, n)),
                               list(torch.chunk(tp, n)), *ws))
        elif mode in ("ep_fsdp", "ep_rows"):
            # ep 2 x fsdp 2: member (f, e) holds token block 2 f + e and
            # expert block e, its embed dim's half f ("ep_fsdp": gathered
            # over fsdp in the exchange); "ep_rows": the same exchange on
            # the gathered weights, one ep group per fsdp row
            half = g // 2
            fsdp = mode == "ep_fsdp"
            disp = moe.make_ragged_ep_dispatch(
                LocalExchange(2), cfg,
                embed=LocalExchange(2) if fsdp else None)
            ws = [[(t[e * half:(e + 1) * half].chunk(2, dim)[f] if fsdp
                    else t[e * half:(e + 1) * half])
                   for f in range(2) for e in range(2)]
                  for t, dim in ((gate, 1), (up, 1), (down, 2))]
            args = [list(torch.chunk(a, n)) for a in (xv, ti, tp)]
            if fsdp:
                y = torch.cat(disp(*args, *ws))
            else:
                y = torch.cat(sum((disp(*[a[2 * f:2 * f + 2] for a in args],
                                        *[wl[2 * f:2 * f + 2] for wl in ws])
                                   for f in range(2)), []))
        else:
            ef = ti.T.reshape(-1)
            y = moe._ragged_dispatch(
                cfg, xv, ef, tp.T.reshape(-1),
                moe._group_sizes(ef, g),
                {"gate": gate, "up": up, "down": down}, torch.bfloat16)
        grads = torch.autograd.grad(y, leaves, cot)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        return [y.detach(), *grads], peak

    want, single_peak = run("single")
    gm.GMM_LAUNCHES = gm.TGMM_LAUNCHES = 0
    gm.GMM_BODY_LAUNCHES.update({k: 0 for k in gm.GMM_BODY_LAUNCHES})
    gm.TGMM_BODY_LAUNCHES.update({k: 0 for k in gm.TGMM_BODY_LAUNCHES})
    got, ep_peak = run("ep")
    launches = {"grouped_matmul": gm.GMM_LAUNCHES, "tgmm": gm.TGMM_LAUNCHES,
                "by_body": {"grouped_matmul": dict(gm.GMM_BODY_LAUNCHES),
                            "tgmm": dict(gm.TGMM_BODY_LAUNCHES)}}
    # each member: 3 forward products (bf16: the Hopper body), 3 fp32-dy
    # d_lhs (the split body) and 3 d_rhs (K6's split body)
    want_k5 = {b: 0 for b in gm.GMM_BODY_LAUNCHES}
    want_k5.update(wgmma=3 * n, split=3 * n)
    want_k6 = {b: 0 for b in gm.TGMM_BODY_LAUNCHES}
    want_k6.update(split=3 * n)
    check(launches["by_body"]["grouped_matmul"] == want_k5
          and launches["by_body"]["tgmm"] == want_k6,
          f"ep exchange: launches by body {launches['by_body']}, want "
          f"{want_k5} / {want_k6}")
    errs = {}
    for key, a, b in zip(("y", "dx", "drouter", "dgate", "dup", "ddown"),
                         got, want):
        check(bool(torch.isfinite(a.float()).all()), f"ep exchange {key}: "
              f"non-finite")
        errs[key] = {"rel_l2": rel_l2(a, b),
                     "max_abs": (a.float() - b.float()).abs().max().item()}
        if key in EP_EXACT:
            check(torch.equal(a, b), f"ep exchange {key}: not bitwise the "
                  f"single device's (rel L2 {errs[key]['rel_l2']})")
        else:
            bound = EP_ROUTER_REL_L2 if key == "drouter" else EP_REL_L2
            check(errs[key]["rel_l2"] <= bound, f"ep exchange {key}: rel L2 "
                  f"{errs[key]['rel_l2']} > {bound}")
    # ep 2 x fsdp 2 over the same 4 virtual members: the embed dim
    # gathered over fsdp inside the exchange, against the ep 2 exchange on
    # the gathered weights (bitwise) and the single device
    rows, _ = run("ep_rows")
    gm.GMM_LAUNCHES = gm.TGMM_LAUNCHES = 0
    fsdp, fsdp_peak = run("ep_fsdp")
    fsdp_launches = {"grouped_matmul": gm.GMM_LAUNCHES,
                     "tgmm": gm.TGMM_LAUNCHES}
    check(fsdp_launches == {"grouped_matmul": 6 * n, "tgmm": 3 * n},
          f"ep 2 x fsdp 2: launches {fsdp_launches}")
    fsdp_errs = {}
    for key, a, b, r in zip(("y", "dx", "drouter", "dgate", "dup", "ddown"),
                            fsdp, want, rows):
        check(torch.equal(a, r), f"ep 2 x fsdp 2 {key}: not bitwise the "
              f"ep 2 exchange on the gathered weights")
        fsdp_errs[key] = rel_l2(a, b)
        bound = EP_ROUTER_REL_L2 if key == "drouter" else EP_REL_L2
        check(fsdp_errs[key] <= bound, f"ep 2 x fsdp 2 {key}: rel L2 "
              f"{fsdp_errs[key]} > {bound}")
    del rows, fsdp
    out_fsdp = {"rel_l2": fsdp_errs, "bitwise_gathered_emulation": True,
                "launches": fsdp_launches, "peak_gb": fsdp_peak}
    log(phase="chapter10", part="ragged exchange ep 2 x fsdp 2 over 4 "
        "virtual members, bf16", card=card, **out_fsdp)
    out = {"members": n, "tokens_per_member": EP_TOKENS, "E": g,
           "ep_fsdp": out_fsdp,
           "k": cfg.experts_per_token, "D": cfg.hidden_size,
           "F": cfg.intermediate_size, "errors": errs,
           "bound": {"y": EP_REL_L2, "dx": EP_REL_L2,
                     "drouter": EP_ROUTER_REL_L2,
                     **{k: "bitwise" for k in EP_EXACT}},
           "launches": launches, "peak_gb_exchange": ep_peak,
           "peak_gb_single": single_peak}
    log(phase="chapter10", part="ragged exchange over 4 members vs the "
        "single device, bf16", card=card, **out)
    del got, want
    torch.cuda.empty_cache()
    return out


def ep_dense(torch, card: str, gen) -> dict:
    """The dense dispatch over 4 members (ep 4, the routing gathered over
    the 4) against the single device's on the 16384 tokens at capacity
    factor 0.75: the same dropped fraction (at least 10%), the same tokens
    with no kept pair, y within ``EP_REL_L2``."""
    import dataclasses

    from distributed_training_guide_tpu_torch.models import get_model, moe
    from distributed_training_guide_tpu_torch.ops.collectives import (
        LocalExchange)

    cfg = dataclasses.replace(get_model("qwen3-30b-a3b",
                                        dtype=torch.bfloat16).config,
                              capacity_factor=EP_DENSE_CF)
    x, router, w, _ = ep_inputs(torch, gen, cfg)
    n, g = EP_MEMBERS, cfg.num_experts
    e_loc = g // n
    with torch.no_grad():
        ti, tp = ep_route(torch, cfg, x, router)
        whole = dict(zip(("gate", "up", "down"), w))
        (want,), want_drop = moe.dense_ep_dispatch(cfg, [x], [ti], [tp],
                                                   [whole])
        ex = LocalExchange(n)
        ys, drop = moe.dense_ep_dispatch(
            cfg, list(torch.chunk(x, n)), list(torch.chunk(ti, n)),
            list(torch.chunk(tp, n)),
            [{k: v[m * e_loc:(m + 1) * e_loc] for k, v in whole.items()}
             for m in range(n)], route=ex, ep=ex)
        got = torch.cat(ys)
    drop, want_drop = float(drop), float(want_drop)
    zero_same = bool(torch.equal(got.norm(dim=-1) == 0,
                                 want.norm(dim=-1) == 0))
    err = rel_l2(got, want)
    check(want_drop >= EP_DENSE_MIN_DROP, f"ep dense: only {want_drop} "
          f"dropped")
    check(drop == want_drop, f"ep dense: dropped {drop}, single {want_drop}")
    check(zero_same, "ep dense: the tokens with no kept pair differ")
    check(err <= EP_REL_L2, f"ep dense: y rel L2 {err} > {EP_REL_L2}")
    out = {"capacity_factor": EP_DENSE_CF, "capacity": max(int(math.ceil(
        EP_DENSE_CF * cfg.experts_per_token * n * EP_TOKENS / g)), 1),
        "dropped_frac": drop, "single_dropped_frac": want_drop,
        "zero_rows_same": zero_same, "y_rel_l2": err, "bound": EP_REL_L2}
    log(phase="chapter10", part="dense dispatch over 4 members vs the "
        "single device", card=card, **out)
    return out


def ep_window_operands(torch, gen, cfg, member: int,
                       tokens: Optional[int] = None) -> dict:
    """Member ``member``'s window at qwen3-30b-a3b's widths: the sorted
    rows of 4 x 4096 tokens x top-8 (M 131072) from its experts' offset,
    its 32 experts' sizes, its stacks, an fp32 dy [M, F]; and the same
    live rows alone (M = their count). ``tokens``: route only the first
    ``tokens`` rows, one member's block on a hop of the expert ring
    (4096 x top-8: M 32768)."""
    from distributed_training_guide_tpu_torch.models import moe

    x, router, w, _ = ep_inputs(torch, gen, cfg)
    if tokens is not None:
        x = x[:tokens]
    g, k = cfg.num_experts, cfg.experts_per_token
    e_loc = g // EP_MEMBERS
    e0 = member * e_loc
    with torch.no_grad():
        ti, _ = ep_route(torch, cfg, x, router)
        ef = ti.T.reshape(-1)
        sizes = moe._group_sizes(ef, g)
        _, x_sorted = moe._ragged_sort(x, ef, torch.bfloat16)
    m = x_sorted.shape[0]
    start = int(sizes[:e0].sum())
    local = sizes[e0:e0 + e_loc].contiguous()
    live = int(local.sum())
    window = torch.zeros_like(x_sorted)
    window[:m - start] = x_sorted[start:]
    dy = torch.randn(m, cfg.intermediate_size, generator=gen, device="cuda")
    return {"m": m, "live": live, "start": start, "sizes": local,
            "x": window, "x_live": window[:live].contiguous(),
            "rhs": w[0][e0:e0 + e_loc].contiguous(), "dy": dy,
            "dy_live": dy[:live].contiguous()}


def ep_window(torch, card: str, gen, tokens: Optional[int] = None,
              phase: str = "chapter10", what: str = "ep window") -> dict:
    """K5 (forward; the fp32-dy d_lhs) and K6 on member 1's ep-local
    window (other experts' rows past the local total, as
    ``_local_groups_compute`` hands them over), each through the body its
    plan names: held to their plain versions, rows past the total zero,
    NaN past the total in both operands ignored; then timed (device time,
    ``queued_ms``) beside the same live rows alone, their bounds (the
    window's outputs written whole, only live rows read) and
    ``torch._grouped_mm`` on the live rows (a yardstick the port never
    calls), with the window's bytes. ``tokens`` (see
    ``ep_window_operands``) gives the expert ring's hop window."""
    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.ops import grouped_matmul as gm

    bf, f32 = torch.bfloat16, torch.float32
    counts = (gm.GMM_LAUNCHES, gm.TGMM_LAUNCHES)
    cfg = get_model("qwen3-30b-a3b", dtype=bf, moe_dispatch="ragged").config
    op = ep_window_operands(torch, gen, cfg, 1, tokens)
    m, live, sz, g = op["m"], op["live"], op["sizes"], op["sizes"].shape[0]
    e, f = cfg.hidden_size, cfg.intermediate_size
    rt = op["rhs"].transpose(1, 2)
    plans = {"fwd": gm._gmm_plan(op["x"], op["rhs"]),
             "dlhs": gm._gmm_plan(op["dy"], rt),
             "drhs": gm._tgmm_plan(op["x"], op["dy"], bf)}
    check(plans == {"fwd": "wgmma", "dlhs": "split", "drhs": "split"},
          f"ep window: plans {plans}")
    before = (dict(gm.GMM_BODY_LAUNCHES), dict(gm.TGMM_BODY_LAUNCHES))
    fwd = gm.gmm(op["x"], op["rhs"], sz)
    dlhs = gm.gmm(op["dy"], rt, sz, f32)
    drhs = gm.tgmm(op["x"], op["dy"], sz, g, f32)
    torch.cuda.synchronize()
    ran = (gm.GMM_BODY_LAUNCHES["wgmma"] - before[0]["wgmma"],
           gm.GMM_BODY_LAUNCHES["split"] - before[0]["split"],
           gm.TGMM_BODY_LAUNCHES["split"] - before[1]["split"])
    check(ran == (1, 1, 1), f"ep window: bodies launched {ran}")
    errs = {
        "fwd_rel_l2": rel_l2(fwd, gm.gmm_reference(op["x"], op["rhs"], sz,
                                                   bf)),
        "dlhs_rel_l2_at_arith": rel_l2(dlhs, gm.gmm_reference(
            op["dy"], rt, sz, f32, split_lhs=True)),
        "drhs_rel_l2_at_arith": rel_l2(drhs, gm.tgmm_reference(
            op["x"], op["dy"], sz, g, f32, split_dy=True))}
    check(errs["fwd_rel_l2"] <= GMM_REL_L2["bf16"], f"ep window K5: {errs}")
    check(errs["dlhs_rel_l2_at_arith"] <= EP_SPLIT_REL_L2
          and errs["drhs_rel_l2_at_arith"] <= EP_SPLIT_REL_L2,
          f"ep window split bodies: {errs}")
    check(not fwd[live:].any() and not dlhs[live:].any(),
          "ep window: rows past the local total not zero")
    # the rows past the total hold NaN in both operands: nothing changes
    xn, dyn = op["x"].clone(), op["dy"].clone()
    xn[live:], dyn[live:] = float("nan"), float("nan")
    nan_same = (torch.equal(gm.gmm(xn, op["rhs"], sz), fwd)
                and torch.equal(gm.gmm(dyn, rt, sz, f32), dlhs)
                and torch.equal(gm.tgmm(xn, dyn, sz, g, f32), drhs))
    check(nan_same, "ep window: NaN past the local total reached an output")
    del xn, dyn, fwd, dlhs, drhs

    def time_pair(call_window, call_live, plain):
        return {"ms": queued_ms(torch, call_window, 10),
                "live_ms": queued_ms(torch, call_live, 10),
                "plain_ms": cuda_ms(plain, iters=2, warmup=1)}

    live_sz = sz
    rows = {}
    t = time_pair(lambda: gm.gmm(op["x"], op["rhs"], sz),
                  lambda: gm.gmm(op["x_live"], op["rhs"], live_sz),
                  lambda: gm.gmm_reference(op["x"], op["rhs"], sz, bf))
    lib_ms, _, lib = library_grouped_mm(torch, op["x_live"], op["rhs"],
                                        live_sz)
    rows["fwd"] = dict(kernel="grouped_matmul", M=m, live_rows=live, K=e,
                       N=f, G=g, body=plans["fwd"], **t, library_ms=lib_ms,
                       **window_bound(m, live, e, f, sz, 2, 2, 2,
                                      "bfloat16"))
    if lib_ms is None:
        rows["fwd"]["library_note"] = lib
    t = time_pair(lambda: gm.gmm(op["dy"], rt, sz, bf),
                  lambda: gm.gmm(op["dy_live"], rt, live_sz, bf),
                  lambda: gm.gmm_reference(op["dy"], rt.float(), sz, bf))
    rows["dlhs"] = dict(kernel="grouped_matmul", M=m, live_rows=live, K=f,
                        N=e, G=g, body=plans["dlhs"], **t, library_ms=None,
                        library_note="no PyTorch call takes fp32 dy against "
                        "a bf16 rhs", **window_bound(m, live, f, e, sz, 4, 2,
                                                     2, "float32"))
    t = time_pair(lambda: gm.tgmm(op["x"], op["dy"], sz, g, bf),
                  lambda: gm.tgmm(op["x_live"], op["dy_live"], live_sz, g,
                                  bf),
                  lambda: gm.tgmm_reference(op["x"], op["dy"], sz, g, bf))
    rows["drhs"] = dict(kernel="tgmm", M=m, live_rows=live, K=e, N=f, G=g,
                        body=plans["drhs"], **t, library_ms=None,
                        library_note="no PyTorch call takes fp32 dy against "
                        "bf16 lhs", **tgmm_window_bound(m, live, e, f, sz, 2,
                                                        4, 2, "float32"))
    fn = getattr(torch, "_grouped_mm", None)
    if fn is not None:      # the all-bf16 yardstick of d_rhs, live rows
        offs = torch.cumsum(live_sz, 0, dtype=torch.int32)
        dyb = op["dy_live"].to(bf)
        try:
            rows["drhs"]["library_bf16_dy_ms"] = queued_ms(
                torch, lambda: fn(op["x_live"].t(), dyb, offs=offs), 5)
        except RuntimeError as exc:
            rows["drhs"]["library_bf16_dy_note"] = str(
                exc).splitlines()[0][:120]
    split_body_bound(rows["dlhs"])
    split_body_bound(rows["drhs"])
    for key, row in rows.items():
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["window_over_live"] = row["ms"] / row["live_ms"]
        log(phase=phase, part=f"{what} timing {key}", card=card, **row)
    out = {"errors": errs, "nan_past_total_ignored": nan_same,
           "window_bytes": {"x_window_bf16": m * e * 2,
                            "x_padded_copy_bf16": 2 * m * e * 2,
                            "dy_fp32": m * f * 4},
           "rows": rows}
    log(phase=phase, part=what, card=card, member=1, M=m,
        start_row=op["start"], errors=errs, nan_past_total_ignored=nan_same,
        window_bytes=out["window_bytes"])
    del op, lib
    torch.cuda.empty_cache()
    gm.GMM_LAUNCHES, gm.TGMM_LAUNCHES = counts   # checks are not main path
    return out


def window_bound(m, live, k, n, sizes, lhs_b, rhs_b, out_b, peak) -> dict:
    """K5 on a window: the live rows of lhs read once, the rhs slices of
    the non-empty groups read once, the whole [M, N] out written once."""
    groups = int((sizes > 0).sum())
    nbytes = live * k * lhs_b + groups * k * n * rhs_b + m * n * out_b
    return _bound(nbytes, 2 * live * k * n, peak)


def tgmm_window_bound(m, live, k, n, sizes, lhs_b, dy_b, out_b,
                      peak) -> dict:
    """K6 on a window: the live rows of lhs and dy read once, every
    group's [K, N] written once."""
    g = sizes.shape[0]
    nbytes = live * (k * lhs_b + n * dy_b) + g * k * n * out_b
    return _bound(nbytes, 2 * live * k * n, peak)


def phase_chapter10(torch, card: str) -> dict:
    """Phase 21: chapter 10 at world 1, the ragged exchange over 4 members,
    the dense dispatch over 4 members, K5 / K6 on the ep window."""
    t0 = time.perf_counter()
    chapter = ep_chapter(torch, card)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    exchange = ep_exchange(torch, card, gen)
    dense = ep_dense(torch, card, gen)
    window = ep_window(torch, card, gen)
    log(phase="chapter10", seconds=time.perf_counter() - t0, card=card,
        launches=chapter["launches"])
    return {"chapter": chapter, "exchange": exchange, "dense": dense,
            "window": window, "launches": chapter["launches"]}


# ---------------------------------------------------------------------------
# phase 22: the overlap schedule and the fused hidden->loss
# (ops/overlap.py) — chapter 04 at world 1 with and without
# --overlap-schedule, the fused loss alone on the single plan,
# --loss-chunks under tp and tp_fsdp, the double-buffered expert ring, and
# chapter 10 scheduled
# ---------------------------------------------------------------------------

OVL_STEPS = 4
OVL_CHUNKS = 8
# the fused loss against the whole-tensor loss: the first step's loss is
# the forward alone (the same bf16 products, their fp32 logz and pick
# summed per chunk, then over chunks); later steps' params moved by grads
# whose fp32 sums of dh and dW run in another order before their rounding
OVL_FIRST_LOSS_REL = 1e-5
OVL_LOSS_REL = 1e-3
OVL_PLAN_LAYERS = 4        # (c): the loss does not depend on the depth
OVL_LAYERS = 4             # (a), (b): full width cut to 4 layers (time)
OVL_PLAN_STEPS = 3
# the ring against the bulk exchange, bf16: per row the same products, the
# owner's partials summed in member order (y); dx and the expert stacks'
# grads are sums over the hops of bf16 partials, each rounded, and of the
# running sums, each rounded again (the bulk rounds once): half-ulp
# roundings of 2^-9 make ~2.3e-3 rel L2 for 4 hops, 3.53e-3 / 2.66e-3 read
# (expert grads / dx, PR 16 call 2); the router's an fp32 sum in another
# order. The same bounds hold the ring against the single device (the bulk
# exchange's expert grads equal it bitwise; its dx is held at EP_REL_L2)
OVL_RING_Y_REL_L2 = 1e-6
OVL_RING_GRAD_REL_L2 = 5e-3
OVL_RING_ROUTER_REL_L2 = 1e-5
# the ring against the bulk exchange and the single device in fp32, the
# same layer: only fp32 sums run in another order (~1e-7), where losing or
# doubling one row of a hop's window moves an expert grad by ~5e-3
OVL_RING_FP32_REL_L2 = 1e-5
# (a) and (d) timed by wall_and_device_ms over this many warmed calls
OVL_TIME_ITERS = 2


def ovl_run(torch, argv: list, plan=None, layers=None,
            timed=None) -> tuple:
    """One ``run_training`` through the CLI parser (``plan``: (strategy,
    mesh kwargs) on a one-rank NCCL group from the env contract; None:
    chapter 01's single device), with the kernels' launches of the run.
    ``timed(out)``, called after the launches are read and before the
    group goes, goes into ``out["timing"]``."""
    import torch.distributed as dist

    from distributed_training_guide_tpu_torch.launch import (
        maybe_initialize_distributed)
    from distributed_training_guide_tpu_torch.parallel import (make_mesh,
                                                               make_plan)
    from distributed_training_guide_tpu_torch.train import cli

    args = cli.get_parser().parse_args(argv)
    over = {"num_layers": layers} if layers else None

    def run(make_plan_fn=None):
        reset_moe_counts()                    # the run's path starts here
        torch.cuda.reset_peak_memory_stats()
        out = (cli.run_training(args, model_overrides=over)
               if make_plan_fn is None else
               cli.run_training(args, make_plan_fn, model_overrides=over))
        torch.cuda.synchronize()
        counts = moe_counts()                 # ... and ends here
        if timed is not None:
            out["timing"] = timed(out)
        return out, counts

    if plan is None:
        return run()
    strategy, mesh_kw = plan

    def go():
        maybe_initialize_distributed("cuda")
        try:
            return run(lambda: make_plan(strategy, make_mesh(**mesh_kw)))
        finally:
            dist.destroy_process_group()
    return with_env(plan_env(), go)


def ovl_step_timing(torch, out) -> list:
    """Two readings of the wall and device milliseconds of the run's
    optimizer step on its trained state (``wall_and_device_ms`` over
    ``OVL_TIME_ITERS`` warmed steps on a fresh batch of *train*'s shape);
    the schedule's gather counts are left as the run made them."""
    state = out["state"]
    ps = state.sharding.plan_state
    trainer, sched = ps.trainer, ps.layer_schedule
    counts = None if sched is None else dict(sched.counts)
    vocab = trainer.bundle.config.vocab_size
    batch = _train_batch(torch, vocab, 4, 2048, SEED + 22)
    got = [wall_and_device_ms(torch, lambda: trainer.step_fn(state, batch),
                              OVL_TIME_ITERS) for _ in range(2)]
    if sched is not None:
        sched.counts.update(counts)
    return got


def ovl_summary(out, counts) -> dict:
    infos = out["infos"]
    later = infos[1:] or infos
    state = out["state"]
    ps = getattr(state.sharding, "plan_state", None) if state.sharding \
        else None
    sched = None if ps is None else ps.layer_schedule
    return {"losses": [i["running_loss"] for i in infos],
            "grad_norms": [i["grad_norm"] for i in infos],
            "time_step_ms": sum(i["time/step"] for i in later) / len(later),
            "peak_alloc_gb": out["last_info"]["peak_alloc_gb"],
            "launches": counts,
            "gathers": None if sched is None else dict(sched.counts),
            "gathered_leaves": None if sched is None else sched.n_gathered,
            "timing": out.get("timing")}


def ovl_rel(a: list, b: list) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def ovl_fused_vs_whole(name: str, fused: dict, whole: dict) -> dict:
    """The fused loss's losses against the whole-tensor loss's: the first
    within ``OVL_FIRST_LOSS_REL``, all within ``OVL_LOSS_REL``."""
    first = abs(fused["losses"][0] - whole["losses"][0]) / abs(
        whole["losses"][0])
    worst = ovl_rel(fused["losses"], whole["losses"])
    check(first <= OVL_FIRST_LOSS_REL, f"overlap {name}: first loss "
          f"{fused['losses'][0]} against the whole-tensor loss's "
          f"{whole['losses'][0]}: rel {first}")
    check(worst <= OVL_LOSS_REL, f"overlap {name}: losses {fused['losses']} "
          f"against {whole['losses']}: rel {worst}")
    return {"first_loss_rel": first, "loss_max_rel": worst,
            "grad_norm_max_rel": ovl_rel(fused["grad_norms"],
                                         whole["grad_norms"]),
            "peak_drop_gb": whole["peak_alloc_gb"] - fused["peak_alloc_gb"]}


def ovl_chapter04(torch, card: str) -> dict:
    """(a) *train*'s model at full width cut to ``OVL_LAYERS`` through
    chapter 04's plan (fsdp) at world 1: unscheduled with the whole-tensor
    loss,
    unscheduled with ``--loss-chunks 8`` (the fused loss), and
    ``--overlap-schedule`` (the fused loss in 8 chunks, each layer's 7
    fsdp leaves gathered a layer ahead and again in the backward). The
    schedule is bitwise the unscheduled fused run (fp32 params: the fp32
    reduce-scatter is the unscheduled one), and within the fused-loss
    bounds of the whole-tensor run; K1-K3 the same in all three."""
    base = TRAIN_ARGS + ["--max-steps", str(OVL_STEPS), "--log-freq", "1"]
    fsdp = ("fsdp", {})
    runs = {}
    for name, extra in (("whole", []),
                        ("fused", ["--loss-chunks", str(OVL_CHUNKS)]),
                        ("scheduled", ["--overlap-schedule"])):
        out, counts = ovl_run(torch, base + extra, plan=fsdp,
                              layers=OVL_LAYERS,
                              timed=lambda o: ovl_step_timing(torch, o))
        runs[name] = ovl_summary(out, counts)
        ch01_free(torch, out)
        log(phase="overlap", part="(a) chapter 04 at world 1", run=name,
            layers=OVL_LAYERS, card=card, **runs[name])
    layers = OVL_LAYERS
    want = {k: layers * OVL_STEPS for k in ("flash_fwd", "flash_dq",
                                            "flash_dkv")}
    for name, r in runs.items():
        got = {k: r["launches"][k] for k in want}
        check(got == want, f"overlap (a) {name}: K1-K3 launches {got}, "
              f"want {want}")
    sched = runs["scheduled"]
    gathers = layers * 7 * OVL_STEPS      # each, forward and recompute
    check(sched["gathered_leaves"] == 7 and sched["gathers"] == {
        "gather": gathers, "regather": gathers},
        f"overlap (a): gathers {sched['gathers']} of "
        f"{sched['gathered_leaves']} leaves, want {gathers} each")
    bitwise = (sched["losses"] == runs["fused"]["losses"]
               and sched["grad_norms"] == runs["fused"]["grad_norms"])
    check(bitwise, f"overlap (a): scheduled {sched['losses']} / "
          f"{sched['grad_norms']} against the unscheduled fused run's "
          f"{runs['fused']['losses']} / {runs['fused']['grad_norms']}")
    timing = {k: runs[k]["timing"] for k in runs}

    def mean(run, k):
        vals = [r.get(k) for r in timing[run]]
        return (sum(vals) / len(vals)
                if all(isinstance(v, float) for v in vals) else None)
    ratio = {k: (mean("scheduled", k) / mean("fused", k)
                 if mean("fused", k) and mean("scheduled", k) else None)
             for k in ("wall_ms", "device_ms")}
    log(phase="overlap", part="(a) step timing", card=card, timing=timing,
        scheduled_over_fused=ratio)
    return {"runs": runs, "scheduled_bitwise_fused": bitwise,
            "scheduled_over_fused": ratio,
            "fused_vs_whole": ovl_fused_vs_whole("(a)", sched,
                                                 runs["whole"])}


def ovl_single(torch, card: str) -> dict:
    """(b) The fused loss alone on the single plan (chapter 01, no plan):
    ``--overlap-schedule`` there gathers nothing and replaces the [B, S, V]
    fp32 logits by the fused loss in 8 chunks. The peak against the
    whole-tensor loss's, 2 steps each, at ``OVL_LAYERS``."""
    base = TRAIN_ARGS + ["--max-steps", "2", "--log-freq", "1"]
    runs = {}
    for name, extra in (("whole", []), ("fused", ["--overlap-schedule"])):
        out, counts = ovl_run(torch, base + extra, layers=OVL_LAYERS)
        runs[name] = ovl_summary(out, counts)
        ch01_free(torch, out)
        log(phase="overlap", part="(b) the single plan", run=name,
            layers=OVL_LAYERS, card=card, **runs[name])
    cmp = ovl_fused_vs_whole("(b)", runs["fused"], runs["whole"])
    check(cmp["peak_drop_gb"] > 0, f"overlap (b): the fused loss's peak "
          f"{runs['fused']['peak_alloc_gb']} GB, the whole-tensor loss's "
          f"{runs['whole']['peak_alloc_gb']}")
    return {"runs": runs, "fused_vs_whole": cmp}


def ovl_loss_chunks(torch, card: str) -> dict:
    """(c) ``--loss-chunks 8`` under the tp and tp_fsdp plans at world 1
    (the vocab-parallel fused loss, the sequence all-gathered first)
    against the same plans' whole-tensor (vocab-parallel) loss, *train*'s
    width cut to 4 layers, 3 steps."""
    base = TRAIN_ARGS + ["--max-steps", str(OVL_PLAN_STEPS), "--log-freq",
                         "1"]
    out_all = {}
    for strategy in ("tp", "tp_fsdp"):
        runs = {}
        for name, extra in (("whole", []),
                            ("fused", ["--loss-chunks", str(OVL_CHUNKS)])):
            out, counts = ovl_run(torch, base + extra, plan=(strategy, {}),
                                  layers=OVL_PLAN_LAYERS)
            runs[name] = ovl_summary(out, counts)
            ch01_free(torch, out)
            check(runs[name]["launches"]["flash_fwd"]
                  == OVL_PLAN_LAYERS * OVL_PLAN_STEPS,
                  f"overlap (c) {strategy} {name}: K1 launches "
                  f"{runs[name]['launches']}")
        out_all[strategy] = {"runs": runs, "fused_vs_whole":
                             ovl_fused_vs_whole(f"(c) {strategy}",
                                                runs["fused"], runs["whole"])}
        log(phase="overlap", part="(c) --loss-chunks under a plan",
            strategy=strategy, layers=OVL_PLAN_LAYERS, card=card,
            **out_all[strategy])
    return out_all


def ovl_ring_fns(torch, cfg, x, router, w, cot, dtype):
    """(fresh, {mode: fwd_bwd(inputs)}) for the layer's ragged dispatch on
    ``cfg`` in ``dtype``: ``fresh()`` makes the inputs (the leaves cloned,
    the routing), "single" (one device), "bulk" (the 4-member exchange)
    and "ring" (``make_ragged_ep_dispatch(overlap=True)``) each return
    [y, dx, drouter, dgate, dup, ddown]."""
    from distributed_training_guide_tpu_torch.models import moe
    from distributed_training_guide_tpu_torch.ops.collectives import (
        LocalExchange)

    g, n = cfg.num_experts, EP_MEMBERS
    e_loc = g // n
    disps = {mode: moe.make_ragged_ep_dispatch(LocalExchange(n), cfg,
                                               overlap=mode == "ring")
             for mode in ("bulk", "ring")}

    def fresh():
        leaves = [t.clone().requires_grad_() for t in (x, router, *w)]
        return (leaves, *ep_route(torch, cfg, leaves[0], leaves[1]))

    def make(mode):
        def fwd_bwd(inputs):
            leaves, ti, tp = inputs
            xv, rv, gate, up, down = leaves
            if mode == "single":
                ef = ti.T.reshape(-1)
                y = moe._ragged_dispatch(
                    cfg, xv, ef, tp.T.reshape(-1), moe._group_sizes(ef, g),
                    {"gate": gate, "up": up, "down": down}, dtype)
            else:
                ws = [[t[m * e_loc:(m + 1) * e_loc] for m in range(n)]
                      for t in (gate, up, down)]
                y = torch.cat(disps[mode](list(torch.chunk(xv, n)),
                                          list(torch.chunk(ti, n)),
                                          list(torch.chunk(tp, n)), *ws))
            return [y.detach(), *torch.autograd.grad(y, leaves, cot)]
        return fwd_bwd

    return fresh, {mode: make(mode) for mode in ("single", "bulk", "ring")}


def ovl_ring(torch, card: str, gen) -> dict:
    """(d) ``make_ragged_ep_dispatch(overlap=True)`` over 4 virtual members
    on phase 21 (b)'s full-width qwen3-30b-a3b layer (4 x 4096 tokens,
    bf16) against the bulk exchange and the single device: agreement, the
    peak memory of each, K5 / K6 launches by body (each member runs the
    window on each of the 4 hops), fwd + bwd timed by
    ``wall_and_device_ms`` (bulk, ring, bulk, ring); then the same layer
    in fp32 (the kernels' fp32 bodies), where the ring holds the bulk
    exchange and the single device within ``OVL_RING_FP32_REL_L2``."""
    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.ops import grouped_matmul as gm

    cfg = get_model("qwen3-30b-a3b", dtype=torch.bfloat16,
                    moe_dispatch="ragged").config
    x, router, w, cot = ep_inputs(torch, gen, cfg)
    n = EP_MEMBERS
    fresh, fns = ovl_ring_fns(torch, cfg, x, router, w, cot, torch.bfloat16)

    def run(mode: str):
        inputs = fresh()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = fns[mode](inputs)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        return got, peak

    single, single_peak = run("single")
    fns["ring"](fresh())                      # warm-up
    bulk, bulk_peak = run("bulk")
    reset_moe_counts()                        # the ring's path starts here
    ring, ring_peak = run("ring")
    launches = {"grouped_matmul": gm.GMM_LAUNCHES, "tgmm": gm.TGMM_LAUNCHES,
                "by_body": {"grouped_matmul": dict(gm.GMM_BODY_LAUNCHES),
                            "tgmm": dict(gm.TGMM_BODY_LAUNCHES)}}
    hops = n * n
    want_k5 = {b: 0 for b in gm.GMM_BODY_LAUNCHES}
    want_k5.update(wgmma=3 * hops, split=3 * hops)
    want_k6 = {b: 0 for b in gm.TGMM_BODY_LAUNCHES}
    want_k6.update(split=3 * hops)
    check(launches["by_body"]["grouped_matmul"] == want_k5
          and launches["by_body"]["tgmm"] == want_k6,
          f"overlap (d): the ring's launches by body {launches['by_body']}, "
          f"want {want_k5} / {want_k6}")
    errs = {}
    for key, a, b, s in zip(("y", "dx", "drouter", "dgate", "dup", "ddown"),
                            ring, bulk, single):
        check(bool(torch.isfinite(a.float()).all()), f"overlap (d) {key}: "
              f"non-finite")
        bound = (OVL_RING_Y_REL_L2 if key == "y" else OVL_RING_ROUTER_REL_L2
                 if key == "drouter" else OVL_RING_GRAD_REL_L2)
        bound_single = (EP_ROUTER_REL_L2 * 10 if key == "drouter"
                        else OVL_RING_GRAD_REL_L2 if key in EP_EXACT
                        else EP_REL_L2)
        errs[key] = {"rel_l2_bulk": rel_l2(a, b),
                     "bitwise_bulk": bool(torch.equal(a, b)),
                     "rel_l2_single": rel_l2(a, s), "bound_bulk": bound,
                     "bound_single": bound_single}
        check(errs[key]["rel_l2_bulk"] <= bound, f"overlap (d) {key}: rel "
              f"L2 {errs[key]['rel_l2_bulk']} from the bulk exchange > "
              f"{bound}")
        check(errs[key]["rel_l2_single"] <= bound_single,
              f"overlap (d) {key}: rel L2 {errs[key]['rel_l2_single']} from "
              f"the single device > {bound_single}")
    del single, bulk, ring
    # each call on fresh inputs: the routing's graph is freed by its
    # backward (the clones and the routing are timed with the call)
    timing = {f"{mode}_{i}": wall_and_device_ms(
        torch, lambda mode=mode: fns[mode](fresh()), OVL_TIME_ITERS)
        for i in (1, 2) for mode in ("bulk", "ring")}
    del fns
    gc.collect()
    torch.cuda.empty_cache()
    out = {"members": n, "tokens_per_member": EP_TOKENS, "errors": errs,
           "launches": launches, "peak_gb_ring": ring_peak,
           "peak_gb_bulk": bulk_peak, "peak_gb_single": single_peak,
           "timing": timing, "fp32": ovl_ring_fp32(torch, x, router, w, cot)}
    log(phase="overlap", part="(d) the ragged ring over 4 members vs the "
        "bulk exchange and the single device, bf16 (fp32 beside)", card=card,
        **out)
    return out


def ovl_ring_fp32(torch, x, router, w, cot) -> dict:
    """(d) in fp32: the ring against the bulk exchange and the single
    device, every output within ``OVL_RING_FP32_REL_L2``."""
    from distributed_training_guide_tpu_torch.models import get_model

    f32 = torch.float32
    cfg = get_model("qwen3-30b-a3b", dtype=f32, moe_dispatch="ragged").config
    fresh, fns = ovl_ring_fns(torch, cfg, x.to(f32), router,
                              [t.to(f32) for t in w], cot.to(f32), f32)
    got = {mode: fns[mode](fresh())
           for mode in ("single", "bulk", "ring")}
    torch.cuda.synchronize()
    errs = {}
    for i, key in enumerate(("y", "dx", "drouter", "dgate", "dup", "ddown")):
        errs[key] = {"rel_l2_bulk": rel_l2(got["ring"][i], got["bulk"][i]),
                     "rel_l2_single": rel_l2(got["ring"][i],
                                             got["single"][i])}
        for ref in ("bulk", "single"):
            check(errs[key][f"rel_l2_{ref}"] <= OVL_RING_FP32_REL_L2,
                  f"overlap (d) fp32 {key}: rel L2 "
                  f"{errs[key][f'rel_l2_{ref}']} from the {ref} > "
                  f"{OVL_RING_FP32_REL_L2}")
    del got, fns, fresh
    gc.collect()
    torch.cuda.empty_cache()
    return {"errors": errs, "bound": OVL_RING_FP32_REL_L2}


def ovl_chapter10(torch, card: str) -> dict:
    """(e) ``c10_moe`` at world 1 (ep plan, ragged; qwen3-30b-a3b at full
    width, 4 layers) with ``--overlap-schedule`` against the unscheduled
    run: one step each, the fused loss against the whole-tensor loss,
    K5 / K6 6 and 3 a layer in both."""
    from distributed_training_guide_tpu_torch.chapters import c10_moe

    over = {"num_layers": MOE_TRAIN_LAYERS}
    argv = MOE_TRAIN_ARGS + ["--moe-dispatch", "ragged", "--log-freq", "1",
                             "--max-steps", "1"]
    runs = {}
    for name, extra in (("whole", []), ("scheduled", ["--overlap-schedule"])):
        reset_moe_counts()                    # the run's path starts here
        torch.cuda.reset_peak_memory_stats()
        out = with_env(plan_env(), lambda: c10_moe.main(
            argv + extra, model_overrides=over))
        torch.cuda.synchronize()
        counts = moe_counts()                 # ... and ends here
        runs[name] = ovl_summary(out, counts)
        ch01_free(torch, out)
        want = {"grouped_matmul": 6 * MOE_TRAIN_LAYERS,
                "tgmm": 3 * MOE_TRAIN_LAYERS}
        check({k: counts[k] for k in want} == want, f"overlap (e) {name}: "
              f"launches {counts}, want {want}")
        log(phase="overlap", part="(e) chapter 10 at world 1", run=name,
            card=card, **runs[name])
    first = abs(runs["scheduled"]["losses"][0] - runs["whole"]["losses"][0]
                ) / abs(runs["whole"]["losses"][0])
    check(first <= OVL_FIRST_LOSS_REL, f"overlap (e): scheduled loss "
          f"{runs['scheduled']['losses']} against {runs['whole']['losses']}")
    return {"runs": runs, "first_loss_rel": first}


def phase_overlap(torch, card: str) -> dict:
    """Phase 22: the overlap schedule and the fused loss on the card."""
    t0 = time.perf_counter()
    ch04 = ovl_chapter04(torch, card)
    single = ovl_single(torch, card)
    chunks = ovl_loss_chunks(torch, card)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    ring = ovl_ring(torch, card, gen)
    # K5 / K6 timed at the window each member runs on a hop of the ring:
    # one member's 4096 tokens x top-8 (M 32768), ~1/4 of them live
    hop = ep_window(torch, card, gen, tokens=EP_TOKENS, phase="overlap",
                    what="(d) the ring's hop window")
    ch10 = ovl_chapter10(torch, card)
    runs = [r for part in (ch04, single, *chunks.values(), ch10)
            for r in part["runs"].values()]
    launches = {k: sum(r["launches"][k] for r in runs)
                for k in runs[0]["launches"]}
    for k in ("grouped_matmul", "tgmm"):
        launches[k] += ring["launches"][k]
    log(phase="overlap", seconds=time.perf_counter() - t0, card=card,
        launches=launches)
    return {"chapter04": ch04, "single": single, "loss_chunks": chunks,
            "ring": ring, "hop_window": hop, "chapter10": ch10,
            "launches": launches}


# ---------------------------------------------------------------------------
# phase 23: speculative decoding, decode horizons and the HTTP endpoint
# (serve/spec.py, ModelPrograms.verify_for / horizon_for, serve/api.py)
# ---------------------------------------------------------------------------

SPEC_K = 4                 # the depth the serve runs speculate at
SPEC_REPEAT = (37, 600)    # a repetitive prompt: 37 tokens repeated to 600
SPEC_MOE_LAYERS = 8        # qwen3-30b-a3b cut to 8 layers for (d)
SPEC_LAYERS = 8            # llama-3.1-8b cut to 8 layers (the time limit)
SPEC_DRAFT_CHUNK = 256     # the drafters' catch-up chunk (prompts to 2000)
SPEC_DRAFT_LAYERS = 4      # the random llama-3.2-1b drafter at 4 of 16 layers
HORIZONS = (1, 4, 8)
HORIZON_PEAK_SLACK = 16 * 2 ** 20   # allocator rounding, not a pool copy
HTTP_TIMEOUT_S = 120


def spec_specs(np, vocab: int) -> list:
    """*serve*'s 8 requests and two repetitive prompts (one greedy, one at
    temperature 0.8 / top-p 0.9), 32 new tokens each."""
    rng = np.random.default_rng(SEED + 23)
    unit, n = SPEC_REPEAT
    reps = []
    for i in range(2):
        block = [int(x) for x in rng.integers(0, vocab, unit)]
        reps.append(dict(prompt_ids=(block * (n // unit + 1))[:n],
                         max_new_tokens=32, seed=8 + i,
                         **({"temperature": 0.8, "top_p": 0.9} if i else {})))
    return serve_specs(np, vocab) + reps


def decision_gap(torch, logits, seeds, positions, temps, top_ks, top_ps):
    """[S] margin of each row's draw in logit units, and [S] the size of
    the sampler's kept set (1 for a greedy row). The margin is the top-2
    logit gap of a greedy row; for a sampled row the gap between the two
    best Gumbel-perturbed scores of the kept set, times the temperature
    (a logit error e moves a score by e / temperature), and 0 where the
    draw sits at the kept set's top-k / top-p edge. A draw can flip where
    its margin is within twice the logits' error, or where the kept set
    itself moves."""
    from distributed_training_guide_tpu_torch.serve.engine import (
        _gumbel_noise)

    top2 = torch.topk(logits, 2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).double()
    ones = torch.ones_like(top2[:, 0], dtype=torch.int64)
    if not bool((temps > 0).any()):
        return gap, ones
    v = logits.shape[-1]
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    sorted_desc, _ = torch.sort(scaled, dim=-1, descending=True, stable=True)
    neg_inf = torch.finfo(torch.float32).min
    k_eff = torch.where(top_ks > 0, top_ks, v).clamp(1, v)
    ranks = torch.arange(v, device=logits.device)[None, :]
    kept = torch.where(ranks < k_eff[:, None], sorted_desc, neg_inf)
    probs = torch.softmax(kept, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    kept = torch.where(cum - probs < top_ps[:, None], kept, neg_inf)
    # the noise is a function of (seed, position, rank), as the sampler's
    noise = _gumbel_noise(seeds, positions, v)
    score = kept.double() + noise
    s2 = torch.topk(score, 2, dim=-1)
    margin = (s2.values[:, 0] - s2.values[:, 1]) * temps.double()
    # at the kept set's edge (the winner is its last rank, or the first
    # rank left out would win if let in) any logit's error can move the
    # edge: margin 0
    last = (kept > neg_inf).sum(-1) - 1
    rows = torch.arange(logits.shape[0], device=logits.device)
    out_rank = torch.clamp(last + 1, max=v - 1)
    edge = (s2.indices[:, 0] == last) | (
        (last + 1 < v) & (sorted_desc[rows, out_rank].double()
                          + noise[rows, out_rank] > s2.values[:, 0]))
    margin = torch.where(edge, torch.zeros_like(margin), margin)
    return (torch.where(temps > 0, margin, gap),
            torch.where(temps > 0, last + 1, ones))


SPEC_TOPK = 8              # logits kept per row to compare two runs
SPEC_LOCAL_CAP = 10        # x (a)'s stream error: past it, not rounding


def gap_programs():
    """A ``ModelPrograms`` that, while ``sink`` is a list, keeps on the
    device, for every active row its forwards draw a token from (decode
    steps and verify rows alike), the (seed, position, decision margin,
    top ``SPEC_TOPK`` logits and ids), and counts its verify forwards'
    active slots and accepted drafts."""
    from distributed_training_guide_tpu_torch.serve.engine import (
        ModelPrograms, _sample_tokens)

    class Tap:
        """The family module, keeping the last all-position logits."""

        def __init__(self, mod):
            self.mod, self.logits = mod, None

        def __getattr__(self, name):
            return getattr(self.mod, name)

        def paged_decode_step(self, *args, **kw):
            logits, cache = self.mod.paged_decode_step(*args, **kw)
            if kw.get("all_logits"):
                self.logits = logits
            return logits, cache

    class GapPrograms(ModelPrograms):
        sink = None

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.verify_slots, self.verify_accepted = [], []
            self.mod = Tap(self.mod)

        def keep(self, logits, seeds, positions, temps, top_ks, top_ps,
                 rows):
            import torch

            top = torch.topk(logits, SPEC_TOPK, dim=-1)
            gap, kept = decision_gap(torch, logits, seeds, positions, temps,
                                     top_ks, top_ps)
            self.sink.append(tuple(x[rows] for x in (
                seeds, positions, gap, kept, top.values, top.indices)))

        def _decode(self, params, pages, tokens, lengths, tables, seeds,
                    temps, top_ks, top_ps, actives, *, stochastic: bool):
            import torch

            attend = self.make_attend(tables, lengths)
            logits, _ = self.mod.paged_decode_step(
                self.config, params, tokens[:, None], lengths, pages, attend)
            logits = logits.float()
            if self.sink is not None:
                self.keep(logits, seeds, lengths + 1, temps, top_ks, top_ps,
                          actives)
            nxt = _sample_tokens(logits, seeds, lengths + 1, temps, top_ks,
                                 top_ps, stochastic=stochastic)
            nxt = torch.where(actives, nxt, 0)
            return nxt, torch.where(actives, lengths + 1, lengths)

        def verify_for(self, t, greedy=False):
            import torch

            fn = super().verify_for(t, greedy)

            def counted(*args):
                targets, n_acc, new_lengths = fn(*args)
                (lengths, seeds, temps, top_ks, top_ps, actives,
                 n_valid) = args[3], *args[5:11]
                self.verify_slots.append(actives.sum())
                self.verify_accepted.append(n_acc[actives].sum())
                if self.sink is not None:
                    s = lengths.shape[0]
                    steps = torch.arange(t, device=lengths.device)

                    def rows(x):
                        return x[:, None].expand(s, t).reshape(s * t)

                    pos = (lengths[:, None] + 1 + steps).reshape(s * t)
                    live = (actives[:, None] & (steps < n_valid[:, None])
                            ).reshape(s * t)
                    self.keep(self.mod.logits.float().reshape(s * t, -1),
                              rows(seeds), pos, rows(temps), rows(top_ks),
                              rows(top_ps), live)
                return targets, n_acc, new_lengths

            return counted

    return GapPrograms


def gaps_by_position(sink) -> dict:
    """(seed, position) -> (decision margin, {token id: logit} of the
    row's top ``SPEC_TOPK``, the kept set's size)."""
    out = {}
    for seeds, pos, gap, kept, vals, ids in sink:
        for s, p, g, n, v, i in zip(seeds.tolist(), pos.tolist(),
                                    gap.tolist(), kept.tolist(),
                                    vals.tolist(), ids.tolist()):
            out[(s, p)] = (g, dict(zip(i, v)), n)
    return out


def local_error(a: dict, b: dict):
    """The max abs difference of two rows' logits over the ids in both
    top lists (None when they share none)."""
    shared = set(a) & set(b)
    return max(abs(a[i] - b[i]) for i in shared) if shared else None


SPEC_STREAM = 32           # positions each stream of (a) covers


def verify_logits_check(torch, programs, specs, ks=SPEC_KS) -> dict:
    """(a) on the whole model: 8 slots prefilled with ``specs``' prompts;
    for each k, a stream of ``SPEC_STREAM`` (rounded up to whole verifies)
    random tokens fed as successive [8, k + 1] verify forwards
    (all_logits) on one clone of the pools, and as T = 1 decode steps on
    another, so that each side reads the k/v it wrote itself, as spec on
    and spec off do: bitwise equal or the max abs error of the fp32
    logits over the stream and over its first window alone, their rel L2
    and the largest logit, and whether every argmax agrees. At
    ``SPEC_K`` also a verify forward's ms beside a decode step's (CUDA
    events, 5 calls each, on scratch clones)."""
    from distributed_training_guide_tpu_torch.serve import (Request,
                                                            ServeEngine)

    eng = ServeEngine(programs.bundle, None, programs=programs, n_slots=8,
                      page_size=16, max_len=4096)
    for r in specs[:8]:
        eng.submit(Request(**{**r, "max_new_tokens": 64}))
    eng.step()                       # admission + every prefill + 1 decode
    sched = eng.scheduler
    check(len(sched.active_indices()) == 8, "verify check: 8 decoding")
    for i in sched.active_indices():     # room for the whole stream
        sched.ensure_lookahead(i, SPEC_STREAM + max(ks) + 1)
    arr = sched.decode_arrays()
    dev = {k: programs.to_device(arr[k]) for k in ("tokens", "lengths",
                                                     "tables")}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 230)
    cfg, mod = programs.config, programs.mod

    def clone(pages):
        return {k: (type(v)(q=v.q.clone(), scale=v.scale.clone())
                    if hasattr(v, "scale") else v.clone())
                for k, v in pages.items()}

    def forward(pages, ids, lens, all_logits):
        return mod.paged_decode_step(
            cfg, programs.params, ids, lens, pages,
            programs.make_attend(dev["tables"], lens),
            all_logits=all_logits)[0].float()

    out = {}
    for k in ks:
        t = k + 1
        n = -(-SPEC_STREAM // t) * t
        ids = torch.randint(0, cfg.vocab_size, (8, n), generator=gen,
                            device="cuda", dtype=torch.int32)
        ids[:, 0] = dev["tokens"]
        pv, p1 = clone(eng.pages), clone(eng.pages)
        got = torch.cat([forward(pv, ids[:, w:w + t], dev["lengths"] + w,
                                 True) for w in range(0, n, t)], dim=1)
        want = torch.stack([forward(p1, ids[:, j:j + 1], dev["lengths"] + j,
                                    False) for j in range(n)], dim=1)
        torch.cuda.synchronize()
        err = (got - want).abs()
        row = {"positions": n, "bitwise": bool(torch.equal(got, want)),
               "max_abs_err": err.max().item(),
               "max_abs_err_first_window": err[:, :t].max().item(),
               "rel_l2": rel_l2(got, want),
               "max_abs_logit": want.abs().max().item(),
               "argmax_equal_share": (got.argmax(-1) == want.argmax(-1)
                                      ).float().mean().item(),
               "finite": bool(torch.isfinite(got).all())}
        check(row["finite"] and got.shape == (8, n, cfg.vocab_size),
              f"verify logits k={k}: {got.shape}, finite {row['finite']}")
        del got, want, err
        if k == SPEC_K:
            first = ids[:, :t]
            row["verify_ms"] = cuda_ms(
                lambda: forward(pv, first, dev["lengths"], True), iters=5,
                warmup=1)
            row["decode_step_ms"] = cuda_ms(
                lambda: forward(p1, first[:, :1], dev["lengths"], False),
                iters=5, warmup=1)
        out[f"k{k}"] = row
        del pv, p1
        torch.cuda.empty_cache()
    del eng
    torch.cuda.empty_cache()
    return out


def spec_run(torch, specs, *, programs, speculate=None, sink=None) -> dict:
    """One ``generate_many`` over ``specs`` on a fresh engine sharing
    ``programs`` (a ``gap_programs()``): tokens, wall, the speculation
    counters, and the K4 / K5 / K7 launches of the run (each count set to
    0 before it and read after it). With a ``sink`` the run keeps its
    rows' margins, kept-set sizes and top logits (a sort a row: such a
    run is not the one timed)."""
    from distributed_training_guide_tpu_torch.ops import grouped_matmul as gm
    from distributed_training_guide_tpu_torch.ops import paged_decode as pd
    from distributed_training_guide_tpu_torch.ops import quantized_matmul as qm
    from distributed_training_guide_tpu_torch.serve import (
        Request, ServeEngine, generate_many, throughput_stats)

    eng = ServeEngine(programs.bundle, None, programs=programs, n_slots=8,
                      page_size=16, max_len=4096, speculate=speculate,
                      spec_k=SPEC_K)
    programs.sink = sink
    programs.verify_slots, programs.verify_accepted = [], []
    verify0, prefill0 = programs.verify_calls, programs.prefill_calls
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = generate_many(eng, [Request(**r) for r in specs])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    programs.sink = None
    launches = {"paged_attend": pd.LAUNCHES,
                "paged_attend_split": pd.SPLIT_LAUNCHES,
                "paged_attend_mma": pd.MMA_LAUNCHES,
                "paged_attend_combine": pd.COMBINE_LAUNCHES,
                "grouped_matmul": gm.GMM_LAUNCHES,
                "quantized_matmul": qm.LAUNCHES}
    for r in res:
        check(r.finish_reason == "length" and len(r.generated_ids) == 32,
              f"spec run: request {r.request_id} ended {r.finish_reason} "
              f"after {len(r.generated_ids)} tokens")
        check(all(0 <= x < programs.config.vocab_size
                  for x in r.generated_ids), "spec run: token out of range")
    st = eng.stats()
    tp = throughput_stats(res, wall, eng)
    out = {"tokens": [r.generated_ids for r in res], "wall_s": wall,
           "launches": launches,
           "verify_forwards": programs.verify_calls - verify0,
           "prefill_forwards": programs.prefill_calls - prefill0,
           "plain_decode_steps": st["host_dispatches"] - st["spec_steps"],
           "tokens_per_s": tp["tokens_per_s"], "ttft_s_p50":
           tp["ttft_s_p50"], "itl_s_avg": st["itl_s_avg"],
           "decode_steps": st["decode_steps"],
           "decode_tokens_per_step": st["decode_tokens_per_step"],
           "spec_steps": st["spec_steps"],
           "drafted": st["spec_tokens_drafted"],
           "accepted": st["spec_tokens_accepted"],
           "rejected": st["spec_tokens_rejected"],
           "acceptance_rate": st.get("spec_acceptance_rate"),
           "drafter": {k: st[k] for k in ("draft_model_steps",
                                          "catchup_tokens",
                                          "catchup_chunks", "resyncs")
                       if k in st}}
    if programs.verify_slots:
        slots = int(sum(x.item() for x in programs.verify_slots))
        acc = int(sum(x.item() for x in programs.verify_accepted))
        # every slot of a verify emits its accepted drafts and one target
        # draw (less where the request ended inside the run)
        out["tokens_per_verify"] = (acc + slots) / out["verify_forwards"]
        out["tokens_per_verify_slot"] = (acc + slots) / slots
    del eng
    torch.cuda.empty_cache()
    return out


def k4_by_t(run: dict, layers: int, draft_layers: int = 0) -> dict:
    """K4 launches of a run by query tile T, from its forward counts: one
    a layer per forward (T 1 the decode steps and the drafter's steps,
    T k + 1 the verifies, ``SPEC_DRAFT_CHUNK`` the drafter's catch-up
    chunks; the bucketed prefill launches none), checked against the
    count."""
    d = run["drafter"]
    by_t = {"T1": layers * run["plain_decode_steps"]
            + draft_layers * d.get("draft_model_steps", 0),
            f"T{SPEC_K + 1}": layers * run["verify_forwards"],
            f"T{SPEC_DRAFT_CHUNK}": draft_layers * d.get("catchup_chunks",
                                                          0)}
    check(sum(by_t.values()) == run["launches"]["paged_attend"],
          f"K4 launches {run['launches']['paged_attend']} against the "
          f"forwards' {by_t}")
    return by_t


def divergences(specs, off: list, on: list, gaps: dict, on_rows: dict,
                bound: float) -> dict:
    """Each stream of ``on`` against spec off's: identical, or its first
    divergence at generated index g (position len(prompt) + g, drawn by a
    spec-off decode step for g >= 1) with spec off's decision margin
    there, the two runs' logit error at that position (``local_err``, on
    the ids both top lists hold), the most of it over the stream's shared
    prefix, and the sampler's kept-set size in each run. ``explained``:
    the margin is within twice ``bound``, the verify-vs-decode logit
    error (a) measured; ``explained_locally``: the error the two runs
    show at that very position is under ``SPEC_LOCAL_CAP`` x ``bound``
    and either the margin is within twice it or the kept set moved (a
    top-p edge among many near-equal probabilities moves with errors far
    below any one margin)."""
    rows = []
    for spec, a, b in zip(specs, off, on):
        if a == b:
            continue
        g = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        p0 = len(spec["prompt_ids"])
        key = (spec["seed"], p0 + g)
        margin = gaps[key][0] if g and key in gaps else None
        errs = [local_error(gaps[(spec["seed"], p0 + j)][1],
                            on_rows[(spec["seed"], p0 + j)][1])
                for j in range(1, g + 1)
                if (spec["seed"], p0 + j) in gaps
                and (spec["seed"], p0 + j) in on_rows]
        errs = [e for e in errs if e is not None]
        local = (local_error(gaps[key][1], on_rows[key][1])
                 if key in gaps and key in on_rows else None)
        kept = ((gaps[key][2], on_rows[key][2])
                if key in gaps and key in on_rows else None)
        edge = kept is not None and kept[0] != kept[1]
        rows.append({
            "seed": spec["seed"], "index": g, "margin": margin,
            "local_err": local, "prefix_max_err": max(errs, default=None),
            "kept_off_on": kept, "kept_set_moved": edge,
            "explained": margin is not None and margin <= 2 * bound,
            "explained_locally": (
                margin is not None and local is not None
                and local <= SPEC_LOCAL_CAP * bound
                and (margin <= 2 * local or edge))})
    return {"identical": len(off) - len(rows), "of": len(off),
            "divergent": rows,
            "all_explained": all(r["explained"] for r in rows),
            "all_explained_locally": all(
                r["explained"] or r["explained_locally"] for r in rows)}


def judge(name: str, specs, off: dict, run: dict, gaps: dict,
          on_rows: dict, logits: dict) -> dict:
    """Which identity held for ``run`` against spec off: every stream
    identical (required where (a) found the verify logits bitwise the
    decode step's); else every divergence within (a)'s bound; else every
    one within the rounding error the two runs show at its position.
    Fails otherwise: a divergence the logits' error cannot explain."""
    bitwise = logits[f"k{SPEC_K}"]["bitwise"]
    bound = logits[f"k{SPEC_K}"]["max_abs_err"]
    div = divergences(specs, off["tokens"], run["tokens"], gaps, on_rows,
                      bound)
    held = ("identical" if div["identical"] == div["of"]
            else "divergences within the bound (a) measured"
            if div["all_explained"]
            else "divergences within the runs' own logit error"
            if div["all_explained_locally"] else "broken")
    check(held == "identical" if bitwise else held != "broken",
          f"{name}: spec on against spec off: {div} (verify logits bitwise "
          f"{bitwise}, error {bound})")
    return {"identity": held, "bound_logit_err": bound, **div}


def spec_serve(torch, card: str, programs, logits: dict) -> dict:
    """(b) *serve* with speculation off, ``ngram``, a self-draft and a
    random-weight llama-3.2-1b drafter (k 4 each), every stream judged
    against spec off."""
    import numpy as np

    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.serve import DraftModelDrafter

    cfg = programs.config
    specs = spec_specs(np, cfg.vocab_size)
    spec_run(torch, specs[:2], programs=programs)          # warm-up
    off = spec_run(torch, specs, programs=programs)
    sink: list = []
    ref = spec_run(torch, specs, programs=programs, sink=sink)
    check(ref["tokens"] == off["tokens"], "spec off: the recorded run's "
          "tokens differ from the timed run's")
    gaps = gaps_by_position(sink)
    del sink
    small = get_model("llama-3.2-1b", dtype=torch.bfloat16,
                      param_dtype=torch.bfloat16,
                      num_layers=SPEC_DRAFT_LAYERS)
    check(small.config.vocab_size == cfg.vocab_size, "draft vocab")
    drafters = {
        "ngram": lambda: "ngram",
        "self-draft": lambda: DraftModelDrafter(
            programs.bundle, programs.params, n_slots=8, max_len=4096,
            k=SPEC_K, chunk=SPEC_DRAFT_CHUNK),
        "draft-1b": lambda: DraftModelDrafter(
            small, small.init(small.config, SEED + 1, device="cuda"),
            n_slots=8, max_len=4096, k=SPEC_K, chunk=SPEC_DRAFT_CHUNK)}
    out = {"off": {k: v for k, v in off.items() if k != "tokens"}}
    out["off"]["k4_by_T"] = k4_by_t(off, cfg.num_layers)
    log(phase="spec_horizon", part="(b) serve, spec off", card=card,
        **out["off"])
    for name, make in drafters.items():
        drafter = make()
        draft_layers = (drafter.config.num_layers
                        if not isinstance(drafter, str) else 0)
        run = spec_run(torch, specs, programs=programs, speculate=drafter)
        on_sink: list = []
        if not isinstance(drafter, str):    # a drafter's state starts anew
            drafter = make()
        rec = spec_run(torch, specs, programs=programs, speculate=drafter,
                       sink=on_sink)
        check(rec["tokens"] == run["tokens"], f"{name}: the recorded run's "
              f"tokens differ from the timed run's")
        del drafter, rec
        check(run["drafted"] > 0 and run["verify_forwards"] > 0,
              f"{name}: the run never speculated")
        row = {k: v for k, v in run.items() if k != "tokens"}
        row["k4_by_T"] = k4_by_t(run, cfg.num_layers, draft_layers)
        row["tokens_per_s_vs_off"] = run["tokens_per_s"] / off[
            "tokens_per_s"]
        row["judged"] = judge(name, specs, off, run, gaps,
                              gaps_by_position(on_sink), logits)
        del on_sink
        out[name] = row
        log(phase="spec_horizon", part=f"(b) serve, {name}", card=card,
            **row)
        gc.collect()
        torch.cuda.empty_cache()
    check(out["draft-1b"]["rejected"] > 0, "the 1b drafter had nothing "
          "rejected")
    return out


def spec_int8(torch, card: str, programs, specs) -> dict:
    """(c) int8 weights (K7 in every product of the verify): the verify
    logits against the decode steps' at k 4, ``ngram`` against spec off,
    the peak with only the int8 tree resident."""
    from distributed_training_guide_tpu_torch.ops import quantized_matmul as qm

    torch.cuda.reset_peak_memory_stats()
    logits = verify_logits_check(torch, programs, specs, ks=(SPEC_K,))
    off = spec_run(torch, specs, programs=programs)
    sink: list = []
    ref = spec_run(torch, specs, programs=programs, sink=sink)
    check(ref["tokens"] == off["tokens"], "int8 spec off: recorded run")
    fma = qm.BODY_LAUNCHES["fma"]
    run = spec_run(torch, specs, programs=programs, speculate="ngram")
    check(run["drafted"] > 0, "int8: the ngram run never speculated")
    on_sink: list = []
    rec = spec_run(torch, specs, programs=programs, speculate="ngram",
                   sink=on_sink)
    check(rec["tokens"] == run["tokens"], "int8: recorded ngram run")
    per_forward = 7 * programs.config.num_layers + 1
    forwards = (run["plain_decode_steps"] + run["verify_forwards"]
                + run["prefill_forwards"])
    check(run["launches"]["quantized_matmul"] == per_forward * forwards,
          f"int8: {run['launches']['quantized_matmul']} K7 launches for "
          f"{forwards} forwards")
    check(qm.BODY_LAUNCHES["fma"] == fma, "int8: a K7 launch took the "
          "FMA body")
    out = {"verify_logits": logits,
           "off": {k: v for k, v in off.items() if k != "tokens"},
           "ngram": {k: v for k, v in run.items() if k != "tokens"},
           "judged": judge("int8 ngram", specs, off, run,
                           gaps_by_position(sink), gaps_by_position(on_sink),
                           logits),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    out["ngram"]["k4_by_T"] = k4_by_t(run, programs.config.num_layers)
    log(phase="spec_horizon", part="(c) int8 weights, ngram vs off",
        card=card, **out)
    return out


def spec_moe(torch, card: str) -> dict:
    """(d) qwen3-30b-a3b at full width cut to ``SPEC_MOE_LAYERS`` layers,
    bf16: the verify logits against the decode steps' at k 4 and
    ``ngram`` against spec off, K5 launched by the verify."""
    import numpy as np

    from distributed_training_guide_tpu_torch.models import get_model

    bundle = get_model("qwen3-30b-a3b", dtype=torch.bfloat16,
                       param_dtype=torch.bfloat16,
                       num_layers=SPEC_MOE_LAYERS)
    params = bundle.init(bundle.config, SEED, device="cuda")
    programs = gap_programs()(bundle, params)
    del params
    specs = spec_specs(np, bundle.config.vocab_size)
    logits = verify_logits_check(torch, programs, specs, ks=(SPEC_K,))
    off = spec_run(torch, specs, programs=programs)
    sink: list = []
    ref = spec_run(torch, specs, programs=programs, sink=sink)
    check(ref["tokens"] == off["tokens"], "moe spec off: recorded run")
    run = spec_run(torch, specs, programs=programs, speculate="ngram")
    check(run["drafted"] > 0, "moe: the ngram run never speculated")
    on_sink: list = []
    rec = spec_run(torch, specs, programs=programs, speculate="ngram",
                   sink=on_sink)
    check(rec["tokens"] == run["tokens"], "moe: recorded ngram run")
    per_forward = 3 * SPEC_MOE_LAYERS       # gate, up, down a layer
    forwards = (run["plain_decode_steps"] + run["verify_forwards"]
                + run["prefill_forwards"])
    check(run["launches"]["grouped_matmul"] == per_forward * forwards,
          f"moe: {run['launches']['grouped_matmul']} K5 launches for "
          f"{forwards} forwards")
    out = {"layers": SPEC_MOE_LAYERS, "verify_logits": logits,
           "off": {k: v for k, v in off.items() if k != "tokens"},
           "ngram": {k: v for k, v in run.items() if k != "tokens"},
           "judged": judge("moe ngram", specs, off, run,
                           gaps_by_position(sink), gaps_by_position(on_sink),
                           logits)}
    out["ngram"]["k4_by_T"] = k4_by_t(run, SPEC_MOE_LAYERS)
    log(phase="spec_horizon", part="(d) qwen3-30b-a3b, ngram vs off",
        card=card, **out)
    del programs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def horizon_run(torch, programs, specs, k: int, profiled: bool) -> dict:
    """One decode run at ``decode_horizon`` k: every request admitted and
    prefilled by the first step, then the decode steps timed on the host
    clock (and, ``profiled``, under torch.profiler for the device's busy
    time)."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_training_guide_tpu_torch.ops import paged_decode as pd
    from distributed_training_guide_tpu_torch.serve import (Request,
                                                            ServeEngine)

    eng = ServeEngine(programs.bundle, None, programs=programs, n_slots=8,
                      page_size=16, max_len=4096, decode_horizon=k)
    ptrs = {n: eng.pages[n].data_ptr() for n in ("k", "v")}
    ids = [eng.submit(Request(**r)) for r in specs]
    done = {}
    for res in eng.step():
        done[res.request_id] = res
    check(len(eng.scheduler.active_indices()) == len(specs),
          f"horizon {k}: every request decoding after the first step")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tokens0 = eng.decode_tokens
    launches0 = pd.LAUNCHES
    ctx = (profile(activities=[ProfilerActivity.CUDA]) if profiled
           else contextlib.nullcontext())
    with ctx as prof:
        t0 = time.perf_counter()
        while eng.has_work:
            for res in eng.step():
                done[res.request_id] = res
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    tokens = eng.decode_tokens - tokens0
    out = {"tokens": [done[i].generated_ids for i in ids],
           "decode_tokens": tokens, "wall_ms": wall * 1e3,
           "wall_ms_per_decode_token": wall * 1e3 / tokens,
           # over the whole run: one read per dispatch
           "host_reads_per_decode_token": (eng.host_dispatches
                                           / eng.decode_tokens),
           "horizon_effective": eng.stats()["horizon_effective"],
           "k4_launches": pd.LAUNCHES - launches0,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "pools_kept": all(eng.pages[n].data_ptr() == ptrs[n]
                             for n in ("k", "v"))}
    if profiled:
        busy = sum(_device_us(e) for e in prof.key_averages()
                   if _device_us(e) > 0) / 1e3
        out["device_busy_ms"] = busy if busy else "not measured"
        out["device_idle_share"] = (max(0.0, 1 - busy / (wall * 1e3))
                                    if busy else "not measured")
    del eng
    torch.cuda.empty_cache()
    return out


def horizons(torch, card: str, programs) -> dict:
    """(e) *serve*'s 8 requests, all greedy, at ``HORIZONS``: tokens
    bitwise K 1's, host reads and wall ms per decode token, the device's
    idle share (a profiled run beside the timed one), the pools' storage
    kept and no peak beyond K 1's."""
    import numpy as np

    specs = [{**r, "temperature": 0.0, "top_p": 1.0}
             for r in serve_specs(np, programs.config.vocab_size)]
    horizon_run(torch, programs, specs[:2], HORIZONS[-1], False)  # warm-up
    out = {}
    for k in HORIZONS:
        timed = horizon_run(torch, programs, specs, k, False)
        prof = horizon_run(torch, programs, specs, k, True)
        check(prof["tokens"] == timed["tokens"], f"horizon {k}: profiled")
        row = {key: v for key, v in timed.items() if key != "tokens"}
        row.update(device_idle_share=prof["device_idle_share"],
                   device_busy_ms=prof["device_busy_ms"],
                   wall_ms_profiled=prof["wall_ms"])
        out[f"K{k}"] = row
        out[f"K{k}"]["tokens_bitwise_k1"] = (
            timed["tokens"] == out.get("_k1", timed["tokens"]))
        out.setdefault("_k1", timed["tokens"])
        check(row["pools_kept"], f"horizon {k}: the pools moved")
        check(out[f"K{k}"]["tokens_bitwise_k1"], f"horizon {k}: tokens "
              f"differ from K 1's")
        check(row["peak_bytes"] <= out["K1"]["peak_bytes"]
              + HORIZON_PEAK_SLACK, f"horizon {k}: peak {row['peak_bytes']} "
              f"over K 1's {out['K1']['peak_bytes']}")
        log(phase="spec_horizon", part=f"(e) decode horizon {k}", card=card,
            **row)
    del out["_k1"]
    return out


def http_call(url: str, body: Optional[dict] = None) -> tuple:
    """(status, parsed JSON body) of one call, with a timeout."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def http_stream(host: str, port: int, body: dict) -> tuple:
    """A streamed /generate: the token events in order and the done
    event."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=HTTP_TIMEOUT_S)
    try:
        conn.request("POST", "/generate", json.dumps({**body,
                                                      "stream": True}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        check(resp.status == 200, f"stream status {resp.status}")
        tokens, done = [], None
        for line in resp.read().decode().splitlines():
            if line.startswith("data: "):
                ev = json.loads(line[6:])
                if "token_id" in ev:
                    tokens.append(ev["token_id"])
                elif ev.get("done"):
                    done = ev
        return tokens, done
    finally:
        conn.close()


def http_serve(torch, card: str, programs) -> dict:
    """(f) ``serve_http`` on 127.0.0.1 at an OS-chosen port, serving
    *serve*'s engine: three requests (one streamed) each equal to
    ``generate_many``'s tokens, /healthz and /readyz answered; the server
    shut down in ``finally``."""
    import numpy as np

    from distributed_training_guide_tpu_torch.serve import (
        Request, ServeEngine, generate_many, serve_http)

    specs = serve_specs(np, programs.config.vocab_size)
    reqs = [{**specs[i], "max_new_tokens": 16} for i in (0, 2, 6)]
    want = [r.generated_ids for r in generate_many(
        ServeEngine(programs.bundle, None, programs=programs, n_slots=8,
                    page_size=16, max_len=4096),
        [Request(**r) for r in reqs])]
    eng = ServeEngine(programs.bundle, None, programs=programs, n_slots=8,
                      page_size=16, max_len=4096)
    server, worker = serve_http(eng, host="127.0.0.1", port=0)
    host, port = server.server_address[:2]
    url = f"http://{host}:{port}"
    try:
        t0 = time.perf_counter()
        health = http_call(url + "/healthz")
        ready = http_call(url + "/readyz")
        got = [http_call(url + "/generate", reqs[i]) for i in (0, 1)]
        streamed, done = http_stream(host, port, reqs[2])
        wall = time.perf_counter() - t0
    finally:
        worker.stop(drain=True, timeout_s=30)
        server.shutdown()
        server.server_close()
        worker.join(timeout=30)
    check(health[0] == 200 and health[1]["ok"], f"/healthz {health}")
    check(ready[0] == 200 and ready[1]["ready"], f"/readyz {ready}")
    for i, (status, body) in enumerate(got):
        check(status == 200 and body["generated_ids"] == want[i],
              f"/generate {i}: {status} {body.get('generated_ids')} "
              f"against {want[i]}")
    check(streamed == want[2] and done is not None
          and done["generated_ids"] == want[2],
          f"streamed /generate: {streamed} against {want[2]}")
    check(not worker.is_alive(), "the worker thread outlived stop()")
    out = {"port": port, "healthz": health[0], "readyz": ready[0],
           "requests": 3, "streamed_tokens": len(streamed), "wall_s": wall,
           "tokens_equal_generate_many": True}
    log(phase="spec_horizon", part="(f) serve_http", card=card, **out)
    return out


def phase_spec_horizon(torch, card: str) -> dict:
    """Phase 23: (a) verify against decode logits, (b) speculation on
    *serve*, (c) under int8 weights, (d) on qwen3-30b-a3b cut in depth,
    (e) decode horizons, (f) the HTTP endpoint."""
    import numpy as np

    from distributed_training_guide_tpu_torch.models import get_model

    t0 = time.perf_counter()
    bundle = get_model("llama-3.1-8b", dtype=torch.bfloat16,
                       param_dtype=torch.bfloat16, num_layers=SPEC_LAYERS)
    params = bundle.init(bundle.config, SEED, device="cuda")
    programs = gap_programs()(bundle, params)
    specs = spec_specs(np, bundle.config.vocab_size)
    logits = verify_logits_check(torch, programs, specs)
    log(phase="spec_horizon", part="(a) verify logits vs decode steps, "
        f"llama-3.1-8b bf16 at {SPEC_LAYERS} layers", card=card, **logits)
    serve = spec_serve(torch, card, programs, logits)
    horizon = horizons(torch, card, programs)
    http = http_serve(torch, card, programs)
    del programs
    gc.collect()
    torch.cuda.empty_cache()
    # int8: the bf16 tree goes once the programs hold the int8 one
    programs = gap_programs()(bundle, params, weight_dtype="int8")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    int8 = spec_int8(torch, card, programs, specs)
    del programs
    gc.collect()
    torch.cuda.empty_cache()
    moe = spec_moe(torch, card)
    runs = [serve[n] for n in ("ngram", "self-draft", "draft-1b")] + [
        int8["ngram"], moe["ngram"]]
    launches = {k: sum(r["launches"][k] for r in runs)
                for k in runs[0]["launches"]}
    log(phase="spec_horizon", seconds=time.perf_counter() - t0, card=card,
        launches=launches)
    return {"logits": logits, "serve": serve, "int8": int8, "moe": moe,
            "horizon": horizon, "http": http, "launches": launches}


# ---------------------------------------------------------------------------
# phase 24: serve tenants (multi-LoRA through K5) and the post-training loop
# ---------------------------------------------------------------------------

TENANT_POOL = dict(max_adapters=5, adapter_rank=8, adapter_alpha=16.0)
TENANT_A_STD, TENANT_B_STD = 0.02, 0.1   # deltas that move greedy tokens
GMM_FP32_REL = 1e-5        # K5's FMA body against gmm_reference, fp32
TENANT_LAYERS = 8          # llama-3.1-8b cut to 8 layers (the time limit)
POST_MODEL = "llama-3.2-1b"
POST_BATCH, POST_NEW, POST_ITERS = 8, 64, 2   # the NaN drill: one more
POST_PROMPTS = (16, 64)    # prompt lengths drawn in this range


def kernel_counts() -> dict:
    """Every kernel wrapper's launch counter (K4 by body)."""
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa
    from distributed_training_guide_tpu_torch.ops import grouped_matmul as gm
    from distributed_training_guide_tpu_torch.ops import paged_decode as pd
    from distributed_training_guide_tpu_torch.ops import quantized_matmul as qm

    return {"flash_fwd": fa.FWD_LAUNCHES, "flash_dq": fa.DQ_LAUNCHES,
            "flash_dkv": fa.DKV_LAUNCHES,
            "paged_attend_split": pd.SPLIT_LAUNCHES,
            "paged_attend_mma": pd.MMA_LAUNCHES,
            "paged_attend_combine": pd.COMBINE_LAUNCHES,
            "grouped_matmul": gm.GMM_LAUNCHES, "tgmm": gm.TGMM_LAUNCHES,
            "quantized_matmul": qm.LAUNCHES}


def zero_counts() -> None:
    """Every kernel wrapper's launch counter that ``kernel_counts`` reads
    to 0 (the counts by body run on: phases compare them across runs)."""
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa
    from distributed_training_guide_tpu_torch.ops import grouped_matmul as gm
    from distributed_training_guide_tpu_torch.ops import paged_decode as pd
    from distributed_training_guide_tpu_torch.ops import quantized_matmul as qm

    fa.FWD_LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0
    pd.LAUNCHES = pd.SPLIT_LAUNCHES = pd.MMA_LAUNCHES = 0
    pd.COMBINE_LAUNCHES = 0
    gm.GMM_LAUNCHES = gm.TGMM_LAUNCHES = qm.LAUNCHES = 0


def counts_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in kernel_counts().items()}


def tenant_gmm(torch) -> dict:
    """(a) K5 at the shapes multi-LoRA serving and the post objective give
    it (fp32 operands: the FMA body) against ``gmm_reference`` on the
    card, timed by ``queued_ms`` beside the plain version, the bound (bytes
    or fp32 operations) and ``torch._grouped_mm`` on bf16 copies where it
    takes the shape. These launches are checks, not the main path."""
    from distributed_training_guide_tpu_torch.ops import grouped_matmul as gm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    counts = (gm.GMM_LAUNCHES, gm.TGMM_LAUNCHES, dict(gm.GMM_BODY_LAUNCHES))
    dev = torch.device("cuda")

    def sz(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    r = TENANT_POOL["adapter_rank"]
    # (b)'s decode mix: request i on adapter i % 5; a chunk on adapter 1;
    # the post batch's continuation lengths, two rollouts empty
    dec, chunk = sz([2, 2, 2, 1, 1]), sz([0, 256, 0, 0, 0])
    post = sz([64, 0, 64, 37, 0, 64, 12, 64])
    m_post = POST_BATCH * (2 * POST_NEW - 1)
    cases = (("lora-a-decode", 8, 4096, r, dec),
             ("lora-b-wq-decode", 8, r, 4096, dec),
             ("lora-b-wv-decode", 8, r, 1024, dec),
             ("lora-a-chunk", 256, 4096, r, chunk),
             ("lora-b-wq-chunk", 256, r, 4096, chunk),
             ("post-objective", m_post, 1, 1, post),
             ("post-objective-dlhs", m_post, 1, 1, post))
    out = {}
    for name, m, k, n, sizes in cases:
        lhs = torch.randn(m, k, generator=gen, device=dev)
        std = (TENANT_A_STD if k > r else TENANT_B_STD) if n > 1 else 1.0
        rhs = torch.randn(sizes.shape[0], k, n, generator=gen,
                          device=dev) * std
        if name.endswith("dlhs"):
            rhs = rhs.transpose(1, 2)          # the backward's rhs^T
        body = gm._gmm_plan(lhs, rhs)
        check(body == "fma", f"tenant gmm {name}: body {body}")
        got = gm.gmm(lhs, rhs, sizes)
        want = gm.gmm_reference(lhs, rhs, sizes, torch.float32)
        total = int(sizes.sum())
        err = (got - want).abs().max().item()
        bound = GMM_FP32_REL * max(want.abs().max().item(), 1e-30)
        check(err <= bound and not got[total:].any(),
              f"tenant gmm {name}: max abs {err} > {bound}")
        call = lambda: gm.gmm(lhs, rhs, sizes)     # noqa: E731
        ms = queued_ms(torch, call, 50)
        plain_ms = cuda_ms(lambda: gm.gmm_reference(lhs, rhs, sizes,
                                                    torch.float32),
                           iters=5, warmup=1)
        lib_ms, lib_call_ms, lib = library_grouped_mm(
            torch, lhs.to(torch.bfloat16),
            rhs.to(torch.bfloat16).contiguous(), sizes)
        fp32_ms, fp32_err, fp32_note = library_fp32_grouped(
            torch, lhs, rhs, sizes, want)
        row = dict(kernel="grouped_matmul", shape=name, M=m, K=k, N=n,
                   G=int(sizes.shape[0]), rows=total,
                   groups_nonempty=int((sizes > 0).sum()), dtype="fp32",
                   body=body, max_abs_err=err, err_bound=bound, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms,
                   library_call_ms=lib_call_ms, library_fp32_ms=fp32_ms,
                   library_fp32_max_abs_err=fp32_err,
                   library_fp32_note=fp32_note,
                   **gmm_bound(m, k, n, sizes, 4, 4, 4, "float32"))
        if lib_ms is None:
            row["library_note"] = ("torch._grouped_mm on bf16 copies: "
                                   + lib)
        else:
            row["library_note"] = ("torch._grouped_mm on bf16 copies of "
                                   "the operands (not the fp32 function)")
        row["share_of_bound"] = row["bound_ms"] / ms
        out[name] = row
        log(phase="tenants_post", part="(a) K5 at the tenant and post "
            "shapes", **row)
        del lhs, rhs, lib
    gm.GMM_LAUNCHES, gm.TGMM_LAUNCHES = counts[:2]
    gm.GMM_BODY_LAUNCHES.update(counts[2])
    return out


def library_fp32_grouped(torch, lhs, rhs, sizes, want) -> tuple:
    """One PyTorch call computing the fp32 grouped product on the fp32
    operands, as a yardstick: ``torch._grouped_mm`` where this torch takes
    fp32, else ``torch.bmm`` of each row against its group's matrix
    gathered per row (the gather inside the timed call). Returns (device
    ms by ``queued_ms``, max abs error against the plain version, what
    ran)."""
    total = int(sizes.sum())
    fn = getattr(torch, "_grouped_mm", None)
    if fn is not None:
        offs = torch.cumsum(sizes, 0, dtype=torch.int32)
        try:
            out = fn(lhs, rhs, offs=offs)
            torch.cuda.synchronize()
            err = (out[:total] - want[:total]).abs().max().item() \
                if total else 0.0
            return (queued_ms(torch, lambda: fn(lhs, rhs, offs=offs), 20),
                    err, "torch._grouped_mm on the fp32 operands")
        except RuntimeError as exc:
            why = str(exc).splitlines()[0][:100]
    else:
        why = "torch._grouped_mm is absent"
    group = torch.repeat_interleave(
        torch.arange(sizes.shape[0], device=lhs.device), sizes.long())

    def call():
        return torch.bmm(lhs[:total, None, :], rhs[group])[:, 0]

    err = (call() - want[:total]).abs().max().item() if total else 0.0
    return (queued_ms(torch, call, 20), err,
            f"fp32 torch.bmm of each row against its gathered adapter "
            f"matrix, the gather timed inside ({why})")


def tap_programs():
    """A ``ModelPrograms`` that, while ``rows`` is a dict, keeps every
    logits row it draws a token from, keyed by (request seed, position):
    the first token's off the prefill, and each active slot's of each
    decode step."""
    from distributed_training_guide_tpu_torch.serve.engine import (
        ModelPrograms, _sample_tokens)

    class TapPrograms(ModelPrograms):
        rows = None

        def sample_one(self, logit, request, position):
            if self.rows is not None:
                self.rows[(request.seed, position)] = logit.float().clone()
            return super().sample_one(logit, request, position)

        def _decode(self, params, pages, tokens, lengths, tables, seeds,
                    temps, top_ks, top_ps, actives, *lora_args,
                    stochastic: bool):
            import torch

            attend = self.make_attend(tables, lengths)
            logits, _ = self.mod.paged_decode_step(
                self.config, params, tokens[:, None], lengths, pages, attend,
                **self._lora_kw(lora_args))
            logits = logits.float()
            if self.rows is not None:
                for i in actives.nonzero()[:, 0].tolist():
                    self.rows[(int(seeds[i]), int(lengths[i]) + 1)] = \
                        logits[i].clone()
            nxt = _sample_tokens(logits, seeds, lengths + 1, temps, top_ks,
                                 top_ps, stochastic=stochastic)
            nxt = torch.where(actives, nxt, 0)
            return nxt, torch.where(actives, lengths + 1, lengths)

    return TapPrograms


def tenant_payloads(torch, shapes: dict, n: int, seed: int) -> list:
    """n seeded random adapters on the card (the params['lora'] layout)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [{t: {"a": torch.randn(p["a"], generator=gen, device="cuda")
                 * TENANT_A_STD,
                 "b": torch.randn(p["b"], generator=gen, device="cuda")
                 * TENANT_B_STD} for t, p in shapes.items()}
            for _ in range(n)]


def rows_equal(a: dict, b: dict, seeds) -> int:
    """The (seed, position) rows of ``seeds`` in ``a``, each bitwise its
    row in ``b``; returns how many were compared."""
    keys = [key for key in a if key[0] in seeds]
    check(keys and all(key in b for key in keys), f"rows of {seeds} "
          f"missing: {len(keys)} recorded")
    for key in keys:
        check(bool((a[key] == b[key]).all()), f"logits row {key} differs")
    return len(keys)


def tenant_run(torch, bundle, programs, specs, common, *, rows=None,
               timed=False) -> tuple:
    """``specs`` through a fresh engine on ``programs``; (results, stats
    or None, the launches of the run, the engine's decode steps and
    forwards)."""
    from distributed_training_guide_tpu_torch.serve import (
        Request, ServeEngine, generate_many, throughput_stats)

    programs.rows = rows
    programs.prefill_calls = 0
    eng = ServeEngine(bundle, None, programs=programs, **common)
    before = kernel_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = generate_many(eng, [Request(**s) for s in specs])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    programs.rows = None
    stats = None
    if timed:
        stats = throughput_stats(res, wall, eng)
        stats["itl_s_avg"] = eng.stats()["itl_s_avg"]
    return (res, stats, counts_since(before),
            eng.decode_steps + programs.prefill_calls)


def tenant_merged(torch, params, pool, payload) -> dict:
    """The base params with the tenant's deltas merged into wq / wv:
    ``(W + scale * A @ B)`` summed in fp32, stored bf16 (the other leaves
    shared)."""
    layers = dict(params["layers"])
    attn = dict(layers["attn"])
    for t, pair in payload.items():
        w = attn[t]
        attn[t] = (w.float() + pool.scale * torch.bmm(pair["a"], pair["b"])
                   ).to(w.dtype)
    layers["attn"] = attn
    return {**params, "layers": layers}


def first_divergence(a: list, b: list):
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)


def tenant_serve(torch, card: str) -> dict:
    """(b) tenants on *serve*: llama-3.1-8b at full width cut to
    ``TENANT_LAYERS`` layers in bf16, 8 slots, page 16, *serve*'s 8
    requests, a pool of 5 slots (4 tenants, r 8, wq / wv, seeded random
    adapters), bucketed."""
    import numpy as np

    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.ops import grouped_matmul as gm
    from distributed_training_guide_tpu_torch.serve import (Request,
                                                            ServeEngine)
    from distributed_training_guide_tpu_torch.serve.adapters import \
        adapter_shapes

    t0 = time.perf_counter()
    bundle = get_model("llama-3.1-8b", dtype=torch.bfloat16,
                       param_dtype=torch.bfloat16, num_layers=TENANT_LAYERS)
    cfg = bundle.config
    params = bundle.init(cfg, SEED, device="cuda")
    specs = serve_specs(np, cfg.vocab_size)
    common = dict(n_slots=8, page_size=16, max_len=4096)
    shapes = adapter_shapes(cfg, rank=TENANT_POOL["adapter_rank"])
    payloads = tenant_payloads(torch, shapes, 4, SEED + 240)
    Tap = tap_programs()
    base = Tap(bundle, params)
    ten = Tap(bundle, params, **TENANT_POOL)
    slots = [ten.publish_adapter(p, name=f"tenant{i}")
             for i, p in enumerate(payloads)]
    check(slots == [1, 2, 3, 4], f"tenant slots {slots}")
    on0 = [dict(s, adapter_id=0) for s in specs]
    mixed = [dict(s, adapter_id=i % TENANT_POOL["max_adapters"])
             for i, s in enumerate(specs)]
    launches = {k: 0 for k in kernel_counts()}

    def add(run):
        for k, v in run.items():
            launches[k] += v

    rows_base = {}
    res_base, _, run, _ = tenant_run(torch, bundle, base, on0, common,
                                     rows=rows_base)
    add(run)
    # adapter 0 on the pooled engine: the base's tokens and logits
    rows0 = {}
    res0, _, run, _ = tenant_run(torch, bundle, ten, on0, common,
                                 rows=rows0)
    add(run)
    check([r.token_ids for r in res0] == [r.token_ids for r in res_base],
          "adapter-0 tokens differ from the adapter-free engine's")
    n0 = rows_equal(rows0, rows_base, set(range(len(specs))))
    # the mix: tenants co-batched with adapter-0 requests
    rows_mix = {}
    body0 = dict(gm.GMM_BODY_LAUNCHES)
    res_mix, _, run, forwards = tenant_run(torch, bundle, ten, mixed, common,
                                           rows=rows_mix)
    add(run)
    per_forward = 4 * cfg.num_layers      # 2 targets x 2 products a layer
    check(run["grouped_matmul"] == per_forward * forwards,
          f"K5 launches {run['grouped_matmul']} for {forwards} forwards "
          f"(expected {per_forward} a forward)")
    by_body = {k: v - body0[k] for k, v in gm.GMM_BODY_LAUNCHES.items()}
    check(by_body["fma"] == run["grouped_matmul"], f"K5 bodies {by_body}")
    zero_ids = [i for i, s in enumerate(mixed) if s["adapter_id"] == 0]
    for i in zero_ids:
        check(res_mix[i].token_ids == res_base[i].token_ids,
              f"adapter-0 request {i} co-batched with tenants differs")
    n_mix0 = rows_equal(rows_mix, rows_base, set(zero_ids))
    moved = sum(res_mix[i].token_ids != res_base[i].token_ids
                for i in range(len(specs)) if i not in zero_ids)
    check(moved > 0, "no tenant's adapter moved its tokens")
    # each tenant alone: its co-batched stream, bit for bit
    solo = {}
    for i in (1, 2, 3, 4):
        rows_solo = {}
        res, _, run, _ = tenant_run(torch, bundle, ten, [mixed[i]], common,
                                    rows=rows_solo)
        add(run)
        check(res[0].token_ids == res_mix[i].token_ids,
              f"tenant request {i}: solo and co-batched tokens differ")
        solo[i] = rows_equal(rows_solo, rows_mix, {mixed[i]["seed"]})
    log(phase="tenants_post", part="(b) adapter 0 and co-residence",
        card=card, adapter0_tokens_identical=True,
        adapter0_rows_bitwise=n0 + n_mix0, solo_rows_bitwise=solo,
        tenants_moved=moved, k5_per_forward=per_forward,
        k5_launches_by_body=by_body)
    # against an engine on the merged weights: the first divergence of a
    # greedy stream must sit at a margin within twice the logit error
    # measured over the positions both runs reached with the same tokens
    merged = {}
    for i in (1, 2):
        mp = tenant_merged(torch, params, ten.adapter_pool, payloads[i - 1])
        rows_m = {}
        res_m, _, run, _ = tenant_run(torch, bundle, Tap(bundle, mp),
                                      [dict(mixed[i], adapter_id=0)], common,
                                      rows=rows_m)
        add(run)
        del mp
        seed, n_prompt = mixed[i]["seed"], len(mixed[i]["prompt_ids"])
        a, b = res_mix[i].generated_ids, res_m[0].generated_ids
        div = first_divergence(a, b)
        upto = len(a) if div is None else div + 1
        errs = [(rows_mix[(seed, n_prompt + j)]
                 - rows_m[(seed, n_prompt + j)]).abs().max().item()
                for j in range(upto)]
        merged[i] = dict(identical=div is None, first_divergence=div,
                         logit_err_max=max(errs))
        if div is not None:
            top2 = torch.topk(rows_m[(seed, n_prompt + div)], 2).values
            merged[i]["margin"] = (top2[0] - top2[1]).item()
    err_bound = max(v["logit_err_max"] for v in merged.values())
    for i, v in merged.items():
        if not v["identical"]:
            check(v["margin"] <= 2 * err_bound,
                  f"tenant {i} vs merged weights: divergence at margin "
                  f"{v['margin']} > 2 x {err_bound}")
    log(phase="tenants_post", part="(b) adapted vs merged weights",
        card=card, streams=merged, logit_err_bound=err_bound)
    del rows_base, rows0, rows_mix
    torch.cuda.empty_cache()
    # throughput beside the adapter-free run, untapped
    _, st_base, run, _ = tenant_run(torch, bundle, base, on0, common,
                                    timed=True)
    add(run)
    _, st_mix, run, forwards = tenant_run(torch, bundle, ten, mixed, common,
                                          timed=True)
    add(run)
    timing = {name: {k: st[k] for k in ("tokens_per_s", "ttft_s_p50",
                                        "itl_s_avg", "wall_s",
                                        "decode_steps")}
              for name, st in (("adapter_free", st_base),
                               ("tenants", st_mix))}
    log(phase="tenants_post", part="(b) throughput", card=card, **timing,
        k5_launches=run["grouped_matmul"], forwards=forwards)
    # a republish into a live slot mid-stream keeps the stacks' storage
    eng = ServeEngine(bundle, None, programs=ten, **common)
    for s in mixed:
        eng.submit(Request(**s))
    before = kernel_counts()
    for _ in range(6):
        eng.step()
    ptrs = {(t, x): v.data_ptr() for t, p in ten.adapter_stacks.items()
            for x, v in p.items()}
    new = tenant_payloads(torch, shapes, 1, SEED + 241)[0]
    eng.publish_adapter(new, slot=1, force=True)
    while eng.has_work:
        eng.step()
    add(counts_since(before))
    check(ptrs == {(t, x): v.data_ptr()
                   for t, p in ten.adapter_stacks.items()
                   for x, v in p.items()}, "a republish moved the stacks")
    check(all(torch.equal(ten.adapter_stacks[t][x][:, 1], new[t][x])
              for t in new for x in ("a", "b")),
          "the republished slot does not hold the new adapter")
    del base, ten, eng
    gc.collect()
    torch.cuda.empty_cache()
    # the int8 base: K7 under the base products, K5 under the deltas
    from distributed_training_guide_tpu_torch.serve.engine import \
        ModelPrograms
    i8_base = ModelPrograms(bundle, params, weight_dtype="int8")
    i8 = ModelPrograms(bundle, params, weight_dtype="int8", **TENANT_POOL)
    for p in payloads:
        i8.publish_adapter(p)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    res_i8_base, _, run, _ = tenant_run(torch, bundle, i8_base, on0, common)
    add(run)
    res_i8_0, _, run, _ = tenant_run(torch, bundle, i8, on0, common)
    add(run)
    check([r.token_ids for r in res_i8_0]
          == [r.token_ids for r in res_i8_base],
          "int8: adapter-0 tokens differ from the adapter-free engine's")
    res_i8, _, run, forwards = tenant_run(torch, bundle, i8, mixed, common)
    add(run)
    check(run["quantized_matmul"] > 0 and run["grouped_matmul"]
          == per_forward * forwards, f"int8 tenants: launches {run}")
    check(all(len(r.generated_ids) == 32 and all(
        0 <= x < cfg.vocab_size for x in r.generated_ids) for r in res_i8),
        "int8 tenants: a stream ended early or left the vocabulary")
    log(phase="tenants_post", part="(b) int8 base", card=card,
        adapter0_tokens_identical=True, launches=run,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        seconds=time.perf_counter() - t0)
    del i8, i8_base
    gc.collect()
    torch.cuda.empty_cache()
    return {"timing": timing, "merged": merged, "launches": launches,
            "k5_per_forward": per_forward, "k5_by_body": by_body}


def post_prompts(np, vocab: int) -> list:
    rng = np.random.default_rng(SEED + 24)
    lo, hi = POST_PROMPTS
    lens = [lo, hi] + [int(x) for x in rng.integers(lo, hi + 1,
                                                    POST_BATCH - 2)]
    return [[int(x) for x in rng.integers(3, vocab, n)] for n in lens]


def post_loop_run(torch, card: str, name: str, *, objective="reinforce",
                  mode="merged", nan_step=None) -> dict:
    """(c) one post-training loop on llama-3.2-1b at full width and depth
    (bf16 compute, fp32 params; LoRA r 8 on wq / wv; 8 rollouts of 64 new
    tokens at temperature 1.0; ``POST_ITERS`` iterations, or to the one
    after the publish ``nan_step`` skips): per iteration
    the loop's metrics and every kernel's launches; the peak beside
    ``price_post_colocation``."""
    import os

    import numpy as np

    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.models.lora import lora_bundle
    from distributed_training_guide_tpu_torch.post import (
        PostTrainingLoop, ProgrammaticScorer, TeacherScorer, band_reward,
        merged_params)
    from distributed_training_guide_tpu_torch.serve import ServeEngine
    from distributed_training_guide_tpu_torch.train.optimizer import \
        adamw_cosine
    from distributed_training_guide_tpu_torch.train.preflight import \
        price_post_colocation
    from distributed_training_guide_tpu_torch.train.step import Trainer

    base = get_model(POST_MODEL, dtype=torch.bfloat16)
    cfg = base.config
    bundle = lora_bundle(base, rank=8, alpha=16.0)
    env = os.environ.get("DTG_FAULT_NAN_LOSS_STEP")
    if nan_step is not None:
        os.environ["DTG_FAULT_NAN_LOSS_STEP"] = str(nan_step)
    try:
        trainer = Trainer(bundle=bundle, optimizer=adamw_cosine(1e-2),
                          lora_only=True, guard_policy="skip",
                          device="cuda")
    finally:
        if env is None:
            os.environ.pop("DTG_FAULT_NAN_LOSS_STEP", None)
        else:
            os.environ["DTG_FAULT_NAN_LOSS_STEP"] = env
    prompts = post_prompts(np, cfg.vocab_size)
    max_len = POST_PROMPTS[1] + POST_NEW + 16
    teacher = base if objective == "distill_kl" else None
    colo = price_post_colocation(trainer, n_slots=POST_BATCH, page_size=16,
                                 max_len=max_len, teacher_bundle=teacher)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_state(SEED)
    engine = ServeEngine(
        base, merged_params(trainer, state), n_slots=POST_BATCH,
        page_size=16, max_len=max_len,
        **({"max_adapters": 2, "adapter_rank": 8} if mode == "adapter"
           else {}))
    scorer = (TeacherScorer(base, base.init(cfg, SEED + 1, device="cuda"))
              if teacher is not None
              else ProgrammaticScorer(band_reward(cfg.vocab_size // 2)))
    loop = PostTrainingLoop(
        trainer, engine, scorer, prompts, state=state, objective=objective,
        max_new_tokens=POST_NEW, temperature=1.0, base_seed=SEED,
        publish_mode=mode)
    iters, launches = [], {k: 0 for k in kernel_counts()}
    for _ in range(POST_ITERS if nan_step is None else nan_step + 2):
        before = kernel_counts()
        m = loop.run_iteration()
        torch.cuda.synchronize()
        run = counts_since(before)
        for k, v in run.items():
            launches[k] += v
        check(run["tgmm"] == 0, f"post {name}: K6 launched {run['tgmm']}")
        check(run["grouped_matmul"] >= 2 and run["flash_dq"] == run[
            "flash_dkv"] == cfg.num_layers and run["flash_fwd"]
            == cfg.num_layers * (2 if teacher is not None else 1)
            and run["paged_attend_split"] > 0,
            f"post {name}: launches {run}")
        iters.append({"reward_mean": m["reward_mean"], "loss": m["loss"],
                      "rollout_tokens_per_s": m["rollout_tokens_per_s"],
                      "update_ms": 1e3 * m["step_s"],
                      "publish_ms": m["publish_ms"],
                      "published": m["published"],
                      "publish_skipped_nonfinite":
                          m["publish_skipped_nonfinite"],
                      "launches": run})
    peak = torch.cuda.max_memory_allocated()
    out = {"iterations": iters, "launches": launches,
           "colocation_bytes": colo["total_bytes"], "peak_bytes": peak}
    if nan_step is not None:
        check(iters[nan_step]["publish_skipped_nonfinite"]
              and not iters[nan_step]["published"]
              and iters[nan_step + 1]["published"],
              f"post {name}: the NaN step did not gate the publish")
    else:
        check(all(i["published"] for i in iters)
              and all(math.isfinite(i["loss"]) for i in iters),
              f"post {name}: {iters}")
    if mode == "merged" and nan_step is None:
        # decode after the publishes: a fresh engine on the final policy
        from distributed_training_guide_tpu_torch.serve import (
            Request, generate_many)

        fresh = ServeEngine(base, merged_params(trainer, loop.state),
                            n_slots=POST_BATCH, page_size=16,
                            max_len=max_len)
        before = kernel_counts()
        reqs = [Request(prompt_ids=p, max_new_tokens=16) for p in prompts]
        got = generate_many(engine, reqs)
        want = generate_many(fresh, reqs)
        for k, v in counts_since(before).items():
            launches[k] += v
        check([r.token_ids for r in got] == [r.token_ids for r in want],
              f"post {name}: decode after the publish differs from a "
              f"fresh engine")
        from distributed_training_guide_tpu_torch.post.rollout import \
            pad_bucket

        n = len(prompts[1])
        ids = torch.zeros(1, pad_bucket(n), dtype=torch.int64, device="cuda")
        ids[0, :n] = torch.tensor(prompts[1])
        a = engine.programs.prefill_for(ids.shape[1])(engine.params, ids,
                                                      n - 1)[0]
        b = fresh.programs.prefill_for(ids.shape[1])(fresh.params, ids,
                                                     n - 1)[0]
        check(torch.equal(a, b), f"post {name}: logits after the publish "
              f"differ from a fresh engine's")
        out["publish_bitwise_fresh_engine"] = True
        del fresh
    log(phase="tenants_post", part=f"(c) post loop: {name}", card=card,
        objective=objective, publish_mode=mode, nan_step=nan_step,
        iterations=iters, colocation_gib=colo["total_bytes"] / 2 ** 30,
        colocation=colo, peak_gib=peak / 2 ** 30,
        publish_bitwise_fresh_engine=out.get(
            "publish_bitwise_fresh_engine"))
    del loop, engine, scorer, state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def post_plan_update(torch, card: str) -> dict:
    """(c) one post-training update (REINFORCE, group baseline) of the
    loop's LoRA policy on llama-3.2-1b at full depth, on one packed batch
    of 8 rollouts (prompts of 16-64 tokens, 64 sampled from the seed),
    under chapter 04's fsdp plan at world 1 (``post_loss`` on the
    gathered logits) against the same update without a plan: the loss and
    every updated leaf bitwise (one-rank collectives are copies), the
    launches counted: K5 twice (its forward and d_lhs), K1-K3 once a
    layer, no K6."""
    import numpy as np
    import torch.distributed as dist

    from distributed_training_guide_tpu_torch.launch import (
        maybe_initialize_distributed)
    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.models.lora import lora_bundle
    from distributed_training_guide_tpu_torch.parallel import (make_mesh,
                                                               make_plan)
    from distributed_training_guide_tpu_torch.train.optimizer import \
        adamw_cosine
    from distributed_training_guide_tpu_torch.train.state import named_leaves
    from distributed_training_guide_tpu_torch.train.step import (
        Trainer, make_post_step)

    base = get_model(POST_MODEL, dtype=torch.bfloat16)
    cfg = base.config
    prompts = post_prompts(np, cfg.vocab_size)
    rng = np.random.default_rng(SEED + 124)
    width = POST_PROMPTS[1] + POST_NEW
    tokens = np.zeros((POST_BATCH, width), np.int64)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
        tokens[i, len(p):len(p) + POST_NEW] = rng.integers(3, cfg.vocab_size,
                                                           POST_NEW)
    batch = {"tokens": tokens,
             "prompt_lens": np.array([len(p) for p in prompts]),
             "total_lens": np.array([len(p) + POST_NEW for p in prompts]),
             "rewards": rng.random(POST_BATCH).astype(np.float32),
             "group_ids": np.arange(POST_BATCH) // 2}

    def run(plan):
        t = Trainer(bundle=lora_bundle(base, rank=8, alpha=16.0),
                    optimizer=adamw_cosine(1e-2), lora_only=True,
                    guard_policy="skip", device="cuda", plan=plan)
        state = t.init_state(SEED)
        step = make_post_step(t, objective="reinforce", baseline="group")
        torch.cuda.synchronize()
        before = kernel_counts()              # the update's path starts
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = counts_since(before)       # ... and ends here
        leaves = {p: v.detach().clone() for p, v in
                  named_leaves(state.params) if p.startswith("lora/")}
        loss = float(m["loss"])
        del state, t, step
        gc.collect()
        torch.cuda.empty_cache()
        return {"loss": loss, "update_ms": ms, "launches": launches}, leaves

    single, want = run(None)

    def under_fsdp():
        maybe_initialize_distributed("cuda")
        try:
            return run(make_plan("fsdp", make_mesh(device="cuda")))
        finally:
            dist.destroy_process_group()

    fsdp, got = with_env(plan_env(), under_fsdp)
    for name, r in (("single", single), ("fsdp", fsdp)):
        k = r["launches"]
        check(k["grouped_matmul"] == 2 and k["tgmm"] == 0
              and k["flash_fwd"] == k["flash_dq"] == k["flash_dkv"]
              == cfg.num_layers, f"post update {name}: launches {k}")
        check(math.isfinite(r["loss"]), f"post update {name}: {r}")
    differ = [p for p in want if not torch.equal(got[p], want[p])]
    check(fsdp["loss"] == single["loss"] and not differ,
          f"post update under fsdp: loss {fsdp['loss']} against "
          f"{single['loss']}, leaves {differ[:4]} differ")
    out = {"single": single, "fsdp": fsdp, "bitwise": True,
           "leaves": len(want)}
    log(phase="tenants_post", part="(c) post update under fsdp at world 1",
        card=card, **out)
    return out


def post_colocation_8b(torch) -> dict:
    """The 8B colocation, priced on the meta device and not run: a LoRA
    policy of llama-3.1-8b, an int8 engine copy and an 8B teacher."""
    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.models.lora import lora_bundle
    from distributed_training_guide_tpu_torch.train.optimizer import \
        adamw_cosine
    from distributed_training_guide_tpu_torch.train.preflight import \
        price_post_colocation
    from distributed_training_guide_tpu_torch.train.step import Trainer

    base = get_model("llama-3.1-8b", dtype=torch.bfloat16)
    trainer = Trainer(bundle=lora_bundle(base, rank=8),
                      optimizer=adamw_cosine(1e-3), lora_only=True,
                      device="meta")
    return price_post_colocation(trainer, n_slots=8, page_size=16,
                                 max_len=4096, weight_dtype="int8",
                                 teacher_bundle=base)


def phase_tenants_post(torch, card: str) -> dict:
    """Phase 24: (a) K5 at the tenant and post shapes, (b) tenants on
    *serve*, (c) the post-training loop."""
    t0 = time.perf_counter()
    gmm_rows = tenant_gmm(torch)
    serve = tenant_serve(torch, card)
    post = {name: post_loop_run(torch, card, name, **kw) for name, kw in (
        ("reinforce-merged", {}),
        ("reinforce-adapter", {"mode": "adapter"}),
        ("distill_kl", {"objective": "distill_kl"}),
        ("nan-gated", {"nan_step": 1}))}
    plan_update = post_plan_update(torch, card)
    colo8b = post_colocation_8b(torch)
    log(phase="tenants_post", part="(c) llama-3.1-8b colocation, priced",
        card=card, gib=colo8b["total_bytes"] / 2 ** 30, **colo8b)
    launches = dict(serve["launches"])
    for run in (*post.values(), plan_update["single"], plan_update["fsdp"]):
        for k, v in run["launches"].items():
            launches[k] += v
    log(phase="tenants_post", seconds=time.perf_counter() - t0, card=card,
        launches=launches)
    return {"gmm": gmm_rows, "serve": serve, "post": post,
            "post_plan": plan_update, "launches": launches,
            "post_launches": {k: sum(r["launches"][k] for r in post.values())
                              + plan_update["single"]["launches"][k]
                              + plan_update["fsdp"]["launches"][k]
                              for k in launches}}


# ---------------------------------------------------------------------------
# phase 25: the serve fleet on one card
# ---------------------------------------------------------------------------

FLEET_COMMON = dict(n_slots=8, page_size=16, max_len=4096)
FLEET_SHARED_PREFIX = 512       # tokens the 4 shared-prefix prompts share
FLEET_KILL_STEP = 6             # the router step the killed replica dies at
FLEET_TIER_BYTES = 1 << 30      # the host tier's budget in (d)
FLEET_POOL_SHARE = 0.5          # (d)'s pool against the batch's pages
FLEET_LOADGEN = dict(rate=40.0, seconds=1.5, max_len=256)




def fleet_specs(np, vocab: int) -> tuple:
    """*serve*'s 8 requests, and 4 prompts sharing a 512-token prefix
    (32 new tokens, greedy, seeds 8-11)."""
    specs = serve_specs(np, vocab)
    rng = np.random.default_rng(SEED + 25)
    prefix = [int(x) for x in rng.integers(0, vocab, FLEET_SHARED_PREFIX)]
    shared = [dict(prompt_ids=prefix + [int(x) for x in rng.integers(
        0, vocab, 16 + 8 * i)], max_new_tokens=32, seed=8 + i)
        for i in range(4)]
    return specs, shared


def by_seed(results, specs) -> dict:
    return {s["seed"]: list(r.token_ids) for r, s in zip(results, specs)}


def fleet_run(torch, engine, specs) -> tuple:
    """``specs`` through any engine-shaped target, synced on the card:
    (results in submit order, throughput stats with the ITL, wall s)."""
    from distributed_training_guide_tpu_torch.serve import (
        Request, generate_many, throughput_stats)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = generate_many(engine, [Request(**s) for s in specs])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = throughput_stats(res, wall, engine)
    stats["itl_s_avg"] = itl_avg(res)
    return res, stats, wall


def itl_avg(results) -> float:
    """Mean over requests of each one's mean inter-token seconds (the
    engines' ``itl_s_avg``, for any target)."""
    itls = [r.itl_s for r in results if len(r.generated_ids) > 1]
    return sum(itls) / len(itls) if itls else 0.0


def timed_calls(obj, name: str, sink: list, torch=None,
                skip_none: bool = False):
    """Wrap ``obj.name`` so each call's wall ms lands in ``sink`` (synced
    on the card when ``torch`` is given), but a call returning None with
    ``skip_none``."""
    fn = getattr(obj, name)

    def wrapped(*a, **kw):
        if torch is not None:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        if torch is not None:
            torch.cuda.synchronize()
        if out is not None or not skip_none:
            sink.append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(obj, name, wrapped)


def mean_ms(xs) -> Optional[float]:
    return sum(xs) / len(xs) if xs else None


def fleet_wire(torch, card: str, programs, bundle, params, prompt) -> dict:
    """(a) The wire: the 2000-token prompt's cached pages (124 full
    pages) out of a bf16 pool and out of an int8 pool (one request served
    through an int8-KV engine on the same params), framed, sent over a
    loopback socketpair and scattered into a second pool: bitwise."""
    from distributed_training_guide_tpu_torch.serve import (
        Request, ServeEngine, generate_many)
    from distributed_training_guide_tpu_torch.serve import transport as tw
    from distributed_training_guide_tpu_torch.serve.engine import \
        ModelPrograms

    out = {}
    for pool in ("bf16", "int8"):
        progs = programs if pool == "bf16" else ModelPrograms(
            bundle, params, kv_dtype="int8")
        eng = ServeEngine(bundle, None, programs=progs, **FLEET_COMMON)
        generate_many(eng, [Request(prompt_ids=prompt, max_new_tokens=2)])
        ids = eng.scheduler.cache.chain_pages(prompt)
        check(len(ids) == (len(prompt) - 1) // 16, f"wire {pool}: "
              f"{len(ids)} cached pages")
        # each leg twice: the first pays the pinned buffers' allocation
        # (the caching host allocator keeps them), the second is warm
        d2h_s, wire_s = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            payload = eng.gather_pages(ids)
            d2h_s.append(time.perf_counter() - t0)
        nbytes = tw.payload_nbytes(payload)
        check(all(v.is_pinned() for v in payload.values()),
              f"wire {pool}: the gather did not land in pinned memory")
        sender, receiver = tw.loopback_channel(pin=True)
        try:
            for xfer in range(2):
                got = None
                t0 = time.perf_counter()
                frame = tw.encode_frame(xfer, {"pool": pool}, payload)
                outcome = sender.send(frame, xfer)
                _, header, got = receiver.inbox.get(timeout=60.0)
                wire_s.append(time.perf_counter() - t0)
                check(outcome == "delivered", f"wire {pool}: {outcome}")
        finally:
            sender.sock.close()
            receiver.sock.close()
        d2h, wire = d2h_s[1], wire_s[1]
        dst = progs.init_device_pages(len(ids) + 1, 16)
        dst_ids = list(range(1, len(ids) + 1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tw.scatter_payload(dst, dst_ids, got)
        torch.cuda.synchronize()
        h2d = time.perf_counter() - t0
        idx_src = torch.tensor(ids, device="cuda")
        idx_dst = torch.tensor(dst_ids, device="cuda")
        for leaf in tw.pool_leaf_names(eng.pages):
            a = tw._leaf(eng.pages, leaf).index_select(1, idx_src)
            b = tw._leaf(dst, leaf).index_select(1, idx_dst)
            check(torch.equal(a.view(torch.uint8), b.view(torch.uint8)),
                  f"wire {pool}: leaf {leaf} differs after the wire")
        out[pool] = dict(pages=len(ids), payload_bytes=nbytes,
                         frame_bytes=len(frame), leaves=header["leaves"],
                         d2h_gb_s=nbytes / d2h / 1e9,
                         wire_gb_s=len(frame) / wire / 1e9,
                         h2d_gb_s=nbytes / h2d / 1e9, d2h_ms=d2h * 1e3,
                         wire_ms=wire * 1e3, h2d_ms=h2d * 1e3,
                         d2h_first_ms=d2h_s[0] * 1e3,
                         wire_first_ms=wire_s[0] * 1e3)
        log(phase="fleet", part="(a) the KV-page wire", card=card,
            pool=pool, bitwise=True, note="cross host on one card: a "
            "loopback socketpair on one host",
            **{k: v for k, v in out[pool].items() if k != "leaves"})
        del eng, dst, payload, got, frame
        gc.collect()
        torch.cuda.empty_cache()
    return out


def fleet_disagg(torch, card: str, bundle, programs, specs, mono) -> dict:
    """(b) ``DisaggEngine`` same-host and cross-host at the monolith's
    geometry on the shared (tapped) programs: tokens and logits rows
    bitwise the monolith's; bytes moved, handoff ms, TTFT, ITL; then a
    cross-host run with transfer 1 torn (``DTG_FAULT_HANDOFF_CRASH_XFER``)."""
    import os

    from distributed_training_guide_tpu_torch.serve.disagg import \
        DisaggEngine
    from distributed_training_guide_tpu_torch.utils import faults

    out = {}
    for transport in ("same_host", "cross_host"):
        pair = DisaggEngine(bundle, None, programs=programs,
                            transport=transport, **FLEET_COMMON)
        sends, takes = [], []
        timed_calls(pair.handoff, "transfer", sends, torch)
        timed_calls(pair.handoff, "take", takes, torch, skip_none=True)
        rows = {}
        programs.rows = rows
        res, st, wall = fleet_run(torch, pair, specs)
        programs.rows = None
        check(by_seed(res, specs) == mono["tokens"],
              f"disagg {transport}: tokens differ from the monolith's")
        n_rows = rows_equal(rows, mono["rows"], {s["seed"] for s in specs})
        hs = pair.stats()
        moved = hs["handoff_bytes_copied"]
        check((moved > 0) == (transport == "cross_host")
              and hs["handoff_delivered"] == len(specs),
              f"disagg {transport}: handoff stats {hs}")
        out[transport] = dict(
            tokens_per_s=st["tokens_per_s"], ttft_s_p50=st["ttft_s_p50"],
            itl_s_avg=st["itl_s_avg"], wall_s=wall, bytes_moved=moved,
            pages_moved=hs["handoff_pages_transferred"],
            handoff_transfer_ms=mean_ms(sends),
            handoff_take_ms=mean_ms(takes),
            rows_bitwise=n_rows)
        log(phase="fleet", part="(b) disaggregated", card=card,
            transport=transport, tokens_identical=True, **out[transport],
            monolith=mono["stats"])
        pair.close()
        del pair
        torch.cuda.empty_cache()
    os.environ[faults.ENV_HANDOFF_CRASH_XFER] = "1"
    try:
        pair = DisaggEngine(bundle, None, programs=programs,
                            transport="cross_host",
                            handoff_ack_timeout_s=5.0, **FLEET_COMMON)
        few = [s for s in specs if len(s["prompt_ids"]) < 1000][:3]
        res, _, _ = fleet_run(torch, pair, few)
        hs = pair.stats()
        pair.close()
    finally:
        del os.environ[faults.ENV_HANDOFF_CRASH_XFER]
    check(by_seed(res, few) == {s["seed"]: mono["tokens"][s["seed"]]
                                for s in few}
          and hs["handoff_dropped_nak"] == 1
          and hs["handoff_requeued"] == 1,
          f"disagg crash drill: stats {hs}")
    out["crash"] = {k: hs[k] for k in ("handoff_transfers",
                                       "handoff_delivered",
                                       "handoff_dropped_nak",
                                       "handoff_requeued")}
    log(phase="fleet", part="(b) handoff crash (transfer 1 torn)",
        card=card, tokens_identical=True, **out["crash"])
    del pair
    torch.cuda.empty_cache()
    return out


def fleet_router(torch, card: str, bundle, programs, specs, shared,
                 want) -> dict:
    """(c) ``local_fleet``-shaped: two replicas sharing the programs on
    the 8 requests plus the shared-prefix prompts; then the same traffic
    with replica r0 killed at router step ``FLEET_KILL_STEP``: fenced,
    every request decodes the uninterrupted tokens; the ms from the fence
    to the first token a resubmitted request adds."""
    import os

    from distributed_training_guide_tpu_torch.serve import (
        Request, ServeEngine, throughput_stats)
    from distributed_training_guide_tpu_torch.serve.router import (Replica,
                                                                   Router)
    from distributed_training_guide_tpu_torch.utils import faults


    def fleet():
        return Router([Replica(f"r{i}", ServeEngine(
            bundle, None, programs=programs, **FLEET_COMMON))
            for i in range(2)], heartbeat_timeout_s=600.0)

    def drive(router, on_step=None):
        """The 8 requests and the first shared prompt, then the other 3
        after 2 router steps (the first one's prefix is committed by
        then, so they can share it). Returns ({seed: tokens}, wall s)."""
        ids = {router.submit(Request(**s)): s["seed"]
               for s in specs + shared[:1]}
        done, it = {}, 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while router.has_work:
            if it == 2:
                ids.update({router.submit(Request(**s)): s["seed"]
                            for s in shared[1:]})
            for r in router.step():
                done[r.request_id] = r
            it += 1
            if on_step is not None:
                on_step(router, done)
        torch.cuda.synchronize()
        return ({seed: list(done[rid].token_ids)
                 for rid, seed in ids.items()},
                time.perf_counter() - t0, [done[i] for i in ids])

    router = fleet()
    got, wall, res = drive(router)
    check(got == want, "fleet: tokens differ from the single engine's")
    st = throughput_stats(res, wall, router)
    st["itl_s_avg"] = itl_avg(res)
    rs = router.stats()
    hits = {n: r.engine.stats()["prefix_hits"]
            for n, r in router.replicas.items()}
    out = {"uninterrupted": dict(
        tokens_per_s=st["tokens_per_s"], ttft_s_p50=st["ttft_s_p50"],
        itl_s_avg=st["itl_s_avg"], wall_s=wall,
        affinity_routed=rs["affinity_routed"], routed=rs["routed"],
        prefix_hits_by_replica=hits)}
    check(rs["affinity_routed"] >= len(shared) and sum(hits.values()) > 0,
          f"fleet: affinity {rs['affinity_routed']}, prefix hits {hits}")
    log(phase="fleet", part="(c) router, uninterrupted", card=card,
        tokens_identical=True, **out["uninterrupted"])
    del router
    torch.cuda.empty_cache()
    mark = {"fence": None, "first": None, "seen": {}}

    def watch(router, done):
        """The fence's time and the moved requests' token counts; then
        the time a moved request first adds a token past them."""
        if mark["fence"] is None and router.counters["fenced"]:
            torch.cuda.synchronize()
            mark["fence"] = time.perf_counter()
            mark["seen"] = {rid: len(rec.generated)
                            for rid, rec in router._records.items()
                            if rec.resubmits}
        elif mark["fence"] is not None and mark["first"] is None:
            now = router.partial_tokens()
            if any(len(now.get(rid, [])) > n
                   or (rid in done and len(done[rid].generated_ids) > n)
                   for rid, n in mark["seen"].items()):
                torch.cuda.synchronize()
                mark["first"] = time.perf_counter()

    os.environ[faults.ENV_REPLICA_KILL] = f"r0@{FLEET_KILL_STEP}"
    try:
        router = fleet()
        got, _, _ = drive(router, watch)
        rs = router.stats()
    finally:
        del os.environ[faults.ENV_REPLICA_KILL]
    t_fence, t_first, seen = mark["fence"], mark["first"], mark["seen"]
    check(router.replicas["r0"].state == "fenced" and rs["fenced"] == 1
          and seen, f"fleet kill: stats {rs}")
    check(got == want, "fleet kill: replayed tokens differ from the "
          "uninterrupted run")
    out["kill"] = dict(fenced_at_step=FLEET_KILL_STEP,
                       resubmitted=rs["resubmitted"],
                       in_flight_on_victim=len(seen),
                       fence_to_first_replayed_token_ms=(
                           (t_first - t_fence) * 1e3 if t_first else None))
    log(phase="fleet", part="(c) replica killed", card=card,
        tokens_identical=True, **out["kill"])
    del router
    torch.cuda.empty_cache()
    return out


def fleet_tier(torch, card: str, bundle, params, programs, specs, shared,
               want) -> dict:
    """(d) A host tier under a pool of ``FLEET_POOL_SHARE`` of the batch's
    pages: shared[0], then the 8 requests (their growth evicts its prefix
    into the tier and preempts sequences, which spill), then shared[1:]
    (the prefix restored from the tier): every stream the tier-free
    tokens; spill and restore ms. Then a 5-slot adapter pool: a fifth
    tenant evicts the first into the tier, ``restore_adapter`` brings its
    rows back bitwise, and a request on it runs K5."""
    from distributed_training_guide_tpu_torch.serve import (
        Request, ServeEngine, generate_many)
    from distributed_training_guide_tpu_torch.serve.adapters import \
        adapter_shapes
    from distributed_training_guide_tpu_torch.serve.kv_pages import \
        pages_for_tokens

    need = sum(pages_for_tokens(len(s["prompt_ids"]) + 32, 16)
               for s in specs)
    n_pages = 1 + int(need * FLEET_POOL_SHARE)
    eng = ServeEngine(bundle, None, programs=programs, n_pages=n_pages,
                      host_tier_bytes=FLEET_TIER_BYTES, **FLEET_COMMON)
    spills, restores = [], []
    timed_calls(eng.scheduler, "_tier_gather", spills, torch)
    timed_calls(eng.scheduler.cache, "_gather", spills, torch)
    timed_calls(eng, "scatter_pages", restores, torch)
    got = {}
    t0 = time.perf_counter()
    for batch in ([shared[0]], specs, shared[1:]):
        res, _, _ = fleet_run(torch, eng, batch)
        got.update(by_seed(res, batch))
        eng.host_tier.audit()
    wall = time.perf_counter() - t0
    check(got == {k: want[k] for k in got},
          "tier: restored streams differ from the tier-free run")
    ts = eng.stats()
    check(ts["preempted"] > 0 and ts["restore_hits"] > 0
          and ts["tier_spills"] > 0, f"tier: no spill or restore ({ts})")
    check(eng.scheduler.pool.n_free + eng.scheduler.cache_pages_held()
          == eng.scheduler.pool.capacity, "tier: the pool did not balance")
    out = {"kv": dict(n_pages=n_pages, batch_pages=need,
                      tier_budget_bytes=FLEET_TIER_BYTES, wall_s=wall,
                      **{k: ts[k] for k in (
                          "preempted", "tier_spills", "restore_hits",
                          "restore_misses", "tier_evictions", "prefix_hits",
                          "tier_bytes_spilled", "tier_bytes_restored")},
                      spill_ms=mean_ms(spills), spills_timed=len(spills),
                      restore_ms=mean_ms(restores),
                      restores_timed=len(restores))}
    log(phase="fleet", part="(d) host tier", card=card,
        tokens_identical=True, **out["kv"])
    del eng
    torch.cuda.empty_cache()

    from distributed_training_guide_tpu_torch.serve.engine import \
        ModelPrograms
    from distributed_training_guide_tpu_torch.serve.tiering import HostTier

    ten = ModelPrograms(bundle, params, **TENANT_POOL)
    tier = HostTier(FLEET_TIER_BYTES)
    ten.attach_host_tier(tier)
    shapes = adapter_shapes(bundle.config, rank=TENANT_POOL["adapter_rank"])
    payloads = tenant_payloads(torch, shapes, 5, SEED + 250)
    slots = [ten.publish_adapter(p, name=f"t{i}")
             for i, p in enumerate(payloads)]
    check(slots[4] == slots[0] and ten.adapter_pool.stats[
        "spill_evictions"] == 1 and ("adapter", "t0") in tier,
        f"adapters: slots {slots}, tier {tier.keys()}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slot = ten.restore_adapter("t0")
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    check(slot is not None and all(
        torch.equal(ten.adapter_stacks[t][x][:, slot], payloads[0][t][x])
        for t in payloads[0] for x in ("a", "b")),
        "adapters: the restored rows are not the spilled tenant's")
    eng = ServeEngine(bundle, None, programs=ten, **FLEET_COMMON)
    before = kernel_counts()
    res = generate_many(eng, [Request(**dict(specs[0], adapter_id=slot))])
    k5 = counts_since(before)["grouped_matmul"]
    check(k5 > 0 and len(res[0].generated_ids) == 32,
          f"adapters: the restored tenant ran {k5} K5 launches")
    out["adapter"] = dict(spilled="t0", restored_slot=slot,
                          restore_ms=restore_ms,
                          record_bytes=tier.counters["bytes_restored"],
                          k5_launches=k5)
    log(phase="fleet", part="(d) adapter spill and restore", card=card,
        rows_bitwise=True, **out["adapter"])
    del eng, ten
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fleet_elastic(torch, card: str, bundle, programs, specs, mono) -> dict:
    """(e) Generation swaps on the shared (tapped) programs after 6
    iterations of the 8 requests: a pool-capacity swap at n_slots 8 seats
    every resident, tokens and rows bitwise the monolith's; n_slots 8 ->
    16 changes the decode GEMMs' M: each stream against the monolith's,
    a divergence only where the monolith's top-2 margin is within twice
    the largest logit error measured on the positions before it."""
    from distributed_training_guide_tpu_torch.serve import (Request,
                                                            ServeEngine)
    from distributed_training_guide_tpu_torch.serve.elastic import \
        swap_engine

    out = {}
    for name, over in (("pool", dict(n_pages=1 + 8 * 256 + 512)),
                       ("slots16", dict(n_slots=16))):
        old = ServeEngine(bundle, None, programs=programs, **FLEET_COMMON)
        rows = {}
        programs.rows = rows
        ids = [old.submit(Request(**s)) for s in specs]
        done = {}
        for _ in range(6):
            done.update({r.request_id: r for r in old.step()})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, evicted, st = swap_engine(old, **over)
        torch.cuda.synchronize()
        swap_ms = (time.perf_counter() - t0) * 1e3
        check(not evicted, f"swap {name}: evicted {evicted}")
        while new.has_work:
            done.update({r.request_id: r for r in new.step()})
        programs.rows = None
        got = {s["seed"]: list(done[i].token_ids)
               for i, s in zip(ids, specs)}
        row = dict(swap_ms=swap_ms, **{k: st[k] for k in (
            "seated", "requeued", "pages_moved", "bytes_moved")})
        if name == "pool":
            check(st["seated"] == len(specs) and got == mono["tokens"],
                  f"swap pool: seated {st['seated']}, tokens differ")
            row["rows_bitwise"] = rows_equal(rows, mono["rows"],
                                             set(got))
        else:
            streams = {}
            for s in specs:
                seed, n_prompt = s["seed"], len(s["prompt_ids"])
                a, b = got[seed][n_prompt:], mono["tokens"][seed][n_prompt:]
                div = first_divergence(a, b)
                upto = len(a) if div is None else div + 1
                errs = [(rows[(seed, n_prompt + j)]
                         - mono["rows"][(seed, n_prompt + j)]
                         ).abs().max().item() for j in range(upto)]
                streams[seed] = dict(first_divergence=div,
                                     logit_err_max=max(errs))
                if div is not None:
                    top2 = torch.topk(mono["rows"][(seed, n_prompt + div)],
                                      2).values
                    streams[seed]["margin"] = (top2[0] - top2[1]).item()
            bound = max(v["logit_err_max"] for v in streams.values())
            for seed, v in streams.items():
                if v["first_divergence"] is not None:
                    check(v["margin"] <= 2 * bound,
                          f"swap slots16: stream {seed} diverged at margin "
                          f"{v['margin']} > 2 x {bound}")
            row.update(streams=streams, logit_err_bound=bound,
                       identical=sum(v["first_divergence"] is None
                                     for v in streams.values()))
        out[name] = row
        log(phase="fleet", part="(e) generation swap", card=card,
            swap=name, **row)
        del old, new
        torch.cuda.empty_cache()
    return out


def fleet_controller(torch, card: str, bundle, programs) -> dict:
    """(e) The SLO controller over ``run_open_loop``, as a check: one
    replica (8 slots, max_len 256) under a Poisson rate past its service
    gives exactly one scale-up, and every request submitted completes.
    The window is short and its traffic one invented scenario, so its
    goodput and tails are logged under ``check_window`` and are no
    workload's figures. The scale-up's ``spawn_like`` shares the built
    programs and the weights on the card: its time (``spawn_ms``) is a
    Python object and a fresh pool, no weight load and no kernel build."""
    from distributed_training_guide_tpu_torch.serve import ServeEngine
    from distributed_training_guide_tpu_torch.serve import loadgen
    from distributed_training_guide_tpu_torch.serve.controller import (
        SLO, Controller)
    from distributed_training_guide_tpu_torch.serve.router import (Replica,
                                                                   Router)

    cfg = FLEET_LOADGEN
    router = Router([Replica("r0", ServeEngine(
        bundle, None, programs=programs, n_slots=8, page_size=16,
        max_len=cfg["max_len"]))])
    ctl = Controller(router, slo=SLO(queue_high=4.0), hold_up=2,
                     cooldown_s=0.0, max_replicas=2)
    scen = [loadgen.Scenario("chat", prompt_len=(16, 96),
                             max_new_tokens=(8, 24))]
    sched = loadgen.build_schedule(
        loadgen.poisson_arrivals(cfg["rate"], cfg["seconds"], seed=SEED),
        scen, vocab=bundle.config.vocab_size, seed=SEED)
    rep = loadgen.run_open_loop(router, sched, controller=ctl,
                                max_wall_s=120.0)
    torch.cuda.synchronize()
    check(ctl.counters["scale_up"] == 1
          and not rep.timed_out and rep.completed == rep.submitted,
          f"controller: scale_up {ctl.counters['scale_up']}, report "
          f"{rep.as_dict()}")
    out = dict(rate_rps=cfg["rate"], window_s=cfg["seconds"],
               offered=rep.offered, submitted=rep.submitted,
               completed=rep.completed, scale_ups=1,
               scale_downs=ctl.counters["scale_down"],
               actions=[a["kind"] for a in ctl.actions],
               spawn_ms=ctl.cold_starts[0] * 1e3,
               check_window=dict(goodput_rps=rep.goodput_rps,
                                 ttft_p50_s=rep.ttft_p50_s,
                                 ttft_p99_s=rep.ttft_p99_s,
                                 itl_p50_s=rep.itl_p50_s,
                                 itl_p99_s=rep.itl_p99_s))
    log(phase="fleet", part="(e) controller over the open loop", card=card,
        **out)
    del router, ctl
    torch.cuda.empty_cache()
    return out


def phase_fleet(torch, card: str) -> dict:
    """Phase 25: the serve fleet on llama-3.1-8b (bf16, 32 layers), one
    tapped ``ModelPrograms`` shared by every engine: (a) the wire, (b)
    disaggregated serving, (c) the router, (d) the host tier, (e) elastic
    generations and the controller. Every count is 0 before and read
    after; no launch here is a check against a plain version."""
    import numpy as np

    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.serve import ServeEngine

    t0 = time.perf_counter()
    bundle = get_model("llama-3.1-8b", dtype=torch.bfloat16,
                       param_dtype=torch.bfloat16)
    params = bundle.init(bundle.config, SEED, device="cuda")
    specs, shared = fleet_specs(np, bundle.config.vocab_size)
    programs = tap_programs()(bundle, params)
    zero_counts()                       # the fleet's paths start here
    mono_rows = {}
    programs.rows = mono_rows
    res, st, wall = fleet_run(
        torch, ServeEngine(bundle, None, programs=programs, **FLEET_COMMON),
        specs + shared)
    programs.rows = None
    want = by_seed(res, specs + shared)
    mono = {"tokens": {s["seed"]: want[s["seed"]] for s in specs},
            "rows": mono_rows,
            "stats": {k: st[k] for k in ("tokens_per_s", "ttft_s_p50",
                                         "itl_s_avg")}}
    log(phase="fleet", part="monolith", card=card, wall_s=wall,
        requests=len(res), **mono["stats"])
    torch.cuda.empty_cache()
    wire = fleet_wire(torch, card, programs, bundle, params,
                      specs[1]["prompt_ids"])
    disagg = fleet_disagg(torch, card, bundle, programs, specs, mono)
    router = fleet_router(torch, card, bundle, programs, specs, shared,
                          want)
    tier = fleet_tier(torch, card, bundle, params, programs, specs, shared,
                      want)
    elastic = fleet_elastic(torch, card, bundle, programs, specs, mono)
    controller = fleet_controller(torch, card, bundle, programs)
    launches = kernel_counts()          # ... and end here
    for k in ("paged_attend_split", "paged_attend_combine",
              "grouped_matmul"):
        check(launches[k] > 0, f"fleet: no {k} launch on the fleet's paths")
    del programs, params, mono_rows
    gc.collect()
    torch.cuda.empty_cache()
    log(phase="fleet", seconds=time.perf_counter() - t0, card=card,
        launches=launches)
    return {"wire": wire, "disagg": disagg, "router": router, "tier": tier,
            "elastic": elastic, "controller": controller,
            "launches": launches}


# ---------------------------------------------------------------------------
# phase 26: runtime robustness and tooling on the card: chapter 01 trained
# under the restart supervisor (a crash, a poison pill, a hang the
# heartbeat kills while the monitor watches the card's power), the elastic
# launch at one slice, and the native token loader
# ---------------------------------------------------------------------------

ROBUST_LAYERS = 2          # llama-3.2-1b at full width, phase 16's depth
ROBUST_STEPS = 6
ROBUST_CRASH_STEP = 4      # (b) saves once, at the step it is killed after
ROBUST_ARGS = ["-d", "synthetic:400000", "-s", "2048", "--lr", "3e-4",
               "--seed", str(SEED), "--native-loader", "--log-freq", "1"]
# the hang drill: attempt 0 trains HANG_TRAIN_S (by (a)'s step time) and
# saves once, the resumed attempt 1 trains as long without a save (so the
# monitor sees each train without a save's pause); the heartbeat timeout
# is past the longest quiet stretch of a healthy worker (its start, a
# 2-layer save of 4.61 GB: ~6 s)
HANG_TRAIN_S = 8.0
HANG_TIMEOUT_S = 15.0
MONITOR_ALERT_AFTER = 3
MONITOR_POLL_S = 1.5       # over the heartbeat's 1 s throttle: a poll
                           # while training always sees a new beat
LOADER_BATCHES = 250       # timed batches of each loader (B 4, S 2048)


def robust_model(root: Path) -> str:
    """An ``hf:`` config of the in-code llama-3.2-1b preset cut to
    ``ROBUST_LAYERS`` (the worker is a process of its own: no
    ``model_overrides``); nothing is downloaded."""
    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.models.hf_export import (
        _hf_config)

    cfg = _hf_config(get_model("llama-3.2-1b", num_layers=ROBUST_LAYERS))
    d = root / "llama-3.2-1b-2l"
    d.mkdir(parents=True, exist_ok=True)
    (d / "config.json").write_text(json.dumps(cfg))
    return f"hf:{d}"


def robust_env(**extra) -> dict:
    import os

    env = {k: v for k, v in os.environ.items()
           if k not in ("ERROR_FILE", "TORCHELASTIC_ERROR_FILE",
                        "HEARTBEAT_FILE") and not k.startswith("DTG_")}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("PYTHONDONTWRITEBYTECODE", None)      # main's bytecode cache
    env["PYTHONPYCACHEPREFIX"] = str(ROOT / "build" / "pycache")
    env.update(extra)
    return env


def robust_module(name: str) -> list:
    return [sys.executable, "-m",
            f"distributed_training_guide_tpu_torch.{name}"]


class Supervised:
    """``launch.supervisor`` in a process of its own, each line of its
    stdout stamped with the host clock as it arrives."""

    def __init__(self, sup_args: list, worker: list, env: dict):
        import atexit
        import threading

        self.lines: list = []
        # its own process group: ``stop`` takes the worker down with it
        self.proc = subprocess.Popen(
            [*robust_module("launch.supervisor"), *sup_args, "--",
             *worker], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
        atexit.register(self.stop)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def stop(self) -> None:
        """Kill the supervisor and its worker if they still run (a failed
        check leaves nothing running behind the script)."""
        import os
        import signal

        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except OSError:
            pass

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.append((time.time(), line.rstrip("\n")))

    def wait(self, timeout: float) -> int:
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.stop()
            self.proc.wait()
            raise RuntimeError(f"chip_smoke: the supervisor ran past "
                               f"{timeout} s: {self.text()[-2000:]}")
        self._reader.join(timeout=10)
        log_dir = Path(self.proc.args[self.proc.args.index("--log-dir") + 1])
        log_dir.mkdir(parents=True, exist_ok=True)
        (log_dir / "supervisor.log").write_text("".join(
            f"{t:.3f} {line}\n" for t, line in self.lines))
        return rc

    def text(self) -> str:
        return "\n".join(line for _, line in self.lines)

    def first(self, needle: str) -> Optional[float]:
        return next((t for t, line in self.lines if needle in line), None)


def attempt_log(log_dir: Path, n: int) -> str:
    d = log_dir / f"attempt_{n}"
    return "".join((d / f).read_text() for f in ("stdout.log", "stderr.log")
                   if (d / f).exists())


def logged_infos(text: str) -> list:
    """(host time, info dict) of each logged step of a worker's log."""
    import ast
    import datetime

    out = []
    for line in text.splitlines():
        at = line.find("INFO:{")
        if at < 0 or not line.startswith("["):
            continue
        try:
            info = ast.literal_eval(line[at + 5:])
        except (ValueError, SyntaxError):
            continue
        if isinstance(info, dict) and "global_step" in info:
            stamp = datetime.datetime.strptime(
                line[1:line.index("]")], "%Y-%m-%d %H:%M:%S,%f")
            out.append((stamp.timestamp(), info))
    return out


def attempt_summary(log_dir: Path, n: int) -> dict:
    """An attempt's losses by step, its kernel launches (the last info's
    ``launches/*``: the worker's counts since its run began), whether it
    resumed and which loader it ran."""
    text = attempt_log(log_dir, n)
    infos = logged_infos(text)
    last = infos[-1][1] if infos else {}
    return {"losses": {i["global_step"]: i["running_loss"]
                       for _, i in infos},
            "times": {i["global_step"]: t for t, i in infos},
            "launches": {k.split("/", 1)[1]: v for k, v in last.items()
                         if k.startswith("launches/")},
            "resumed": "Resumed=True" in text,
            "loader": ("native" if "by the native loader" in text else
                       "python" if "by the python loader" in text else None)}


def robust_golden(torch, model: str, card: str) -> dict:
    """(a) In-process ``run_training`` with ``--native-loader``, 6 steps
    (no saves: ``--ckpt-freq`` only acts under ``-e``): the losses every
    supervised run is held to bitwise, the K1-K3 launches by body."""
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa
    from distributed_training_guide_tpu_torch.train import cli

    args = cli.get_parser().parse_args(
        ["-m", model, *ROBUST_ARGS, "-b", "4", "--max-steps",
         str(ROBUST_STEPS), "--ckpt-freq", "2"])
    reset_moe_counts()                        # the run's path starts here
    copies = fa.ALIGN_COPIES
    out = cli.run_training(args)
    torch.cuda.synchronize()
    counts = moe_counts()                     # ... and ends here
    bodies = check_hopper_path("robustness (a)", copies)
    losses = ch01_losses(out)
    want = {k: ROBUST_LAYERS * ROBUST_STEPS for k in ("flash_fwd",
                                                      "flash_dq", "flash_dkv")}
    check({k: counts[k] for k in want} == want,
          f"robustness (a): K1-K3 launches {counts}, want {want}")
    check(out["loader"] == "native", f"robustness (a): the {out['loader']} "
          f"loader ran, not the native one")
    check(set(losses) == set(range(1, ROBUST_STEPS + 1)) and all(
        map(math.isfinite, losses.values())), f"robustness (a): {losses}")
    res = {"losses": losses, "launches": counts,
           "launches_by_body": bodies["flash_fwd"], "loader": out["loader"],
           **ch01_rates(out)}
    ch01_free(torch, out)
    log(phase="robustness", part="(a) golden run", layers=ROBUST_LAYERS,
        card=card, **res)
    return res


def robust_crash(model: str, root: Path, golden: dict, card: str) -> dict:
    """(b) The crash drill under the supervisor: SIGKILL after step 4's
    checkpoint (the only one: ``--ckpt-freq 4``), a restart that resumes,
    the stitched losses bitwise (a)'s;
    the time to recover is the ms from the supervisor seeing the death to
    the resumed worker logging its first step."""
    from distributed_training_guide_tpu_torch.utils import faults

    logs = root / "sup-crash"
    sup = Supervised(
        ["--max-restarts", "2", "--restart-backoff", "0.05", "--log-dir",
         str(logs)],
        [*robust_module("train"), "-m", model, *ROBUST_ARGS, "-b", "4",
         "--max-steps", str(ROBUST_STEPS), "-e", "drill", "--ckpt-freq",
         str(ROBUST_CRASH_STEP), "--save-dir", str(root / "work")],
        robust_env(**{faults.ENV_CRASH_STEP: str(ROBUST_CRASH_STEP)}))
    rc = sup.wait(600)
    out = sup.text()
    a0, a1 = attempt_summary(logs, 0), attempt_summary(logs, 1)
    check(rc == 0 and "attempt 0 failed rc=-9" in out
          and "attempt 1 exited cleanly" in out,
          f"robustness (b): rc {rc}: {out[-2000:]}")
    check(set(a0["losses"]) == set(range(1, ROBUST_CRASH_STEP + 1))
          and set(a1["losses"]) == set(range(ROBUST_CRASH_STEP + 1,
                                             ROBUST_STEPS + 1))
          and a1["resumed"], f"robustness (b): attempt 0 steps "
          f"{sorted(a0['losses'])}, attempt 1 {sorted(a1['losses'])}, "
          f"resumed {a1['resumed']}")
    stitched = {**a0["losses"], **a1["losses"]}
    check(stitched == golden["losses"], f"robustness (b): stitched "
          f"{stitched} against (a)'s {golden['losses']}")
    check(a0["loader"] == a1["loader"] == "native",
          f"robustness (b): loaders {a0['loader']} / {a1['loader']}")
    hb = json.loads((logs / "attempt_1" / "heartbeat.json").read_text())
    check(hb["step"] >= ROBUST_CRASH_STEP + 1,
          f"robustness (b): heartbeat {hb}")
    died = sup.first("attempt 0 failed rc=-9")
    recover_ms = (a1["times"][ROBUST_CRASH_STEP + 1] - died) * 1e3
    launches = {k: a0["launches"][k] + a1["launches"][k]
                for k in a0["launches"]}
    want = {k: ROBUST_LAYERS * ROBUST_STEPS for k in ("flash_fwd",
                                                      "flash_dq", "flash_dkv")}
    check({k: launches[k] for k in want} == want,
          f"robustness (b): K1-K3 launches {launches}, want {want}")
    res = {"rc": rc, "stitched_bitwise": True, "heartbeat_step": hb["step"],
           "time_to_recover_ms": recover_ms, "launches": launches,
           "loader": a1["loader"]}
    log(phase="robustness", part="(b) crash drill", card=card, **res)
    return res


def robust_poison(model: str, root: Path, card: str):
    """(c) A NaN loss at step 2 under ``--guard-policy abort``: the error
    file classifies as non-finite, the supervisor stops after attempt 0
    (no ``attempt_1``) and exits nonzero. Starts the supervisor and
    returns the function that waits for it and checks it (the drill runs
    beside (e))."""
    from distributed_training_guide_tpu_torch.utils import faults

    logs = root / "sup-poison"
    sup = Supervised(
        ["--max-restarts", "2", "--restart-backoff", "0.05", "--log-dir",
         str(logs)],
        [*robust_module("train"), "-m", model, *ROBUST_ARGS, "-b", "4",
         "--max-steps", str(ROBUST_STEPS), "--guard-policy", "abort"],
        robust_env(**{faults.ENV_NAN_LOSS_STEP: "2"}))

    def finish() -> dict:
        return poison_checks(sup, logs, card)
    return finish


def poison_checks(sup, logs: Path, card: str) -> dict:
    from distributed_training_guide_tpu_torch.launch.errors import (
        classify_error)

    rc = sup.wait(300)
    out = sup.text()
    payload = json.loads((logs / "attempt_0" / "error.json").read_text())
    reason = classify_error(payload)
    check(rc != 0 and reason == "non-finite"
          and "non-retryable failure (non-finite:" in out
          and not (logs / "attempt_1").exists(),
          f"robustness (c): rc {rc}, reason {reason}: {out[-2000:]}")
    res = {"rc": rc, "reason": reason, "attempts": 1,
           "error": payload["message"]["error"][:120],
           "launches": attempt_summary(logs, 0)["launches"]}
    log(phase="robustness", part="(c) poison drill", card=card, **res)
    return res


def monitor_poll() -> dict:
    """One ``top_cluster --local`` poll, as its own process (the ssh
    payload's shape)."""
    out = subprocess.run(robust_module("monitor.top_cluster") + ["--local"],
                         cwd=ROOT, env=robust_env(), capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"top_cluster --local: {out.stderr[-500:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def robust_hang(model: str, root: Path, card: str, step_ms: float) -> dict:
    """(d) The hang drill: once attempt 0's heartbeat is past its
    checkpoint (and the monitor has seen it train), the phase SIGSTOPs the
    worker; the supervisor's heartbeat timeout kills it and restarts it,
    and the restart resumes and finishes. ``top_cluster --local`` is
    polled every ``MONITOR_POLL_S`` into ``ClusterWatch(alert_after=3)``: ok
    while training (a poll whose heartbeat advanced over it and the 3
    before it: no save or start in the window), stalled while the worker
    is stopped (memory resident, power down), ok again after the
    restart."""
    import os
    import signal

    from distributed_training_guide_tpu_torch.monitor.top_cluster import (
        ClusterWatch)
    from distributed_training_guide_tpu_torch.utils.heartbeat import (
        read_heartbeat)

    logs = root / "sup-hang"
    exp = root / "work" / "hang"
    ckpt = max(20, math.ceil(HANG_TRAIN_S * 1e3 / step_ms))
    steps = 2 * ckpt - 1
    sup = Supervised(
        ["--max-restarts", "1", "--restart-backoff", "0.05", "--log-dir",
         str(logs), "--heartbeat-timeout", str(HANG_TIMEOUT_S)],
        [*robust_module("train"), "-m", model, *ROBUST_ARGS, "-b", "4",
         "--max-steps", str(steps), "-e", "hang", "--ckpt-freq", str(ckpt),
         "--save-dir", str(root / "work")],
        robust_env())
    watch = ClusterWatch(alert_after=MONITOR_ALERT_AFTER)
    polls = []
    stage = "start"           # start -> training -> stopped -> restarted
    stopped_pid = None
    last_step = {}
    deadline = time.time() + 400
    while sup.proc.poll() is None and time.time() < deadline:
        t0 = time.time()
        attempt = 1 if (logs / "attempt_1").exists() else 0
        hb = read_heartbeat(logs / f"attempt_{attempt}" / "heartbeat.json")
        step = hb["step"] if hb else None
        advanced = (step is not None
                    and step > last_step.get(attempt, -1) >= 0)
        if step is not None:
            last_step[attempt] = step
        row = watch.update(monitor_poll())
        dev = {"power_w": row.get("power_w"),
               "power_limit_w": row.get("power_limit_w"),
               "hbm_gb": row.get("hbm_gb")}
        if attempt == 1 and stage == "stopped":
            stage = "restarted"
        polls.append({"t": t0, "stage": stage, "attempt": attempt,
                      "step": step, "advanced": advanced,
                      "status": row["status"], **dev})
        if (stage in ("start", "training") and attempt == 0
                and step is not None):
            stage = "training"
            trained = sum(p["advanced"] and p["stage"] == "training"
                          for p in polls)
            published = (exp / "state.json").exists() and json.loads(
                (exp / "state.json").read_text()).get("checkpoint")
            if (step > ckpt and published
                    and trained > MONITOR_ALERT_AFTER):
                stopped_pid = hb["pid"]
                os.kill(stopped_pid, signal.SIGSTOP)
                stage = "stopped"
        time.sleep(max(0.0, MONITOR_POLL_S - (time.time() - t0)))
    rc = sup.wait(300)
    out = sup.text()
    a0, a1 = attempt_summary(logs, 0), attempt_summary(logs, 1)
    for i, p in enumerate(polls):
        window = polls[max(0, i - MONITOR_ALERT_AFTER):i + 1]
        p["steady"] = (len(window) == MONITOR_ALERT_AFTER + 1 and all(
            q["advanced"] and q["attempt"] == p["attempt"] for q in window))
    by_stage = {k: [p for p in polls if p["stage"] == k]
                for k in ("training", "stopped", "restarted")}
    check(stopped_pid is not None, f"robustness (d): never stopped the "
          f"worker: {polls[-5:]}")
    check(rc == 0 and f"no heartbeat progress for {HANG_TIMEOUT_S}s -> "
          f"SIGKILL (hang)" in out and "attempt 0 failed rc=-9" in out
          and "attempt 1 exited cleanly" in out and a1["resumed"],
          f"robustness (d): rc {rc}: {out[-2000:]}")
    check(set(a1["losses"]) and max(a1["losses"]) == steps,
          f"robustness (d): attempt 1 steps {sorted(a1['losses'])}")
    training_ok = [p["status"] for p in by_stage["training"]
                   if p["steady"]]
    check(training_ok and set(training_ok) == {"ok"},
          f"robustness (d): while training {by_stage['training']}")
    check("stalled" in {p["status"] for p in by_stage["stopped"]},
          f"robustness (d): while stopped {by_stage['stopped']}")
    after = [p["status"] for p in by_stage["restarted"] if p["steady"]]
    check(after and set(after) == {"ok"},
          f"robustness (d): after the restart {by_stage['restarted']}")
    stalled_at = next(p["t"] for p in by_stage["stopped"]
                      if p["status"] == "stalled")
    killed = sup.first("SIGKILL (hang)")
    launches = {k: a0["launches"].get(k, 0) + a1["launches"].get(k, 0)
                for k in a1["launches"]}
    res = {"rc": rc, "steps": steps, "ckpt_freq": ckpt,
           "stopped_at_step": last_step.get(0),
           "resumed_steps": [min(a1["losses"]), max(a1["losses"])],
           "stalled_after_s": stalled_at - by_stage["stopped"][0]["t"],
           "killed_after_stop_s": (killed - by_stage["stopped"][0]["t"]
                                   if killed else None),
           # each poll: stage, heartbeat step, steady, status, W, GB
           "polls": [[p["stage"][:2], p["step"], int(p["steady"]),
                      p["status"], p["power_w"], round(p["hbm_gb"], 2)]
                     for p in polls],
           "power_limit_w": polls[-1]["power_limit_w"],
           "power_w_training": [p["power_w"] for p in by_stage["training"]
                                if p["steady"]],
           "power_w_stopped": [p["power_w"] for p in by_stage["stopped"]],
           "launches": launches, "loader": a1["loader"]}
    log(phase="robustness", part="(d) hang drill", card=card,
        heartbeat_timeout_s=HANG_TIMEOUT_S, **res)
    return res


def robust_elastic(model: str, root: Path, golden: dict, card: str):
    """(e) The elastic launch at one slice: one member of one device at
    global batch 4 (``-b {world_batch}``); ``world.json`` names it,
    ``elastic.jsonl`` has its "start" line, the losses are (a)'s bitwise.
    A world change needs a second card (NCCL takes one rank a GPU): the
    2 -> 1 drill runs on the CPU (``tests/test_torch_elastic_launch.py``).
    Starts the supervisor and returns the function that waits for it and
    checks it (the run goes beside (c))."""
    logs, coord = root / "sup-elastic", root / "coord"
    sup = Supervised(
        ["--max-restarts", "0", "--log-dir", str(logs), "--elastic-dir",
         str(coord), "--slice-name", "slice0", "--devices-per-slice", "1",
         "--elastic-global-batch", "4"],
        [*robust_module("train"), "-m", model, *ROBUST_ARGS, "-b",
         "{world_batch}", "--max-steps", str(ROBUST_STEPS)],
        robust_env())

    def finish() -> dict:
        return elastic_checks(sup, logs, coord, golden, card)
    return finish


def elastic_checks(sup, logs: Path, coord: Path, golden: dict,
                   card: str) -> dict:
    from distributed_training_guide_tpu_torch.launch import elastic

    rc = sup.wait(300)
    a0 = attempt_summary(logs, 0)
    world = json.loads((coord / elastic.WORLD_FILE).read_text())
    events = elastic.read_events(coord)
    check(rc == 0 and world["members"] == ["slice0"] and len(events) == 1
          and events[0]["trigger"] == "start"
          and events[0]["new_world"]["members"] == ["slice0"],
          f"robustness (e): rc {rc}, world {world}, events {events}: "
          f"{sup.text()[-1500:]}")
    check(a0["losses"] == golden["losses"], f"robustness (e): losses "
          f"{a0['losses']} against (a)'s {golden['losses']}")
    res = {"rc": rc, "world": world["members"],
           "events": [e["trigger"] for e in events], "bitwise": True,
           "launches": a0["launches"], "loader": a0["loader"]}
    log(phase="robustness", part="(e) elastic at one slice", card=card,
        **res)
    return res


def robust_loader(card: str) -> dict:
    """(f) Host ms per batch of the C++ loader and the Python loader at B
    4, S 2048 over ``LOADER_BATCHES`` batches each (host tensors: the
    assembly, not the copy to the card); an epoch covers each sequence
    once, two loaders of one seed agree, and ``start_step`` equals
    skipping that many batches."""
    import numpy as np

    from distributed_training_guide_tpu_torch.data import BatchLoader
    from distributed_training_guide_tpu_torch.data.native_loader import (
        NativeTokenLoader, write_token_file)
    from distributed_training_guide_tpu_torch.data.pipeline import (
        synthetic_dataset)
    import tempfile

    b, s = 4, 2048
    data = synthetic_dataset(b * s * LOADER_BATCHES, 128256, s, SEED)
    times = {}
    for backend in ("native", "python"):
        loader = BatchLoader(data, b, device="cpu", seed=SEED,
                             native=backend == "native")
        check(loader.backend == backend, f"robustness (f): {backend} "
              f"loader ran as {loader.backend}")
        it = loader.epoch_batches()
        t0 = time.perf_counter()
        n = sum(1 for _ in it)
        times[backend] = (time.perf_counter() - t0) * 1e3 / n
        loader.close()
        check(n == LOADER_BATCHES, f"robustness (f): {n} batches")
    with tempfile.TemporaryDirectory() as d:
        path = write_token_file(data, Path(d) / "tokens.bin")
        one = NativeTokenLoader(path, s, b, seed=SEED)
        two = NativeTokenLoader(path, s, b, seed=SEED)
        whole = np.concatenate(list(one.epoch_batches(0)))
        rows = {r.tobytes() for r in whole}
        check(len(rows) == len(whole) == len(data)
              and rows == {r.tobytes() for r in data},
              "robustness (f): an epoch does not cover each sequence once")
        check(np.array_equal(np.concatenate(list(two.epoch_batches(0))),
                             whole), "robustness (f): two loaders of one "
              "seed disagree")
        check(np.array_equal(np.concatenate(list(two.epoch_batches(
            0, start_step=7))), whole[7 * b:]),
            "robustness (f): start_step is not a skip")
        one.close()
        two.close()
    res = {"B": b, "S": s, "batches": LOADER_BATCHES,
           "native_ms_per_batch": times["native"],
           "python_ms_per_batch": times["python"]}
    log(phase="robustness", part="(f) native loader", card=card, **res)
    return res


def phase_robustness(torch, card: str) -> dict:
    """Phase 26: chapter 01 (llama-3.2-1b at full width, 2 layers, B 4, S
    2048, ``--native-loader``) driven in-process and under the restart
    supervisor through K1-K3; every count is 0 before each run and read
    after (the workers' from their own info dicts)."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    seconds = {}

    def timed(part, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[part] = time.perf_counter() - t
        return out

    root = Path(tempfile.mkdtemp(prefix="robustness-"))
    try:
        model = robust_model(root)
        golden = timed("a", robust_golden, torch, model, card)
        crash = timed("b", robust_crash, model, root, golden, card)
        # (c) and (e) side by side: two workers' starts at once
        finish_c = robust_poison(model, root, card)
        finish_e = robust_elastic(model, root, golden, card)
        poison, el = timed("c_e", lambda: (finish_c(), finish_e()))
        hang = timed("d", robust_hang, model, root, card,
                     golden["time_step_ms"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    loader = timed("f", robust_loader, card)
    launches = {k: golden["launches"][k] + sum(
        r["launches"].get(k, 0) for r in (crash, poison, hang, el))
        for k in ("flash_fwd", "flash_dq", "flash_dkv")}
    check(all(v > 0 for v in launches.values()),
          f"robustness: a kernel of the path never launched: {launches}")
    log(phase="robustness", seconds=time.perf_counter() - t0,
        seconds_by_part=seconds, card=card, launches=launches)
    return {"golden": golden, "crash": crash, "poison": poison,
            "hang": hang, "elastic": el, "loader": loader,
            "launches": launches}


# ---------------------------------------------------------------------------
# phase 27: serving under a plan; gpt-neox-20b through K4 at head_dim 96
# ---------------------------------------------------------------------------

NEOX20B = "gpt-neox-20b"        # hidden 6144, 64 heads of 96, 44 layers
NEOX_MAX_LEN = 2048             # its position table
# the engine's logits against ``models/neox.py:apply`` over the same
# tokens, bf16 through 44 random layers: the largest |difference| in ulps
# of the largest |reference| logit (one ulp: 2**(e - 7) for |x| in
# [2**e, 2**(e + 1))), and the relative L2 of phase 7
NEOX_LOGIT_ULPS = 32.0
SERVE_PLAN_LAYERS = 8           # llama-3.1-8b at full width, 8 of 32 layers
SERVE_PLAN_MODEL = "llama-3.1-8b"
TP2_TIMEOUT_S = 400
# (c)'s int8 runs, each held to (b)'s plain engine in the same storage
TP2_INT8_RUNS = (("int8_pool", {"kv_dtype": "int8"}),
                 ("int8_weights", {"weight_dtype": "int8"}))

TP2_GO_WAIT_S = 900            # (c)'s ranks wait this long for (a) and (b)

# (c): two ranks of a tp-2 plan on the one card over gloo, every
# collective on CUDA tensors; argv: repo root, JSON of the phase's
# requests, the output path, the model's depth, the model, the go file.
# The ranks start with the phase and start up (imports, gloo) while (a)
# and (b) run; they touch the card (a CUDA context, the probes, serving)
# only once the go file exists: (a) holds most of its memory
_TP2_SCRIPT = """
import faulthandler, json, os, sys, time
faulthandler.enable()
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from distributed_training_guide_tpu_torch.launch.distributed import (
    _env_contract)
from distributed_training_guide_tpu_torch.models import get_model
from distributed_training_guide_tpu_torch.ops import paged_decode as pd
from distributed_training_guide_tpu_torch.ops import quantized_matmul as qm
from distributed_training_guide_tpu_torch.parallel import make_mesh, make_plan
from distributed_training_guide_tpu_torch.serve import (
    Request, ServeEngine, generate_many)
from distributed_training_guide_tpu_torch.serve.engine import ModelPrograms

coord, world, rank = _env_contract()
rank = int(rank)
dist.init_process_group("gloo", init_method="tcp://" + coord, rank=rank,
                        world_size=int(world))
t_wait = time.time()
while not os.path.exists(sys.argv[6]):
    if time.time() - t_wait > %d:
        raise SystemExit("rank %%d: no go file after %%.0f s"
                         %% (rank, time.time() - t_wait))
    time.sleep(0.05)
torch.cuda.set_device(0)
torch.backends.cuda.matmul.allow_tf32 = False
specs, out_path, layers = json.loads(sys.argv[2]), sys.argv[3], int(sys.argv[4])
probe = {}
x = torch.full((4,), float(rank + 1), device="cuda")
dist.all_reduce(x)
probe["all_reduce"] = x.tolist()
y = torch.empty(8, device="cuda")
dist.all_gather_into_tensor(y, torch.full((4,), float(rank), device="cuda"))
probe["all_gather"] = y.tolist()
z = torch.full((2,), float(rank), device="cuda")
dist.broadcast(z, 0)
probe["broadcast"] = z.tolist()
bundle = get_model(sys.argv[5], dtype=torch.bfloat16,
                   param_dtype=torch.bfloat16, num_layers=layers)
params = bundle.init(bundle.config, 0, device="cuda")
plan = make_plan("tp", make_mesh(tp=2, device="cuda"))
out = {"probe": probe, "runs": {}}
for name, kw in (("bf16", {}), ("int8_pool", {"kv_dtype": "int8"}),
                 ("int8_weights", {"weight_dtype": "int8"})):
    reqs = specs if name == "bf16" else specs[:2]
    progs = ModelPrograms(bundle, params, device="cuda", plan=plan,
                          shard_kv=True, **kw)
    pd.LAUNCHES = pd.SPLIT_LAUNCHES = pd.MMA_LAUNCHES = 0
    pd.COMBINE_LAUNCHES = qm.LAUNCHES = 0
    rec = {}
    if progs.leads:
        eng = ServeEngine(bundle, None, programs=progs, n_slots=8,
                          page_size=16, max_len=4096, prefill_chunk=256)
        firsts = {}
        base = eng._on_prefill_complete

        def keep(adm, logit, base=base, firsts=firsts):
            firsts[adm.request.seed] = logit.float().cpu()
            return base(adm, logit)
        eng._on_prefill_complete = keep
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = generate_many(eng, [Request(**r) for r in reqs])
        torch.cuda.synchronize()
        rec["wall_s"] = time.perf_counter() - t0
        rec["tokens"] = [r.token_ids for r in res]
        rec["generated"] = [len(r.generated_ids) for r in res]
        torch.save(firsts[1], out_path + "." + name + ".logits1.pt")
        progs.release()
    else:
        progs.follow()
    torch.cuda.synchronize()
    rec["pool_heads"] = [int((p["k"].q if hasattr(p["k"], "q") else
                              p["k"]).shape[3]) for p in progs._pools]
    rec["launches"] = {"paged_attend_split": pd.SPLIT_LAUNCHES,
                       "paged_attend_mma": pd.MMA_LAUNCHES,
                       "paged_attend_combine": pd.COMBINE_LAUNCHES,
                       "quantized_matmul": qm.LAUNCHES}
    out["runs"][name] = rec
    del progs
    torch.cuda.empty_cache()
with open(out_path + ".rank" + str(rank), "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
""" % TP2_GO_WAIT_S


def logit_ulps(torch, got, ref) -> float:
    """max |got - ref| in ulps of the largest |ref| (bf16: 8 bits)."""
    big = ref.abs().max()
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    return ((got - ref).abs().max() / ulp).item()


def serve_neox20b(torch, card: str) -> dict:
    """(a) gpt-neox-20b at full width and depth (bf16, ~41 GB) serving
    phase 7's 8 requests (prompts 17 to 2000 tokens, 32 new) with 256-token
    chunks: K4 at head_dim 96, both bodies and the combine. The
    2000-token request's prefill logits and first decode step's against
    ``models/neox.py:apply`` over its prompt and first token."""
    import numpy as np

    from distributed_training_guide_tpu_torch.models import get_model, neox
    from distributed_training_guide_tpu_torch.ops import paged_decode as pd
    from distributed_training_guide_tpu_torch.serve import (
        Request, ServeEngine, generate_many, throughput_stats)

    t0 = time.perf_counter()
    bundle = get_model(NEOX20B, dtype=torch.bfloat16,
                       param_dtype=torch.bfloat16)
    params = bundle.init(bundle.config, SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = bundle.config
    specs = dense_serve_specs(np, cfg.vocab_size, 2000)
    programs = tap_programs()(bundle, params, device="cuda")
    programs.rows = {}
    eng = ServeEngine(bundle, None, programs=programs, n_slots=8,
                      page_size=16, max_len=NEOX_MAX_LEN, prefill_chunk=256)
    reset_dense_counts()                        # the main path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = generate_many(eng, [Request(**r) for r in specs])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dense_counts()                   # ... and ends here
    for r in res:
        check(r.finish_reason == "length" and len(r.generated_ids) == 32
              and all(0 <= x < cfg.vocab_size for x in r.generated_ids),
              f"neox-20b: request {r.request_id} ended {r.finish_reason} "
              f"after {len(r.generated_ids)} tokens")
    for k in ("paged_attend_split", "paged_attend_mma",
              "paged_attend_combine"):
        check(launches[k] > 0, f"neox-20b: no {k} launch at head_dim 96")
    check(launches["paged_attend"] == cfg.num_layers * (
        eng.decode_steps + programs.prefill_calls),
        f"neox-20b: {launches['paged_attend']} K4 calls for "
        f"{eng.decode_steps} decode steps and {programs.prefill_calls} "
        f"chunk forwards")
    stats = throughput_stats(res, wall, eng)
    long = res[1]
    prompt = list(specs[1]["prompt_ids"])
    n = len(prompt)
    rows = {"prefill": programs.rows[(1, n)],
            "first decode": programs.rows[(1, n + 1)]}
    programs.rows = None
    del eng, programs
    torch.cuda.empty_cache()
    ids = torch.tensor([prompt + long.generated_ids[:1]], device="cuda")
    with torch.no_grad():
        ref = neox.apply(cfg, params, ids)[0].float()
    checks = {}
    for (name, got), pos in zip(rows.items(), (n - 1, n)):
        got = got.float()
        want = ref[pos]
        checks[name] = dict(
            ulps_of_max=logit_ulps(torch, got, want),
            rel_l2=((got - want).norm() / want.norm()).item(),
            max_abs=(got - want).abs().max().item(),
            argmax_equal=bool(got.argmax() == want.argmax()))
        check(bool(torch.isfinite(got).all()) and got.shape == want.shape,
              f"neox-20b {name} logits not finite / wrong shape")
        check(checks[name]["ulps_of_max"] <= NEOX_LOGIT_ULPS
              and checks[name]["rel_l2"] <= LOGIT_REL_L2_BF16,
              f"neox-20b {name} logits: {checks[name]} (bounds "
              f"{NEOX_LOGIT_ULPS} ulps, rel L2 {LOGIT_REL_L2_BF16})")
    del ref, params
    torch.cuda.empty_cache()
    out = dict(model=NEOX20B, layers=cfg.num_layers, head_dim=cfg.head_size,
               params=bundle.num_params(), init_s=init_s, wall_s=wall,
               tokens_per_s=stats["tokens_per_s"],
               ttft_s_p50=stats["ttft_s_p50"], launches=launches,
               logits=checks, bound_ulps=NEOX_LOGIT_ULPS)
    log(phase="serve_plan", part="(a) gpt-neox-20b, head_dim 96", card=card,
        **out)
    return out


def serve_world_one(torch, card: str, specs) -> dict:
    """(b) llama-3.1-8b at full width, 8 layers, served with no plan, under
    tp and under fsdp at world 1 over NCCL: the plans' tokens bitwise the
    plain engine's, K4's launches equal. Returns (c)'s references: the
    plain engine's tokens, first-token logits of the 2000-token request
    and each drawn row's top-2 margin, in bf16 (every request) and with
    an int8 pool and int8 weights (the first two)."""
    import torch.distributed as dist

    from distributed_training_guide_tpu_torch.launch import (
        maybe_initialize_distributed)
    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.parallel import (make_mesh,
                                                               make_plan)
    from distributed_training_guide_tpu_torch.serve import (
        Request, ServeEngine, generate_many)

    bundle = get_model(SERVE_PLAN_MODEL, dtype=torch.bfloat16,
                       param_dtype=torch.bfloat16,
                       num_layers=SERVE_PLAN_LAYERS)
    params = bundle.init(bundle.config, SEED, device="cuda")
    runs = {}

    def serve(plan, programs=None, reqs=specs):
        eng = ServeEngine(bundle, params, n_slots=8, page_size=16,
                          max_len=4096, prefill_chunk=256, plan=plan,
                          programs=programs)
        firsts = {}
        base = eng._on_prefill_complete

        def keep(adm, logit):
            firsts[adm.request.seed] = logit.float()
            return base(adm, logit)
        eng._on_prefill_complete = keep
        before = kernel_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = generate_many(eng, [Request(**r) for r in reqs])
        torch.cuda.synchronize()
        return dict(tokens=[r.token_ids for r in res],
                    wall_s=time.perf_counter() - t0,
                    launches=counts_since(before), logits1=firsts[1])

    def reference(reqs, **kw):
        """The plain engine's run, with each drawn row's top-2 margin
        (kept by a tap on its programs): (c)'s judge."""
        tap = tap_programs()(bundle, params, device="cuda", **kw)
        tap.rows = {}
        run = serve(None, tap, reqs)
        run["margins"] = {}
        for key, row in tap.rows.items():
            top = row.float().topk(2).values
            run["margins"][key] = float(top[0] - top[1])
        run["logits1"] = run["logits1"].cpu()
        return run

    zero_counts()                               # the main path starts here
    runs["plain"] = reference(specs)
    refs = {"bf16": runs["plain"]}
    for name, kw in TP2_INT8_RUNS:
        refs[name] = reference(specs[:2], **kw)

    def plans():
        maybe_initialize_distributed("cuda")
        try:
            for name, strategy in (("tp", "tp"), ("fsdp", "fsdp")):
                runs[name] = serve(make_plan(strategy, make_mesh()))
        finally:
            dist.destroy_process_group()
    with_env(plan_env(), plans)
    launches = kernel_counts()                  # ... and ends here
    out = {}
    for name in ("tp", "fsdp"):
        out[name] = dict(
            bitwise=runs[name]["tokens"] == runs["plain"]["tokens"],
            launches_equal=runs[name]["launches"] == runs["plain"][
                "launches"],
            wall_s=runs[name]["wall_s"])
        check(out[name]["bitwise"] and out[name]["launches_equal"],
              f"serve_plan (b) {name} at world 1: tokens bitwise "
              f"{out[name]['bitwise']}, launches {runs[name]['launches']} "
              f"against {runs['plain']['launches']}")
    log(phase="serve_plan", part="(b) tp / fsdp at world 1", card=card,
        model=SERVE_PLAN_MODEL, layers=SERVE_PLAN_LAYERS,
        plain_wall_s=runs["plain"]["wall_s"],
        launches_per_run=runs["plain"]["launches"],
        int8_refs={n: {"wall_s": r["wall_s"], "launches": r["launches"]}
                   for n, r in refs.items() if n != "bf16"}, **out)
    del params
    torch.cuda.empty_cache()
    return dict(out, launches=launches, refs=refs)


def start_tp2_ranks(specs) -> dict:
    """(c)'s two ranks started (``launch.local``): they start up while
    (a) and (b) run and serve once ``serve_tp2_ranks`` writes the go
    file."""
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="tp2-"))
    out = {"tmp": tmp, "go": tmp / "go", "stdout": open(tmp / "out", "w"),
           "stderr": open(tmp / "err", "w")}
    out["proc"] = subprocess.Popen(
        [sys.executable, "-m", "distributed_training_guide_tpu_torch.launch."
         "local", "--nproc", "2", "--log-dir", str(tmp / "logs"), "--",
         sys.executable, "-c", _TP2_SCRIPT,
         str(ROOT), json.dumps(specs), str(tmp / "tp2"),
         str(SERVE_PLAN_LAYERS), SERVE_PLAN_MODEL, str(out["go"])],
        cwd=str(ROOT), stdout=out["stdout"], stderr=out["stderr"],
        text=True)
    return out


def stop_tp2_ranks(ranks: dict) -> None:
    """(c)'s gang ended (SIGTERM: ``launch.local`` ends its ranks) if it
    still runs, its output files closed."""
    proc = ranks["proc"]
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    ranks["stdout"].close()
    ranks["stderr"].close()


def serve_tp2_ranks(torch, card: str, specs, plain: dict,
                    ranks: dict) -> dict:
    """(c) tp 2 with shard_kv as two ranks on the one card over gloo:
    each rank's pool holds 4 of the 8 kv heads, K4 runs on them. Each run
    (bf16 over every request; an int8 pool and int8 weights, K7 on each
    rank's shards, over the first two) is held to (b)'s plain engine in
    the same storage: the first-token logits of the 2000-token request
    within phase 7's bound, and the greedy requests' tokens (a bf16 GEMM
    split over two ranks sums in another order: a stream may part where
    the plain logits' top-2 margin is within twice that logit error)."""
    tmp, out_path = ranks["tmp"], str(ranks["tmp"] / "tp2")
    ranks["go"].write_text("go")
    try:
        rc = ranks["proc"].wait(timeout=TP2_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        rc = None
    stop_tp2_ranks(ranks)
    logs = "".join(p.read_text()[-3000:] for p in sorted(
        (tmp / "logs").glob("*")) if p.is_file())
    check(rc == 0, f"serve_plan (c): rc {rc}: "
          f"{(tmp / 'out').read_text()[-1500:]} "
          f"{(tmp / 'err').read_text()[-3000:]} {logs}")
    ranks = [json.loads(Path(f"{out_path}.rank{r}").read_text())
             for r in (0, 1)]
    probe = ranks[0]["probe"]
    check(probe["all_reduce"] == [3.0] * 4
          and probe["all_gather"] == [0.0] * 4 + [1.0] * 4
          and probe["broadcast"] == [0.0, 0.0],
          f"serve_plan (c): gloo on CUDA tensors: {probe}")
    runs = ranks[0]["runs"]
    res = {}
    for name, rec in runs.items():
        heads = {r: ranks[r]["runs"][name]["pool_heads"] for r in (0, 1)}
        check(all(set(h) == {4} for h in heads.values()),
              f"serve_plan (c) {name}: pool kv heads {heads}")
        check(all(g == 32 for g in rec["generated"]),
              f"serve_plan (c) {name}: generated {rec['generated']}")
        lau = {r: ranks[r]["runs"][name]["launches"] for r in (0, 1)}
        check(all(lau[r]["paged_attend_split"] > 0
                  and lau[r]["paged_attend_mma"] > 0 for r in (0, 1)),
              f"serve_plan (c) {name}: launches {lau}")
        if name == "int8_weights":
            check(all(lau[r]["quantized_matmul"] > 0 for r in (0, 1)),
                  f"serve_plan (c): no K7 launch on the shards: {lau}")
        want = plain["refs"][name]
        logits = torch.load(f"{out_path}.{name}.logits1.pt")
        ref = want["logits1"]
        rel = ((logits - ref).norm() / ref.norm()).item()
        res[name] = dict(pool_heads=heads[0], launches=lau,
                         wall_s=rec["wall_s"], logits1_rel_l2=rel,
                         agree=sum(a == b for a, b in zip(
                             rec["tokens"], want["tokens"])),
                         first_tokens_equal=[a[:1] == b[:1] for a, b in zip(
                             rec["tokens"], want["tokens"])])
        check(bool(torch.isfinite(logits).all()) and logits.shape
              == ref.shape and rel <= LOGIT_REL_L2_BF16,
              f"serve_plan (c) {name}: first-token logits rel L2 {rel} > "
              f"{LOGIT_REL_L2_BF16} (or not finite / shape "
              f"{tuple(logits.shape)})")
        # a greedy stream may part from (b)'s only at a draw whose top-2
        # margin in (b) is within twice the logit error the two ranks'
        # bf16 sums show on the first-token row
        err = (logits - ref).abs().max().item()
        parted, greedy = [], 0
        for i, r in enumerate(specs[:len(rec["tokens"])]):
            if "temperature" in r:
                continue
            greedy += 1
            # token_ids: the prompt, then the drawn tokens; the row a
            # token at position j was drawn from is keyed (seed, j)
            a, b = rec["tokens"][i], want["tokens"][i]
            j = next((j for j in range(min(len(a), len(b)))
                      if a[j] != b[j]), None)
            if j is not None:
                parted.append((i, j, want["margins"][(r["seed"], j)]))
        res[name].update(logit_max_abs_err=err, parted=parted,
                         greedy_equal=greedy - len(parted))
        check(all(m <= 2 * err for _, _, m in parted),
              f"serve_plan (c) {name}: greedy streams parted from (b)'s "
              f"at margins above twice the logit error {err}: {parted}")
    log(phase="serve_plan", part="(c) tp 2, shard_kv, two ranks on one "
        "card over gloo", card=card, probe=probe, **res)
    return dict(runs=res, launches={
        r: {k: sum(ranks[r]["runs"][n]["launches"][k] for n in runs)
            for k in runs["bf16"]["launches"]} for r in (0, 1)})


def phase_serve_plan(torch, card: str) -> dict:
    """Phase 27: (a) gpt-neox-20b through K4 at head_dim 96, (b) the tp
    and fsdp plans at world 1, (c) tp 2 with the sharded pool as two
    ranks on the card."""
    import numpy as np

    from distributed_training_guide_tpu_torch.models import get_model

    gc.collect()
    torch.cuda.empty_cache()
    log(phase="serve_plan", allocated_gib=torch.cuda.memory_allocated()
        / 2 ** 30, reserved_gib=torch.cuda.memory_reserved() / 2 ** 30)
    specs = dense_serve_specs(
        np, get_model(SERVE_PLAN_MODEL).config.vocab_size, 2000)
    ranks = start_tp2_ranks(specs)
    try:
        neox20b = serve_neox20b(torch, card)
        world1 = serve_world_one(torch, card, specs)
        tp2 = serve_tp2_ranks(torch, card, specs, world1, ranks)
    finally:
        stop_tp2_ranks(ranks)
    launches = {k: neox20b["launches"].get(k, 0) + world1["launches"].get(
        k, 0) for k in set(neox20b["launches"]) | set(world1["launches"])}
    return {"neox20b": neox20b, "world1": {k: v for k, v in world1.items()
                                            if k != "refs"},
            "tp2": tp2, "launches": launches}


def ptxas_serialized(build) -> list:
    """The kernels whose wgmma ptxas serialized (warning C7520: a wgmma
    under a branch it cannot prove warp-uniform), as the warning names
    them (mangled), from the ``-Xptxas -v`` logs."""
    import re

    return sorted({m.group(1) for log in build.build_logs.values()
                   for line in log.splitlines() if "C7520" in line
                   for m in [re.search(r"function '([^']+)'", line)] if m}
                  | {line.strip()[:160] for log in build.build_logs.values()
                     for line in log.splitlines() if "C7520" in line
                     and "function '" not in line})


def ptxas_summary(build) -> dict:
    """kernel -> {instantiation: [registers, spill store bytes]} from
    ``nvcc -Xptxas -v``, names demangled by the toolkit's ``cu++filt``."""
    import re

    found = []                      # [mangled, registers, spill bytes]
    for name in sorted(build.build_logs):
        for line in build.build_logs[name].splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                found.append([m.group(1), None, None])
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and found:
                found[-1][2] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and found:
                found[-1][1] = int(m.group(1))
    filt = Path(build.nvcc_path()).with_name("cu++filt")
    names = [f[0] for f in found]
    if filt.exists() and names:
        names = subprocess.run([str(filt), *names], capture_output=True,
                               text=True, check=True,
                               timeout=60).stdout.split("\n")[:len(found)]
    out: dict = {}
    for (mangled, regs, spill), name in zip(found, names):
        m = re.search(r"\w+_kernel<[^>]*>", name.replace("(int)", ""))
        short = m.group(0) if m else name.strip()
        kernel = next((k for w, k in (
            ("paged_attend_split", "paged_attend_split"),
            ("paged_attend_mma", "paged_attend_mma"),
            ("paged_attend_combine", "paged_attend_combine"),
            ("flash_fwd", "flash_fwd"),
            ("flash_dq", "flash_dq"), ("flash_dkv", "flash_dkv"),
            ("tgmm", "tgmm"), ("gmm_", "grouped_matmul"),
            ("qmm_", "quantized_matmul")) if w in short),
            "other")
        out.setdefault(kernel, {})[short] = [regs, spill]
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (ROOT / "distributed_training_guide_tpu_torch" / "ops" / "csrc"
            ).is_dir():
        print(f"chip_smoke: the repository is not beside {__file__}",
              file=sys.stderr)
        return 2
    # bytecode cached under build/ (this card's environment writes none:
    # PYTHONDONTWRITEBYTECODE), so phase 26's workers import torch's
    # modules from bytecode as an installed package does
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.path.insert(0, str(ROOT))
    from distributed_training_guide_tpu_torch.ops import _build

    t_start = time.perf_counter()
    card = torch.cuda.get_device_name(0)
    smi = smi_name_power()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import importlib.util

    log(phase="device", name=card, nvidia_smi=smi,
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, matmul_allow_tf32=False,
        cudnn_allow_tf32=False,
        # present or not: the port imports none of them at module level
        optional_modules={m: importlib.util.find_spec(m) is not None
                          for m in ("safetensors", "transformers", "wandb",
                                    "tqdm", "triton")})

    t0 = time.perf_counter()
    sources = _build.all_sources()
    _build.build(sources)
    ptxas = ptxas_summary(_build)
    serialized = ptxas_serialized(_build)
    log(phase="build", sources=sources, seconds=time.perf_counter() - t0,
        ptxas=ptxas, wgmma_serialized_c7520=serialized)
    check(not any("tgmm" in name for name in serialized),
          f"ptxas serialized K6's wgmma (C7520): {serialized}")

    phase_s = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        phase_s[name] = round(time.perf_counter() - t, 1)
        return res

    worst = timed("kernels", phase_kernels, torch)
    timing = timed("timing", phase_timing, torch)
    # phase 27 runs here, on a card nothing else holds: gpt-neox-20b's
    # weights and pool take ~59 of its 80 GB
    serve_plan = timed("serve_plan", phase_serve_plan, torch, smi)
    flash_worst = timed("flash", phase_flash, torch)
    flash_timing = timed("flash_timing", phase_flash_timing, torch)
    serve = timed("serve", phase_serve, torch, smi)
    train = timed("train", phase_train, torch, smi)
    gmm_worst = timed("grouped", phase_grouped, torch)
    gmm_timing = timed("grouped_timing", phase_grouped_timing, torch)
    moe_serve = timed("moe_serve", phase_moe_serve, torch, smi)
    moe_train = timed("moe_train", phase_moe_train, torch, smi)
    qmm_worst = timed("qmm", phase_qmm, torch)
    qmm_timing = timed("qmm_timing", phase_qmm_timing, torch)
    int8_serve = timed("int8_serve", phase_int8_serve, torch, smi)
    # phase 18's preflight (CPU work on meta tensors in a process of its
    # own) runs beside phases 16 and 17
    preflight = ch05_preflight_start()
    atexit.register(lambda: preflight.poll() is None and preflight.kill())
    ch01 = timed("chapter01", phase_chapter01, torch, smi)
    plans = timed("plans", phase_plans, torch, smi)
    ch05 = timed("chapter05", phase_chapter05, torch, smi, plans, preflight)
    dense = timed("dense", phase_dense, torch, smi, ch01)
    cp_pp = timed("cp_pp", phase_cp_pp, torch, smi, plans)
    ch10 = timed("chapter10", phase_chapter10, torch, smi)
    ovl = timed("overlap", phase_overlap, torch, smi)
    spec = timed("spec_horizon", phase_spec_horizon, torch, smi)
    tp = timed("tenants_post", phase_tenants_post, torch, smi)
    fleet = timed("fleet", phase_fleet, torch, smi)
    robust = timed("robustness", phase_robustness, torch, smi)

    # K4 is three kernels: each body at the shape it serves (decode, the
    # prefill chunk) and the combine at decode; "k4_ms" is the whole call
    k4_shapes = {k: {kk: v[kk] for kk in (
        "S", "T", "heads", "head_dim", "context", "dtype", "ms", "call_ms", "plain_ms",
        "library_ms",
        "bound_ms", "bound_by", "share_of_bound", "body_ms", "body_bound_ms",
        "combine_ms", "combine_bound_ms")} for k, v in timing.items()}
    k4 = {"route": "cuda",
          "source": "distributed_training_guide_tpu_torch/ops/csrc/"
                    "paged_attend.cu",
          "replaces": "distributed_training_guide_tpu/ops/paged_decode.py:107"}
    dec, chunk = timing["decode"], timing["chunk"]
    kernels = [{
        "name": "paged_attend_split", **k4,
        "launches": serve["body_launches"]["split"]
        + spec["launches"]["paged_attend_split"]
        + tp["launches"]["paged_attend_split"]
        + fleet["launches"]["paged_attend_split"]
        + serve_plan["launches"]["paged_attend_split"],
        "launches_fleet": fleet["launches"]["paged_attend_split"],
        "launches_serve_plan": serve_plan["launches"]["paged_attend_split"],
        "launches_serve_plan_neox20b_d96": serve_plan["neox20b"][
            "launches"]["paged_attend_split"],
        "launches_serve_plan_tp2_ranks": {
            r: v["paged_attend_split"]
            for r, v in serve_plan["tp2"]["launches"].items()},
        "launches_tenants_post": tp["launches"]["paged_attend_split"],
        "launches_spec_horizon": spec["launches"]["paged_attend_split"],
        "max_abs_err": worst["split"], "shape": "decode", "ms": dec["body_ms"],
        "plain_ms": dec["body_plain_ms"], "bound_ms": dec["body_bound_ms"],
        "bound_by": dec["body_bound_by"], "library_ms": dec["library_ms"],
        "library_note": "SDPA computes the whole attention, body and combine",
        "k4_ms": dec["ms"], "k4_call_ms": dec["call_ms"],
        "k4_plain_ms": dec["plain_ms"], "k4_bound_ms": dec["bound_ms"],
        "launches_per_decode_step": serve["per_step"],
        "launches_dense_families": dense["launches"]["paged_attend_split"],
        "ptxas_registers_spills": ptxas.get("paged_attend_split", {}),
        "shapes": {**k4_shapes, **dense["k4_timing"]},
    }, {
        "name": "paged_attend_mma", **k4,
        "launches": serve["body_launches"]["mma"]
        + spec["launches"]["paged_attend_mma"]
        + tp["launches"]["paged_attend_mma"]
        + fleet["launches"]["paged_attend_mma"]
        + serve_plan["launches"]["paged_attend_mma"],
        "launches_fleet": fleet["launches"]["paged_attend_mma"],
        "launches_serve_plan": serve_plan["launches"]["paged_attend_mma"],
        "launches_serve_plan_neox20b_d96": serve_plan["neox20b"][
            "launches"]["paged_attend_mma"],
        "launches_serve_plan_tp2_ranks": {
            r: v["paged_attend_mma"]
            for r, v in serve_plan["tp2"]["launches"].items()},
        "launches_tenants_post": tp["launches"]["paged_attend_mma"],
        "launches_spec_horizon": spec["launches"]["paged_attend_mma"],
        "launches_dense_families": dense["launches"]["paged_attend_mma"],
        "max_abs_err": worst["mma"], "shape": "chunk", "ms": chunk["body_ms"],
        "plain_ms": chunk["body_plain_ms"],
        "bound_ms": chunk["body_bound_ms"],
        "bound_by": chunk["body_bound_by"], "library_ms": chunk["library_ms"],
        "library_note": "SDPA computes the whole attention, body and combine",
        "k4_ms": chunk["ms"], "k4_call_ms": chunk["call_ms"],
        "k4_plain_ms": chunk["plain_ms"], "k4_bound_ms": chunk["bound_ms"],
        "ptxas_registers_spills": ptxas.get("paged_attend_mma", {}),
    }, {
        "name": "paged_attend_combine", **k4,
        "launches": serve["body_launches"]["combine"]
        + spec["launches"]["paged_attend_combine"]
        + tp["launches"]["paged_attend_combine"]
        + fleet["launches"]["paged_attend_combine"]
        + serve_plan["launches"]["paged_attend_combine"],
        "launches_fleet": fleet["launches"]["paged_attend_combine"],
        "launches_serve_plan": serve_plan["launches"]["paged_attend_combine"],
        "launches_serve_plan_neox20b_d96": serve_plan["neox20b"][
            "launches"]["paged_attend_combine"],
        "launches_serve_plan_tp2_ranks": {
            r: v["paged_attend_combine"]
            for r, v in serve_plan["tp2"]["launches"].items()},
        "launches_tenants_post": tp["launches"]["paged_attend_combine"],
        "launches_spec_horizon": spec["launches"]["paged_attend_combine"],
        "launches_dense_families": dense["launches"]["paged_attend_combine"],
        "max_abs_err": worst["combine"], "shape": "decode",
        "ms": dec["combine_ms"], "plain_ms": dec["combine_plain_ms"],
        "bound_ms": dec["combine_bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "library_note": "no PyTorch call merges split softmax partials",
        "ptxas_registers_spills": ptxas.get("paged_attend_combine", {}),
    }]
    replaces = {"flash_fwd": 112, "flash_dq": 297, "flash_dkv": 341}
    shape_keys = ("body", "ms", "profiler_ms", "call_ms", "plain_ms",
                  "library_ms", "library_call_ms", "bound_ms", "bound_by",
                  "share_of_bound", "causal_tail")
    for name, line in replaces.items():
        t = flash_timing["1b-main"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "distributed_training_guide_tpu_torch/ops/csrc/"
                      + ("flash_fwd.cu" if name == "flash_fwd"
                         else "flash_bwd.cu"),
            "replaces": f"distributed_training_guide_tpu/ops/"
                        f"flash_attention.py:{line}",
            "launches": train["launches"][name] + tp["launches"][name]
            + robust["launches"][name],
            "launches_tenants_post": tp["launches"][name],
            "launches_robustness": robust["launches"][name],
            "launches_per_post_iteration": {
                run: [i["launches"][name] for i in r["iterations"]]
                for run, r in tp["post"].items()},
            "max_abs_err": flash_worst[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "launches_per_train_step": train["per_step"],
            "ptxas_registers_spills": ptxas.get(name, {}),
            "shape": "B 4, S 2048, Hq 32, Hkv 8, D 64, bf16, causal",
            **({"library_note": t["library_note"]}
               if "library_note" in t else {}),
            "body": t["body"],
            "bf16_kernel_arith_rel_l2": flash_worst["kernel_arith"][name],
            "launches_chapter01": ch01["launches"][name],
            "launches_plans": plans["launches"][name],
            "launches_chapter05": ch05["launches"][name],
            "launches_dense_families": dense["launches"][name],
            "launches_per_step_dense": {
                k: v["launches_per_step"][name]
                for k, v in dense["train"].items()},
            "launches_per_step_405b_layer":
                ch05["layer"]["launches_per_step"][name],
            "launches_per_step_by_plan": {
                k: v[name] for k, v in plans["per_step"].items()},
            "launches_per_step_by_remat_policy": {
                p: r["launches_per_step"][name]
                for p, r in ch01["remat"].items()},
            "launches_context_pipeline": cp_pp["launches"][name],
            "launches_by_run_context_pipeline": {
                "ring_S32768": cp_pp["ring"][f"S{RING_LONG_SEQ}"][
                    "launches"][name],
                "ring_band": (cp_pp["ring"]["band-x1"]["launches"][name]
                              + cp_pp["ring"]["band-x12"]["launches"][name]),
                "ulysses": cp_pp["ulysses"]["launches"][name],
                **{f"pipeline_pp{pp}": cp_pp["pipeline"][f"pp{pp}"][
                    "launches"][name] for pp in PP_STAGES},
                "chapters_08_09": cp_pp["chapters"]["launches"][name]},
            "launches_per_step_context_pipeline": cp_pp["per_step"],
            "launches_chapter10": ch10["launches"][name],
            "launches_overlap": ovl["launches"][name],
            "shapes": {**{shape: {
                "B_S_Hq_Hkv_D": FLASH_TIMING_SHAPES[shape],
                **{kk: flash_timing[shape][name][kk] for kk in shape_keys
                   if kk in flash_timing[shape][name]}}
                for shape in FLASH_TIMING_SHAPES},
                "405b-layer": {
                    "B_S_Hq_Hkv_D": CH05_405B_SHAPE,
                    **{kk: v for kk, v in
                       ch05["layer"]["kernels"]["timing"][name].items()
                       if kk in shape_keys}},
                **{shape: {"B_S_Hq_Hkv_D": DENSE_FLASH_SHAPES[shape],
                           **{kk: dense["flash_timing"][shape][name][kk]
                              for kk in shape_keys
                              if kk in dense["flash_timing"][shape][name]}}
                   for shape in DENSE_FLASH_SHAPES},
                "gemma2-2b-train": {
                    "B_S_Hq_Hkv_D": (1, GEMMA2_SEQ, GEMMA2["hq"],
                                     GEMMA2["hkv"], GEMMA2["d"]),
                    "window": GEMMA2["window"], "softcap": GEMMA2["softcap"],
                    **{kk: v for kk, v in
                       dense["gemma2_flash"]["timing"][name].items()
                       if kk in shape_keys + ("library_note",)}},
                **{shape: {
                    **{kk: t[kk] for kk in ("B_Sq_Sk_Hq_Hkv_D", "causal",
                                             "band", "live_pairs")},
                    **{kk: t[name][kk] for kk in shape_keys
                       + ("library_note",) if kk in t[name]}}
                   for shape, t in cp_pp["timing"].items()}},
        })
    keys = ("M", "K", "N", "G", "dtype", "body", "ms", "profiler_ms",
            "call_ms", "plain_ms", "library_ms", "library_call_ms", "bound_ms",
            "bound_by", "bound_fma_ms", "share_of_bound")
    dec = gmm_timing["decode"]
    kernels.append({
        "name": "grouped_matmul", "route": "cuda",
        "source": "distributed_training_guide_tpu_torch/ops/csrc/"
                  "grouped_matmul.cu",
        "replaces": "distributed_training_guide_tpu/ops/grouped_matmul.py:150",
        "launches": moe_serve["launches"]
        + moe_train["launches"]["grouped_matmul"]
        + ch10["launches"]["grouped_matmul"]
        + ovl["launches"]["grouped_matmul"]
        + spec["launches"]["grouped_matmul"]
        + tp["launches"]["grouped_matmul"]
        + fleet["launches"]["grouped_matmul"],
        "launches_fleet": fleet["launches"]["grouped_matmul"],
        "launches_spec_horizon": spec["launches"]["grouped_matmul"],
        "launches_tenants_post": tp["launches"]["grouped_matmul"],
        "launches_per_tenant_forward": tp["serve"]["k5_per_forward"],
        "launches_by_body_tenants": tp["serve"]["k5_by_body"],
        "launches_per_post_iteration": {
            run: [i["launches"]["grouped_matmul"] for i in r["iterations"]]
            for run, r in tp["post"].items()},
        "launches_overlap": ovl["launches"]["grouped_matmul"],
        "launches_ep_ring_by_body": ovl["ring"]["launches"]["by_body"][
            "grouped_matmul"],
        "launches_serve": moe_serve["launches"],
        "launches_train": moe_train["launches"]["grouped_matmul"],
        "launches_chapter10": ch10["launches"]["grouped_matmul"],
        "launches_per_step_chapter10": ch10["chapter"]["ragged"][
            "launches_per_step"]["grouped_matmul"],
        "launches_ep_exchange_by_body": ch10["exchange"]["launches"][
            "by_body"]["grouped_matmul"],
        "launches_per_serve_forward": moe_serve["per_forward"],
        "launches_per_train_step": moe_train["per_step"]["grouped_matmul"],
        "launches_by_body_train": moe_train["launches_by_body"],
        "launches_chapter01": ch01["launches"]["grouped_matmul"],
        "max_abs_err": gmm_worst["grouped_matmul"], "body": dec["body"],
        "tc_sum_drift_k8192": gmm_worst["tc_sum_drift"],
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"],
        "ptxas_registers_spills": ptxas.get("grouped_matmul", {}),
        "shapes": {**{k: {kk: gmm_timing[k].get(kk) for kk in keys}
                      for k in ("decode", "verify", "train", "train-dlhs")},
                   "ep-window": ch10["window"]["rows"]["fwd"],
                   "ep-window-dlhs": ch10["window"]["rows"]["dlhs"],
                   "ring-hop-window": ovl["hop_window"]["rows"]["fwd"],
                   "ring-hop-window-dlhs": ovl["hop_window"]["rows"][
                       "dlhs"],
                   **{k: {kk: v.get(kk) for kk in keys + (
                       "max_abs_err", "library_note", "library_fp32_ms",
                       "library_fp32_note")}
                      for k, v in tp["gmm"].items()}},
    })
    t = gmm_timing["tgmm-train"]
    tkeys = keys + ("fma_ms", "library_bf16_dy_ms")
    kernels.append({
        "name": "tgmm", "route": "cuda",
        "source": "distributed_training_guide_tpu_torch/ops/csrc/"
                  "grouped_matmul.cu",
        "replaces": "distributed_training_guide_tpu/ops/grouped_matmul.py:176",
        "launches": moe_train["launches"]["tgmm"]
        + ch10["launches"]["tgmm"] + ovl["launches"]["tgmm"]
        + tp["launches"]["tgmm"],
        "launches_tenants_post": tp["launches"]["tgmm"],
        "launches_post_path": tp["post_launches"]["tgmm"],
        "launches_overlap": ovl["launches"]["tgmm"],
        "launches_ep_ring_by_body": ovl["ring"]["launches"]["by_body"][
            "tgmm"],
        "launches_per_train_step": moe_train["per_step"]["tgmm"],
        "launches_chapter10": ch10["launches"]["tgmm"],
        "launches_per_step_chapter10": ch10["chapter"]["ragged"][
            "launches_per_step"]["tgmm"],
        "launches_ep_exchange_by_body": ch10["exchange"]["launches"][
            "by_body"]["tgmm"],
        "launches_by_body_train": moe_train["tgmm_launches_by_body"],
        "launches_chapter01": ch01["launches"]["tgmm"],
        "max_abs_err": gmm_worst["tgmm"], "body": t["body"],
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "bound_fma_ms": t["bound_fma_ms"],
        "library_ms": t["library_ms"], "library_note": t["library_note"],
        "ptxas_registers_spills": ptxas.get("tgmm", {}),
        "shapes": {**{k: {kk: gmm_timing[k].get(kk) for kk in tkeys}
                      for k in ("tgmm-train", "tgmm-train-down")},
                   "ep-window": ch10["window"]["rows"]["drhs"],
                   "ring-hop-window": ovl["hop_window"]["rows"]["drhs"]},
    })
    t = qmm_timing["gate-decode"]
    kernels.append({
        "name": "quantized_matmul", "route": "cuda",
        "source": "distributed_training_guide_tpu_torch/ops/csrc/"
                  "quantized_matmul.cu",
        "replaces": "distributed_training_guide_tpu/ops/"
                    "quantized_matmul.py:119",
        "launches": int8_serve["launches"]
        + spec["launches"]["quantized_matmul"]
        + tp["launches"]["quantized_matmul"]
        + fleet["launches"]["quantized_matmul"],
        "launches_fleet": fleet["launches"]["quantized_matmul"],
        "launches_serve_plan_tp2_ranks": {
            r: v["quantized_matmul"]
            for r, v in serve_plan["tp2"]["launches"].items()},
        "launches_tenants_post": tp["launches"]["quantized_matmul"],
        "launches_spec_horizon": spec["launches"]["quantized_matmul"],
        "launches_by_body": int8_serve["launches_by_body"],
        "launches_per_serve_forward": int8_serve["per_forward"],
        "max_abs_err": qmm_worst, "body": t["body"],
        "ms": t["ms"], "call_ms": t["call_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "bound_fma_ms": t["bound_fma_ms"],
        "library_ms": None, "library_note": t["library_note"],
        "control_ms": t["control_ms"], "control_note": t["control_note"],
        "ptxas_registers_spills": ptxas.get("quantized_matmul", {}),
        "shapes": {k: {kk: v[kk] for kk in (
            "M", "K", "N", "bs", "dtype", "body", "splits", "ms", "call_ms",
            "plain_ms", "control_ms", "bound_ms", "bound_by", "bound_fma_ms",
            "share_of_bound")}
            for k, v in qmm_timing.items()},
    })
    log(phase="done", seconds=time.perf_counter() - t_start,
        seconds_by_phase=phase_s)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
