#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (on PATH or in /usr/local/cuda/bin) and the
checkout's ``src/``; imports nothing of JAX or of the JAX package.  Phases,
each of which raises on failure (nothing is caught):

1. the card's name and power limit, the torch/CUDA versions, and the
   build of all seven kernel sources from ``src/repro_torch/kernels/csrc``
   (nvcc, sm_90a, one process per source, all at once);
2. the launch floor (the graph-replay time of one in-place add on a
   one-element tensor), then each kernel against its plain PyTorch
   version at the serving paths' shapes (attention at smollm-135m's
   head_dim 64 / group 3, deepseek-moe-16b's head_dim 128 / group 1,
   granite-3-8b's head_dim 128 / group 4 and recurrentgemma-2b's
   head_dim 256 / group 10; flash also at the static engine's 8 x 200
   for smollm, granite and recurrentgemma (its 2048 window), non-causal
   at whisper-medium's encoder (16 heads of 64 over 1500 states, batch 1
   and 8) and cross-attention (1 and 200 queries against 1500 keys),
   and causal at llava-next-mistral-7b's prefill (1152 patches + 200
   tokens, 32 / 8 heads of 128);
   paged attention also at 16 pages a row, lengths up to 2048; the
   grouped matmul at deepseek's prefill and decode expert shapes and a
   ragged one; the RG-LRU scan at recurrentgemma's (1, 300, 2560), also
   at 2048 and 40 steps, batch 4 and the static engine's batch 8 x 200,
   a ragged shape and a nonzero initial state, bit-exact in fp32; the
   RWKV-6 WKV at rwkv6-3b's (1, 300, 40, 64), also at the model's full
   decay range, at 128 tokens from a nonzero state and at the static
   engine's batch 8 x 200, output and final state), fp32 and bf16 (bf16
   flash on the tensor cores), with its time, the plain version's time,
   the time of the one PyTorch call that computes the same function
   where there is one, and its bound on the H100.  Flash attention and
   the grouped matmul have two instances, the tensor cores' for bf16
   and the CUDA cores' for fp32:
   each case line names the one that ran.  Every kernel must give
   bit-identical output in two calls, and the grouped matmul also runs
   deepseek's decode product as the model does, with
   ``counts`` from a top-6 routing of 8 tokens (its line gives the live
   experts and the bound of the bytes they need);
3. the serving path of smollm-135m at full width (30 layers, vocab 49152,
   bf16, random weights from a seed): (a) the CLI entry point, (b) the
   engine over the batched executor with mixed prompt lengths, and (c)
   kernel-vs-plain logits of the full model's prefill and first decode
   step; then (d) the static engine through the CLI (``--engine static``,
   16 requests, batch 8, 200 tokens, 64 new; ``serve_cli_static``) and
   (e) the CLI's continuous engine with bursty arrivals spread over 2 s
   (``serve_cli_arrival``: submit times as ``request_arrivals`` gives
   them, tokens complete);
4. the serving path of deepseek-moe-16b at full published width (28
   layers, d 2048, 64 routed top-6 + 2 shared experts, first layer
   dense, vocab 102400) with bf16 params (the reference's serve_bf16
   variant; random weights drawn on the card from a seed): (a) the
   engine over ``make_executor``, rows admitting and detaching
   mid-flight, and (b) kernel-vs-plain logits with all three kernels;
   then granite-3-8b at full published width (40 layers, d 4096, 32 / 8
   heads at 128, vocab 49155, fp32 params, bf16 compute): the engine
   (``serve_engine_granite``), kernel-vs-plain logits, graph vs eager,
   and the static server at batch 8 (``serve_static``) on the same raw
   weights;
5. the serving paths of recurrentgemma-2b (26 layers, d 2560, 8 windowed
   MQA attention layers at head_dim 256, 18 RG-LRU layers, vocab 256000)
   and rwkv6-3b (32 layers, d 2560, 40 WKV heads of 64, vocab 65536) at
   full published width, fp32 params and bf16 compute, each (a) through
   ``make_executor``, which picks the per-slot executor, (b) with
   kernel-vs-plain logits of the prefill and the first decode step, and
   (c) through the static server at batch 8 (``serve_static``);
5b. the serving paths of whisper-medium (enc-dec: 24 encoder and 24
   decoder layers, d 1024, 16 heads of 64, 1500 encoder states, vocab
   51865) and llava-next-mistral-7b (vlm: 32 layers, d 4096, 32 / 8
   heads of 128, vocab 32000, 1152 patch embeddings before the prompt)
   at full published width, fp32 params and bf16 compute, zero frames /
   patches as the reference's executors feed them, each (a) through
   ``make_executor``, which picks the per-slot executor
   (``serve_engine_whisper``: max_len 364; ``serve_engine_llava``:
   max_len 1152 + 300 + 48 = 1500, so the ring keeps every patch), (b)
   with kernel-vs-plain logits of the prefill and the first decode step,
   (c) ``graph_vs_eager`` and ``prefill_graph_vs_eager`` (llava's
   max_len again holding the patches) and (d) through the static server
   at batch 8 (``serve_static``, sized as the reference's server sizes
   it: max_len 232, so llava's ring keeps the newest 232 of its 1352
   prefill positions);
6. training smollm-135m at full width (bf16 compute, fp32 master
   params, batch 8 x 2048): (a) the flash forward with its LSE at the
   training shape, and the flash backward against its plain version at
   the training shape, d 128 with g 1, a window and a ragged length, fp32
   on the CUDA cores and bf16 on the tensor cores (held to the plain
   version with P and dS rounded as the kernel rounds them, and by its
   distance from the fp32 backward), with its time, the plain version's,
   SDPA's backward's and its bound; (b) the full model's loss and gradients
   with kernel and with plain attention (fp32 leaf by leaf, bf16 against
   the plain bf16 model's own distance from fp32); (c) the logits head
   at the training shape, bf16 x bf16 -> fp32 against the fp32 form it
   replaced (``train_head``: both forms' ms, the backward's, bounds);
   then, every step a replay of the captured ``TrainStep``: (d) the
   train CLI, 2 steps; (e) an ``Orchestrator`` run of 20 steps
   preempted at 15, then one on the same checkpoints and ``AotCache``
   (the same captured step) that resumes at step 10 and ends at 20: the
   emissions (STEP, CHECKPOINT, LOST in the scheduling layer,
   compiler-layer INIT on the cold run only), finite losses, step time,
   tokens/s, MFU, peak memory, capture seconds and bytes, checkpoint
   seconds, compile seconds and RG; (f) ``train_graph_vs_eager``: a
   captured and a direct-call step from the same state over the same 3
   batches, bit-identical params, m, v, step and metrics; (g) 10
   captured steps on one fixed batch, whose loss must fall, and 5
   direct-call ones with the same losses; (h) a profile of 2 steps of
   each for the device busy share;
7. training deepseek-moe-16b at its published widths with the depth cut
   28 -> 2 (the dense first layer and one MoE layer of 64 routed top-6
   and 2 shared experts; bf16 compute, fp32 master params, batch 4 x
   2048, so 960 rows per expert), each part freeing its memory before
   the next: (a) the grouped matmul's backward (``moe_gmm_bwd``, dX and
   dW) against its plain version at the wi / wg and wo training shapes
   with a real top-6 routing's row counts, and a ragged case with empty
   experts, fp32 on the CUDA cores and bf16 on the tensor cores (the
   persistent ``wgmma`` + TMA kernel: its SASS must hold ``HGMMA``
   where cuobjdump exists, its registers and spills come from the
   build's ptxas report, its dX and dW tiles are also timed alone in
   two builds of the source for one product each, started beside the
   package's build), with its time, the plain version's, ``torch.bmm``'s,
   its bound and the card's clocks while they ran, an fp32 case whose
   kernel and plain sums must both lie within the worst-case fp32 error
   of the fp64 sum, and the forward at C = 960; (b) the full model's loss and gradients with the
   kernels and with the plain versions, as in phase 6, after both fp32
   runs routed every token alike; (c) a captured ``TrainStep`` built
   from a state held on the host, 10 steps on one fixed batch (the loss
   must fall, the aux loss stay finite and positive): step ms,
   tokens/s, MFU by active parameters, the card's clocks, peak memory,
   capture seconds and pool bytes, a 2-step profile; (d) ``train_moe_graph_vs_eager``: a
   captured and a direct-call step from the same host state over the
   same 3 batches, one after the other, bit-identical metrics and final
   params, m, v and step;
8. training recurrentgemma-2b at its published widths with the depth cut
   26 -> 6 (layers 0-5: RG-LRU, RG-LRU, attention, twice; bf16 compute,
   fp32 master params, one 4,096-token sequence, so the 2048 window masks
   keys), each part freeing its memory before the next: (a) the RG-LRU
   reverse scan (``rglru_scan_bwd``) against its plain version at (1,
   4096, 2560) from zeros and from a nonzero h0 and at a ragged (1, 37,
   40), fp32 and bf16, bit-exact, with its time, the plain version's and
   its bound, and the forward scan at (1, 4096, 2560) as in phase 2; the
   flash forward with its LSE at the training shape (q
   (1, 4096, 10, 256), k, v (1, 4096, 1, 256), causal, window 2048)
   beside SDPA's forward, and the flash backward there, fp32 on the CUDA
   cores and bf16 on the tensor cores as in phase 6, beside SDPA's
   backward, both with the window as a boolean mask and the kv head
   expanded (their backends named); the backward's line also gives each
   of its launches timed apart by ``torch.profiler`` (the D pass, dQ,
   dK / dV and the sum over the group's splits), and the bf16 one its
   kernels' registers and spills and whether its SASS holds ``HGMMA``;
   (b) the full model's loss and gradients with the
   kernels (flash and the RG-LRU scan, forward and backward) and with
   the plain versions, as in phase 6, every ``lru_*``, ``w_y`` and
   ``conv_*`` leaf with a nonzero gradient; (c) a captured ``TrainStep``
   built from a state held on the host, 10 steps on one fixed batch (the
   loss must fall): step ms, tokens/s, MFU over the window's visible
   pairs, the card's clocks, peak memory, capture seconds and pool
   bytes, a 2-step profile; (d) ``train_hybrid_graph_vs_eager``: a
   captured and a direct-call step from the same host state over the
   same 3 batches, bit-identical metrics and final params, m, v and
   step;
9. training rwkv6-3b at its published widths with the depth cut 32 -> 8
   (d 2560, 40 WKV heads of 64, d_ff 8960, vocab 65536; bf16 compute,
   fp32 master params, one 4,096-token sequence), each part freeing its
   memory before the next: (a) the WKV reverse (``rwkv6_wkv_bwd``: the
   sequence cut into segments, a carry launch, the main launch with two
   blocks an SM, a finish) against its plain version at (1, 4096, 40,
   64) fp32 from zeros, from a nonzero s0 with a nonzero final-state
   gradient and at the model's full decay range, at batch 2 (2, 2048,
   40, 64) and at a ragged (1, 37, 3, 16), every gradient within
   ``WKV_BWD_RTOL`` of its largest element and two calls bit-identical,
   with its time and each launch's, the segments, blocks, registers and
   blocks an SM, the plain version's time and its bound; the
   forward at (1, 4096, 40, 64) with and without the chunk states the
   reverse reads, beside its bound (each plain version timed by the one
   eager call its check or its first row makes); (b) the full model's
   loss and gradients, at ``SSM_GRAD_LAYERS`` (2) of the 8 layers (the
   plain WKV loops over the tokens in Python: ~6 s a layer for the four
   gradient runs), with the WKV kernels and with the plain versions, as
   in phase 6, decay_b drawn nonzero so that decay_a has a gradient, every
   WKV leaf (``wr``, ``wk``, ``wv``, ``decay_*``, ``bonus``) nonzero, the
   fp32 leaves held to ``fp32_grad_limit``; (c) a captured
   ``TrainStep`` from a host state, 10 steps on one fixed batch (the
   loss must fall): step ms, tokens/s, MFU (6 N tokens, no attention),
   the card's clocks, peak memory, capture seconds and pool bytes, a
   2-step profile; (d) ``train_ssm_graph_vs_eager``, as in phase 8;
10. training whisper-medium at its published widths and full depth (24
   encoder and 24 decoder layers; bf16 compute, fp32 master params,
   remat; 8 rows of 448 tokens, each beside 1500 frames drawn from a
   seeded normal): (a) the flash forward with its LSE and the backward
   at the encoder's shape (8, 16 / 16 heads of 64, 1500 x 1500), the
   cross-attention's (448 queries x 1500 keys), both without the causal
   mask, and the decoder's causal 448, against their plain versions as
   in phase 6, beside SDPA's; (b) the full model's loss and gradients
   with the flash kernels and with the plain versions, every encoder
   attention and decoder cross-attention leaf moving, the key biases
   held by KEY_BIAS_GRAD_SHARE; (c) a captured ``TrainStep`` from a host
   state, 10 steps on one fixed batch (the loss must fall): step ms,
   tokens/s, MFU by the enc-dec formula (``train_model_flops``), the
   card's clocks, peak memory, capture seconds and pool bytes, a 2-step
   profile; (d) ``train_encdec_graph_vs_eager``, as in phase 8;
11. training llava-next-mistral-7b at its published widths with the
   depth cut 32 -> 5 (d 4096, 32 / 8 heads of 128, d_ff 14336; one
   stream of 1152 patches, drawn from a seeded normal, and 2,944
   tokens): phase 10's (a)-(d) at its causal 4096 (GQA group 4),
   every attention leaf moving, the dense MFU over the 4,096 positions
   (``train_vlm``, ``train_vlm_graph_vs_eager``);
12. the compile-time analysis of the six training cells above
   (``analysis``; it runs no step, it reads their measured step times):
   ``H100_SXM.hbm_bytes`` (``repro_torch.core.hardware``) against the
   card's total memory (within ``HBM_SPEC_SHARE``); per cell the
   reference's ``model_flops`` (6 N_active tokens) and its MFU
   (``mfu_model_flops``) beside the smoke's own, the cost reference's
   counted flops and bytes (``repro_torch.core.costref``: the plain step
   on ``meta`` tensors, on the host, each kernel's plain version at its
   kernel's bytes) and the roofline of one H100
   (``RooflineCell``: compute, memory and lower-bound times, the
   dominant term, the useful share, ``pg_measured`` = t_ideal over the
   measured step; a lower bound above the step fails), and the seconds
   each count took (the counts made beside phase 1's build, in a
   subprocess that sees no card, ``CUDA_VISIBLE_DEVICES`` empty, on host
   cores the build leaves idle, joined before phase 2 so that no timed
   phase shares the host with it); and the dry run's mesh records
   (``repro_torch.launch.dryrun``), made beside the build the same way,
   in a subprocess of their own (a fake default process group cannot
   share a process with phase 13's NCCL group):
   smollm-135m ``train_4k`` on the "cuda"-typed 16 x 16 mesh over a fake
   group of 256 ranks, and the 1 x 1 record of phase 13's smollm 8 x
   2048 train cell; the ``dryrun_mesh`` line, after phase 13: the 16 x
   16 record's collectives by kind (count and bytes), argument, temp and
   peak bytes per rank against 80 GiB, its top 3 collectives and its
   seconds, the 1 x 1 record's argument bytes, which must equal
   ``distributed_smollm``'s static state plus batch exactly, with no
   collective, and the subprocess's wall and the seconds the smoke
   waited for it after the build; a failed subprocess fails the smoke;
13. distribution (``distributed``), on a freed card: the default process
   group started through NCCL at world size 1 (a file store; its
   seconds and ``torch.cuda.nccl.version()`` logged), a 1 x 1
   ("data", "model") mesh, and per cell a captured ``TrainStep`` and a
   captured ``ShardedTrainStep`` (the state as DTensors, the batch split
   by ``batch_placements``, the step under the mesh's ``ParallelCtx``,
   its NCCL collectives in the graph) from the same host state over the
   same 3 batches, one after the other: smollm-135m at full width, 8 x
   2048, and deepseek-moe-16b at its published widths, depth 2, 4 x
   2048, with ``moe_impl="ep"`` (``moe_ep``: 64 local experts, both
   all-to-alls through NCCL, the grouped matmul forward and backward on
   the local rows); then recurrentgemma-2b (``distributed_hybrid``:
   published widths, depth 3, two RG-LRU layers and one local-attention
   layer, 1 x 4096, window 2048) and rwkv6-3b (``distributed_ssm``:
   depth 2, 1 x 4096), the scans and their reverses on each rank's
   channels / heads through ``run_local``; then whisper-medium
   (``distributed_encdec``: published widths, encoder and decoder cut to
   6 layers each, 8 x 448 tokens beside 8 x 1500 frames) and
   llava-next-mistral-7b (``distributed_vlm``: depth 2, one stream of
   1152 patches and 2,944 tokens), flash and its backward on each rank's
   heads.  Each line: ``at_start_gb``, both steps' ms and
   their ratio, build and capture seconds, pool bytes, peak memory, the
   launches (exact per direct call; the sharded steps' own, where every
   flash, grouped-matmul, RG-LRU and WKV kernel, forward and reverse,
   must be above 0 over the phase), the sharded step's collectives by
   kind (count and bytes; the EP step's all-to-alls present), and the
   final params, m, v, step and metrics bit for bit against
   ``TrainStep``'s.  Then, in the same group,
   the serving sub-phase ``distributed_serve``: the split softmax of the
   sharded decode attention (``decode_attention_pieces``, the reductions
   over the stacked pieces) against the one-piece ``decode_attention``
   at smollm's (8, 1, 9, 64) and deepseek's (8, 1, 16, 128) queries and
   a 264-slot cache cut into 4 pieces, fp32 and bf16, with rows of
   ``n_valid`` 0, rows in one piece and rows of a wrapped ring
   (``distributed_split_softmax``: the only place the card runs the
   split, as at world size 1 no sequence is split); the scans on the
   blocks a 2-rank model axis holds (``distributed_split_scans``): the
   RG-LRU forward and reverse at (1, 4096, 2560) on the two channel
   halves and the WKV forward at (1, 4096, 40, 64) on the two head
   halves, each stitched back bit for bit against the whole call, the
   WKV reverse bit for bit where ``bwd_segments`` cuts the half as the
   whole, else within ``WKV_BWD_RTOL``, both segment counts logged;
   then six cells one after the other, each freed before the next,
   smollm-135m at full width and depth, deepseek-moe-16b at full
   published width and depth with bf16 params and ``moe_impl="ep"``,
   and recurrentgemma-2b, rwkv6-3b, whisper-medium and
   llava-next-mistral-7b at full width and depth with bf16 params: the
   unsharded path (weights drawn on the card from seed 0,
   ``model.prefill_fn`` as one captured graph and a ``DecodeGraph`` over
   ``decode_step_inplace``) prefills 8 x 200 tokens into a 264-slot
   cache and takes 32 greedy steps (whisper: beside 8 x 1500 frames,
   its ring the prompt + 64 = 264 slots of a 328-slot buffer, 72 steps,
   so that every row decodes past its ring; llava: 1152 patches before
   the tokens, a 1,384-slot cache), keeps logits, tokens and the final
   cache on the host and frees its weights; then the same weights,
   drawn again, shared without a copy (at world size 1 each DTensor's
   local tensor is the card's tensor itself) by a captured
   ``ShardedPrefillStep`` and a captured ``ShardedDecodeStep``, do the
   same.  Each line (``distributed_serve_smollm``,
   ``distributed_serve_deepseek_ep``, ``distributed_serve_recurrentgemma``,
   ``distributed_serve_rwkv6``, ``distributed_serve_whisper``,
   ``distributed_serve_llava``): every logit, token and cache leaf
   (the recurrent states, the hybrid's window ring, whisper's encoder
   states, positions and rings included)
   ``torch.equal``, both paths' prefill and decode-step ms and their
   ratios, the sharded capture seconds and pool bytes, the peaks and
   ``at_start_gb``, the flash, grouped-matmul, RG-LRU and WKV launches
   (exact per direct call, each above 0 over the sub-phase; whisper's
   decode step runs flash in each decoder layer's cross-attention), one
   decode step's collectives by kind (the EP step's all-to-alls
   present), and for whisper that every row's position passed its ring.
   The group is destroyed at the end.

Every serving run goes through the executor's ``serving_params`` (the
weights cast to the compute dtype once) and runs each decode step as a
replay of a captured CUDA graph (``serve/decode_graph.py``: one graph
for the batched executor, one per batch-1 cache for the per-slot one,
its ``n_slots`` entries captured when ``make_executor`` builds it), and
each prefill as a replay of a graph captured once per prompt length
(``serve/prefill_graph.py``).  After each model's serving run the same
short request stream goes through ``decode_impl="graph"`` and
``"eager"`` executors on the same weights, and their per-request tokens
must be identical (``graph_vs_eager``); then 8 requests over three
prompt lengths go through ``prefill_impl="graph"``, ``"eager"`` and
``"graph"`` with a bound of 2 graphs, with identical tokens, one
capture per length (the bounded run evicting), one replay per prefill,
and one 200-token prefill's logits ``torch.equal`` between graph and
direct call (``prefill_graph_vs_eager``: the wall of a hit, a first
sight and an eager prefill, the graph's device time, capture seconds
and pool bytes).  The logit checks run the
kernels' compute-dtype models on the cast tree and everything else on
the raw tree, require the kernels' logits on both trees to be
bit-identical, and time a decode step and a 200-token prefill on both
(``full_model_timing``: the eager span, the device time, and for the
step the wall time of one graph replay).

Each static server run (``serve_cli_static``, ``serve_static``) decodes
with one CUDA graph captured at the full batch and replayed for every
group, and prefills each group by a replay of the graph of its shape,
which writes into the decode graph's static cache; the same requests
then go through ``decode_impl="eager"`` and ``prefill_impl="eager"`` on
the same weights, and the tokens must be identical.  Its counted
launches must be one ``per_call_launches`` prefill per direct call of
the prefill step (flash 30 / 40 / 8 / 0 / 72 / 32, ``rglru_scan`` 18,
``rwkv6_wkv`` 32) and per decode step nothing but whisper's 24 flash
cross-attentions.

The launch counters are zeroed before each serving run (before its
executor is built: the batched one captures its decode step then, the
per-slot one its entries).  They count Python calls of a wrapper, and a
replay makes none, so they must read, per direct call of the prefill
step (its warm-up and capture calls on the graph path: ``WARMUP`` + 1
for an owner's first length, 1 for each later one; every prefill on the
eager path), one flash launch per attention layer (enc-dec: one per
encoder layer and two per decoder layer, self and cross: 72), 3 x
(num_layers - first_k_dense) grouped-matmul launches (MoE only), one
RG-LRU scan per recurrent layer (hybrid) and one WKV launch per layer
(ssm), and per direct call of the decode step (likewise) num_layers
paged launches and the same grouped-matmul count on the batched path,
no launch at all on the per-slot path (its decode is plain torch, as the
reference's) but enc-dec's one flash cross-attention per decoder layer
(24), whose queries see the 1500 encoder states.  The
prefill replays must equal the prefills, the decode replays the decode
steps (batched) or the live requests summed over the steps (per-slot),
and the launches a run reports add each replay's to the counted ones.
Every serving path computes in bf16, so each of its flash and
grouped-matmul launches must also be a tensor-core one; the
fp32-compute logit checks run the CUDA-core ones.

The training runs' counters are zeroed before each run and must read,
per direct call of the train step (its 2 warm-ups and its capture, on a
cold ``AotCache`` only; a replay makes no Python call), one flash
forward per attention layer, again in remat's recompute, and one flash
backward per attention layer, for the MoE 3 grouped-matmul forwards per
MoE layer, again in remat's recompute, and 3 backward calls
(``LAUNCHES_BWD``, each dX and dW), for the hybrid one RG-LRU scan
per recurrent layer, again in remat's recompute, and one reverse scan
(``LAUNCHES_BWD``): flash 2 x 2 + 2, the scan 4 x 2 + 4 at depth 6, and
for the ssm one WKV per layer, again in remat's recompute, and one
reverse WKV (``LAUNCHES_BWD``): 8 x 2 + 8 at depth 8, for the enc-dec family one
flash forward per encoder layer and two per decoder layer (self and
cross), again in remat's recompute, and as many backwards: 72 x 2 +
72, and for the vlm 5 x 2 + 5; every flash and
grouped-matmul launch on the tensor cores; the launches a run reports
add one step's per replay, and the replays must equal the steps.

Prints one JSON line per measured case, then the kernels' summary line,
and as its last line ``{"ok": true, "device": {...}}``.  Exits non-zero,
with no result line, without a card.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from collections import OrderedDict
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.hardware import H100_SXM  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and flop/s for
# bf16 on the tensor cores (``H100_SXM``) and fp32 outside them (the
# kernels' exact fp32: 67 TFLOP/s)
HBM_BYTES_S = H100_SXM.hbm_bw
PEAK_FLOPS = {"torch.bfloat16": H100_SXM.peak_flops_bf16,
              "torch.float32": 67e12}
# the analysis phase: H100_SXM's HBM capacity may differ from the card's
# total memory by at most this share
HBM_SPEC_SHARE = 0.03
TOL = {"torch.float32": dict(atol=1e-5, rtol=1e-5),
       "torch.bfloat16": dict(atol=1.6e-2, rtol=1e-2)}
# full-model logits, bf16, kernel vs plain attention: the two attentions
# round the same fp32 values to bf16 and may differ by one ulp per
# element; through 30 layers that moves the logits (spread ~0.5 at this
# init) by at most this much
LOGIT_ATOL = 0.1
# deepseek-moe-16b: a one-ulp bf16 difference in an attention output can
# tip a token's top-6 routing, a discrete change the later layers carry
# on, so no fixed bf16 bound separates a wiring fault from rounding.  The
# kernels are held in fp32 compute (same bf16 weights) to the plain
# versions within DS_FP32_LOGIT_ATOL: ~1e-5 for the same fp32 arithmetic
# in another order through 28 layers, with room for a routing tie tipped
# at an earlier token, which reaches the last token only through
# attention.  In bf16 the kernels' logits must be as accurate as the
# plain versions': within DS_BF16_FLOOR_FACTOR times the plain bf16
# model's own distance from the fp32 plain model, measured in the same
# run (each bf16 model's distance is set by the routing its rounding
# tips, so two equally accurate ones differ by up to twice it)
DS_FP32_LOGIT_ATOL = 1e-2
DS_BF16_FLOOR_FACTOR = 2.0
# rwkv6-3b at random weights is far more sensitive to rounding than the
# others: its plain bf16 model lands ~1.8 from fp32 (deepseek ~0.3,
# recurrentgemma ~0.17), and a ~4e-6 difference between two fp32
# summation orders of the WKV grows through 32 layers to ~0.05 in the
# logits.  Its fp32 kernel logits are held to SSM_FP32_SHARE of the plain
# bf16 model's distance from fp32 (same run) where that exceeds
# DS_FP32_LOGIT_ATOL; a wiring fault moves them by the logits' spread.
# Its fp32 training gradients are held so leaf by leaf
# (``fp32_grad_limit``)
SSM_FP32_SHARE = 0.1
# the RWKV-6 WKV in fp32: its state sums hundreds of outer products
# (entries up to ~100) and the kernel sums in another order than the
# plain version's einsums, so output and state are held to 1e-4 (the CPU
# parity bound); the RG-LRU scan rounds as its plain version does (exact)
WKV_FP32_TOL = dict(atol=1e-4, rtol=1e-4)


# every line but the kernels' summary carries ``t_s``, the seconds since
# the smoke started: the phases' walls are their lines' differences
_T0 = time.perf_counter()


def log(obj) -> None:
    if "kernels" not in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean span of one eager call of ``fn`` on the device's timeline over
    ``iters`` back-to-back calls: the device time, or the host's time to
    issue the call where that is longer."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, reps: int = 20, replays: int = 10) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in a
    CUDA graph and replayed, so no host time is in the span.  The capture
    runs on the warm-up's stream, whose per-stream state (paged
    attention's tickets) the warm-up made."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):                  # warm-up outside the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


# the plain versions' timings: a few replays of two calls (each call is
# 0.05-15 ms, far above a replay's overhead)
PLAIN_REPS = dict(reps=2, replays=3)


def graph_wall_ms(torch, fn, iters: int = 20) -> float:
    """Host wall time of one step of ``fn`` through the executors'
    ``DecodeGraph``: a replay, then a synchronise, timed on the host
    clock and averaged over ``iters`` steps after the capture."""
    from repro_torch.serve.decode_graph import DecodeGraph

    dev = torch.device("cuda")
    graph = DecodeGraph(lambda bufs: fn(), {}, dev, "graph")
    graph()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        graph()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound(flops: float, nbytes: float, dtype) -> tuple:
    t_ops = flops / PEAK_FLOPS[str(dtype)]
    t_mem = nbytes / HBM_BYTES_S
    return max(t_ops, t_mem) * 1e3, "operations" if t_ops > t_mem else "bytes"


def check_close(torch, name, out, ref, tol) -> float:
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    lim = tol["atol"] + tol["rtol"] * ref.float().abs()
    if not bool(torch.all(err <= lim)) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version, max abs err {err.max().item()}")
    return err.max().item()


def run_counted(torch, mod, name, fn, counter="LAUNCHES",
                tc_counter="LAUNCHES_TC"):
    """One call of a kernel wrapper: its output (a tensor or a tuple of
    them, None where the wrapper gives none) and the instance it ran
    ("tc" or "cuda_core", read from the module's counters; kernels with
    one instance run on the CUDA cores), after a second call has given
    bit-identical output.  ``counter`` is
    the module's count of this wrapper's launches, ``tc_counter`` that of
    its tensor-core instance's."""
    n0, tc0 = getattr(mod, counter), getattr(mod, tc_counter, 0)
    out = fn()
    again = fn()
    torch.cuda.synchronize()
    if getattr(mod, counter) != n0 + 2:
        raise AssertionError(f"{name}: the kernel was not launched")
    outs, agains = ((out, again) if isinstance(out, tuple)
                    else ((out,), (again,)))
    if not all(a is b or torch.equal(a, b) for a, b in zip(outs, agains)):
        raise AssertionError(f"{name}: two calls differ")
    tc = getattr(mod, tc_counter, 0) == tc0 + 2
    return out, "tc" if tc else "cuda_core"


def launch_floor(torch):
    """The device time of the least kernel there is, one in-place add on a
    one-element tensor, replayed from a CUDA graph as the kernels are: the
    floor under every kernel line's ``kernel_ms``."""
    x = torch.zeros(1, device="cuda")
    floor_ms = graph_ms(torch, lambda: x.add_(1.0))
    log({"phase": "launch_floor", "launch_floor_ms": floor_ms})
    return floor_ms


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# llava-next-mistral-7b's prefill positions: its 1152 patches before a
# 200-token prompt
FLASH_LLAVA_SQ = 1152 + 200


def flash_cases(torch):
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    import torch.nn.functional as F

    dev = torch.device("cuda")
    rows = []
    # smollm-135m's heads (d 64, group 3), then deepseek-moe-16b's (d 128,
    # MHA), whose 160.5 KB of shared memory need the opt-in above 48 KB
    cases = [((1, 9, 3, 64), sq_w) for sq_w in
             ((1, 0), (127, 0), (129, 0), (300, 0), (300, 64))]
    cases += [((1, 16, 16, 128), sq_w) for sq_w in
              ((1, 0), (129, 0), (300, 0))]
    # granite-3-8b's heads (d 128, group 4): the continuous engine's
    # batch-1 prefills, and the static engine's batch-8 prefill of 200
    cases += [((1, 32, 8, 128), sq_w) for sq_w in
              ((1, 0), (129, 0), (300, 0))]
    cases += [((8, 32, 8, 128), (200, 0))]
    # recurrentgemma-2b's heads (d 256, MQA group 10; 64-key tiles), with
    # its 2048 window inactive at 300 tokens, and a window of 100 active
    cases += [((1, 10, 1, 256), sq_w) for sq_w in ((300, 0), (300, 100))]
    # the static engine's batch-8 prefills of 200 for smollm-135m and
    # recurrentgemma-2b (with its 2048 window, as the model passes it)
    cases += [((8, 9, 3, 64), (200, 0)), ((8, 10, 1, 256), (200, 2048))]
    # whisper-medium (d 64, MHA): the encoder over its 1500 states,
    # non-causal; cross-attention, one decode query or a 200-token prompt
    # against the 1500 states; each at batch 1 (the per-slot executor)
    # and 8 (the static server), and the static server's causal decoder
    # self-attention over 8 x 200
    cases += [((b, 16, 16, 64), (sq, 0), 1500, False)
              for b in (1, 8) for sq in (1500, 1, 200)]
    cases += [((8, 16, 16, 64), (200, 0))]
    # llava-next-mistral-7b's prefill, 1152 patches + a 200-token prompt:
    # one (the per-slot executor) and 8 (the static server)
    cases += [((b, 32, 8, 128), (FLASH_LLAVA_SQ, 0)) for b in (1, 8)]
    for dtype in (torch.float32, torch.bfloat16):
        for (b, hq, hkv, d), (sq, window), *kv in cases:
            skv, causal = kv or (sq, True)
            g = torch.Generator(device=dev).manual_seed(sq + window + d)
            # the model's (b, s, h, d) tensors, viewed as (b, h, s, d)
            q, k, v = (torch.randn((b, s, h, d), generator=g, device=dev)
                       .to(dtype).transpose(1, 2)
                       for s, h in ((sq, hq), (skv, hkv), (skv, hkv)))
            kw = dict(causal=causal, window=window)
            what = (f"flash d={d} hq={hq} hkv={hkv} sq={sq} skv={skv} "
                    f"causal={causal} w={window} {dtype}")
            out, inst = run_counted(
                torch, fa, what, lambda: fa.flash_attention(q, k, v, **kw))
            if dtype == torch.bfloat16 and inst != "tc":
                raise AssertionError(f"{what}: ran on the {inst} instance")
            ref = attention_ref(q, k, v, **kw)
            err = check_close(torch, what, out, ref, TOL[str(dtype)])
            qpos = torch.arange(sq, device=dev)[:, None]
            kpos = torch.arange(skv, device=dev)[None, :]
            mask = (kpos <= qpos if causal
                    else torch.ones((sq, skv), dtype=torch.bool, device=dev))
            if window:
                mask &= kpos > qpos - window
            pairs = int(mask.sum())
            es = q.element_size()
            nbytes = es * d * (2 * b * hq * sq + 2 * b * hkv * skv)
            flops = 4.0 * d * b * hq * pairs
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            sdpa_kw = ({"attn_mask": mask} if window
                       else {"is_causal": causal})
            rows.append({
                "kernel": "flash_attention", "dtype": str(dtype), "b": b,
                "hq": hq, "hkv": hkv, "d": d, "sq": sq, "skv": skv,
                "causal": causal, "window": window, "pairs": pairs,
                "instance": inst, "max_abs_err": err, "tol": TOL[str(dtype)],
                "kernel_ms": graph_ms(torch, lambda: fa.flash_attention(
                    q, k, v, **kw)),
                "kernel_call_ms": cuda_ms(torch, lambda: fa.flash_attention(
                    q, k, v, **kw)),
                "plain_ms": graph_ms(torch, lambda: attention_ref(
                    q, k, v, **kw), **PLAIN_REPS),
                "library_ms": graph_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q, k, v, enable_gqa=True, **sdpa_kw)),
                "bound_ms": bound_ms, "bound_by": bound_by})
            log(rows[-1])
    return rows


def paged_cases(torch):
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    dev = torch.device("cuda")
    bt = 128
    serving = [0, 1, 100, 127, 128, 129, 250, 300]
    long_ctx = [0, 1, 129, 700, 1000, 1500, 2047, 2048]
    rows = []
    # smollm-135m's heads, then deepseek-moe-16b's (d 128, group 1), at
    # the serving paths' 3 pages a row; then both at 16 pages a row, where
    # a row's pages are split over blocks and merged in the launch
    cases = ([((8, 9, 3, 64), 3, w, serving) for w in (0, 100)]
             + [((8, 16, 16, 128), 3, 0, serving)]
             # granite-3-8b's heads (d 128, group 4)
             + [((8, 32, 8, 128), 3, 0, serving)]
             + [(heads, 16, 0, long_ctx)
                for heads in ((8, 9, 3, 64), (8, 16, 16, 128))])
    for dtype in (torch.float32, torch.bfloat16):
        for (b, hq, hkv, d), nb, window, lengths in cases:
            n_pages = b * nb + 1
            g = torch.Generator(device=dev).manual_seed(7 + window + d)
            q = torch.randn((b, hq, d), generator=g, device=dev).to(dtype)
            kp, vp = (torch.randn((hkv, n_pages, bt, d), generator=g,
                                  device=dev).to(dtype) for _ in range(2))
            tables = torch.randperm(b * nb, generator=g, device=dev) \
                .reshape(b, nb).to(torch.int32)
            for r, n in enumerate(lengths):
                tables[r, -(-n // bt):] = n_pages - 1      # null-page tail
            lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
            args = (q, kp, vp, tables, lens)
            what = (f"paged d={d} hq={hq} hkv={hkv} nb={nb} w={window} "
                    f"{dtype}")
            out, _ = run_counted(torch, pa, what, lambda: pa.paged_attention(
                *args, window=window))
            ref = paged_attention_ref(*args, window=window)
            err = check_close(torch, what, out, ref, TOL[str(dtype)])
            if not bool(torch.all(out[0] == 0)):
                raise AssertionError("paged: a length-0 row is not zeros")
            keys = sum(min(n, window) if window else n for n in lengths)
            es = q.element_size()
            nbytes = (es * (2 * b * hq * d + 2 * hkv * keys * d)
                      + 4 * (tables.numel() + lens.numel()))
            flops = 4.0 * d * (hq // hkv) * hkv * keys
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            pps = pa.plan_splits(b, hkv, nb)
            rows.append({
                "kernel": "paged_attention", "dtype": str(dtype), "b": b,
                "hq": hq, "hkv": hkv, "d": d, "block_tokens": bt, "nb": nb,
                "lengths": lengths, "window": window,
                "pages_per_split": pps, "blocks": b * hkv * -(-nb // pps),
                "max_abs_err": err, "tol": TOL[str(dtype)],
                "kernel_ms": graph_ms(torch, lambda: pa.paged_attention(
                    *args, window=window)),
                "kernel_call_ms": cuda_ms(torch, lambda: pa.paged_attention(
                    *args, window=window)),
                "plain_ms": graph_ms(torch, lambda: paged_attention_ref(
                    *args, window=window), **PLAIN_REPS),
                "library_ms": None,    # no one PyTorch call takes a block table
                "bound_ms": bound_ms, "bound_by": bound_by})
            log(rows[-1])
    return rows


def routed_counts(torch, e: int, c: int, tokens: int, top_k: int, seed: int):
    """Rows per expert of a real top-k routing: ``tokens`` random router
    logits (seeded), each token's top_k experts, at most ``c`` rows each;
    an (e,) int32 CUDA tensor."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn((tokens, e), generator=g, device="cuda")
    idx = logits.topk(top_k, dim=-1).indices.reshape(-1)
    return torch.bincount(idx, minlength=e).clamp(max=c).int()


def gmm_cases(torch):
    """The experts' three products of deepseek-moe-16b: decode (8 rows x
    top-6 at the raised capacity: C = 48), the decode wi product as the
    model runs it (``counts`` from a top-6 routing of 8 tokens: only the
    experts that hold a row read their weights), prefill of a 200-token
    prompt (C = 24), and a ragged shape no tile divides."""
    from repro_torch.kernels.moe_gmm import moe_gmm as mg
    from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref

    dev = torch.device("cuda")
    shapes = [("decode_wi", 64, 48, 2048, 1408),
              ("decode_wi_routed", 64, 48, 2048, 1408),
              ("decode_wo", 64, 48, 1408, 2048),
              ("prefill_wi", 64, 24, 2048, 1408),
              ("ragged", 4, 24, 64, 44)]
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for what, e, c, k, f in shapes:
            g = torch.Generator(device=dev).manual_seed(e + c + k + f)
            x = torch.randn((e, c, k), generator=g, device=dev).to(dtype)
            w = (torch.randn((e, k, f), generator=g, device=dev)
                 * k ** -0.5).to(dtype)
            counts = None
            if what.endswith("_routed"):
                counts = routed_counts(torch, e, c, 8, 6, seed=17)
                x *= (torch.arange(c, device=dev)[None, :]
                      < counts[:, None])[..., None]
            name = f"moe_gmm {what} {dtype}"
            out, inst = run_counted(torch, mg, name,
                                    lambda: mg.moe_gmm(x, w, counts))
            err = check_close(torch, name, out, moe_gmm_ref(x, w, counts),
                              TOL[str(dtype)])
            es = x.element_size()
            nbytes = es * (e * c * k + e * k * f + e * c * f)
            flops = 2.0 * e * c * k * f
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            row = {
                "kernel": "moe_gmm", "dtype": str(dtype), "case": what,
                "e": e, "c": c, "k": k, "f": f, "instance": inst,
                "max_abs_err": err, "tol": TOL[str(dtype)],
                "kernel_ms": graph_ms(torch, lambda: mg.moe_gmm(x, w, counts)),
                "kernel_call_ms": cuda_ms(torch,
                                          lambda: mg.moe_gmm(x, w, counts)),
                "plain_ms": graph_ms(torch,
                                     lambda: moe_gmm_ref(x, w, counts),
                                     **PLAIN_REPS),
                "library_ms": graph_ms(torch, lambda: torch.bmm(x, w)),
                "bound_ms": bound_ms, "bound_by": bound_by}
            if counts is not None:
                # what this routing needs: the filled rows of x, the
                # weights of the experts that hold a row, all of out
                live = int((counts > 0).sum())
                n_rows = int(counts.sum())
                live_bytes = (es * (n_rows * k + live * k * f + e * c * f)
                              + 4 * e)
                row.update(live_experts=live, filled_rows=n_rows,
                           bound_live_ms=bound(2.0 * n_rows * k * f,
                                               live_bytes, dtype)[0])
            rows.append(row)
            log(rows[-1])
            del x, w, out
    return rows


# (b, s, w, from a nonzero state) of the RG-LRU scan's serving cases, and
# the hybrid's training shape (timed in phase 8, beside the reverse)
RGLRU_SERVE_SHAPES = ((1, 300, 2560, False), (1, 300, 2560, True),
                      (1, 2048, 2560, False), (1, 40, 2560, False),
                      (3, 37, 200, True), (4, 300, 2560, True),
                      (8, 200, 2560, False))
RGLRU_TRAIN_SHAPES = ((1, 4096, 2560, False),)


def rglru_cases(torch, floor_ms, shapes=RGLRU_SERVE_SHAPES):
    """The RG-LRU scan at ``shapes``, fp32 and bf16 (the gates are fp32
    in the model): by default recurrentgemma-2b's prefill shape, from
    zeros and from a nonzero state, at 2048 and 40 steps, a ragged shape
    no block divides, batch 4, and the static engine's batch-8 prefill of
    200 tokens; fp32 must be bit-exact against the plain version (both
    round the same two ops)."""
    from repro_torch.kernels.rglru_scan import rglru_scan as rs
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

    dev = torch.device("cuda")
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, w, with_h0 in shapes:
            g = torch.Generator(device=dev).manual_seed(s + w + with_h0)
            a = (0.85 + 0.149 * torch.rand((b, s, w), generator=g,
                                           device=dev)).to(dtype)
            x = (0.1 * torch.randn((b, s, w), generator=g,
                                   device=dev)).to(dtype)
            h0 = (torch.randn((b, w), generator=g, device=dev)
                  if with_h0 else None)
            what = f"rglru_scan {(b, s, w)} h0={with_h0} {dtype}"
            out, _ = run_counted(torch, rs, what,
                                 lambda: rs.rglru_scan(a, x, h0))
            ref = rglru_scan_ref(a, x, h0)
            err = check_close(torch, what, out, ref, TOL[str(dtype)])
            if dtype == torch.float32 and not torch.equal(out, ref):
                raise AssertionError(f"{what}: not bit-exact against the "
                                     f"plain version (max abs err {err})")
            es = a.element_size()
            nbytes = es * 3 * b * s * w + (4 * b * w if with_h0 else 0)
            bound_ms, bound_by = bound(2.0 * b * s * w, nbytes, dtype)
            kernel_ms = graph_ms(torch, lambda: rs.rglru_scan(a, x, h0))
            rows.append({
                "kernel": "rglru_scan", "dtype": str(dtype), "b": b, "s": s,
                "w": w, "h0": with_h0, "max_abs_err": err,
                "tol": TOL[str(dtype)], "kernel_ms": kernel_ms,
                "kernel_call_ms": cuda_ms(torch,
                                          lambda: rs.rglru_scan(a, x, h0)),
                "plain_ms": graph_ms(torch, lambda: rglru_scan_ref(a, x, h0),
                                     **PLAIN_REPS),
                "library_ms": None,    # no one PyTorch call scans a recurrence
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_ratio": kernel_ms / bound_ms,
                "floor_ratio": kernel_ms / floor_ms})
            log(rows[-1])
    return rows


def wkv_cases(torch):
    """The RWKV-6 WKV at rwkv6-3b's prefill shape (fp32 in the model), at
    128 tokens from a nonzero state, a small ragged one, and the static
    engine's batch-8 prefill of 200 tokens, with decays
    in [-exp(-1), -exp(-6)]; then the prefill shape at the model's full
    decay range (logw = -exp(d), d in [-20, 10], the clamp of
    ``models/rwkv.py``).  The output and the final state both against the
    plain version; two calls bit-identical."""
    from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv as wk
    from repro_torch.kernels.rwkv6_wkv.ref import rwkv6_wkv_ref

    dev = torch.device("cuda")
    decays = {"usual": (-6.0, -1.0), "full": (-20.0, 10.0)}
    shapes = [(1, 300, 40, 64, False, "usual"),
              (1, 128, 40, 64, True, "usual"),
              (2, 37, 4, 16, True, "usual"),
              (1, 300, 40, 64, False, "full"),
              (8, 200, 40, 64, False, "usual")]
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        tol = WKV_FP32_TOL if dtype == torch.float32 else TOL[str(dtype)]
        for b, s, h, n, with_s0, decay in shapes:
            g = torch.Generator(device=dev).manual_seed(s + h + n)
            # the model's (b, s, h*n) projections viewed as (b, s, h, n)
            r, k, v = ((0.5 * torch.randn((b, s, h * n), generator=g,
                                          device=dev)).to(dtype)
                       .view(b, s, h, n) for _ in range(3))
            logw = (-torch.exp(torch.empty((b, s, h, n), device=dev)
                               .uniform_(*decays[decay], generator=g))
                    ).to(dtype)
            u = 0.1 * torch.randn((h, n), generator=g, device=dev)
            s0 = (torch.randn((b, h, n, n), generator=g, device=dev)
                  if with_s0 else None)
            args = (r, k, v, logw, u, s0)
            what = (f"rwkv6_wkv {(b, s, h, n)} s0={with_s0} decay={decay} "
                    f"{dtype}")
            (o, st), _ = run_counted(torch, wk, what,
                                     lambda: wk.rwkv6_wkv(*args))
            o_ref, st_ref = rwkv6_wkv_ref(*args)
            err = check_close(torch, what, o, o_ref, tol)
            st_err = check_close(torch, what + " state", st, st_ref,
                                 WKV_FP32_TOL)
            es = r.element_size()
            nbytes = (es * 5 * b * s * h * n + 4 * h * n
                      + 4 * b * h * n * n * (2 if with_s0 else 1))
            flops = float(b * h * s * (5 * n * n + 4 * n))
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            rows.append({
                "kernel": "rwkv6_wkv", "dtype": str(dtype), "b": b, "s": s,
                "h": h, "n": n, "s0": with_s0, "decay": decay,
                "max_abs_err": err,
                "state_max_abs_err": st_err, "tol": tol,
                "kernel_ms": graph_ms(torch, lambda: wk.rwkv6_wkv(*args)),
                "kernel_call_ms": cuda_ms(torch,
                                          lambda: wk.rwkv6_wkv(*args)),
                "plain_ms": graph_ms(torch, lambda: rwkv6_wkv_ref(*args),
                                     **PLAIN_REPS),
                "library_ms": None,    # no one PyTorch call computes it
                "bound_ms": bound_ms, "bound_by": bound_by})
            log(rows[-1])
    return rows


# ---------------------------------------------------------------------------
# phases 3-5: the serving paths at full width
# ---------------------------------------------------------------------------

def _kernel_modules():
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.moe_gmm import moe_gmm as mg
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.rglru_scan import rglru_scan as rs
    from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv as wk

    return {"flash_attention": fa, "paged_attention": pa, "moe_gmm": mg,
            "rglru_scan": rs, "rwkv6_wkv": wk}


# the kernels with a tensor-core instance, which the bf16 paths must take
TC_KERNELS = ("flash_attention", "moe_gmm")


def reset_counts():
    mods = _kernel_modules()
    for mod in mods.values():
        mod.LAUNCHES = 0
    for name in TC_KERNELS:
        mods[name].LAUNCHES_TC = 0
    for name in ("flash_attention", "moe_gmm"):
        mods[name].LAUNCHES_BWD = 0
        mods[name].LAUNCHES_BWD_TC = 0
    mods["rglru_scan"].LAUNCHES_BWD = 0
    mods["rwkv6_wkv"].LAUNCHES_BWD = 0


def read_counts():
    return {name: mod.LAUNCHES for name, mod in _kernel_modules().items()}


def read_tc_counts():
    mods = _kernel_modules()
    return {name: mods[name].LAUNCHES_TC for name in TC_KERNELS}


def per_call_launches(cfg):
    """Launches of each kernel per prefill and per decode step: the
    batched paged path for dense / MoE, the per-slot path for the others
    (no kernel in its decode, but for enc-dec the flash cross-attention
    of every decoder layer; an enc-dec prefill runs flash in every
    encoder layer and twice in every decoder layer, self and cross)."""
    none = dict.fromkeys(_kernel_modules(), 0)
    if cfg.family == "encdec":
        return ({**none, "flash_attention": cfg.encoder_layers
                 + 2 * cfg.num_layers},
                {**none, "flash_attention": cfg.num_layers})
    if cfg.family == "vlm":
        return {**none, "flash_attention": cfg.num_layers}, none
    if cfg.family == "hybrid":
        n_attn = sum(cfg.is_attention_layer(i)
                     for i in range(cfg.num_layers))
        return ({**none, "flash_attention": n_attn,
                 "rglru_scan": cfg.num_layers - n_attn}, none)
    if cfg.family == "ssm":
        return {**none, "rwkv6_wkv": cfg.num_layers}, none
    n_moe = cfg.num_layers - cfg.first_k_dense if cfg.num_experts else 0
    return ({**none, "flash_attention": cfg.num_layers, "moe_gmm": 3 * n_moe},
            {**none, "paged_attention": cfg.num_layers, "moe_gmm": 3 * n_moe})


def instrument(ex):
    """Wrap ``ex``'s prefill, decode and release to record a run: the
    executor's decode seconds (its own clock), decode calls, decode
    tokens (the live requests summed over the steps), the most requests
    live in one step, the rows live at each admission and detach, and
    each prefill's input shape in order."""
    rec = {"decode_s": 0.0, "decode_calls": 0, "decode_tokens": 0,
           "peak_live": 0, "events": [], "prefill_shapes": []}
    decode, prefill, release = ex.decode, ex.prefill, ex.release

    def live():
        # rows of the batched executor, live entries of the per-slot one
        return len(ex.rows) if hasattr(ex, "rows") else len(ex._caches)

    def timed_decode(rs):
        toks, cost = decode(rs)
        rec["decode_s"] += cost
        rec["decode_calls"] += 1
        rec["decode_tokens"] += len(toks)
        rec["peak_live"] = max(rec["peak_live"], len(toks))
        return toks, cost

    def logged_prefill(rs):
        rec["events"].append(("admit", ex.decode_steps, live()))
        rec["prefill_shapes"] += [(1, len(r.prompt)) for r in rs]
        return prefill(rs)

    def logged_release(r):
        rec["events"].append(("detach", ex.decode_steps, live()))
        return release(r)

    ex.decode, ex.prefill, ex.release = (timed_decode, logged_prefill,
                                         logged_release)
    return rec


def lru_misses(shapes, bound: int):
    """(misses, evictions) of a least-recently-used cache of ``bound``
    entries over ``shapes`` in order: the captures and evictions
    ``PrefillGraphs`` must report."""
    kept, misses, evictions = OrderedDict(), 0, 0
    for shape in shapes:
        if shape in kept:
            kept.move_to_end(shape)
            continue
        misses += 1
        if len(kept) >= bound:
            kept.popitem(last=False)
            evictions += 1
        kept[shape] = None
    return misses, evictions


def check_prefill(owner, shapes, what, mode="graph"):
    """An owner's prefill graphs (``owner._prefills``), exact, for the
    prefills of ``shapes`` in order: on the graph path one capture per
    least-recently-used miss (the first after ``WARMUP`` direct calls),
    evictions as the LRU bound makes them, and one replay per prefill;
    on the eager path one direct call per prefill.  Returns the
    graphs' counts."""
    from repro_torch.step_graph import WARMUP

    p = owner.prefill_graph_stats()
    misses, evictions = lru_misses(shapes, owner._prefills.max_graphs)
    if mode == "graph":
        want = {"captures": misses, "replays": len(shapes),
                "calls": WARMUP + misses if misses else 0,
                "evictions": evictions}
        kept = misses - evictions
    else:
        want = {"captures": 0, "replays": 0, "calls": len(shapes),
                "evictions": evictions}
        kept = 0
    got = {k: p[k] for k in want}
    if got != want or owner.prefill_graph_count() != kept:
        raise AssertionError(
            f"{what}: prefill graphs {p} ({owner.prefill_graph_count()} "
            f"kept), expected {want} ({kept} kept) for {len(shapes)} "
            f"prefills of {len(set(shapes))} shapes on the {mode} path")
    return p


def check_run(cfg, ex, rec, counts, tc_counts, what, mode="graph",
              prefill_mode="graph"):
    """A serving run's launches, decode graphs and prefill graphs, exact.

    The counters count Python calls of a kernel's wrapper; a graph replay
    makes none.  So the counted launches must equal ``per_call_launches``
    per direct call of the prefill step (its warm-up and capture calls on
    the graph path, every prefill on the eager one) plus per direct call
    of the decode step (likewise), and on a bf16 path every flash and
    grouped-matmul launch must have been a tensor-core one.  On the graph
    path the batched executor holds one decode graph replayed once per
    decode step, the per-slot executor its ``n_slots`` entries, made at
    construction, replayed once per live request per step; on the eager
    path none.  The prefill graphs are held by :func:`check_prefill`.
    Returns the run's figures, with the launches the card made: the
    counted ones plus each replay's."""
    import torch

    from repro_torch.serve.decode_graph import WARMUP

    per_pre, per_dec = per_call_launches(cfg)
    g = ex.decode_graph_stats()
    p = check_prefill(ex, rec["prefill_shapes"], what, prefill_mode)
    want = {k: per_pre[k] * p["calls"] + per_dec[k] * g["calls"]
            for k in per_pre}
    if (counts != want or not ex.prefills or not ex.decode_steps
            or len(rec["prefill_shapes"]) != ex.prefills):
        raise AssertionError(
            f"{what}: kernel launches {counts}, expected {want} for "
            f"{cfg.name} ({per_pre} per call of the prefill step, "
            f"{per_dec} per call of the decode step; {ex.prefills} "
            f"prefills, {p['calls']} prefill calls, {g['calls']} step "
            f"calls)")
    if cfg.compute_dtype == torch.bfloat16:
        want_tc = {k: want[k] for k in TC_KERNELS}
        if tc_counts != want_tc:
            raise AssertionError(
                f"{what}: tensor-core launches {tc_counts}, expected every "
                f"bf16 launch {want_tc} for {cfg.name}")
    batched = hasattr(ex, "rows")
    n_graphs = ex.decode_graph_count()
    if mode == "graph":
        ok = (g["replays"] == (ex.decode_steps if batched
                               else rec["decode_tokens"])
              and n_graphs == (1 if batched else ex.n_slots)
              and g["calls"] == (WARMUP + 1) * n_graphs)
    else:
        ok = n_graphs == 0 and g["replays"] == 0
    if not ok or rec["decode_calls"] != ex.decode_steps:
        raise AssertionError(
            f"{what}: {mode} path with {n_graphs} decode graphs and {g} for "
            f"{ex.decode_steps} decode steps, {rec['decode_tokens']} "
            f"decode tokens, at most {rec['peak_live']} requests live")
    replayed = {k: per_pre[k] * p["replays"] + per_dec[k] * g["replays"]
                for k in per_pre}
    return {"mode": mode, "prefill_mode": prefill_mode,
            "decode_graphs": n_graphs,
            "replays": g["replays"], "step_calls": g["calls"],
            "capture_s": g["capture_s"],
            "graph_mem_mb": g["capture_bytes"] / 1e6,
            "prefill_graphs": {
                "captures": p["captures"], "replays": p["replays"],
                "calls": p["calls"], "evictions": p["evictions"],
                "capture_s": p["capture_s"],
                "graph_mem_mb": p["capture_bytes"] / 1e6},
            "launches": {k: counts[k] + replayed[k] for k in counts},
            "tc_launches": {k: tc_counts[k] + replayed[k]
                            for k in TC_KERNELS},
            "launches_counted": counts,
            "decode_tokens_per_s": rec["decode_tokens"] / rec["decode_s"],
            "mean_decode_step_ms": 1e3 * rec["decode_s"]
            / rec["decode_calls"]}


def serve_cli(cfg, extra=(), phase="serve_cli", max_new=64):
    """The CLI entry point, continuous engine: 16 requests of 200 tokens,
    ``max_new`` new tokens each, through 8 slots, with the flags
    ``extra``.  Checks the executor's launches and graph, the tokens and
    the decode shapes; returns the run's launches and the requests'
    submit times."""
    from repro_torch.launch import serve
    from repro_torch.serve import batched_executor

    argv = ["--requests", "16", "--batch", "8", "--prompt-len", "200",
            "--max-new", str(max_new), *extra]
    # the CLI builds its executor through make_executor and its requests
    # itself: keep a handle on both, for the graph's counts and the
    # submit times (the CLI's report carries neither)
    made, seen = [], []
    make, run_engine = (batched_executor.make_executor,
                        serve.run_continuous_server)

    def make_and_keep(*args, **kw):
        ex, kv = make(*args, **kw)
        made.append((ex, instrument(ex)))
        return ex, kv

    def run_and_keep(cfg_, reqs, *args, **kw):
        seen.append([r.t_submit for r in reqs])
        return run_engine(cfg_, reqs, *args, **kw)

    batched_executor.make_executor = make_and_keep
    serve.run_continuous_server = run_and_keep
    reset_counts()
    t0 = time.perf_counter()
    try:
        out = serve.main(argv)
    finally:
        batched_executor.make_executor = make
        serve.run_continuous_server = run_engine
    wall = time.perf_counter() - t0
    counts, tc_counts = read_counts(), read_tc_counts()
    (ex, rec), = made
    run = check_run(cfg, ex, rec, counts, tc_counts, phase)
    # the wrappers refer back to the executor: free it now, not at the
    # next collection, so the runs after this one start without it
    del ex, rec, made
    gc.collect()
    summary = out["executor"]
    if out["tokens"] != 16 * max_new or out["requests"] != 16:
        raise AssertionError(f"{phase}: {out['tokens']} tokens for "
                             f"{out['requests']} requests, expected "
                             f"{16 * max_new}/16")
    if summary["decode_shapes"] != 1:
        raise AssertionError(f"decode input shapes changed: {summary}")
    submits, = seen
    log({"phase": phase, "argv": argv, "wall_s": wall, **run,
         "executor": summary, "tokens": out["tokens"],
         "mean_ttft_s": out["ttft_s"]["mean"], "span_s": out["span"],
         "slo_goodput": out["slo_goodput"], "RG": out["goodput"]["RG"],
         "submit_offsets_s": [t - submits[0] for t in submits]})
    return run["launches"], submits


def serve_cli_arrival(cfg):
    """The CLI's continuous engine with bursty arrivals spread over 2 s of
    the serve timeline: the submit times must be the port's
    ``request_arrivals`` for the CLI's seed, offset by one base time,
    spread over more than half the span, and the report's tokens
    complete.  (At a 2 s span every profile is flat; each profile's shape
    is held against the reference's on the host.)  Returns the run's
    launches."""
    from repro_torch.fleet.scenarios import SCENARIOS, request_arrivals

    span, arrival = 2.0, "bursty"
    counts, submits = serve_cli(
        cfg, ["--span", str(span), "--arrival", arrival],
        f"serve_cli_arrival {arrival}", max_new=32)
    want = request_arrivals(16, span, seed=0,
                            arrival=SCENARIOS[arrival].arrival)
    base = submits[0] - want[0]
    if not (all(abs(t - base - a) < 1e-6 for t, a in zip(submits, want))
            and all(0.0 <= a < span for a in want)
            and max(want) - min(want) > span / 2):
        raise AssertionError(f"serve_cli_arrival {arrival}: submit "
                             f"offsets {[t - base for t in submits]}, "
                             f"expected {want}")
    return counts


def check_static(cfg, server, counts, tc_counts, what, mode, shapes):
    """A static server run's launches, decode graph and prefill graphs,
    exact: ``per_call_launches`` per direct call of the group-prefill
    step (its warm-up and capture calls on the graph path, every batch on
    the eager one; the batches' prefill ``shapes`` held by
    :func:`check_prefill`), and per direct call of the decode step
    (likewise) the grouped-matmul launches of a MoE decode step and the
    flash cross-attention of an enc-dec one, no other kernel (the rest
    of the decode is plain torch, as the reference's); on a bf16
    path every flash and grouped-matmul launch on the tensor cores.  The
    graph path captures the decode once and replays it once per decode
    step; ``mode`` is both graphs' path.  Returns the run's figures, with
    the launches the card made: the counted ones plus each replay's."""
    import torch

    from repro_torch.serve.decode_graph import WARMUP

    per_pre, per_dec = per_call_launches(cfg)
    per_step = {**dict.fromkeys(per_pre, 0), "moe_gmm": per_pre["moe_gmm"]}
    if cfg.family == "encdec":
        per_step["flash_attention"] = per_dec["flash_attention"]
    g = server.decode_graph_stats()
    p = check_prefill(server, shapes, what, mode)
    want = {k: per_pre[k] * p["calls"] + per_step[k] * g["calls"]
            for k in per_pre}
    if (counts != want or not server.batches or not server.decode_steps
            or len(shapes) != server.batches):
        raise AssertionError(
            f"{what}: kernel launches {counts}, expected {want} for "
            f"{cfg.name} ({per_pre} per call of the prefill step; "
            f"{server.batches} batches, {p['calls']} prefill calls, "
            f"{g['calls']} step calls)")
    if cfg.compute_dtype == torch.bfloat16:
        want_tc = {k: want[k] for k in TC_KERNELS}
        if tc_counts != want_tc:
            raise AssertionError(f"{what}: tensor-core launches {tc_counts}"
                                 f", expected every bf16 launch {want_tc}")
    graph = ((1, server.decode_steps, WARMUP + 1) if mode == "graph"
             else (0, 0, server.decode_steps))
    if (g["captures"], g["replays"], g["calls"]) != graph:
        raise AssertionError(f"{what}: {mode} path with {g} for "
                             f"{server.decode_steps} decode steps")
    replayed = {k: per_pre[k] * p["replays"] + per_step[k] * g["replays"]
                for k in per_pre}
    return {"mode": mode, "batches": server.batches,
            "decode_steps": server.decode_steps, "replays": g["replays"],
            "step_calls": g["calls"], "capture_s": g["capture_s"],
            "graph_mem_mb": g["capture_bytes"] / 1e6,
            "prefill_graphs": {
                "captures": p["captures"], "replays": p["replays"],
                "calls": p["calls"], "capture_s": p["capture_s"],
                "graph_mem_mb": p["capture_bytes"] / 1e6},
            "launches": {k: counts[k] + replayed[k] for k in counts},
            "tc_launches": {k: tc_counts[k] + replayed[k]
                            for k in TC_KERNELS},
            "launches_counted": counts}


def add_counts(total, counts):
    """Add a run's launches to ``total``, kernel by kernel."""
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def static_step_ms(torch, server, iters: int = 20) -> float:
    """Host wall time of one static decode step after a run: a replay of
    the server's decode graph, then a synchronise, averaged over
    ``iters`` steps (the static cache's contents are spent by then)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        server._graph()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def serve_static(torch, cfg, params, n_req=8, max_new=32, cli=False):
    """The static fixed-group server at batch 8 over ``n_req`` requests of
    200 tokens and ``max_new`` new ones: through the CLI's ``--engine
    static`` (``cli=True``: the server draws its weights from seed 0)
    or ``run_static_server`` on the weights ``params``, with the decode
    and the group prefill as CUDA graphs; then the same requests with
    ``decode_impl="eager"`` and ``prefill_impl="eager"`` on the same
    weights (for the CLI, drawn again from seed 0), whose tokens must be
    identical.  Each run's tokens must be complete and its
    launches exact (:func:`check_static`).  Logs both runs with the
    graph step's wall time; returns the graph run's launches."""
    import numpy as np

    from repro_torch.launch import serve
    from repro_torch.models.init import init_params

    batch, plen = 8, 200
    run_static = serve.run_static_server
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
               for _ in range(n_req)]
    runs, toks = {}, {}
    for mode in ("graph", "eager"):
        # submitted now, on the server's clock, as the CLI submits them
        t_submit = time.monotonic()
        reqs = [serve.Request(i, p, max_new, t_submit=t_submit)
                for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        if cli and mode == "graph":
            argv = ["--engine", "static", "--requests", str(n_req),
                    "--batch", str(batch), "--prompt-len", str(plen),
                    "--max-new", str(max_new)]
            kept = []

            def run_and_keep(cfg_, reqs_, *args, **kw):
                server_, out_ = run_static(cfg_, reqs_, *args, **kw)
                kept.append((server_, reqs_))
                return server_, out_

            serve.run_static_server = run_and_keep
            try:
                out = serve.main(argv)
            finally:
                serve.run_static_server = run_static
            (server, reqs), = kept
            del kept
            prompts = [r.prompt for r in reqs]
        else:
            if cli:
                params = init_params(
                    cfg, torch.Generator(device="cuda").manual_seed(0),
                    torch.device("cuda"))
            server, out = run_static(cfg, reqs, batch, max_new, plen,
                                     params=params, decode_impl=mode,
                                     prefill_impl=mode)
        wall = time.perf_counter() - t0
        what = f"serve_static {cfg.name} {mode}"
        run = check_static(cfg, server, read_counts(), read_tc_counts(),
                           what, mode, [(batch, plen)] * -(-n_req // batch))
        if (out["tokens_generated"] != n_req * max_new
                or out["requests"] != n_req):
            raise AssertionError(f"{what}: {out['tokens_generated']} tokens "
                                 f"for {out['requests']} requests, expected "
                                 f"{n_req * max_new}/{n_req}")
        run.update(wall_s=wall, prefill_s=out["prefill_s"],
                   decode_s=out["decode_s"],
                   throughput_tok_s=out["throughput_tok_s"],
                   mean_ttft_s=out["mean_ttft_s"], RG=out["serve_rg"],
                   decode_ms_per_step=1e3 * out["decode_s"]
                   / server.decode_steps,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        if mode == "graph":
            run["step_graph_wall_ms"] = static_step_ms(torch, server)
        runs[mode] = run
        toks[mode] = [r.out_tokens for r in reqs]
        del server, reqs
        gc.collect()
        torch.cuda.empty_cache()
    same = toks["graph"] == toks["eager"]
    log({"phase": "serve_cli_static" if cli else "serve_static",
         "arch": cfg.name, "requests": n_req, "batch": batch,
         "prompt_len": plen, "max_new": max_new, "tokens_identical": same,
         **runs})
    if not same:
        raise AssertionError(f"{cfg.name}: graph and eager static decode "
                             f"gave other tokens: {toks}")
    return runs["graph"]["launches"]


def serve_engine(torch, cfg, n_req: int, max_new_hi: int, phase: str,
                 max_len: int = 300 + 64):
    """The continuous engine over ``make_executor`` (params drawn on the
    card from seed 0, only their cast tree kept; ``peak_mem_gb`` is the
    run's peak, ``held_mem_gb`` what stays after it): ``n_req`` requests with prompts of 40-300 tokens
    and 16-``max_new_hi`` new tokens through 8 slots, so rows admit and
    detach while others decode; the executor sized for ``max_len``
    positions a request."""
    import numpy as np

    from repro_torch.models.init import init_params
    from repro_torch.serve.batched_executor import make_executor
    from repro_torch.serve.engine import (NO_SLO, ContinuousServeEngine,
                                          ServeRequest)

    rng = np.random.default_rng(0)
    n_slots = 8
    reqs = []
    for i in range(n_req):
        plen = int(rng.integers(40, 301))
        reqs.append(ServeRequest(
            rid=i, prompt_len=plen,
            max_new=int(rng.integers(16, max_new_hi + 1)),
            prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # counted from here: the batched executor captures its decode step
    # as it is built
    reset_counts()
    t0 = time.perf_counter()
    ex, kv = make_executor(cfg, max_len, n_slots)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rec = instrument(ex)
    t0 = time.perf_counter()
    rep = ContinuousServeEngine(n_slots, ex, slo=NO_SLO, kv_cache=kv).run(reqs)
    wall = time.perf_counter() - t0
    counts, tc_counts = read_counts(), read_tc_counts()
    run = check_run(cfg, ex, rec, counts, tc_counts, phase)
    want = sum(r.max_new for r in reqs)
    shapes = (ex.decode_shape_count() if hasattr(ex, "decode_shape_count")
              else 1)
    if rep.tokens != want or shapes != 1:
        raise AssertionError(f"{phase}: {rep.tokens} tokens (want {want}), "
                             f"{shapes} decode shapes")
    crossed = sum(1 for r in reqs
                  if (r.prompt_len - 1) // 128
                  != (r.prompt_len + r.max_new - 2) // 128)
    if not crossed:
        raise AssertionError(f"{phase}: no request's decode crossed a page")
    admitted_mid, detached_mid = churn(ex, rec, phase)
    log({"phase": phase, "arch": cfg.name,
         "executor": type(ex).__name__, "requests": n_req,
         "n_slots": n_slots, "max_len": max_len,
         "prompt_lens": [r.prompt_len for r in reqs],
         "max_new": [r.max_new for r in reqs], "crossed_page": crossed,
         "admitted_mid_flight": admitted_mid,
         "detached_mid_flight": detached_mid, "init_s": init_s,
         "wall_s": wall, **run, "prefills": ex.prefills,
         "decode_steps": ex.decode_steps, "tokens": rep.tokens,
         "mean_ttft_s": rep.ttft_s["mean"], "slo_goodput": rep.slo_goodput,
         "RG": rep.goodput["RG"], "preemptions": rep.preemptions,
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
         "held_mem_gb": torch.cuda.memory_allocated() / 1e9})
    # the executor drew its params and kept only their cast tree: draw
    # the raw tree again from the same seed for the logit checks (the
    # cast-vs-raw check holds the two trees to the same logits)
    raw = init_params(cfg, torch.Generator(ex.device).manual_seed(0),
                      ex.device)
    return run["launches"], raw, ex.serving_params


def churn(ex, rec, phase):
    """Admissions into a decoding batch and detaches from one with others
    left in it, counted from ``instrument``'s events; raises if either
    never happened."""
    last = ex.decode_steps
    admitted_mid = sum(1 for ev, step, live in rec["events"]
                       if ev == "admit" and step > 0 and live > 0)
    detached_mid = sum(1 for ev, step, live in rec["events"]
                       if ev == "detach" and step < last and live > 1)
    if not admitted_mid or not detached_mid:
        raise AssertionError(f"{phase}: {admitted_mid} admissions and "
                             f"{detached_mid} detaches mid-flight")
    return admitted_mid, detached_mid


def graph_vs_eager(torch, cfg, params):
    """The same short request stream (6 requests, prompts of 40-300
    tokens, 8-16 new tokens, 4 slots, so rows admit and detach while
    others decode) through ``make_executor`` with ``decode_impl="graph"``,
    then ``"eager"``, on the same weights ``params``: the per-request
    tokens must be identical.  Each path's launches and graphs are checked
    as a serving run's, and its decode tokens/s and mean executor step
    time are logged."""
    import numpy as np

    from repro_torch.serve.batched_executor import make_executor
    from repro_torch.serve.engine import (NO_SLO, ContinuousServeEngine,
                                          ServeRequest)

    rng = np.random.default_rng(5)
    shapes = [(int(rng.integers(40, 301)), int(rng.integers(8, 17)))
              for _ in range(6)]
    toks, paths = {}, {}
    for mode in ("graph", "eager"):
        reqs = [ServeRequest(rid=i, prompt_len=n, max_new=m,
                             prompt=np.random.default_rng(i).integers(
                                 0, cfg.vocab_size, n).astype(np.int32))
                for i, (n, m) in enumerate(shapes)]
        reset_counts()
        # room for the vlm's patches too, so that its ring keeps them
        ex, kv = make_executor(cfg, 300 + 16 + cfg.num_patches, 4,
                               params=params, decode_impl=mode)
        rec = instrument(ex)
        ContinuousServeEngine(4, ex, slo=NO_SLO, kv_cache=kv).run(reqs)
        run = check_run(cfg, ex, rec, read_counts(), read_tc_counts(),
                        f"graph_vs_eager {mode}", mode)
        churn(ex, rec, f"graph_vs_eager {mode}")
        paths[mode] = {k: run[k] for k in (
            "decode_graphs", "replays", "capture_s", "graph_mem_mb",
            "decode_tokens_per_s", "mean_decode_step_ms", "launches")}
        paths[mode]["decode_steps"] = ex.decode_steps
        toks[mode] = [r.out_tokens for r in reqs]
        del ex, kv
        gc.collect()
        torch.cuda.empty_cache()
    same = toks["graph"] == toks["eager"]
    log({"phase": "graph_vs_eager", "arch": cfg.name,
         "requests": [list(x) for x in shapes], "tokens_identical": same,
         **paths})
    if not same:
        raise AssertionError(f"{cfg.name}: graph and eager executors gave "
                             f"other tokens: {toks}")


# the compiled prefill's stream: 8 requests over these prompt lengths, so
# lengths repeat
PREFILL_LENS = (64, 200, 300)


def prefill_walls(ex, kv, cfg, rid: int):
    """Wall ms of single prefills through ``ex`` after its run, on the
    executor's own clock (which it reads after the tokens' read-back):
    200 tokens (a length the run prefilled: a hit on the graph path),
    then 128 (a length it did not: first sight), then 128 again (a
    hit)."""
    import numpy as np

    from repro_torch.serve.engine import ServeRequest

    rng = np.random.default_rng(rid)
    out = {}
    for key, n in (("hit_200", 200), ("first_128", 128), ("hit_128", 128)):
        r = ServeRequest(rid=rid, prompt_len=n, max_new=1,
                         prompt=rng.integers(0, cfg.vocab_size, n)
                         .astype(np.int32))
        kv.allocate(rid, n)
        _, cost = ex.prefill([r])
        ex.release(r)
        kv.free(rid)
        out[key] = 1e3 * cost
        rid += 1
    return out


def first_sight_split(torch, step, warm, bufs):
    """Where a first sight's wall time goes: ``step`` captured over
    ``bufs`` (a shape it has not run at) on a side stream that has run it
    over ``warm`` (another shape), as ``PrefillGraphs`` captures a later
    length: ms of the step's issue under capture, of ``capture_end``
    (the end of the capture and the graph's instantiation) and of the
    first replay to its end."""
    dev = torch.device("cuda")
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        step(warm)
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    gc.disable()
    try:
        with torch.cuda.stream(side):
            t0 = time.perf_counter()
            graph.capture_begin()
            step(bufs)
            t1 = time.perf_counter()
            graph.capture_end()
            t2 = time.perf_counter()
    finally:
        gc.enable()
    torch.cuda.current_stream(dev).wait_stream(side)
    t3 = time.perf_counter()
    graph.replay()
    torch.cuda.synchronize(dev)
    t4 = time.perf_counter()
    return {"capture_issue_ms": 1e3 * (t1 - t0),
            "capture_end_ms": 1e3 * (t2 - t1),
            "first_replay_ms": 1e3 * (t4 - t3)}


def prefill_logits(torch, cfg, serving, max_len: int, n: int = 200):
    """One ``n``-token prefill's logits through a ``PrefillGraphs`` of
    the model's prefill on the cast tree ``serving``, captured and
    called directly: whether they are ``torch.equal``, the graph's
    device ms by CUDA events over 10 replays, the direct call's span by
    CUDA events, and a 150-token first sight's split
    (:func:`first_sight_split`)."""
    from repro_torch.models import model
    from repro_torch.serve.prefill_graph import PrefillGraphs

    dev = torch.device("cuda")
    prefill = model.prefill_fn(cfg, max_len=max_len)
    # the stub front end's zero frames / patches, one static buffer
    frontend = model.frontend_inputs(cfg, 1, dev)

    def step(b):
        b["logits"].copy_(prefill(serving, {"tokens": b["tokens"],
                                            **frontend})[0])

    def buffers(shape):
        return {"tokens": torch.zeros(shape, dtype=torch.int64, device=dev),
                "logits": torch.zeros((shape[0], cfg.vocab_size),
                                      dtype=torch.float32, device=dev)}

    gen = torch.Generator(device=dev).manual_seed(13)
    tokens = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                           device=dev)
    logits = {}
    with torch.inference_mode():
        for impl in ("graph", "eager"):
            graphs = PrefillGraphs(step, buffers, dev, impl)
            bufs = graphs((1, n), lambda b: b["tokens"].copy_(tokens))
            logits[impl] = bufs["logits"].clone()
            if impl == "graph":
                device_ms = cuda_ms(torch, lambda: graphs(
                    (1, n), lambda b: None), 10, 2)
            del graphs
        eager_ms = cuda_ms(torch, lambda: step(bufs), 10, 2)
        fresh = buffers((1, 150))
        fresh["tokens"].copy_(tokens[:, :150])
        split = first_sight_split(torch, step, bufs, fresh)
    return {f"logits_equal_{n}": torch.equal(logits["graph"],
                                            logits["eager"]),
            f"prefill_{n}_device_ms": device_ms,
            f"prefill_{n}_eager_span_ms": eager_ms,
            "first_sight_150": split}


def prefill_graph_vs_eager(torch, cfg, params):
    """The compiled prefill against the eager one, on the weights
    ``params``: 8 requests over the prompt lengths ``PREFILL_LENS`` (so
    lengths repeat), 4-8 new tokens, 4 slots, through ``make_executor``
    with ``prefill_impl="graph"``, then ``"eager"``, then ``"graph"``
    with ``max_prefill_graphs=2`` (decode graphs in all three).  The
    tokens must be identical in all three; each run's counts are exact
    (:func:`check_run`), the graph run captures one graph per distinct
    length and evicts none, the bounded run evicts.  After the graph and
    eager runs, the wall of single prefills through their executors
    (:func:`prefill_walls`); then one 200-token prefill's logits,
    captured and called directly, must be ``torch.equal``
    (:func:`prefill_logits`, with the graph's device time, the direct
    call's span, and where a first sight's time goes)."""
    import numpy as np

    from repro_torch.models.compute_params import serving_params
    from repro_torch.serve.batched_executor import make_executor
    from repro_torch.serve.engine import (NO_SLO, ContinuousServeEngine,
                                          ServeRequest)

    rng = np.random.default_rng(7)
    lens = [PREFILL_LENS[i % len(PREFILL_LENS)] for i in range(8)]
    shapes = [(n, int(rng.integers(4, 9))) for n in lens]
    n_slots, max_len = 4, max(PREFILL_LENS) + 8 + cfg.num_patches
    runs, toks = {}, {}
    for name, impl, bound in (("graph", "graph", 32),
                              ("eager", "eager", 32),
                              ("graph_bound2", "graph", 2)):
        reqs = [ServeRequest(rid=i, prompt_len=n, max_new=m,
                             prompt=np.random.default_rng(100 + i).integers(
                                 0, cfg.vocab_size, n).astype(np.int32))
                for i, (n, m) in enumerate(shapes)]
        what = f"prefill_graph_vs_eager {cfg.name} {name}"
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        ex, kv = make_executor(cfg, max_len, n_slots, params=params,
                               prefill_impl=impl, max_prefill_graphs=bound)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        rec = instrument(ex)
        rep = ContinuousServeEngine(n_slots, ex, slo=NO_SLO,
                                    kv_cache=kv).run(reqs)
        run = check_run(cfg, ex, rec, read_counts(), read_tc_counts(), what,
                        prefill_mode=impl)
        p = run["prefill_graphs"]
        if name == "graph" and (p["captures"] != len(set(lens))
                                or p["evictions"]):
            raise AssertionError(f"{what}: {p} for lengths {lens}")
        if name == "graph_bound2" and not p["evictions"]:
            raise AssertionError(f"{what}: no eviction at a bound of 2: "
                                 f"{p}")
        runs[name] = {"init_s": init_s, "mean_ttft_s": rep.ttft_s["mean"],
                      "prefill_graphs": p, "launches": run["launches"]}
        if name != "graph_bound2":
            runs[name]["prefill_wall_ms"] = prefill_walls(
                ex, kv, cfg, len(reqs))
        toks[name] = [r.out_tokens for r in reqs]
        del ex, kv, rec
        gc.collect()
        torch.cuda.empty_cache()
    same = toks["graph"] == toks["eager"] == toks["graph_bound2"]
    serving = serving_params(cfg, params, torch.device("cuda"))
    single = prefill_logits(torch, cfg, serving, max_len)
    equal = single["logits_equal_200"]
    del serving
    gc.collect()
    torch.cuda.empty_cache()
    log({"phase": "prefill_graph_vs_eager", "arch": cfg.name,
         "prompt_lens": lens, "max_new": [m for _, m in shapes],
         "n_slots": n_slots, "tokens_identical": same, **single, **runs})
    if not same or not equal:
        raise AssertionError(f"{cfg.name}: graph and eager prefills differ "
                             f"(tokens identical {same}, logits equal "
                             f"{equal}): {toks}")


# the logits phase's page pool: 3 pages of 128 tokens per prompt row
PAGE_TOKENS, PAGES_PER_ROW = 128, 3


def _full_model_logits(torch, cfg, params, impl, prompts, tok=None):
    """Prefill logits of ``prompts`` (one per row, scattered into pages)
    and the first batched decode step's logits over those pages, with
    every kernel (impl "kernel") or every plain version ("ref").  The
    decode step feeds ``tok`` (default: the prefill's argmax) and runs at
    the executor's decode config.  Returns (prefill, decode, decode
    inputs)."""
    from repro_torch.models import model, transformer, whisper
    from repro_torch.serve.batched_executor import decode_config

    dev = torch.device("cuda")
    bt, nb = PAGE_TOKENS, PAGES_PER_ROW
    if not model.supports_paged_decode(cfg, bt * nb):
        # the per-slot path: batch-1 prefill (with the zero frames /
        # patches the executors feed; the cache long enough to keep the
        # patches, whisper's its prompt + 64 ring), then a decode step on
        # its cache
        frontend = model.frontend_inputs(cfg, 1, dev)
        max_len = bt * nb + cfg.num_patches
        pre, caches = [], []
        for p in prompts:
            batch = {"tokens": p, **frontend}
            if cfg.family == "encdec":
                logits, cache = whisper.prefill(params, batch, cfg,
                                                attn_impl=impl)
            else:
                logits, cache = transformer.prefill(
                    params, batch, cfg, max_len=max_len, attn_impl=impl,
                    gmm_impl=impl, scan_impl=impl)
            pre.append(logits[0])
            caches.append(cache)
        pre = torch.stack(pre)
        tok = pre.argmax(-1) if tok is None else tok
        step = model.decode_fn(cfg, attn_impl=impl, gmm_impl=impl)
        dec = torch.stack([step(params, tok[row:row + 1], cache)[0][0]
                           for row, cache in enumerate(caches)])
        return pre, dec, (tok, caches)
    tables = torch.arange(len(prompts) * nb, device=dev, dtype=torch.int32) \
        .reshape(len(prompts), nb)
    kp = torch.zeros(transformer.paged_kv_shape(cfg, len(prompts) * nb, bt),
                     dtype=cfg.compute_dtype, device=dev)
    vp = torch.zeros_like(kp)
    pre = []
    for row, p in enumerate(prompts):
        logits, cache = transformer.prefill(
            params, {"tokens": p}, cfg, max_len=bt * nb, attn_impl=impl,
            gmm_impl=impl)
        pos = torch.arange(p.shape[1], device=dev)
        transformer.scatter_prefill_pages(
            cache, cfg, kp, vp, tables[row].long()[pos // bt], pos % bt)
        pre.append(logits[0])
    pre = torch.stack(pre)
    tok = pre.argmax(-1) if tok is None else tok
    lengths = torch.tensor([p.shape[1] + 1 for p in prompts],
                           dtype=torch.int32, device=dev)
    cfg_dec = decode_config(cfg)
    dec, _, _ = transformer.paged_decode_step(
        params, tok, lengths, kp, vp, tables, cfg_dec, attn_impl=impl,
        gmm_impl=impl)
    return pre, dec, (tok, lengths, kp, vp, tables, cfg_dec)


def _compare_logits(torch, a, b, tol):
    """The figures of logits ``a`` against ``b``; "ok" when ``a`` is
    finite, within ``tol`` of ``b`` and of the same argmax on every row
    whose top-2 gap in ``b`` exceeds it."""
    finite = bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())
    err = (a - b).abs().max().item()
    top2 = b.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > tol
    same = a.argmax(-1) == b.argmax(-1)
    ok = finite and err <= tol and bool(same[clear].all())
    return {"ok": ok, "max_abs_err": err, "tol": tol,
                "rows_checked_argmax": int(clear.sum()),
                "argmax_agree": int(same.sum()),
                "logit_spread": b.std().item()}


def logits_kernel_vs_plain(torch, cfg, params, serving, tol):
    """The full model at full width with every kernel against every plain
    version, same weights and inputs: prefill of 8 prompts and the first
    batched decode step over their pages (4 prompts, each with its own
    first decode step, on the per-slot path), held to ``tol``.  The
    kernels' compute-dtype runs take ``serving``, the executor's cast
    tree, and their logits must be bit-identical to those of the kernels
    on the raw tree ``params`` (``cast_vs_raw_*``); every plain run and
    every fp32-compute run takes ``params``, so the plain versions are
    held apart from ``compute_params``.

    ``tol=None`` (MoE and the recurrent families) runs the comparison in
    fp32 compute too, held to ``DS_FP32_LOGIT_ATOL`` (for ssm, at least
    ``SSM_FP32_SHARE`` of the plain bf16 model's distance from fp32), and
    holds the kernels' bf16 logits to the fp32 plain ones within
    ``DS_BF16_FLOOR_FACTOR`` times the plain bf16 logits' distance from
    them.  Every comparison is logged, then a failed one raises."""
    from repro_torch.models import model, transformer

    dev = torch.device("cuda")
    paged = cfg.family in ("dense", "moe")
    lens = ([40, 77, 127, 128, 129, 200, 255, 300] if paged
            else [40, 128, 200, 300])
    g = torch.Generator(device=dev).manual_seed(11)
    prompts = [torch.randint(0, cfg.vocab_size, (1, n), generator=g,
                             device=dev) for n in lens]
    res = {}
    with torch.inference_mode():
        kern = _full_model_logits(torch, cfg, serving, "kernel", prompts)
        tok = kern[2][0]
        raw = _full_model_logits(torch, cfg, params, "kernel", prompts, tok)
        for i, name in enumerate(("prefill", "decode")):
            res[f"cast_vs_raw_{name}"] = {
                "ok": torch.equal(kern[i], raw[i]),
                "max_abs_err": (kern[i] - raw[i]).abs().max().item()}
        del raw
        plain = _full_model_logits(torch, cfg, params, "ref", prompts, tok)
        if tol is not None:
            for i, name in enumerate(("prefill", "decode")):
                res[name] = _compare_logits(torch, kern[i], plain[i], tol)
        else:
            cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
            k32 = _full_model_logits(torch, cfg32, params, "kernel", prompts,
                                     tok)
            p32 = _full_model_logits(torch, cfg32, params, "ref", prompts,
                                     tok)
            for i, name in enumerate(("prefill", "decode")):
                floor = (plain[i] - p32[i]).abs().max().item()
                tol32 = DS_FP32_LOGIT_ATOL
                if cfg.family == "ssm":
                    tol32 = max(tol32, SSM_FP32_SHARE * floor)
                res[f"{name}_fp32"] = _compare_logits(
                    torch, k32[i], p32[i], tol32)
                res[name] = _compare_logits(
                    torch, kern[i], p32[i], DS_BF16_FLOOR_FACTOR * floor)
                res[name].update(
                    plain_bf16_vs_fp32=floor,
                    kernel_vs_plain_bf16=(kern[i] - plain[i]).abs().max()
                    .item())
            del k32, p32
        # where a full-model call's time goes: its span on the device
        # timeline when issued eagerly against its device time alone
        # (CUDA-graph replay), on the raw tree (every weight cast per
        # call) and on the executor's cast tree; for the decode step also
        # the host's wall time of one replay of it as the executors
        # capture it (DecodeGraph), to the end of its work on the card
        p200 = prompts[lens.index(200)]
        frontend = model.frontend_inputs(cfg, 1, dev)
        step_name = "decode_step_w8" if paged else "decode_step_b1"
        timing = {step_name: {}, "prefill_s200": {}}
        for tree_name, tree in (("raw", params), ("cast", serving)):
            if paged:
                tok, lengths, kp, vp, tables, cfg_dec = kern[2]
                step = lambda: transformer.paged_decode_step(  # noqa: E731
                    tree, tok, lengths, kp, vp, tables, cfg_dec)
            else:   # one slot's step (the cache is rewritten in place)
                tok, caches = kern[2]
                step = lambda: model.decode_fn(cfg)(           # noqa: E731
                    tree, tok[:1], caches[0])
            pre200 = lambda: model.prefill_fn(                 # noqa: E731
                cfg, max_len=PAGE_TOKENS * PAGES_PER_ROW + cfg.num_patches)(
                tree, {"tokens": p200, **frontend})
            timing[step_name][tree_name] = {
                "eager_ms": cuda_ms(torch, step, 20),
                "device_ms": graph_ms(torch, step, 5),
                "graph_wall_ms": graph_wall_ms(torch, step)}
            # a prefill is 5-60 ms: a few calls time it
            timing["prefill_s200"][tree_name] = {
                "eager_ms": cuda_ms(torch, pre200, 5, warmup=2),
                "device_ms": graph_ms(torch, pre200, 2, replays=3)}
        if cfg.family in ("encdec", "vlm"):
            # where the cast tree's device time goes, by kernel class
            # (eager calls: the kernels a graph replay runs)
            for name, fn in ((step_name, step), ("prefill_s200", pre200)):
                timing[name]["cast"]["split"] = kernel_class_split(
                    kernel_split_ms(torch, fn))
    log({"phase": "logits_kernel_vs_plain", "arch": cfg.name,
         "prompt_lens": lens, **res})
    log({"phase": "full_model_timing", "arch": cfg.name, "prompt_lens": lens,
         **timing})
    failed = [name for name, r in res.items() if not r["ok"]]
    if failed:
        raise AssertionError(f"{cfg.name}: kernel logits off the plain "
                             f"versions' in {failed}: {res}")


# ---------------------------------------------------------------------------
# phase 6: training smollm-135m at full width
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ = 8, 2048
# the flash backward against its plain version on the same (q, k, v, o,
# lse, dO): its dq / dk / dv sum thousands of products (dk and dv over
# every query row of a group) in another order than the plain version's
# einsums, so fp32 (the CUDA-core instance) is held to 1e-4.  The bf16
# (tensor-core) instance rounds P and dS to bf16 as operands, as SDPA's
# backward does: it is held to the plain version with the same rounding
# (``operand_dtype=torch.bfloat16``), both sides' fp32 sums rounded once
# to bf16 (TOL's one ulp), and its relative distance from the fp32 plain
# backward on the same (upcast) inputs to DS_BF16_FLOOR_FACTOR times the
# rounding model's own
BWD_TOL = {"torch.float32": dict(atol=1e-4, rtol=1e-4),
           "torch.bfloat16": TOL["torch.bfloat16"]}
# the flash forward at the training shape with its LSE, against the
# plain forward's: the CUDA-core instance (fp32) sums as the plain one
# does to 1e-5; the tensor-core instance (bf16) sums the bf16-rounded P
# into l, so its LSE moves by up to log(1 + 2^-9) ~ 2e-3 (the card
# tests' bound)
LSE_TOL = {"torch.float32": dict(atol=1e-5, rtol=1e-5),
           "torch.bfloat16": dict(atol=1e-2, rtol=1e-3)}
# full-model gradients, kernel against plain attention, on the same
# weights and a batch of the path's shape.  fp32 compute: each gradient
# leaf within TRAIN_FP32_GRAD_RTOL of the plain leaf's norm and the loss
# within TRAIN_FP32_LOSS_ATOL.  The limit sits 10x above the worst leaf
# measured on the H100 (5.1e-6: the same fp32 attention in another
# summation order, carried through 30 layers and back) and far below
# the control the phase logs, the plain bf16 model's smallest per-leaf
# distance from fp32 (a backward or LSE carrying bf16 rounding lands
# near it; a wiring fault moves a leaf by its own size).  bf16 compute:
# each leaf's distance from the fp32 plain gradient within
# DS_BF16_FLOOR_FACTOR times the plain bf16 model's own distance from
# it, measured in the same run (the tensor-core forward rounds P to
# bf16, and the tensor-core backward P and dS, which the plain ones do
# not)
TRAIN_FP32_GRAD_RTOL = 5e-5
TRAIN_FP32_LOSS_ATOL = 1e-4
# 10 AdamW steps (lr 1e-3) on one fixed batch of random tokens must
# lower the loss (~log 49152 = 10.8 at init) by this many nats: the
# reference's "runs and learns" check
LEARN_MARGIN = 0.5
# a key bias (whisper's attention ``bk``) adds one value to every score
# of a query's row, which the softmax does not see: its gradient is zero
# in exact arithmetic, and each run computes rounding (the kernel's dS
# rows, rounded to bf16, sum to ~2^-9 of their size instead of 0).  So
# its gradients are not compared by direction: in every run (fp32, bf16,
# kernel, plain) its norm must stay within this share of its layer's
# query bias's, a gradient of the same shape that no cancellation
# removes (whisper-medium at 8 x 448 on the H100, the most of the four
# runs: 8.3e-4 in the encoder, 1.4e-2 in the decoder's self-attention,
# 7.2e-2 in its cross-attention; the plain fp32 model at 2 + 2 layers
# on the CPU: under 2e-6, so bf16 rounding sets the share); a row of dS that does not sum to zero (a masking or
# scaling fault) gives a key-bias gradient of the query bias's order
KEY_BIAS_GRAD_SHARE = 0.25


def _causal_mask(torch, sq: int, window: int):
    dev = torch.device("cuda")
    qpos = torch.arange(sq, device=dev)[:, None]
    kpos = torch.arange(sq, device=dev)[None, :]
    mask = kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def flash_case(case):
    """A flash training case as (name, b, hq, hkv, sq, d, window, skv,
    causal): the cases are (name, b, hq, hkv, sq, d, window), causal with
    skv = sq, or name the keys' length and the mask after them."""
    what, b, hq, hkv, sq, d, window, *rest = case
    skv, causal = rest if rest else (sq, True)
    return what, b, hq, hkv, sq, d, window, skv, causal


def _flash_mask(torch, sq: int, skv: int, window: int, causal: bool):
    """(mask, pairs, SDPA's mask arguments) of a flash case: the causal
    (and windowed) mask as a boolean (sq, sq) and its true pairs, or
    none without the causal mask (sq x skv pairs; no window there)."""
    if not causal:
        if window:
            raise ValueError("a non-causal case takes no window")
        return None, sq * skv, {}
    mask = _causal_mask(torch, sq, window)
    return (mask, int(mask.sum()),
            {"attn_mask": mask} if window else {"is_causal": True})


# the flash forward with its LSE at a training path's shape: (name, b,
# hq, hkv, sq, d, window[, skv, causal]) (``flash_case``)
FLASH_FWD_SMOLLM_CASE = ("smollm_train_lse", TRAIN_BATCH, 9, 3, TRAIN_SEQ,
                         64, 0)


def flash_train_fwd_cases(torch, cases=(FLASH_FWD_SMOLLM_CASE,),
                          expand_kv=False):
    """The flash forward at the shapes a train step gives it (``cases``:
    smollm's b 8 x 2048, hq 9 / hkv 3, d 64 by default) with its LSE,
    fp32 (the CUDA-core instance) and bf16 (the tensor-core one, as on
    the path): output and LSE against ``attention_ref(...,
    return_lse=True)``, two calls bit-identical; times of the kernel,
    the plain version and SDPA's forward (a window as a boolean mask;
    with ``expand_kv`` on k and v expanded to the query heads, else with
    ``enable_gqa``; the backend the dispatcher picks is named), and the
    bound (bytes of q, k, v read once and o, lse written once, or the
    forward's flops over the unmasked pairs)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    import torch.nn.functional as F

    dev = torch.device("cuda")
    rows = []
    for case in cases:
        what, b, hq, hkv, sq, d, window, skv, causal = flash_case(case)
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=dev).manual_seed(skv + d + 1)
            q, k, v = (torch.randn((b, n, h, d), generator=g, device=dev)
                       .to(dtype).transpose(1, 2)
                       for n, h in ((sq, hq), (skv, hkv), (skv, hkv)))
            name = f"flash {what} forward with LSE {dtype}"
            kw = {"causal": causal, "window": window}

            def call():
                return fa.flash_attention(q, k, v, return_lse=True, **kw)

            (out, lse), inst = run_counted(torch, fa, name, call)
            if inst != ("tc" if dtype == torch.bfloat16 else "cuda_core"):
                raise AssertionError(f"{name}: ran on the {inst} instance")
            ref, ref_lse = attention_ref(q, k, v, return_lse=True, **kw)
            err = check_close(torch, name, out, ref, TOL[str(dtype)])
            lse_err = check_close(torch, f"{name} lse", lse, ref_lse,
                                  LSE_TOL[str(dtype)])
            del out, lse, ref, ref_lse
            mask, pairs, sdpa_kw = _flash_mask(torch, sq, skv, window,
                                               causal)
            es = q.element_size()
            nbytes = (es * d * (2 * b * hq * sq + 2 * b * hkv * skv)
                      + 4 * b * hq * sq)
            bound_ms, bound_by = bound(4.0 * d * b * hq * pairs, nbytes,
                                       dtype)
            kv = ([t.repeat_interleave(hq // hkv, dim=1) for t in (k, v)]
                  if expand_kv else [k, v])
            if not expand_kv:
                sdpa_kw["enable_gqa"] = True
            row = {"kernel": "flash_attention", "case": what,
                   "dtype": str(dtype), "b": b, "hq": hq, "hkv": hkv,
                   "d": d, "sq": sq, "skv": skv, "causal": causal,
                   "window": window, "instance": inst,
                   "max_abs_err": err, "lse_max_abs_err": lse_err,
                   "tol": TOL[str(dtype)], "lse_tol": LSE_TOL[str(dtype)],
                   "kernel_ms": graph_ms(torch, call, reps=5),
                   "plain_ms": graph_ms(torch, lambda: attention_ref(
                       q, k, v, return_lse=True, **kw), reps=2,
                       replays=3),
                   "library_ms": graph_ms(
                       torch, lambda: F.scaled_dot_product_attention(
                           q, *kv, **sdpa_kw), reps=5),
                   "library": "SDPA forward ("
                              f"{_sdpa_backend(torch, q, *kv, **sdpa_kw)}"
                              f"{', kv expanded' if expand_kv else ''})",
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "pairs": pairs}
            rows.append(row)
            log(row)
            del q, k, v, kv, mask, sdpa_kw
            gc.collect()
            torch.cuda.empty_cache()
    return rows


# (name, b, hq, hkv, sq, d, window[, skv, causal]) (``flash_case``), all
# causal: smollm's training shape, d 128 with g 1 at 1024 tokens, a
# window, and a ragged length
FLASH_BWD_CASES = [("smollm_train", 8, 9, 3, 2048, 64, 0),
                   ("d128_g1", 2, 16, 16, 1024, 128, 0),
                   ("window", 4, 9, 3, 1024, 64, 256),
                   ("ragged", 2, 9, 3, 1000, 64, 0)]


def _sdpa_backend(torch, q, k, v, **kw) -> str:
    """The backend PyTorch's dispatcher picks for this SDPA call."""
    from torch.nn.attention import SDPBackend

    choice = getattr(torch, "_fused_sdp_choice", None)
    if choice is None:
        return "not reported by this torch"
    names = {int(b): n for n, b in SDPBackend.__members__.items()}
    return names.get(int(choice(q, k, v, **kw)), "unknown")


def kernel_split_ms(torch, fn, calls: int = 5):
    """Each kernel that ``fn`` launches, by name, over ``calls`` calls in
    a ``torch.profiler`` window (after one call outside it): its mean
    device ms a launch (``ms``) and the launches the profiler recorded a
    call (``per_call``: below 1 where it dropped some).  Empty if the
    profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:80]: {"ms": e.self_device_time_total / 1e3 / e.count,
                         "per_call": e.count / calls}
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


# kernel classes of a full-model call's profile, the first whose
# substring a kernel's name holds (lower case); the rest are "other"
KERNEL_CLASSES = (("flash", ("flash",)),
                  ("matmul", ("gemm", "gemv", "xmma", "cutlass", "cublas",
                              "wgmma", "splitk", "nvjet")),
                  ("norm", ("layer_norm", "layernorm", "rms")),
                  ("softmax_reduce", ("softmax", "reduce")),
                  ("copy_index", ("copy", "cat", "index", "gather",
                                  "scatter", "fill")),
                  ("elementwise", ("elementwise", "vectorized", "unrolled",
                                   "gelu")))


def kernel_class_split(split, top: int = 8):
    """A :func:`kernel_split_ms` profile summed by ``KERNEL_CLASSES``:
    each class's device ms a call and launches a call, the profile's
    total, and its ``top`` kernels by device ms a call."""
    classes = {}
    for name, r in split.items():
        low = name.lower()
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(k in low for k in keys)), "other")
        row = classes.setdefault(cls, {"ms": 0.0, "launches": 0.0})
        row["ms"] += r["ms"] * r["per_call"]
        row["launches"] += r["per_call"]
    heavy = sorted(split.items(), key=lambda kv: -kv[1]["ms"]
                   * kv[1]["per_call"])[:top]
    return {"total_ms": sum(c["ms"] for c in classes.values()),
            "classes": classes,
            "top": [{"kernel": n, "ms": r["ms"] * r["per_call"],
                     "per_call": r["per_call"]} for n, r in heavy]}


def flash_bwd_cases(torch, cases=FLASH_BWD_CASES, expand_kv=False,
                    ptxas_report: str = ""):
    """The flash backward against ``attention_bwd_ref`` on the same
    (q, k, v, o, lse, dO) (o and lse from the plain forward) at each of
    ``cases`` (``flash_case``: causal, or without a mask at sq != skv);
    fp32 on the CUDA cores, bf16 on the tensor cores (the
    instance read from the counters); two calls bit-identical.  bf16 is
    held to the rounding model and to DS_BF16_FLOOR_FACTOR times its
    distance from the fp32 plain backward (both distances logged).  Each
    line has the kernel's device time (bf16 lines also the same case's
    fp32 CUDA-core time, which the tensor-core one must beat), the plain
    version's, the SDPA backward's (the library call: its autograd
    backward alone, timed eagerly, a window as a boolean mask, no mask
    for a non-causal case; with
    ``expand_kv`` on k and v expanded to the query heads, else with
    ``enable_gqa``; the backend the dispatcher picks is named), and the
    bound: 2.5x the forward's matmul flops over the unmasked pairs at the
    dtype's peak, or the bytes of q, k, v, o, dO, lse read once and dq,
    dk, dv written once.  Lines at head_dim 256 also give each launch's
    device time apart (:func:`kernel_split_ms`: the D pass, dQ, dK / dV
    and the sum over the group's splits), and the bf16 one the registers
    and spills of the kernels (from ``ptxas_report``, the build's
    ``-Xptxas -v`` output for the source, when it built in this run) and
    whether the library's SASS holds ``HGMMA``."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_ref)
    import torch.nn.functional as F

    dev = torch.device("cuda")
    rows, fp32_ms = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for case in cases:
            what, b, hq, hkv, sq, d, window, skv, causal = flash_case(case)
            kw = {"causal": causal, "window": window}
            g = torch.Generator(device=dev).manual_seed(skv + d + window)
            q, k, v, do = (torch.randn((b, n, h, d), generator=g,
                                       device=dev).to(dtype).transpose(1, 2)
                           for n, h in ((sq, hq), (skv, hkv), (skv, hkv),
                                        (sq, hq)))
            o, lse = attention_ref(q, k, v, return_lse=True, **kw)
            args = (q, k, v, o, lse, do)
            name = f"flash_bwd {what} {dtype}"
            out, inst = run_counted(
                torch, fa, name,
                lambda: fa.flash_attention_bwd(*args, **kw),
                counter="LAUNCHES_BWD", tc_counter="LAUNCHES_BWD_TC")
            if inst != ("tc" if bf16 else "cuda_core"):
                raise AssertionError(f"{name}: ran on the {inst} instance")
            ref = attention_bwd_ref(*args, **kw, operand_dtype=(
                torch.bfloat16 if bf16 else None))
            errs = {gn: check_close(torch, f"{name} {gn}", a, r,
                                    BWD_TOL[str(dtype)])
                    for gn, a, r in zip(("dq", "dk", "dv"), out, ref)}
            dists = {}
            if bf16:
                # distances from the fp32 plain backward on the same inputs
                exact = attention_bwd_ref(*(t.float() for t in args), **kw)
                for gn, a, r, x in zip(("dq", "dk", "dv"), out, ref, exact):
                    dists[gn] = {"kernel": _rel_dist(torch, a, x),
                                 "model": _rel_dist(torch, r, x)}
                    if dists[gn]["kernel"] > (DS_BF16_FLOOR_FACTOR
                                              * dists[gn]["model"]):
                        raise AssertionError(
                            f"{name} {gn}: {dists[gn]['kernel']} from the "
                            f"fp32 backward, over {DS_BF16_FLOOR_FACTOR}x "
                            f"the rounding model's {dists[gn]['model']}")
                del exact
            del out, ref
            mask, pairs, sdpa_kw = _flash_mask(torch, sq, skv, window,
                                               causal)
            es = q.element_size()
            nbytes = (es * d * (3 * b * hq * sq + 2 * b * hkv * skv)
                      + 4 * b * hq * sq
                      + es * d * (b * hq * sq + 2 * b * hkv * skv))
            flops = 2.5 * 4.0 * d * b * hq * pairs
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            if expand_kv:
                kv = [t.repeat_interleave(hq // hkv, dim=1) for t in (k, v)]
            else:
                kv = [k, v]
                sdpa_kw["enable_gqa"] = True
            leaves = [t.detach().requires_grad_() for t in (q, *kv)]
            backend = _sdpa_backend(torch, *leaves, **sdpa_kw)
            so = F.scaled_dot_product_attention(*leaves, **sdpa_kw)
            big = b * hq * sq * skv >= 2 ** 28
            row = {
                "kernel": "flash_attention_bwd", "case": what,
                "dtype": str(dtype), "b": b, "hq": hq, "hkv": hkv, "d": d,
                "sq": sq, "skv": skv, "causal": causal, "window": window,
                "instance": inst,
                "max_abs_err": max(errs.values()), "errs": errs,
                "tol": BWD_TOL[str(dtype)],
                "kernel_ms": graph_ms(torch, lambda: fa.flash_attention_bwd(
                    *args, **kw), reps=5 if big else 20),
                "kernel_call_ms": cuda_ms(
                    torch, lambda: fa.flash_attention_bwd(
                        *args, **kw), 10 if big else 50),
                "plain_ms": graph_ms(torch, lambda: attention_bwd_ref(
                    *args, **kw), **PLAIN_REPS),
                "library_ms": cuda_ms(torch, lambda: torch.autograd.grad(
                    so, leaves, do, retain_graph=True), 10, 2),
                "library": f"SDPA backward ({backend}"
                           f"{', kv expanded' if expand_kv else ''})",
                "bound_ms": bound_ms, "bound_by": bound_by,
                "pairs": pairs, "flops": flops}
            row["tflops"] = flops / row["kernel_ms"] / 1e9
            if d == 256:
                row["launch_ms"] = kernel_split_ms(
                    torch, lambda: fa.flash_attention_bwd(*args, **kw))
            if bf16 and d == 256:
                from repro_torch.kernels import _build

                row["ptxas"] = ptxas_entries(ptxas_report, "flash_bwd")
                row["sass_hgmma"] = sass_has(
                    _build._artifact("flash_attention_bwd"), "HGMMA")
            if bf16:
                row["rel_dist_fp32"] = dists
                row["fp32_cuda_core_ms"] = fp32_ms[what]
                if row["kernel_ms"] >= fp32_ms[what]:
                    raise AssertionError(
                        f"{name}: the tensor-core instance takes "
                        f"{row['kernel_ms']} ms, the CUDA-core one "
                        f"{fp32_ms[what]} in fp32")
            else:
                fp32_ms[what] = row["kernel_ms"]
            rows.append(row)
            log(row)
            del so, leaves, kv, args, o, lse, q, k, v, do, mask, sdpa_kw
            gc.collect()
            torch.cuda.empty_cache()
    return rows


def _rel_dist(torch, a, b) -> float:
    """||a - b|| / ||b|| in fp32 (0 for two zero leaves)."""
    a, b = a.float(), b.float()
    nb = torch.linalg.vector_norm(b).item()
    return torch.linalg.vector_norm(a - b).item() / max(nb, 1e-30)


def fp32_grad_limit(cfg, floor: float) -> float:
    """The fp32 kernel-vs-plain limit of one gradient leaf whose plain
    bf16 gradient lies ``floor`` (relative) from the plain fp32 one:
    TRAIN_FP32_GRAD_RTOL, and for the ssm the larger of that and
    SSM_FP32_SHARE x floor.  rwkv6-3b multiplies rounding far more than
    the others (the module note; at the first token its state is zero,
    the WKV output is the bonus term alone and the per-head group norm's
    variance drops toward its eps, so its backward multiplies the
    rounding of its input by up to ~260): two fp32 summation orders of
    the WKV then differ by far more than 5e-5 in a leaf.  The same
    amplification carries bf16's rounding (2^-9 a value against fp32's
    2^-24) into ``floor``, so an fp32 difference that is rounding sits
    orders of magnitude below a tenth of it, while a wiring fault moves a
    leaf by its own size, above the floor."""
    if cfg.family != "ssm":
        return TRAIN_FP32_GRAD_RTOL
    return max(TRAIN_FP32_GRAD_RTOL, SSM_FP32_SHARE * floor)


def _record_routing(store):
    """Make the port's router keep each call's expert ids (the device
    tensor it returns) in ``store``; returns the function that undoes
    it."""
    from repro_torch.models import moe

    real = moe.router_topk

    def router(x2d, router_w, cfg):
        out = real(x2d, router_w, cfg)
        store.append(out[1])
        return out

    moe.router_topk = router
    return lambda: setattr(moe, "router_topk", real)


def train_grads_kernel_vs_plain(torch, cfg, batch_size=TRAIN_BATCH,
                                seq=TRAIN_SEQ, must_move=()):
    """One loss and gradient of the full-width model (random weights
    from seed 0, one DataPipeline batch of ``batch_size`` x ``seq``
    tokens) with the kernels (attention, the experts' grouped matmul for
    a MoE and the RG-LRU scan for a hybrid, forward and backward) and
    with their plain versions, through the train step's mixed-precision
    ``value_and_grad``: fp32 compute held leaf by leaf to the plain
    gradients, bf16 compute held to the plain bf16 model's own distance
    from the fp32 plain gradients (the module note).  No leaf's kernel
    gradient may be all zero where the plain one is not, and every leaf
    whose name ends in one of ``must_move`` must have a nonzero gradient
    in every run (a kernel output without a gradient would leave the
    leaves behind it at zero).  For a MoE the two fp32 runs must route
    every token alike first (each MoE layer's expert ids, recorded from
    the router): a near-tie tipped by the kernels' summation order would
    show as such, not as a gradient off.  For the ssm the drawn decay_b
    is made nonzero first (``give_decay_lora_work``), and its fp32 leaves
    are held to SSM_FP32_SHARE of their plain bf16 distance where that
    exceeds TRAIN_FP32_GRAD_RTOL (``fp32_grad_limit``).  The batch is
    ``train_batches``'s (frames or patches beside the tokens for the
    enc-dec and vlm families); a key bias (whisper's ``bk``) is held by
    KEY_BIAS_GRAD_SHARE instead, in every run."""
    from repro_torch.launch.strategy import value_and_grad
    from repro_torch.models.init import init_params
    from repro_torch.tree import flatten

    dev = torch.device("cuda")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    if cfg.family == "ssm":
        give_decay_lora_work(torch, params)
    batch = {k: t.to(dev) for k, t in train_batches(
        torch, cfg, batch_size, seq, 5)[0].items()}
    names = flatten(_leaf_names(params))[0]
    res, routes = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        c = dataclasses.replace(cfg, compute_dtype=dt)
        for impl in ("ref", "kernel"):
            routes[(dt, impl)] = []
            undo = _record_routing(routes[(dt, impl)])
            try:
                t0 = time.perf_counter()
                loss, metrics, grads = value_and_grad(c, impl, impl, impl)(
                    params, batch)
                torch.cuda.synchronize()
            finally:
                undo()
            res[(dt, impl)] = (float(loss), flatten(grads)[0],
                               time.perf_counter() - t0,
                               float(metrics["aux"]) if "aux" in metrics
                               else None)
    f32, b16 = torch.float32, torch.bfloat16
    # each MoE layer's ids from the forward (remat's recompute repeats them)
    n_moe = (cfg.num_layers - cfg.first_k_dense) if cfg.num_experts else 0
    tipped = [int((a != b).any(dim=-1).sum()) for a, b in zip(
        routes[(f32, "kernel")][:n_moe], routes[(f32, "ref")][:n_moe])]
    worst32, worst32_share, worst16, control = 0.0, 0.0, 0.0, float("inf")
    worst32_leaf = None
    failed, still, key_bias = [], [], {}
    for i, name in enumerate(names):
        if name.endswith(".bk"):
            # zero in exact arithmetic: held by its size, not its direction
            j = names.index(name[:-2] + "bq")
            norm = torch.linalg.vector_norm
            key_bias[name] = max(
                norm(v[1][i].float()).item()
                / max(norm(v[1][j].float()).item(), 1e-30)
                for v in res.values())
            continue
        moved = {key: bool(v[1][i].any()) for key, v in res.items()}
        if ((moved[(f32, "ref")] and not moved[(f32, "kernel")])
                or (moved[(b16, "ref")] and not moved[(b16, "kernel")])
                or (name.endswith(must_move) and not all(moved.values()))):
            still.append(name)
        p32 = res[(f32, "ref")][1][i]
        d32 = _rel_dist(torch, res[(f32, "kernel")][1][i], p32)
        floor = _rel_dist(torch, res[(b16, "ref")][1][i], p32)
        d16 = _rel_dist(torch, res[(b16, "kernel")][1][i], p32)
        if d32 >= worst32:
            worst32, worst32_leaf = d32, name
        worst32_share = max(worst32_share, d32 / max(floor, 1e-30))
        worst16 = max(worst16, d16 / max(floor, 1e-30))
        control = min(control, floor)
        if (d32 > fp32_grad_limit(cfg, floor)
                or d16 > DS_BF16_FLOOR_FACTOR * floor):
            failed.append((name, d32, d16, floor))
    loss_err = abs(res[(f32, "kernel")][0] - res[(f32, "ref")][0])
    log({"phase": "train_grads_kernel_vs_plain", "arch": cfg.name,
         "num_layers": cfg.num_layers, "batch": [batch_size, seq],
         "leaves": len(names),
         "loss": {f"{str(dt)}_{impl}": v[0] for (dt, impl), v in res.items()},
         "aux": {f"{str(dt)}_{impl}": v[3] for (dt, impl), v in res.items()},
         "seconds": {f"{str(dt)}_{impl}": v[2]
                     for (dt, impl), v in res.items()},
         "fp32_tokens_routed_apart": tipped,
         "key_bias_grad_share_of_bq": key_bias,
         "key_bias_share_limit": KEY_BIAS_GRAD_SHARE,
         "leaves_that_must_move": sum(n.endswith(must_move) for n in names)
         if must_move else 0,
         "leaves_without_gradient": still,
         "fp32_loss_abs_err": loss_err,
         "fp32_worst_leaf_rel": worst32, "fp32_worst_leaf": worst32_leaf,
         "fp32_rtol": TRAIN_FP32_GRAD_RTOL,
         "fp32_worst_leaf_share_of_bf16_floor": worst32_share,
         "fp32_share": SSM_FP32_SHARE if cfg.family == "ssm" else None,
         "bf16_floor_min_leaf_rel": control,
         "bf16_worst_leaf_ratio": worst16,
         "bf16_factor": DS_BF16_FLOOR_FACTOR})
    del res, routes, params, batch
    if any(v > KEY_BIAS_GRAD_SHARE for v in key_bias.values()):
        raise AssertionError(f"{cfg.name}: key-bias gradients, zero but "
                             f"for rounding, reach {key_bias} of their "
                             f"query bias's (limit {KEY_BIAS_GRAD_SHARE})")
    if still:
        raise AssertionError(f"{cfg.name}: leaves without a gradient (all "
                             f"zero with the kernels, or where they must "
                             f"move): {still}")
    if any(tipped):
        raise AssertionError(f"{cfg.name}: the fp32 kernel and plain runs "
                             f"route {tipped} tokens apart (per MoE layer): "
                             f"a near-tie between two experts")
    if control <= TRAIN_FP32_GRAD_RTOL:
        raise AssertionError(f"{cfg.name}: the plain bf16 gradients lie "
                             f"within {control} of fp32, under the fp32 "
                             f"limit {TRAIN_FP32_GRAD_RTOL}: the limit "
                             f"cannot tell bf16 rounding from fp32")
    if failed or loss_err > TRAIN_FP32_LOSS_ATOL:
        raise AssertionError(f"{cfg.name}: kernel gradients off the plain "
                             f"ones (leaf, fp32 rel, bf16 rel, bf16 floor): "
                             f"{failed}; fp32 loss err {loss_err}")


def _leaf_names(tree, prefix=""):
    """The tree with each leaf replaced by its dotted key path."""
    return {k: _leaf_names(v, f"{prefix}{k}.") if isinstance(v, dict)
            else prefix + k for k, v in tree.items()}


def train_counts_per_call(cfg):
    """Kernel launches of one train step, by layer kind: one flash
    forward per attention layer, again under remat's recompute, and one
    flash backward per attention layer; 3 grouped-matmul forwards per
    MoE layer (again under remat) and 3 backward calls (dX and dW each);
    one RG-LRU scan per recurrent layer of a hybrid (again under remat)
    and one reverse scan; one WKV per RWKV-6 layer (again under remat)
    and one reverse WKV."""
    n_fwd = 1 + int(cfg.remat)
    n_attn = n_attention_layers(cfg)
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    n_scan = cfg.num_layers - n_attn if cfg.family == "hybrid" else 0
    n_wkv = cfg.num_layers if cfg.family == "ssm" else 0
    return {"flash_attention": n_attn * n_fwd,
            "flash_attention_bwd": n_attn,
            "moe_gmm": 3 * n_moe * n_fwd, "moe_gmm_bwd": 3 * n_moe,
            "rglru_scan": n_scan * n_fwd, "rglru_scan_bwd": n_scan,
            "rwkv6_wkv": n_wkv * n_fwd, "rwkv6_wkv_bwd": n_wkv}


def n_attention_layers(cfg) -> int:
    """Attention calls a training forward makes (``is_attention_layer``
    names every layer of a non-hybrid one; the ssm has none; enc-dec:
    each encoder layer's, and each decoder layer's self and cross
    attention)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.num_layers
    return sum(cfg.is_attention_layer(i) for i in range(cfg.num_layers))


def check_train_counts(cfg, what, calls: int, replays: int):
    """The launches counted since ``reset_counts``, which must be
    ``train_counts_per_call``'s times ``calls``, the direct calls of the
    train step (its warm-ups and capture on the graph path; a replay
    launches from no Python call), every forward and every backward of
    the kernels with two instances on the tensor cores (the runs compute
    in bf16).  Returns the launches the run made: ``calls`` plus
    ``replays`` times one step's."""
    mods = _kernel_modules()
    counts, tc = {}, {}
    for name in ("flash_attention", "moe_gmm"):
        mod = mods[name]
        counts[name], tc[name] = mod.LAUNCHES, mod.LAUNCHES_TC
        counts[name + "_bwd"] = mod.LAUNCHES_BWD
        tc[name + "_bwd"] = mod.LAUNCHES_BWD_TC
    for name in ("rglru_scan", "rwkv6_wkv"):
        counts[name] = mods[name].LAUNCHES
        counts[name + "_bwd"] = mods[name].LAUNCHES_BWD
    per = train_counts_per_call(cfg)
    want = {k: n * calls for k, n in per.items()}
    if counts != want or any(tc[k] != counts[k] for k in tc):
        raise AssertionError(
            f"{what}: launches {counts} ({tc} on the tensor cores), "
            f"expected {want} for {calls} direct calls of the step, every "
            f"bf16 launch on the tensor cores")
    return {k: n * (calls + replays) for k, n in per.items()}


def train_head(torch, cfg):
    """The logits head at the training shape (the loss's 8 x 2047
    positions, d 576, smollm-135m's tied 49152-row table as a transposed
    bf16 view, random values): the port's form (``HeadFn``: bf16 x bf16
    -> fp32, ``aten::mm.dtype``) against the fp32 form it replaced (both
    operands cast up, one fp32 GEMM), which it must match within fp32
    summation-order error (``d x 2^-24 x (|x| @ |w|)`` per element).
    Logs the ms of the forward in both forms and of the fp32 GEMM alone
    (operands cast beforehand, as the serving tree held them), of the
    backward's two fp32 GEMMs (``head_backward``), and their bounds."""
    from repro_torch.models.layers import HeadFn, head_backward

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    n, d, v = TRAIN_BATCH * (TRAIN_SEQ - 1), cfg.d_model, cfg.vocab_size
    x = torch.randn((n, d), generator=g, device=dev).bfloat16()
    w = (0.02 * torch.randn((v, d), generator=g, device=dev)).bfloat16().T
    with torch.no_grad():
        new = HeadFn.apply(x, w)
        old = torch.mm(x.float(), w.float())
        err = (new - old).abs()
        ok = bool((err <= d * 2.0 ** -24 * torch.mm(
            x.float().abs(), w.float().abs())).all())
        max_err = err.max().item()
        del new, old, err
        x32, w32 = x.float(), w.float()
        cot = torch.randn((n, v), generator=g, device=dev)
        ms = {"new": lambda: HeadFn.apply(x, w),
              "old": lambda: torch.mm(x.float(), w.float()),
              "old_gemm": lambda: torch.mm(x32, w32),
              "backward": lambda: head_backward(cot, x, w)}
        ms = {k: cuda_ms(torch, f, iters=10, warmup=2) for k, f in ms.items()}
        del x32, w32, cot
    flops = 2.0 * n * d * v
    out_bytes = 4.0 * n * v
    b_new = bound(flops, 2.0 * (n * d + d * v) + out_bytes, torch.bfloat16)
    b_old = bound(flops, 4.0 * (n * d + d * v) + out_bytes, torch.float32)
    # the cotangent and both operands read, both gradients written (bf16)
    b_bwd = bound(2 * flops, out_bytes + 4.0 * (n * d + d * v),
                  torch.float32)
    log({"phase": "train_head", "n": n, "d": d, "v": v,
         "new_form": "bf16 x bf16 -> fp32 (aten::mm.dtype)",
         "old_form": "fp32 x fp32 of the operands cast up",
         "within_fp32_sum_error": ok, "max_abs_err": max_err,
         "new_ms": ms["new"], "new_bound_ms": b_new[0],
         "new_bound_by": b_new[1], "old_ms": ms["old"],
         "old_gemm_ms": ms["old_gemm"], "old_bound_ms": b_old[0],
         "backward_fp32_ms": ms["backward"], "backward_bound_ms": b_bwd[0],
         "backward_bound_by": b_bwd[1]})
    if not ok:
        raise AssertionError(f"head: the bf16 form is {max_err} off the "
                             f"fp32 form, beyond fp32 summation error")


def _layer_chip_time(orc, phase):
    by_layer = orc.ledger.segment_phase_chip_time("layer")
    return {layer: v[phase.value] for layer, v in by_layer.items()
            if phase.value in v}


def _train_step_ms(torch, step, batch, n: int):
    """Host wall ms of ``n`` steps of ``step`` on ``batch``, each read
    back as the orchestrator reads it (``float(loss)``), and the
    losses."""
    walls, losses = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        losses.append(float(step(batch)["loss"]))
        walls.append(1e3 * (time.perf_counter() - t0))
    return walls, losses


def _profile_steps(torch, step, batch, n: int = 2):
    """Kernel time by name over ``n`` steps of ``step`` in a
    ``torch.profiler`` window, and the window's wall seconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            m = step(batch)
        float(m["loss"])
        span = time.perf_counter() - t0
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA], span


def train_runs(torch, cfg):
    """The training path at full width (batch 8 x 2048, bf16 compute,
    fp32 master params, random weights from seed 0), every step a replay
    of the captured ``TrainStep``: (a) the CLI entry point, 2 steps; (b)
    an ``Orchestrator`` run of 20 steps with a checkpoint every 10,
    preempted at step 15, then a second one on the same directory and
    the same ``AotCache`` (the same captured step, its restored state
    loaded into it) that resumes at step 10 and ends at 20; (c)
    ``train_graph_vs_eager``: a captured and a direct-call ``TrainStep``
    from the same state over the same batches, bit-identical state and
    metrics after every step; (d) 10 captured steps on one fixed batch,
    whose loss must fall, and 5 direct-call ones that must give the same
    losses; (e) the device busy share of both steps from a profile of 2
    steps each.  Checks the emissions, the launches and the losses;
    reports step time, tokens/s, MFU, peak memory, capture seconds and
    bytes, checkpoint seconds, compile seconds and RG.  Returns the
    launches of (a) and (b), replays counted, and the measured step
    (``measured_step``: the orchestrator's steady steps)."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.core.goodput import (Layer, Phase, compute_goodput,
                                          rg_breakdown)
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch import train
    from repro_torch.launch.strategy import TrainStep, init_train_state
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.compile_cache import AotCache
    from repro_torch.runtime.orchestrator import Orchestrator, RunConfig
    from repro_torch.tree import flatten

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    launches = {"flash_attention": 0, "flash_attention_bwd": 0}

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    class KeptOrchestrator(Orchestrator):
        """The CLI's orchestrator, kept for its step's counts."""
        made = []

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.made.append(self)

    try:
        # (a) the CLI
        reset_counts()
        argv = ["--steps", "2", "--batch", str(TRAIN_BATCH), "--seq",
                str(TRAIN_SEQ), "--checkpoint-every", "2", "--ckpt-dir",
                str(tmp / "cli")]
        train.Orchestrator = KeptOrchestrator
        try:
            out = train.main(argv)
        finally:
            train.Orchestrator = Orchestrator
        torch.cuda.synchronize()
        g = KeptOrchestrator.made[0].train_step.graph
        if (g.mode, g.replays) != ("graph", 2):
            raise AssertionError(f"train CLI: step {g.mode}, {g.replays} "
                                 f"replays for 2 steps")
        add(check_train_counts(cfg, "train CLI", g.calls, g.replays))
        if out["steps"] != [0, 2] or not np.isfinite(out["final_loss"]):
            raise AssertionError(f"train CLI: {out}")
        log({"phase": "train_cli", "argv": argv, **out})
        del g, KeptOrchestrator.made[:]
        shutil.rmtree(tmp / "cli")

        # (b) preempted run, then the resume, one AotCache
        aot = AotCache()
        base = dict(steps=20, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                    checkpoint_every=10, ckpt_dir=str(tmp / "orc"), keep=2,
                    device="cuda", job_id="train-smollm-135m")
        runs, seen = [], (0, 0)
        for label, extra in (("preempted", {"preempt_at_step": 15}),
                             ("resumed", {})):
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            orc = Orchestrator(cfg, RunConfig(**base, **extra), aot=aot)
            t0 = time.perf_counter()
            res = orc.run()
            wall = time.perf_counter() - t0
            peak = (torch.cuda.max_memory_allocated() / 1e9,
                    torch.cuda.max_memory_reserved() / 1e9)
            g = orc.train_step.graph
            calls, replays = g.calls - seen[0], g.replays - seen[1]
            seen = (g.calls, g.replays)
            if g.mode != "graph" or replays != len(res["losses"]):
                raise AssertionError(f"train {label}: step {g.mode}, "
                                     f"{replays} replays for "
                                     f"{len(res['losses'])} steps")
            add(check_train_counts(cfg, f"train {label}", calls, replays))
            runs.append((label, orc, res, wall, peak))
        (_, orc1, out1, wall1, peak1), (_, orc2, out2, wall2, peak2) = runs
        if orc2.train_step is not orc1.train_step:
            raise AssertionError("train: the resumed run did not reuse the "
                                 "captured step of its AotCache")
        if not (out1["preempted"] and out1["end_step"] == 15
                and len(out1["losses"]) == 15 and out2["start_step"] == 10
                and out2["end_step"] == 20 and not out2["preempted"]
                and len(out2["losses"]) == 10):
            raise AssertionError(f"train runs: preempted {out1}, resumed "
                                 f"{out2}")
        losses = out1["losses"] + out2["losses"]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"train runs: losses {losses}")
        for orc, n_step, n_ckpt in ((orc1, 15, 1), (orc2, 10, 1)):
            ivs = orc.intervals
            got = (sum(i.phase == Phase.STEP for i in ivs),
                   sum(i.phase == Phase.CHECKPOINT for i in ivs))
            if got != (n_step, n_ckpt):
                raise AssertionError(f"train: {got} STEP / CHECKPOINT "
                                     f"intervals, expected {(n_step, n_ckpt)}")
        lost1 = _layer_chip_time(orc1, Phase.LOST)
        init1 = _layer_chip_time(orc1, Phase.INIT)
        init2 = _layer_chip_time(orc2, Phase.INIT)
        if not (lost1.get(Layer.SCHEDULING.value, 0.0) > 0
                and set(lost1) == {Layer.SCHEDULING.value}
                and init1.get(Layer.COMPILER.value, 0.0) > 0
                and Layer.COMPILER.value not in init2
                and not _layer_chip_time(orc2, Phase.LOST)):
            raise AssertionError(f"train emissions: LOST {lost1}, INIT "
                                 f"cold {init1}, warm {init2}")
        # steady steps: all but each run's first
        steady = orc1.step_times[1:] + orc2.step_times[1:]
        step_s = float(np.mean(steady))
        tokens = TRAIN_BATCH * TRAIN_SEQ
        n_params = cfg.num_params()
        pairs = TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
        attn_flops = (12.0 * cfg.num_layers * TRAIN_BATCH * cfg.num_heads
                      * cfg.head_dim * pairs)
        model_flops = 6.0 * n_params * tokens + attn_flops
        mfu_formula = ("(6 N tokens + 12 L b hq d s(s+1)/2) / "
                       "(step_s x 989e12); remat's forward not counted")
        measured = measured_step("train_orchestrator", cfg, TRAIN_BATCH,
                                 TRAIN_SEQ, step_s, model_flops, mfu_formula)
        ivs = orc1.intervals + orc2.intervals
        rep = compute_goodput(ivs, sum(i.chip_time for i in ivs))
        ck = [o.ckpt.metrics for o in (orc1, orc2)]
        n_saves = sum(m["n_saves"] for m in ck)
        g = orc1.train_step.graph
        log({"phase": "train_orchestrator", "arch": cfg.name,
             "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
             "step_impl": g.mode,
             "steps": [[out1["start_step"], out1["end_step"]],
                       [out2["start_step"], out2["end_step"]]],
             "losses": losses, "wall_s": [wall1, wall2],
             "step_ms": 1e3 * step_s,
             "step_ms_all": [1e3 * t for t in orc1.step_times
                             + orc2.step_times],
             "tokens_per_s": tokens / step_s,
             "model_flops_per_step": model_flops,
             "mfu": measured["mfu"], "mfu_formula": mfu_formula,
             "n_params": n_params,
             "peak_mem_gb": [peak1[0], peak2[0]],
             "peak_reserved_gb": [peak1[1], peak2[1]],
             "capture_s": g.capture_s, "capture_gb": g.capture_bytes / 1e9,
             "step_calls": g.calls, "step_replays": g.replays,
             "ckpt_write_s_per_save": sum(m["write_s"] for m in ck)
             / n_saves,
             "ckpt_pause_s_per_save": sum(m["device_pause_s"] for m in ck)
             / n_saves, "ckpt_saves": n_saves,
             "compile_s": out1["compile_s"],
             "compile_s_warm": out2["compile_s"],
             "RG": rep.rg, "rg_breakdown": rg_breakdown(ivs),
             "RG_per_run": [compute_goodput(
                 o.intervals, sum(i.chip_time for i in o.intervals)).rg
                 for o in (orc1, orc2)],
             "data": out2["data"], "restore": out2["restore"]})
        del orc1, orc2, runs, aot, orc, g
        gc.collect()
        torch.cuda.empty_cache()

        # (c) graph vs eager on the same state and batches
        opt = AdamWConfig(lr=1e-3)
        s0 = init_train_state(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        # device memory each step took at most above what was allocated
        # before it: the graph's in its warm-ups and capture, the eager
        # one's in its warm-up and the 3 steps below
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        graph = TrainStep(cfg, opt, s0, TRAIN_BATCH, TRAIN_SEQ, "graph")
        extra_gb = {"graph": (torch.cuda.max_memory_allocated() - base) / 1e9}
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        eager = TrainStep(cfg, opt, s0, TRAIN_BATCH, TRAIN_SEQ, "eager")
        names = flatten(_leaf_names(graph.state))[0]
        pipe = DataPipeline(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=7)
        differ, compared = [], []
        for i in range(3):
            batch = {k: torch.from_numpy(a) for k, a in next(pipe).items()}
            mg, me = graph(batch), eager(batch)
            torch.cuda.synchronize()
            differ += [f"step {i} metric {k}" for k in mg
                       if not torch.equal(mg[k], me[k])]
            differ += [f"step {i} {n}" for n, a, b in zip(
                names, flatten(graph.state)[0], flatten(eager.state)[0])
                if not torch.equal(a, b)]
            compared.append(float(mg["loss"]))
        extra_gb["eager"] = (torch.cuda.max_memory_allocated() - base) / 1e9
        log({"phase": "train_graph_vs_eager", "steps": 3,
             "leaves": len(names), "losses": compared,
             "identical": not differ, "differ": differ[:20],
             "peak_above_base_gb": extra_gb,
             "capture_s": graph.graph.capture_s,
             "capture_gb": graph.graph.capture_bytes / 1e9})
        if differ:
            raise AssertionError(f"train graph vs eager: {len(differ)} "
                                 f"leaves or metrics differ: {differ[:20]}")

        # (d) one fixed batch: the loss must fall; the direct-call step
        # must give the same losses
        batch = {k: torch.from_numpy(a) for k, a in next(DataPipeline(
            cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=123)).items()}
        graph.load_state(s0)
        eager.load_state(s0)
        walls, fixed = _train_step_ms(torch, graph, batch, 10)
        walls_e, fixed_e = _train_step_ms(torch, eager, batch, 5)
        log({"phase": "train_fixed_batch", "losses": fixed,
             "drop": fixed[0] - fixed[-1], "margin": LEARN_MARGIN,
             "step_ms": walls, "eager_losses": fixed_e,
             "eager_step_ms": walls_e})
        if not (all(np.isfinite(fixed))
                and fixed[-1] < fixed[0] - LEARN_MARGIN):
            raise AssertionError(f"fixed batch: losses {fixed} did not "
                                 f"fall by {LEARN_MARGIN}")
        if fixed_e != fixed[:5]:
            raise AssertionError(f"fixed batch: eager losses {fixed_e} are "
                                 f"not the graph's {fixed[:5]}")

        # (e) device busy share of each step: its kernel time in a profile
        # of 2 steps over the wall time of an unprofiled step (the last 5
        # fixed-batch steps; the profiler's own host cost stretches the
        # profiled steps' wall, also reported), and for the graph the
        # device span of one replay by CUDA events
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.graph()
        end.record()
        torch.cuda.synchronize()
        replay_ms = start.elapsed_time(end)
        prof = {}
        for name, step, unprofiled in (("graph", graph, walls[5:]),
                                       ("eager", eager, walls_e[1:])):
            kernels, span = _profile_steps(torch, step, batch)
            dev_us = sum(e.self_device_time_total for e in kernels)
            wall = float(np.mean(unprofiled)) / 1e3
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)
            prof[name] = {
                "wall_s": span, "device_s": dev_us / 1e6,
                "unprofiled_step_s": wall,
                "device_busy_share": dev_us / 2e6 / wall if dev_us else None,
                "device_busy_share_profiled": (dev_us / 1e6 / span
                                               if dev_us else None),
                "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3
                                   for e in top[:12]},
                # the backward's two kernels, ms a step each
                "flash_bwd_ms_per_step": {
                    e.key[:60]: e.self_device_time_total / 2e3
                    for e in kernels if "flash_bwd" in e.key}}
        prof["graph"]["replay_device_ms"] = replay_ms
        prof["graph"]["replay_busy_share"] = (
            replay_ms / 1e3 / prof["graph"]["unprofiled_step_s"])
        log({"phase": "train_profile", "steps": 2, **prof})
        del graph, eager, s0, batch
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, measured


# ---------------------------------------------------------------------------
# phase 7: training deepseek-moe-16b at its published widths, depth 2
# ---------------------------------------------------------------------------

# 4 x 2048 = 8,192 tokens: capacity 960 rows per expert
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 4, 2048
MOE_TRAIN_LAYERS = 2                    # the dense first layer and one MoE


def _gmm_bwd_bound(torch, x, w, counts):
    """Bound of one ``moe_gmm_bwd`` call on these inputs: dX's and dW's
    flops over the rows the counts hold, against the bytes of those rows
    of x and dy, the weights of the experts that hold a row (read once)
    and all of dx and dw (written once)."""
    e, c, k = x.shape
    f = w.shape[2]
    es = x.element_size()
    if counts is None:
        n_rows, live = e * c, e
    else:
        n_rows, live = int(counts.sum()), int((counts > 0).sum())
    flops = 4.0 * n_rows * k * f
    nbytes = (es * (n_rows * (k + f) + live * k * f + e * c * k + e * k * f)
              + (0 if counts is None else 4 * e))
    return bound(flops, nbytes, x.dtype), flops, n_rows, live


def ptxas_entries(report: str, fragment: str):
    """Registers and spill bytes of each kernel whose mangled name holds
    ``fragment``, from one source's ``-Xptxas -v`` report: ``{name:
    {"registers", "spill_stores", "spill_loads"}}``, or None where the
    report is empty (the library was built before this run)."""
    if not report:
        return None
    out, cur = {}, None
    for ln in report.splitlines():
        if "Compiling entry function '" in ln:
            name = ln.split("'")[1]
            cur = out.setdefault(name, {}) if fragment in name else None
        elif cur is not None and "spill stores" in ln:
            nums = [int(t) for t in ln.replace(",", " ").split()
                    if t.isdigit()]
            cur["spill_stores"], cur["spill_loads"] = nums[1], nums[2]
        elif cur is not None and "Used" in ln and "registers" in ln:
            words = ln.split()
            cur["registers"] = int(words[words.index("registers,") - 1])
    return out


def sass_has(lib: Path, opcode: str):
    """Whether ``cuobjdump -sass`` of a built library shows ``opcode``
    (e.g. Hopper's ``HGMMA``); None where the toolkit has no cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    return opcode in sass


class ClockSampler:
    """The card's SM clock (MHz), power draw (W) and active clock-event
    (throttle) reasons, sampled every ``period_ms`` by ``nvidia-smi -lms``
    while the ``with`` block runs; ``summary()`` gives the clock's least,
    median and most, the most power drawn, the reason masks seen and the
    number of samples (None when the block ended before the first
    sample).  The sampler is stopped when the block ends."""

    QUERY = "clocks.sm,power.draw,clocks_throttle_reasons.active"

    def __init__(self, period_ms: int = 100):
        self.period_ms = period_ms
        self.samples = []

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", f"--query-gpu={self.QUERY}",
             "--format=csv,noheader,nounits", "-lms", str(self.period_ms)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        for ln in out.splitlines():
            parts = [t.strip() for t in ln.split(",")]
            try:
                self.samples.append((float(parts[0]), float(parts[1]),
                                     parts[2]))
            except (IndexError, ValueError):
                continue                # a line cut by the terminate
        return False

    def summary(self):
        if not self.samples:
            return None
        mhz = sorted(c for c, _, _ in self.samples)
        return {"sm_mhz_min": mhz[0], "sm_mhz_median": mhz[len(mhz) // 2],
                "sm_mhz_max": mhz[-1],
                "power_w_max": max(w for _, w, _ in self.samples),
                "reasons": sorted({r for _, _, r in self.samples}),
                "samples": len(self.samples)}


# the tensor-core backward built for one product alone (its source's
# REPRO_GMM_BWD_PARTS: 1 walks dX's tiles, 2 dW's), to time the two apart
GMM_BWD_PARTS = {"dx": 1, "dw": 2}


def start_gmm_bwd_part_builds():
    """Start ``nvcc`` on ``moe_gmm_bwd.cu`` once for each product alone,
    with the package's flags plus ``-DREPRO_GMM_BWD_PARTS``, into
    ``build/moe_gmm_bwd_parts/``: timing builds for phase 7(a), beside
    the package's build and not part of it.  Returns ``{part: (process,
    library)}`` for :func:`gmm_bwd_part_entries`."""
    from repro_torch.kernels import _build

    out = _build.BUILD_DIR.parent / "moe_gmm_bwd_parts"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for part, bits in GMM_BWD_PARTS.items():
        lib = out / f"moe_gmm_bwd_{part}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS,
               f"-DREPRO_GMM_BWD_PARTS={bits}", "-I", str(_build.CSRC),
               "-o", str(lib), str(_build.CSRC / "moe_gmm_bwd.cu")]
        procs[part] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), lib)
    return procs


def gmm_bwd_part_entries(procs):
    """Wait for :func:`start_gmm_bwd_part_builds`' compilers; raise if one
    failed.  Returns ``{part: the library's repro_moe_gmm_bwd_tc}``, with
    the wrapper's argument types."""
    import ctypes

    from repro_torch.kernels.moe_gmm import moe_gmm as mg

    fns, failed = {}, []
    for part, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {part} (nvcc exit {proc.returncode}) ---\n"
                          f"{out}")
            continue
        fn = ctypes.CDLL(str(lib)).repro_moe_gmm_bwd_tc
        fn.argtypes, fn.restype = mg._ARGS_BWD_TC, ctypes.c_int
        fns[part] = fn
    if failed:
        raise RuntimeError("moe_gmm_bwd timing build failed:\n"
                           + "\n".join(failed))
    return fns


def gmm_bwd_fp64(torch, x, w, dy, counts):
    """dx and dw of ``moe_gmm_bwd`` summed in fp64 from the same inputs,
    and for each element the worst-case error of an fp32 sum of the same
    n products in any order, gamma_n sum_i |a_i b_i| with gamma_n =
    n u / (1 - n u), u = 2^-24 (Higham, Accuracy and Stability of
    Numerical Algorithms, eq. 3.5): n = F for dX, the expert's live rows
    for dW.  Returns (dx, dw, dx bound, dw bound)."""
    e, c, k = x.shape
    f = w.shape[2]
    live = torch.arange(c, device=x.device)[None, :] < counts[:, None]
    xd, wd = x.double(), w.double()
    dyd = dy.double() * live[..., None]
    u = 2.0 ** -24
    n_dw = counts.clamp(max=c).double()[:, None, None]
    return (torch.einsum("ecf,ekf->eck", dyd, wd),
            torch.einsum("eck,ecf->ekf", xd, dyd),
            f * u / (1 - f * u) * torch.einsum("ecf,ekf->eck", dyd.abs(),
                                               wd.abs()),
            n_dw * u / (1 - n_dw * u) * torch.einsum(
                "eck,ecf->ekf", xd.abs(), dyd.abs()))


def gmm_bwd_sum_order(torch):
    """The fp32 CUDA-core backward at (E 1, C 300, K 128, F 264, counts
    [250]), with the inputs the card tests draw for this edge case (the
    same seed and draws): for each product, the elements where the
    kernel and the plain version (cuBLAS, its own order) differ by more
    than the fp32 tests' allowance against the plain version (1e-5 +
    1e-5 |plain|), and the one where the difference is the largest
    share of that allowance, with both values, the fp64 sum of the same
    products and the worst-case error of an fp32 sum there
    (``gmm_bwd_fp64``).  Both must lie within that bound of the fp64 sum
    at every element; the line is logged."""
    import numpy as np

    from repro_torch.kernels.moe_gmm import moe_gmm as mg
    from repro_torch.kernels.moe_gmm.ref import moe_gmm_bwd_ref

    dev = torch.device("cuda")
    e, c, k, f = 1, 300, 128, 264
    g = torch.Generator(device=dev).manual_seed(e + c + k + f)
    x = torch.randn((e, c, k), generator=g, device=dev)
    w = torch.randn((e, k, f), generator=g, device=dev) * k ** -0.5
    dy = torch.randn((e, c, f), generator=g, device=dev)
    counts = torch.tensor([250], dtype=torch.int32, device=dev)
    got = mg.moe_gmm_bwd(x, w, dy, counts)
    plain = moe_gmm_bwd_ref(x, w, dy, counts)
    d64 = gmm_bwd_fp64(torch, x, w, dy, counts)
    row = {"kernel": "moe_gmm_bwd", "case": "fp32_sum_order",
           "dtype": str(torch.float32), "e": e, "c": c, "k": k, "f": f,
           "counts": [250]}
    for i, what in enumerate(("dx", "dw")):
        kern, pl, ref, bnd = got[i], plain[i], d64[i], d64[2 + i]
        share = (kern - pl).abs() / (1e-5 + 1e-5 * pl.abs())
        j = int(share.argmax())
        at = [t.reshape(-1)[j].item() for t in (kern, pl, ref, bnd)]
        ratio = {name: float(((t.double() - ref).abs() / bnd.clamp_min(
                     1e-300)).max()) for name, t in (("kernel", kern),
                                                     ("plain", pl))}
        row[what] = {"n": f if what == "dx" else 250,
                     "index": [int(t) for t in np.unravel_index(
                         j, tuple(kern.shape))],
                     "kernel": at[0], "plain": at[1], "fp64": at[2],
                     "kernel_minus_plain": at[0] - at[1],
                     "test_allowance": 1e-5 + 1e-5 * abs(at[1]),
                     "over_allowance": int((share > 1).sum()),
                     "elements": kern.numel(),
                     "gamma_n_bound": at[3],
                     "max_err_over_bound": ratio}
        if max(ratio.values()) > 1:
            log(row)
            raise AssertionError(f"moe_gmm_bwd fp32 {what}: off the fp64 "
                                 f"sum by more than gamma_n: {ratio}")
    log(row)
    return row


def gmm_bwd_cases(torch, part_fns, ptxas_report: str = ""):
    """The grouped matmul's backward (``moe_gmm_bwd``: dX and dW in one
    call) against ``moe_gmm_bwd_ref`` on the same inputs, at the training
    shapes of deepseek-moe-16b (C = 960, the wi / wg product (2048,
    1408) and the wo product (1408, 2048)) with the row counts of a real
    top-6 routing of 8,192 tokens, and a ragged case (C = 200, experts
    with no row, rows past the counts holding values that must add
    nothing); fp32 on the CUDA cores, bf16 on the tensor cores; two calls
    bit-identical.  Each line: the call's device time (graph replays),
    dX's and dW's shares of it (fp32: a profile of its two kernels; bf16:
    the one persistent kernel built for dX's tiles alone and for dW's
    alone, ``part_fns`` from :func:`gmm_bwd_part_entries`, whose outputs
    must equal the full call's bit for bit), the plain version's time,
    the library calls' (``torch.bmm(dy, w^T)`` for dX, ``torch.bmm(x^T,
    dy)`` for dW, and their sum), the bound of the rows the counts hold
    and the card's clocks while they were timed (:class:`ClockSampler`);
    the instance's design, its registers and spills from ``ptxas_report``
    (the build's ``-Xptxas -v`` report of ``moe_gmm_bwd.cu``, None if it
    was built before this run) and whether the library's SASS holds
    ``HGMMA`` (None without cuobjdump).  Then the fp32 sum-order case
    (:func:`gmm_bwd_sum_order`) and the forward ``moe_gmm`` at the wi
    shape, C = 960 (first timed there), against the plain version,
    ``torch.bmm`` and its bound.  Returns (backward lines, forward
    lines)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    from repro_torch.kernels import _ctypes as C
    from repro_torch.kernels.moe_gmm import moe_gmm as mg
    from repro_torch.kernels.moe_gmm.ref import moe_gmm_bwd_ref, moe_gmm_ref

    dev = torch.device("cuda")
    hgmma = sass_has(_build._artifact("moe_gmm_bwd"), "HGMMA")
    if hgmma is False:
        raise AssertionError("moe_gmm_bwd: the built library's SASS holds no "
                             "HGMMA (wgmma) instruction")
    design = {"tc": "wgmma+tma", "cuda_core": "cuda-core fma"}
    regs = {inst: ptxas_entries(ptxas_report, frag) for inst, frag in
            (("tc", "gmm_bwd_tc"), ("cuda_core", "gmm_bwd_cc"))}
    tokens = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ
    shapes = [("train_wi", 64, 960, 2048, 1408),
              ("train_wo", 64, 960, 1408, 2048),
              ("ragged", 8, 200, 256, 136)]
    rows, fwd_rows = [], []
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for what, e, c, k, f in shapes:
            g = torch.Generator(device=dev).manual_seed(e + c + k + f)
            x = torch.randn((e, c, k), generator=g, device=dev).to(dtype)
            w = (torch.randn((e, k, f), generator=g, device=dev)
                 * k ** -0.5).to(dtype)
            dy = torch.randn((e, c, f), generator=g, device=dev).to(dtype)
            if what == "ragged":
                counts = torch.tensor([0, 200, 37, 1, 0, 150, 199, 64],
                                      dtype=torch.int32, device=dev)
            else:
                counts = routed_counts(torch, e, c, tokens, 6, seed=23)
                # the model's buffers: rows past the counts are zeros
                live_rows = torch.arange(c, device=dev)[None, :] < counts[
                    :, None]
                x *= live_rows[..., None]
            name = f"moe_gmm_bwd {what} {dtype}"

            def call():
                return mg.moe_gmm_bwd(x, w, dy, counts)

            (dx, dw), inst = run_counted(torch, mg, name, call,
                                         counter="LAUNCHES_BWD",
                                         tc_counter="LAUNCHES_BWD_TC")
            if inst != ("tc" if bf16 else "cuda_core"):
                raise AssertionError(f"{name}: ran on the {inst} instance")
            rdx, rdw = moe_gmm_bwd_ref(x, w, dy, counts)
            errs = {"dx": check_close(torch, f"{name} dx", dx, rdx,
                                      TOL[str(dtype)]),
                    "dw": check_close(torch, f"{name} dw", dw, rdw,
                                      TOL[str(dtype)])}
            past = (torch.arange(c, device=dev)[None, :]
                    >= counts[:, None])[..., None]
            if bool((dx.masked_select(past) != 0).any()):
                raise AssertionError(f"{name}: dx rows past the counts are "
                                     f"not zero")
            if bf16:
                alone = (torch.empty_like(dx), torch.empty_like(dw))

                def part_call(fn):
                    rc = fn(x.data_ptr(), w.data_ptr(), dy.data_ptr(),
                            alone[0].data_ptr(), alone[1].data_ptr(),
                            counts.data_ptr(), e, c, k, f, C.stream_of(x))
                    C.check("moe_gmm_bwd", rc)

                parts = {part: (lambda fn=fn: part_call(fn))
                         for part, fn in part_fns.items()}
                for part in parts.values():
                    part()
                if not (torch.equal(alone[0], dx)
                        and torch.equal(alone[1], dw)):
                    raise AssertionError(f"{name}: dX or dW alone differs "
                                         f"from the full call")
            del dx, dw, rdx, rdw
            (bound_ms, bound_by), flops, n_rows, live = _gmm_bwd_bound(
                torch, x, w, counts)
            big = not bf16 and what != "ragged"
            reps = dict(reps=2, replays=3) if big else {}
            with ClockSampler() as clocks:
                kernel_ms = graph_ms(torch, call, **reps)
                if bf16:
                    split = {part: graph_ms(torch, fn)
                             for part, fn in parts.items()}
                else:
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        for _ in range(3):
                            call()
                        torch.cuda.synchronize()
                    split = {ev.key[:60]: ev.self_device_time_total / 3e3
                             for ev in prof.key_averages()
                             if ev.device_type == DeviceType.CUDA
                             and "gmm_bwd" in ev.key}
                lib = {"dx": graph_ms(torch, lambda: torch.bmm(
                           dy, w.transpose(1, 2)), **reps),
                       "dw": graph_ms(torch, lambda: torch.bmm(
                           x.transpose(1, 2), dy), **reps)}
            row = {"kernel": "moe_gmm_bwd", "case": what,
                   "dtype": str(dtype), "e": e, "c": c, "k": k, "f": f,
                   "filled_rows": n_rows, "live_experts": live,
                   "instance": inst, "max_abs_err": max(errs.values()),
                   "errs": errs, "tol": TOL[str(dtype)],
                   "kernel_ms": kernel_ms, "kernel_split_ms": split,
                   "plain_ms": graph_ms(torch, lambda: moe_gmm_bwd_ref(
                       x, w, dy, counts), **PLAIN_REPS),
                   "library_ms": lib["dx"] + lib["dw"],
                   "library_dx_ms": lib["dx"], "library_dw_ms": lib["dw"],
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "share_of_bound": bound_ms / kernel_ms,
                   "flops": flops, "tflops": flops / kernel_ms / 1e9,
                   "design": design[inst], "sass_hgmma": hgmma,
                   "ptxas": regs[inst], "clocks": clocks.summary()}
            rows.append(row)
            log(row)
            if what == "ragged" and not bf16:
                gmm_bwd_sum_order(torch)
            if what == "train_wi" and bf16:
                # the forward at the training capacity, as the model runs it
                fname = f"moe_gmm {what}_forward {dtype}"

                def fcall():
                    return mg.moe_gmm(x, w, counts)

                out, finst = run_counted(torch, mg, fname, fcall)
                err = check_close(torch, fname, out,
                                  moe_gmm_ref(x, w, counts), TOL[str(dtype)])
                es = x.element_size()
                fb = bound(2.0 * n_rows * k * f,
                           es * (n_rows * k + live * k * f + e * c * f)
                           + 4 * e, dtype)
                frow = {"kernel": "moe_gmm", "case": f"{what}_forward",
                        "dtype": str(dtype), "e": e, "c": c, "k": k, "f": f,
                        "filled_rows": n_rows, "live_experts": live,
                        "instance": finst, "max_abs_err": err,
                        "tol": TOL[str(dtype)], "kernel_ms": graph_ms(
                            torch, fcall),
                        "plain_ms": graph_ms(torch, lambda: moe_gmm_ref(
                            x, w, counts), **PLAIN_REPS),
                        "library_ms": graph_ms(torch,
                                               lambda: torch.bmm(x, w)),
                        "bound_ms": fb[0], "bound_by": fb[1]}
                fwd_rows.append(frow)
                log(frow)
                del out
            del x, w, dy, counts
            gc.collect()
            torch.cuda.empty_cache()
    return rows, fwd_rows


def train_batches(torch, cfg, b: int, s: int, seed: int, n: int = 1):
    """``n`` host batches of the training shape ``input_specs`` gives for
    b x s (s the positions the stack runs): tokens from a
    ``DataPipeline`` seeded with ``seed`` (the vlm's s - num_patches of
    them), and for the enc-dec family ``frames`` (b, 1500, d), for the
    vlm ``patches`` (b, num_patches, d), drawn in bf16 from a normal on a
    generator seeded with ``seed``: rows that differ (zero frames would
    give every row of the encoder the same states)."""
    from repro_torch.data.pipeline import DataPipeline

    stub = {"encdec": ("frames", cfg.encoder_positions),
            "vlm": ("patches", cfg.num_patches)}.get(cfg.family)
    pipe = DataPipeline(cfg.vocab_size, b,
                        s - cfg.num_patches if cfg.family == "vlm" else s,
                        seed=seed)
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        batch = {k: torch.from_numpy(a) for k, a in next(pipe).items()}
        if stub:
            batch[stub[0]] = torch.randn((b, stub[1], cfg.d_model),
                                         generator=gen).to(torch.bfloat16)
        out.append(batch)
    return out


def train_model_flops(cfg, b: int, s: int):
    """(model flops of one train step at b x s, the formula): 6 N tokens
    (N the active parameters) and 12 b hq d over the attention's pairs
    per attention layer (causal, and windowed where the config has a
    window); for the enc-dec family each part at its own length, T the
    encoder's 1500 positions: 6 (N_enc b T + N_dec b s + N_xkv b T + V d
    b (s - 1)) + 12 b hq d (L_enc T^2 + L_dec s (s + 1) / 2 + L_dec s T),
    N_enc the encoder's parameters, N_xkv the cross-attention's key and
    value projections, N_dec the decoder's others but the embeddings, V d
    the tied head.  Remat's recompute is not counted."""
    from repro_torch.models.init import param_specs

    attn = 12.0 * b * cfg.num_heads * cfg.head_dim
    if cfg.family != "encdec":
        pairs = _visible_pairs(s, cfg.attention_window)
        return (6.0 * cfg.num_active_params() * b * s
                + attn * n_attention_layers(cfg) * pairs,
                "(6 N_active tokens + 12 L_attn b hq d pairs) / (step_s x "
                "989e12), pairs the causal (and windowed) visible pairs; "
                "remat's forward not counted")
    t = cfg.encoder_positions
    part = {"enc": 0, "xkv": 0, "embed": 0, "dec": 0}
    for name, spec in param_specs(cfg).items():
        key = ("enc" if name.startswith(("enc_blocks.", "final_norm_enc"))
               else "xkv" if name.startswith("dec_blocks.xattn.")
               and name.rsplit(".", 1)[1] in ("wk", "wv", "bk", "bv")
               else "embed" if name.startswith("embed.") else "dec")
        part[key] += math.prod(spec.shape)
    flops = (6.0 * (part["enc"] * b * t + part["dec"] * b * s
                    + part["xkv"] * b * t
                    + cfg.vocab_size * cfg.d_model * b * (s - 1))
             + attn * (cfg.encoder_layers * t * t
                       + cfg.num_layers * s * (s + 1) // 2
                       + cfg.num_layers * s * t))
    return flops, ("(6 (N_enc b T + N_dec b s + N_xkv b T + V d b (s-1)) + "
                   "12 b hq d (L_enc T^2 + L_dec s(s+1)/2 + L_dec s T)) / "
                   f"(step_s x 989e12), T {t}, N_enc {part['enc']}, N_dec "
                   f"{part['dec']} (no embeddings), N_xkv {part['xkv']}; "
                   "remat's forward not counted")


def _host(tree):
    """A copy of a tree of device tensors on the host."""
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.detach().cpu(), tree)


def _visible_pairs(s: int, window: int) -> int:
    """(query, key) pairs a causal attention over ``s`` tokens computes,
    with keys older than ``window`` masked (0: no window)."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def train_cut_runs(torch, cfg, b: int, s: int, phase: str):
    """A training path at full published width with its depth cut to
    ``cfg.num_layers`` (batch b x s, s the positions the stack runs,
    bf16 compute, fp32 master params, random weights from seed 0, the
    initial state held on the host so that the card holds only the
    step's own; batches from ``train_batches``, with the enc-dec
    family's frames or the vlm's patches): (a) a captured
    ``TrainStep``, 10 steps on one fixed batch, whose loss must fall by
    LEARN_MARGIN (for a MoE with a finite aux above 0 at every step):
    step ms (mean of the steady steps), tokens/s, MFU
    (``train_model_flops``: by active parameters for a MoE; attention
    over the pairs its mask leaves; the enc-dec family part by part),
    peak memory, capture seconds and pool bytes, the card's clocks, and
    a 2-step profile for the device busy share and the top kernels
    (line ``phase``); (b) ``<phase>_graph_vs_eager``: a captured and a
    direct-call step from the same state over the same 3 batches, one
    after the other (two steps do not fit the card at once), the
    first's metrics and final state held on the host: bit-identical
    params, m, v, step and metrics.  Launches counted exactly, per
    direct call, those of the kernels with two instances all on the
    tensor cores.  Returns the launches made, replays counted, and the
    measured step (``measured_step``)."""
    import numpy as np

    from repro_torch.launch.strategy import TrainStep, init_train_state
    from repro_torch.optim import AdamWConfig
    from repro_torch.tree import flatten

    opt = AdamWConfig(lr=1e-3)
    s0 = _host(init_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"))
    gc.collect()
    torch.cuda.empty_cache()
    # what earlier phases left on the card (none of it this phase's)
    at_start = (torch.cuda.memory_allocated() / 1e9,
                torch.cuda.memory_reserved() / 1e9)
    launches = {}

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    # (a) the captured step on one fixed batch
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step = TrainStep(cfg, opt, s0, b, s, "graph", device="cuda")
    build_s = time.perf_counter() - t0
    batch = train_batches(torch, cfg, b, s, 123)[0]
    walls, losses, auxes = [], [], []
    with ClockSampler() as clocks:
        for _ in range(10):
            t0 = time.perf_counter()
            m = step(batch)
            losses.append(float(m["loss"]))
            walls.append(1e3 * (time.perf_counter() - t0))
            auxes.append(float(m["aux"]) if "aux" in m else None)
    peak = (torch.cuda.max_memory_allocated() / 1e9,
            torch.cuda.max_memory_reserved() / 1e9)
    kernels, span = _profile_steps(torch, step, batch)
    by_name = {}                      # device ms a step, by kernel name
    for e in kernels:
        key = e.key[:100]
        by_name[key] = by_name.get(key, 0.0) + e.self_device_time_total / 2e3
    classes = kernel_class_split(
        {e.key: {"ms": e.self_device_time_total / 1e3 / max(e.count, 1),
                 "per_call": e.count / 2} for e in kernels
         if e.self_device_time_total > 0})["classes"]
    g = step.graph
    if g.replays != 10 + 2:
        raise AssertionError(f"{phase}: {g.replays} replays for 10 + 2 "
                             f"(profiled) steps")
    add(check_train_counts(cfg, phase, g.calls, g.replays))
    dev_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:16]
    step_s = float(np.mean(walls[1:])) / 1e3
    tokens = b * s
    n_active = cfg.num_active_params()
    n_attn = n_attention_layers(cfg)
    model_flops, formula = train_model_flops(cfg, b, s)
    measured = measured_step(phase, cfg, b, s, step_s, model_flops, formula)
    log({"phase": phase, "arch": cfg.name,
         "num_layers": cfg.num_layers,
         "encoder_layers": cfg.encoder_layers, "attention_layers": n_attn,
         "batch": b, "seq": s, "batch_keys": sorted(batch),
         "visible_pairs": _visible_pairs(s, cfg.attention_window),
         "n_params": cfg.num_params(), "n_active_params": n_active,
         "losses": losses, "aux": auxes, "drop": losses[0] - losses[-1],
         "margin": LEARN_MARGIN, "step_ms_all": walls,
         "step_ms": 1e3 * step_s, "tokens_per_s": tokens / step_s,
         "encoder_frames_per_s": (b * cfg.encoder_positions / step_s
                                  if cfg.family == "encdec" else None),
         "clocks": clocks.summary(), "model_flops_per_step": model_flops,
         "mfu": measured["mfu"], "mfu_formula": formula,
         "peak_mem_gb": peak[0], "peak_reserved_gb": peak[1],
         "at_start_gb": {"allocated": at_start[0],
                         "reserved": at_start[1]},
         "build_s": build_s, "capture_s": g.capture_s,
         "capture_gb": g.capture_bytes / 1e9, "step_calls": g.calls,
         "step_replays": g.replays,
         "profile": {"steps": 2, "wall_s": span, "device_s": dev_us / 1e6,
                     "device_busy_share": dev_us / 2e6 / step_s,
                     "device_busy_share_profiled": dev_us / 1e6 / span,
                     "top_kernels_ms_per_step": dict(top),
                     "classes_per_step": classes,
                     "top_kernels_share": {
                         k: v * 2e3 / dev_us for k, v in top}}})
    if not (all(np.isfinite(losses))
            and losses[-1] < losses[0] - LEARN_MARGIN):
        raise AssertionError(f"{phase}: losses {losses} did not fall by "
                             f"{LEARN_MARGIN}")
    if cfg.num_experts and not all(np.isfinite(a) and a > 0 for a in auxes):
        raise AssertionError(f"{phase}: aux losses {auxes}")
    del step, g, m, kernels, top, by_name
    gc.collect()
    torch.cuda.empty_cache()

    # (b) graph vs eager, one after the other from the host state
    batches = train_batches(torch, cfg, b, s, 7, 3)
    seen = {}
    for mode in ("graph", "eager"):
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        st = TrainStep(cfg, opt, s0, b, s, mode, device="cuda")
        metrics = [{k: v.cpu() for k, v in st(bt).items()} for bt in batches]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        calls, replays = st.graph.calls, st.graph.replays
        if (calls, replays) != ((3, 3) if mode == "graph" else (4, 0)):
            raise AssertionError(f"{phase}_graph_vs_eager {mode}: "
                                 f"{calls} calls, {replays} replays")
        add(check_train_counts(cfg, f"{phase}_graph_vs_eager {mode}",
                               calls, replays))
        seen[mode] = (metrics, st.state if mode == "eager"
                      else _host(st.state), peak_gb)
        if mode == "graph":
            del st
            gc.collect()
            torch.cuda.empty_cache()
    (mg, sg, peak_g), (me, se, peak_e) = seen["graph"], seen["eager"]
    names = flatten(_leaf_names(sg))[0]
    differ = [f"step {i} metric {k}" for i in range(3) for k in mg[i]
              if not torch.equal(mg[i][k], me[i][k])]
    differ += [n for n, a, e in zip(names, flatten(sg)[0], flatten(se)[0])
               if not torch.equal(a, e.cpu())]
    log({"phase": f"{phase}_graph_vs_eager", "steps": 3,
         "leaves": len(names), "losses": [float(x["loss"]) for x in mg],
         "aux": [float(x["aux"]) if "aux" in x else None for x in mg],
         "identical": not differ,
         "differ": differ[:20], "peak_mem_gb": {"graph": peak_g,
                                                "eager": peak_e}})
    if differ:
        raise AssertionError(f"{phase} graph vs eager: {len(differ)} "
                             f"leaves or metrics differ: {differ[:20]}")
    del seen, se, sg, s0
    return launches, measured


def measured_step(phase: str, cfg, b: int, s: int, step_s: float,
                  model_flops: float, formula: str) -> dict:
    """A training phase's measured step as the ``analysis`` phase reads
    it: the cell (config as cut, b x s), the step's seconds, and the
    smoke's own MFU with its formula."""
    return {"phase": phase, "cfg": cfg, "batch": b, "seq": s,
            "step_s": step_s, "mfu": model_flops / step_s
            / PEAK_FLOPS["torch.bfloat16"], "mfu_formula": formula}


# ---------------------------------------------------------------------------
# phase 12: the compile-time analysis of the training cells
# ---------------------------------------------------------------------------

def analysis(torch, cells, counts):
    """The reference's compile-time analysis of each training cell the
    smoke ran (``cells``: ``measured_step``'s records), on the host, no
    step run: ``H100_SXM.hbm_bytes`` against the card's total memory
    (both printed; more than HBM_SPEC_SHARE apart fails), then per cell
    ``model_flops`` (6 N_active tokens, ``repro_torch.core.flops``) and
    its MFU over the measured step, the cost reference's counted flops
    and bytes (``cost_reference``, counted anew: the plain step on
    ``meta`` tensors, the eager ops outside the kernels unfused and each
    kernel at its byte model), the one-H100 ``RooflineCell`` of them
    (t_compute, t_memory, t_lower_bound, t_ideal, the dominant term,
    useful_ratio, pg_overlap) and ``pg_measured`` = t_ideal / the
    measured step.  The counts (``counts``: :func:`analysis_counts`'s,
    made beside the build) must hold every cell.  A lower bound above
    the measured step fails: the counts would not describe the step
    that ran."""
    from repro_torch.core.flops import model_flops
    from repro_torch.core.roofline import RooflineCell
    from repro_torch.models.config import ShapeConfig

    t_phase = time.perf_counter()
    total = torch.cuda.get_device_properties(0).total_memory
    share = abs(H100_SXM.hbm_bytes - total) / total
    log({"phase": "analysis_hbm", "spec": H100_SXM.name,
         "spec_hbm_bytes": H100_SXM.hbm_bytes,
         "device_total_memory": total, "share": share,
         "limit": HBM_SPEC_SHARE})
    if share > HBM_SPEC_SHARE:
        raise AssertionError(f"H100_SXM.hbm_bytes {H100_SXM.hbm_bytes} is "
                             f"{share:.3f} away from the card's {total}")
    peak = H100_SXM.peak_flops_bf16
    for m in cells:
        cfg, b, s, step_s = m["cfg"], m["batch"], m["seq"], m["step_s"]
        shape = ShapeConfig("smoke_train", "train", s, b)
        mf = model_flops(cfg, shape)
        cost = counts.get(cell_key(cfg, b, s))
        if cost is None:
            raise AssertionError(f"analysis: no count of {m['phase']}'s "
                                 f"cell (train_cells differs from it)")
        count_s = cost["count_s"]
        cell = RooflineCell(arch=cfg.name, shape=shape.name, mesh="1",
                            chips=1, hlo_flops=cost["flops"],
                            hlo_bytes=cost["bytes"],
                            collective_bytes_per_chip=0.0, model_flops=mf,
                            chip=H100_SXM)
        log({"phase": "analysis", "cell": m["phase"], "arch": cfg.name,
             "num_layers": cfg.num_layers,
             "encoder_layers": cfg.encoder_layers, "batch": b, "seq": s,
             "step_ms": 1e3 * step_s, "model_flops": mf,
             "mfu": m["mfu"], "mfu_model_flops": mf / (step_s * peak),
             "mfu_formula": {
                 "mfu": m["mfu_formula"],
                 "mfu_model_flops": "6 N_active tokens / (step_s x "
                                    "989e12): repro_torch.core.flops."
                                    "model_flops, the reference's"},
             "counted_flops": cost["flops"], "counted_bytes": cost["bytes"],
             "counted_bytes_model": "eager aten ops unfused, each input "
                                    "and output once; each kernel's "
                                    "tensors in and out once",
             "count_points": len(cost["ref_points"]),
             "t_compute_ms": 1e3 * cell.t_compute,
             "t_memory_ms": 1e3 * cell.t_memory,
             "t_lower_bound_ms": 1e3 * cell.t_lower_bound,
             "t_ideal_ms": 1e3 * cell.t_ideal, "dominant": cell.dominant,
             "useful_ratio": cell.useful_ratio,
             "pg_overlap": cell.pg_optimistic,
             "pg_measured": cell.t_ideal / step_s,
             "lower_bound_share": cell.t_lower_bound / step_s,
             "count_s": count_s})
        if cell.t_lower_bound > step_s:
            raise AssertionError(
                f"{m['phase']}: the roofline's lower bound "
                f"{1e3 * cell.t_lower_bound:.2f} ms is above the measured "
                f"step {1e3 * step_s:.2f} ms: the counts do not describe "
                f"the step that ran")
    log({"phase": "analysis_total", "cells": len(cells),
         "seconds": time.perf_counter() - t_phase})


# the host-only work that runs beside the build, in subprocesses that see
# no card: each takes ~30 s on the card machine's host alone
HOST_WORK_TIMEOUT = 600


def start_host_work(fn: str):
    """``chip_smoke.<fn>(out)`` started in a subprocess that sees no card
    (``CUDA_VISIBLE_DEVICES`` empty), ``out`` a JSON file under
    ``build/``: returns (process, out, start time)."""
    import os

    out = ROOT / "build" / f"{fn}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    proc = subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke; chip_smoke.{fn}({str(out)!r})"],
        cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    return proc, out, time.perf_counter()


def join_host_work(started) -> dict:
    """Waits for a :func:`start_host_work` subprocess; returns what it
    wrote, with its wall (``subprocess_s``) and the seconds waited for
    it (``waited_s``).  Fails where it failed."""
    proc, out, t0 = started
    t_wait = time.perf_counter()
    try:
        rc = proc.wait(timeout=max(1.0, HOST_WORK_TIMEOUT - (t_wait - t0)))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc:
        raise AssertionError(f"{out.stem}: the subprocess exited {rc}")
    return {**json.loads(out.read_text()),
            "subprocess_s": time.perf_counter() - t0,
            "waited_s": time.perf_counter() - t_wait}


def dryrun_mesh_records(out: str) -> None:
    """Host work: the dry run's mesh records (the module note), as JSON
    at ``out``."""
    import torch

    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models.config import ShapeConfig

    torch.set_num_threads(1)
    recs = {"16x16": run_cell("smollm-135m", "train_4k", False, save=False),
            "1x1": run_cell("smollm-135m", ShapeConfig(
                "distributed_smollm", "train", TRAIN_SEQ, TRAIN_BATCH),
                save=False, mesh_shape=(1, 1))}
    Path(out).write_text(json.dumps(recs))


def train_cells():
    """The six training cells as phases 6-11 train them: (config, batch,
    seq), smollm-135m at full width, the others at their published
    widths with their phases' depth cuts."""
    from repro_torch.configs import get_config

    def cut(arch, n):
        return dataclasses.replace(get_config(arch), num_layers=n)

    return [(get_config("smollm-135m"), TRAIN_BATCH, TRAIN_SEQ),
            (cut("deepseek-moe-16b", MOE_TRAIN_LAYERS), MOE_TRAIN_BATCH,
             MOE_TRAIN_SEQ),
            (cut("recurrentgemma-2b", HYBRID_TRAIN_LAYERS),
             HYBRID_TRAIN_BATCH, HYBRID_TRAIN_SEQ),
            (cut("rwkv6-3b", SSM_TRAIN_LAYERS), SSM_TRAIN_BATCH,
             SSM_TRAIN_SEQ),
            (get_config("whisper-medium"), ENCDEC_TRAIN_BATCH,
             ENCDEC_TRAIN_SEQ),
            (cut("llava-next-mistral-7b", VLM_TRAIN_LAYERS),
             VLM_TRAIN_BATCH, VLM_TRAIN_SEQ)]


def cell_key(cfg, b: int, s: int) -> str:
    return f"{cfg!r} {b} x {s}"


def analysis_counts(out: str) -> None:
    """Host work: the cost reference's counts of the six training cells
    (``cost_reference``, counted anew, each with its seconds), by
    :func:`cell_key`, as JSON at ``out``; phase 12 reads them."""
    import torch

    from repro_torch.core.costref import cost_reference
    from repro_torch.models.config import ShapeConfig

    torch.set_num_threads(1)
    counts = {cell_key(cfg, b, s): cost_reference(
        cfg, ShapeConfig("smoke_train", "train", s, b), use_cache=False)
        for cfg, b, s in train_cells()}
    Path(out).write_text(json.dumps(counts))


def dryrun_mesh(recs: dict, smollm_argument_bytes: int) -> None:
    """Logs ``dryrun_mesh`` from the subprocess's records; fails where the
    16 x 16 record lacks a collective or a temp size, or where the 1 x 1
    record's argument bytes are not ``smollm_argument_bytes`` (phase
    13's static state plus batch) or it shows a collective."""
    mesh, one = recs["16x16"], recs["1x1"]
    m, c = mesh["memory"], mesh["collectives"]
    log({"phase": "dryrun_mesh", "arch": mesh["arch"],
         "shape": mesh["shape"], "mesh": mesh["mesh"],
         "chips": mesh["chips"], "mesh_device": "cuda",
         "count_by_kind": c["count_by_kind"],
         "bytes_by_kind": c["bytes_by_kind"],
         "total_bytes": c["total_bytes"],
         "argument_bytes": m["argument_bytes"],
         "temp_bytes": m["temp_bytes"], "peak_bytes": m["peak_bytes"],
         "hbm_per_chip": m["hbm_per_chip"],
         "peak_share_of_hbm": m["peak_bytes"] / m["hbm_per_chip"],
         "flops_once": mesh["cost"]["flops_once"],
         "bytes_once": mesh["cost"]["bytes_once"],
         "top_collectives": mesh["top_collectives"][:3],
         "lower_s": mesh["lower_s"], "compile_s": mesh["compile_s"],
         "one_by_one": {"shape": one["shape"],
                        "argument_bytes": one["memory"]["argument_bytes"],
                        "phase13_state_batch_bytes": smollm_argument_bytes,
                        "count_by_kind": one["collectives"]["count_by_kind"],
                        "peak_bytes": one["memory"]["peak_bytes"],
                        "compile_s": one["compile_s"]},
         "subprocess_s": recs["subprocess_s"],
         "waited_s": recs["waited_s"]})
    if not c["count_by_kind"] or m["temp_bytes"] is None:
        raise AssertionError(f"dryrun_mesh: the 16 x 16 record has no "
                             f"collectives or no temp size: {mesh}")
    if one["memory"]["argument_bytes"] != smollm_argument_bytes:
        raise AssertionError(
            f"dryrun_mesh: the 1 x 1 record's argument bytes "
            f"{one['memory']['argument_bytes']} are not phase 13's smollm "
            f"state plus batch, {smollm_argument_bytes}")
    if one["collectives"]["count_by_kind"]:
        raise AssertionError(f"dryrun_mesh: the 1 x 1 record issues "
                             f"{one['collectives']['count_by_kind']}")


# ---------------------------------------------------------------------------
# phase 8: training recurrentgemma-2b at its published widths, depth 6
# ---------------------------------------------------------------------------

# one 4,096-token sequence (the reference's train_4k length): past token
# 2,048 the 2048 window masks keys
HYBRID_TRAIN_BATCH, HYBRID_TRAIN_SEQ = 1, 4096
# layers 0-5: RG-LRU, RG-LRU, attention, RG-LRU, RG-LRU, attention (two
# periods of the 1:2 pattern); 26 layers' train state (~30 B a parameter
# with the step's new copy, gradients and casts) would not fit 80 GB
HYBRID_TRAIN_LAYERS = 6
# the hybrid's leaves whose gradient comes through the RG-LRU scan alone
SCAN_LEAVES = ("lru_wa", "lru_ba", "lru_wx", "lru_bx", "lru_a", "w_y",
               "conv_w", "conv_b")
# the flash backward at the hybrid's training shape: q (1, 4096, 10, 256),
# k, v (1, 4096, 1, 256), causal with the 2048 window
FLASH_BWD_HYBRID_CASES = [("recurrentgemma_train", HYBRID_TRAIN_BATCH, 10,
                           1, HYBRID_TRAIN_SEQ, 256, 2048)]
FLASH_FWD_HYBRID_CASE = ("recurrentgemma_train_lse", HYBRID_TRAIN_BATCH, 10,
                         1, HYBRID_TRAIN_SEQ, 256, 2048)


def rglru_bwd_cases(torch):
    """The RG-LRU reverse scan (``rglru_scan_bwd``) against its plain
    version at the hybrid's training shape (1, 4096, 2560), from zeros
    and from a nonzero h0, and at a ragged shape (seq 37, 40 channels)
    from an h0; fp32 and bf16, each bit-exact (both round the same two
    ops and each output once) with two calls ``torch.equal``; the inputs
    a in the model's decay range, h from the plain forward scan.  Each
    line: the kernel's device time, the plain version's, and the bound
    (a, h, dh read once and da, db written once, plus h0 and dh0; 3
    flops an element).  No one PyTorch call computes it."""
    from repro_torch.kernels.rglru_scan import rglru_scan as rs
    from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_ref,
                                                    rglru_scan_ref)

    dev = torch.device("cuda")
    shapes = [(1, HYBRID_TRAIN_SEQ, 2560, False),
              (1, HYBRID_TRAIN_SEQ, 2560, True), (1, 37, 40, True)]
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, w, with_h0 in shapes:
            g = torch.Generator(device=dev).manual_seed(s + w + with_h0)
            a = (0.85 + 0.149 * torch.rand((b, s, w), generator=g,
                                           device=dev)).to(dtype)
            x = (0.1 * torch.randn((b, s, w), generator=g,
                                   device=dev)).to(dtype)
            dh = torch.randn((b, s, w), generator=g, device=dev).to(dtype)
            h0 = (torch.randn((b, w), generator=g, device=dev)
                  if with_h0 else None)
            h = rglru_scan_ref(a, x, h0)
            what = f"rglru_scan_bwd {(b, s, w)} h0={with_h0} {dtype}"
            out, _ = run_counted(torch, rs, what,
                                 lambda: rs.rglru_scan_bwd(a, h, dh, h0),
                                 counter="LAUNCHES_BWD")
            ref = rglru_scan_bwd_ref(a, h, dh, h0)
            torch.cuda.synchronize()
            for name, o, r in zip(("da", "db", "dh0"), out, ref):
                if (o is None) != (r is None) or (
                        r is not None and not torch.equal(o, r)):
                    raise AssertionError(f"{what} {name}: not bit-exact "
                                         f"against the plain version")
            es = a.element_size()
            nbytes = es * 5 * b * s * w + (8 * b * w if with_h0 else 0)
            bound_ms, bound_by = bound(3.0 * b * s * w, nbytes, dtype)
            kernel_ms = graph_ms(torch,
                                 lambda: rs.rglru_scan_bwd(a, h, dh, h0))
            rows.append({
                "kernel": "rglru_scan_bwd", "dtype": str(dtype), "b": b,
                "s": s, "w": w, "h0": with_h0, "bit_exact": True,
                "max_abs_err": 0.0, "kernel_ms": kernel_ms,
                "kernel_call_ms": cuda_ms(
                    torch, lambda: rs.rglru_scan_bwd(a, h, dh, h0)),
                "plain_ms": graph_ms(
                    torch, lambda: rglru_scan_bwd_ref(a, h, dh, h0),
                    reps=1, replays=2),
                "library_ms": None,    # no one PyTorch call computes it
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_ratio": kernel_ms / bound_ms})
            log(rows[-1])
            del out, ref, a, x, dh, h, h0
    gc.collect()
    torch.cuda.empty_cache()
    return rows



# ---------------------------------------------------------------------------
# phase 9: training rwkv6-3b at its published widths, depth 8
# ---------------------------------------------------------------------------

# one 4,096-token sequence (the reference's train_4k length)
SSM_TRAIN_BATCH, SSM_TRAIN_SEQ = 1, 4096
# 32 layers' train state (~30 B a parameter with the step's new copy,
# gradients and casts: ~92 GB) would not fit 80 GB; 8 layers are 1.02 B
# parameters, the size of the MoE and hybrid cuts
SSM_TRAIN_LAYERS = 8
# the kernel-vs-plain gradient check of the ssm runs the first 2 of those
# layers: each plain gradient run loops the WKV over the tokens in Python
# (~6.5 s a layer), and the smoke's time limit is shared by every phase
SSM_GRAD_LAYERS = 2
# the time-mix leaves whose gradient comes through the WKV alone: the
# r, k, v projections, the decay's LoRA and base, and the bonus
WKV_LEAVES = ("wr", "wk", "wv", "decay_a", "decay_b", "decay_base", "bonus")
# the reverse WKV against its plain version, each gradient within
# WKV_BWD_RTOL of its largest element plus WKV_BWD_RTOL relative.  The
# plain fp32 reverse lies within ~2e-7 of the largest element from an
# fp64 one for the per-token gradients and ~2.2e-6 for du (a sum over
# 4,096 tokens of entries up to ~160), at this shape and both decay
# ranges (measured on the host); the kernel sums its column blocks, warps
# and lanes in another order, so it may lie up to twice that from the
# plain version.  1e-4 is the forward's bound, 45x above du's and 500x
# above the rest; a wrong index or a missing term moves an element by
# the order of the largest
WKV_BWD_RTOL = 1e-4


def _wkv_bwd_inputs(torch, b, s, h, n, with_state, decay, seed):
    """fp32 r, k, v, logw in the model's layout ((b, s, h*n) projections
    viewed as (b, s, h, n)), u, the output's gradient, and s0 / the final
    state's gradient or None; logw = -exp(x), x uniform in ``decay``."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = ((0.5 * torch.randn((b, s, h * n), generator=g, device=dev))
               .view(b, s, h, n) for _ in range(3))
    logw = -torch.exp(torch.empty((b, s, h, n), device=dev)
                      .uniform_(*decay, generator=g))
    u = 0.1 * torch.randn((h, n), generator=g, device=dev)
    do = torch.randn((b, s, h, n), generator=g, device=dev)
    s0, ds = ((torch.randn((b, h, n, n), generator=g, device=dev)
               for _ in range(2)) if with_state else (None, None))
    return r, k, v, logw, u, do, s0, ds


def wkv_bwd_cases(torch, ptxas_report: str = ""):
    """The reverse WKV (``rwkv6_wkv_bwd``) against its plain version at
    the ssm's training shape (1, 4096, 40, 64) fp32 (what the time mix
    feeds it): from zeros, from a nonzero s0 with a nonzero final-state
    gradient, at the model's full decay range (logw = -exp(d), d in
    [-20, 10]), at batch 2 (2, 2048, 40, 64) from a state (du summed
    over rows and segments), and at a ragged (1, 37, 3, 16) from a
    state; each gradient within WKV_BWD_RTOL, two calls bit-identical,
    the chunk states from the forward kernel.  Each line: the kernel's
    device time (a graph replay), each of its launches' (carry, main,
    finish) by ``torch.profiler`` (:func:`kernel_split_ms`), the
    segments and the main launch's blocks, the blocks resident on an SM,
    its registers and local bytes a thread (``bwd_info``: the runtime's
    figures for the loaded library; at n 64 fewer than two blocks an SM
    fails), the build's ptxas registers and spills of the three kernels
    (from ``ptxas_report``, empty if built before this run), the plain
    version's time (one eager call: its two loops of a few small ops a
    token), and the bound (r, k, v, logw, do and the chunk states read
    once, dr, dk, dv, dlogw written once, plus u, ds, du, ds0; 14 n^2
    flops a token and head: the states recomputed once, G updated, dr,
    dk, dv, dlogw).  Then the forward at the training shape, with and
    without its chunk-state output (bound: r, k, v, logw read, o
    written, and the states; 5 n^2 + 4 n flops a token and head).  No
    one PyTorch call computes either."""
    from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv as wk
    from repro_torch.kernels.rwkv6_wkv.ref import (rwkv6_wkv_bwd_ref,
                                                   rwkv6_wkv_ref)

    decays = {"usual": (-6.0, -1.0), "full": (-20.0, 10.0)}
    cases = [("zeros", 1, SSM_TRAIN_SEQ, 40, 64, False, "usual"),
             ("state", 1, SSM_TRAIN_SEQ, 40, 64, True, "usual"),
             ("full_decay", 1, SSM_TRAIN_SEQ, 40, 64, False, "full"),
             ("batch2", 2, SSM_TRAIN_SEQ // 2, 40, 64, True, "usual"),
             ("ragged", 1, 37, 3, 16, True, "usual")]
    ptxas = ptxas_entries(ptxas_report, "wkv_bwd")
    rows, fwd_rows = [], []
    f32 = torch.float32
    for case, b, s, h, n, with_state, decay in cases:
        r, k, v, logw, u, do, s0, ds = _wkv_bwd_inputs(
            torch, b, s, h, n, with_state, decays[decay], s + h + n)
        _, _, states = wk.rwkv6_wkv(r, k, v, logw, u, s0, states=True)
        args = (r, k, v, logw, u, do, states, s0, ds)
        what = f"rwkv6_wkv_bwd {case} {(b, s, h, n)}"
        out, _ = run_counted(torch, wk, what, lambda: wk.rwkv6_wkv_bwd(*args),
                             counter="LAUNCHES_BWD")
        # the plain reverse is timed by this one eager call, its check's
        plain = torch.cuda.Event(enable_timing=True)
        plain_end = torch.cuda.Event(enable_timing=True)
        plain.record()
        ref = rwkv6_wkv_bwd_ref(r, k, v, logw, u, do, s0, ds)
        plain_end.record()
        torch.cuda.synchronize()
        plain_ms = plain.elapsed_time(plain_end)
        errs = {}
        for name, o, w in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"),
                              out, ref):
            if (o is None) != (w is None):
                raise AssertionError(f"{what} {name}: None on one side")
            if w is None:
                continue
            err = (o - w).abs()
            lim = WKV_BWD_RTOL * (w.abs().max() + w.abs())
            errs[name] = err.max().item()
            if not bool((err <= lim).all()) or not bool(o.isfinite().all()):
                raise AssertionError(f"{what} {name}: kernel disagrees with "
                                     f"its plain version, max abs err "
                                     f"{errs[name]} (largest "
                                     f"{w.abs().max().item()})")
        del out, ref
        tokens = b * s * h
        nbytes = 4 * (9 * tokens * n + 2 * h * n + states.numel()
                      + (2 * b * h * n * n if with_state else 0))
        bound_ms, bound_by = bound(float(tokens * 14 * n * n), nbytes, f32)
        kernel_ms = graph_ms(torch, lambda: wk.rwkv6_wkv_bwd(*args))
        info = wk.bwd_info(b, s, h, n)
        if n == 64 and info["blocks_per_sm"] < 2:
            raise AssertionError(f"{what}: the main kernel fits "
                                 f"{info['blocks_per_sm']} block(s) an SM "
                                 f"(registers {info['registers']}, local "
                                 f"bytes {info['local_bytes']})")
        rows.append({
            "kernel": "rwkv6_wkv_bwd", "case": case, "dtype": str(f32),
            "b": b, "s": s, "h": h, "n": n, "state": with_state,
            "decay": decay, "bit_identical": True, **info,
            "launch_ms": kernel_split_ms(
                torch, lambda: wk.rwkv6_wkv_bwd(*args)),
            "ptxas": {k: v for k, v in (ptxas or {}).items()
                      if f"ILi{n}E" in k or "finish" in k},
            "max_abs_err": max(errs.values()), "max_abs_err_by_grad": errs,
            "rtol_of_largest": WKV_BWD_RTOL, "kernel_ms": kernel_ms,
            "kernel_call_ms": cuda_ms(torch,
                                      lambda: wk.rwkv6_wkv_bwd(*args)),
            "plain_ms": plain_ms,
            "plain_timing": "the check's eager call",
            "library_ms": None,        # no one PyTorch call computes it
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_ratio": kernel_ms / bound_ms})
        log(rows[-1])
        if case == "zeros":
            # the forward at the training shape, serving and training forms
            nb_fwd = 4 * (5 * tokens * n + h * n + b * h * n * n)
            flops = float(tokens * (5 * n * n + 4 * n))
            # one eager call of the plain forward (the same function for
            # both rows: the chunk states are the kernel's own output)
            f_plain_ms = cuda_ms(
                torch, lambda: rwkv6_wkv_ref(r, k, v, logw, u, s0),
                iters=1, warmup=0)
            for keep in (False, True):
                fn = (lambda keep=keep: wk.rwkv6_wkv(r, k, v, logw, u, s0,
                                                     states=keep))
                nbytes = nb_fwd + (4 * states.numel() if keep else 0)
                f_bound, f_by = bound(flops, nbytes, f32)
                f_ms = graph_ms(torch, fn)
                fwd_rows.append({
                    "kernel": "rwkv6_wkv", "case": "train_shape",
                    "dtype": str(f32), "b": b, "s": s, "h": h, "n": n,
                    "chunk_states": keep, "kernel_ms": f_ms,
                    "plain_ms": f_plain_ms,
                    "plain_timing": "one eager call, shared by both rows",
                    "library_ms": None,
                    "bound_ms": f_bound, "bound_by": f_by,
                    "bound_ratio": f_ms / f_bound})
                log(fwd_rows[-1])
        del args, states, r, k, v, logw, u, do, s0, ds
        gc.collect()
        torch.cuda.empty_cache()
    return rows, fwd_rows


def give_decay_lora_work(torch, params):
    """decay_b starts at zero (the reference's init), so the decay's LoRA
    has no gradient for decay_a at the first step: draw it small (0.01 x
    randn from seed 1), in place, so that every WKV leaf moves."""
    g = torch.Generator(device="cuda").manual_seed(1)
    db = params["blocks"]["tm"]["decay_b"]
    db.copy_(0.01 * torch.randn(db.shape, generator=g, device=db.device))


# ---------------------------------------------------------------------------
# phases 10 and 11: training whisper-medium at full depth and
# llava-next-mistral-7b at its published widths, depth 5
# ---------------------------------------------------------------------------

# 8 rows of whisper's own 448-token decoder context, each with its 1500
# encoder frames
ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ = 8, 448
# one 4,096-position stream: 1152 patches and 2,944 tokens; 32 layers'
# train state (~30 B a parameter with the step's new copy, gradients and
# casts: 7.24 B parameters) would not fit 80 GB.  Depth 6 peaked at 70.6
# GB (65.7 GiB) with phases 10 and 11 alone, but after the earlier
# phases its capture ran out of memory, asking for 70.1 GiB beside 9.8
# GiB cached and unusable; each layer is ~5.2 GB of the step
VLM_TRAIN_BATCH, VLM_TRAIN_SEQ = 1, 4096
VLM_TRAIN_LAYERS = 5
# the leaves whose gradient comes through the flash backward alone: the
# encoder's attention and the decoder's cross-attention (the key bias is
# held by KEY_BIAS_GRAD_SHARE instead: its gradient is zero but for
# rounding), and llava's attention
ENCDEC_LEAVES = tuple(f"{blk}.{w}" for blk in ("enc_blocks.attn",
                                               "dec_blocks.xattn")
                      for w in ("wq", "wk", "wv", "wo", "bq", "bv"))
VLM_LEAVES = tuple(f"blocks.attn.{w}" for w in ("wq", "wk", "wv", "wo"))
# the flash forward with its LSE and the backward at the training shapes
# (``flash_case``): whisper's encoder (1500 x 1500) and cross-attention
# (448 queries x 1500 keys), both without the causal mask, and its
# decoder's causal 448, d 64 with 16 / 16 heads at batch 8; llava's
# causal 4096 at d 128 with 32 / 8 heads
FLASH_ENCDEC_CASES = [
    ("whisper_encoder", ENCDEC_TRAIN_BATCH, 16, 16, 1500, 64, 0, 1500, False),
    ("whisper_cross", ENCDEC_TRAIN_BATCH, 16, 16, ENCDEC_TRAIN_SEQ, 64, 0,
     1500, False),
    ("whisper_decoder_self", ENCDEC_TRAIN_BATCH, 16, 16, ENCDEC_TRAIN_SEQ,
     64, 0, ENCDEC_TRAIN_SEQ, True)]
FLASH_VLM_CASES = [("llava_train", VLM_TRAIN_BATCH, 32, 8, VLM_TRAIN_SEQ,
                    128, 0)]


# ---------------------------------------------------------------------------
# phase 13: distribution (the sharded steps at world size 1)
# ---------------------------------------------------------------------------

# the kernels the sharded train steps must have launched over the phase
DIST_KERNELS = ("flash_attention", "flash_attention_bwd", "moe_gmm",
                "moe_gmm_bwd", "rglru_scan", "rglru_scan_bwd", "rwkv6_wkv",
                "rwkv6_wkv_bwd")
# the recurrent families' train cells: published widths, depth cut to 3
# (layers 0-2: RG-LRU, RG-LRU, local attention) and 2, one 4,096-token
# sequence each, as phases 8 and 9 train them
DIST_HYBRID_LAYERS = 3
DIST_SSM_LAYERS = 2


def _local_host(tree):
    """This rank's blocks of a tree of DTensors, on the host (at world
    size 1 the whole tensors)."""
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.to_local().detach().cpu(), tree)


def sharded_vs_train_step(torch, cfg, b: int, s: int, mesh, phase: str):
    """A captured ``TrainStep`` and a captured ``ShardedTrainStep`` on
    ``mesh`` from the same host state (random weights from seed 0) over
    the same 3 batches, one after the other: step ms of each (the steady
    steps' mean wall, batch copy included) and their ratio, build and
    capture seconds, pool bytes, the peak bytes of the construction
    (warm-ups and capture) and of the 3 replays, the launches (exact per direct
    call, every bf16 one on the tensor cores), the sharded step's
    collectives of one step, and the final params, m, v, step and
    metrics, which must be bit-identical.  Returns the launches made
    (replays counted): both steps', and the sharded step's alone."""
    import numpy as np

    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.launch.strategy import (ShardedTrainStep, TrainStep,
                                             init_train_state)
    from repro_torch.optim import AdamWConfig
    from repro_torch.tree import flatten

    gc.collect()
    torch.cuda.empty_cache()
    at_start = {"allocated": torch.cuda.memory_allocated() / 1e9,
                "reserved": torch.cuda.memory_reserved() / 1e9}
    t_cell = time.perf_counter()
    opt = AdamWConfig(lr=1e-3)
    s0 = _host(init_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"))
    batches = train_batches(torch, cfg, b, s, 7, 3)
    gc.collect()
    torch.cuda.empty_cache()
    launches, seen, own = {}, {}, {}
    for kind in ("train_step", "sharded"):
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        st = (TrainStep(cfg, opt, s0, b, s, "graph", device="cuda")
              if kind == "train_step" else
              ShardedTrainStep(cfg, opt, mesh, s0, b, s, "graph"))
        build_s = time.perf_counter() - t0
        peak_build = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        metrics, walls = [], []
        for bt in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = st(bt)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
            metrics.append({k: v.detach().cpu() for k, v in m.items()})
        g = st.graph
        if (g.calls, g.replays) != (3, 3):
            raise AssertionError(f"{phase} {kind}: {g.calls} calls, "
                                 f"{g.replays} replays")
        own[kind] = check_train_counts(cfg, f"{phase} {kind}", g.calls,
                                       g.replays)
        for k, n in own[kind].items():
            launches[k] = launches.get(k, 0) + n
        row = {"step_ms": float(np.mean(walls[1:])), "step_ms_all": walls,
               "build_s": build_s, "capture_s": g.capture_s,
               "capture_gb": g.capture_bytes / 1e9,
               "peak_build_gb": peak_build,
               "peak_steps_gb": torch.cuda.max_memory_allocated() / 1e9,
               "losses": [float(x["loss"]) for x in metrics]}
        if kind == "sharded":
            c = st.collectives
            row["argument_bytes"] = tree_bytes(st.state) + tree_bytes(
                st.batch)
            row["collectives"] = {
                "count_by_kind": c.stats().count_by_kind,
                "bytes_by_kind": c.stats().bytes_by_kind,
                "total_bytes": c.stats().total_bytes,
                "top": c.top(4)}
            state = _local_host(st.state)
        else:
            state = _host(st.state)
        seen[kind] = (metrics, state, row)
        del st, g, m
        gc.collect()
        torch.cuda.empty_cache()
    (mt, st_t, row_t), (ms, st_s, row_s) = seen["train_step"], seen["sharded"]
    names = flatten(_leaf_names(st_t))[0]
    differ = [f"step {i} metric {k}" for i in range(3) for k in mt[i]
              if not torch.equal(mt[i][k], ms[i][k])]
    differ += [n for n, a, e in zip(names, flatten(st_t)[0],
                                    flatten(st_s)[0])
               if not torch.equal(a, e)]
    per_call = train_counts_per_call(cfg)
    kinds = row_s["collectives"]["count_by_kind"]
    log({"phase": phase, "arch": cfg.name, "num_layers": cfg.num_layers,
         "encoder_layers": cfg.encoder_layers,
         "batch": b, "seq": s, "moe_impl": cfg.moe_impl,
         "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
         "at_start_gb": at_start, "train_step": row_t, "sharded": row_s,
         "step_ms_ratio": row_s["step_ms"] / row_t["step_ms"],
         "launches_per_call": {k: n for k, n in per_call.items() if n},
         "launches": {k: n for k, n in launches.items() if n},
         "sharded_launches": {k: n for k, n in own["sharded"].items() if n},
         "identical": not differ, "differ": differ[:20],
         "leaves": len(names), "seconds": time.perf_counter() - t_cell})
    if differ:
        raise AssertionError(f"{phase}: the sharded step differs from "
                             f"TrainStep in {len(differ)} leaves or "
                             f"metrics: {differ[:20]}")
    if cfg.num_experts and cfg.moe_impl == "ep" and not kinds.get(
            "all-to-all"):
        raise AssertionError(f"{phase}: no all-to-all in the EP step's "
                             f"collectives {kinds}")
    del seen, s0
    return launches, own["sharded"], row_s["argument_bytes"]


# the sharded serving cells: 8 prompts of 200 tokens into a 264-slot
# cache, then greedy decode steps; whisper's beside 8 x 1500 frames, its
# ring the prompt + 64 = 264 slots of a 328-slot buffer, decoded past
# the ring's end (the ring wraps at step 65); llava's 1152 patches
# before the tokens, the cache holding the patches, the tokens and the
# new ones
DIST_SERVE_BATCH, DIST_SERVE_SEQ, DIST_SERVE_MAX_LEN = 8, 200, 264
DIST_SERVE_STEPS = 32
DIST_WHISPER_STEPS = 72
# the enc-dec and vlm train cells: published widths, whisper's encoder
# and decoder cut to 6 layers each (8 x 448 beside 8 x 1500 frames, as
# phase 10), llava to 2 (one stream of 1152 patches and 2,944 tokens,
# as phase 11)
DIST_ENCDEC_LAYERS = 6
DIST_VLM_LAYERS = 2
# the kernels the sharded serving steps must have launched
DIST_SERVE_KERNELS = ("flash_attention", "moe_gmm", "rglru_scan",
                      "rwkv6_wkv")
# the split softmax against the one-piece decode attention: the cache's
# 264 slots cut into this many pieces, the pieces' reductions done over
# the stacked pieces.  fp32 sums the same products in another order
# (1e-5); in bf16 P is rounded to bf16 after a sum l taken in another
# order, so an element of P may land one bf16 ulp away, and the output,
# rounded to bf16, one ulp (TOL's bf16 bound)
SPLIT_PIECES = 4
SPLIT_TOL = {"torch.float32": dict(atol=1e-5, rtol=1e-5),
             "torch.bfloat16": dict(atol=1.6e-2, rtol=1e-2)}


def split_softmax_cases(torch):
    """``decode_attention_pieces`` (the sharded decode's split softmax,
    its reductions over the stacked pieces) against the one-piece
    ``decode_attention`` on the card: smollm-135m's (8, 1, 9, 64) and
    deepseek-moe-16b's (8, 1, 16, 128) queries against a
    ``DIST_SERVE_MAX_LEN``-slot cache cut into ``SPLIT_PIECES`` pieces,
    fp32 and bf16, rows with ``n_valid`` 0, rows inside the first piece
    and rows of a wrapped ring (every slot valid)."""
    from repro_torch.models.attention import (decode_attention,
                                              decode_attention_pieces)

    slots, b = DIST_SERVE_MAX_LEN, 8
    s_p = slots // SPLIT_PIECES
    n_valid = torch.tensor([0, 0, 1, s_p - 1, s_p, slots, slots, 2 * s_p + 3],
                           dtype=torch.int32, device="cuda")
    rows = []
    for arch, hq, hkv, hd in (("smollm-135m", 9, 3, 64),
                              ("deepseek-moe-16b", 16, 16, 128)):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda").manual_seed(hq)
            q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                       for shape in ((b, 1, hq, hd), (b, slots, hkv, hd),
                                     (b, slots, hkv, hd)))

            def stack(t):
                return t.reshape(b, SPLIT_PIECES, s_p, hkv, hd).transpose(0, 1)

            got = decode_attention_pieces(
                q, stack(k), stack(v), n_valid,
                torch.arange(SPLIT_PIECES, device="cuda") * s_p,
                lambda t: t.amax(0, keepdim=True).expand_as(t),
                lambda t: t.sum(0, keepdim=True).expand_as(t))
            want = decode_attention(q, k, v, n_valid)
            err = check_close(torch, f"split_softmax {arch} {dtype}", got,
                              want, SPLIT_TOL[str(dtype)])
            rows.append({"arch": arch, "dtype": str(dtype), "q": [b, 1, hq, hd],
                         "cache": [b, slots, hkv, hd],
                         "pieces": SPLIT_PIECES,
                         "n_valid": n_valid.tolist(), "max_abs_err": err,
                         "tol": SPLIT_TOL[str(dtype)]})
    log({"phase": "distributed_split_softmax", "cases": rows})


# the scans on the blocks a 2-rank model axis holds: the RG-LRU on
# channel halves, the WKV on head halves, each a contiguous copy
SPLIT_SCAN_RANKS = 2


def _halves(tensors, dim):
    """Each rank's contiguous block of every tensor, split on ``dim``."""
    return [[t.chunk(SPLIT_SCAN_RANKS, dim)[i].contiguous()
             for t in tensors] for i in range(SPLIT_SCAN_RANKS)]


def split_scan_cases(torch):
    """The recurrences on the blocks a 2-rank model axis would hold
    (``act_rnn``: the channels, or the heads, split in two), the only
    place the card runs them split (at world size 1 nothing is):
    ``rglru_scan`` and ``rglru_scan_bwd`` at the hybrid's training shape
    (1, 4096, 2560) on the two channel halves, fp32, stitched back equal
    to the whole call bit for bit (both are per channel); the WKV
    forward with its chunk states at the ssm's (1, 4096, 40, 64) on the
    two halves of the heads, bit for bit (per head); its reverse bit for
    bit where ``bwd_segments`` cuts the half as the whole, else within
    ``WKV_BWD_RTOL`` of each gradient's largest element (the segments
    join in another order, and du sums the same terms in another order),
    both segment counts logged."""
    from repro_torch.kernels.rglru_scan import rglru_scan as rs
    from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv as wk

    dev = torch.device("cuda")
    b, s, w = HYBRID_TRAIN_BATCH, HYBRID_TRAIN_SEQ, 2560
    g = torch.Generator(device=dev).manual_seed(11)
    a = 0.85 + 0.149 * torch.rand((b, s, w), generator=g, device=dev)
    x = 0.1 * torch.randn((b, s, w), generator=g, device=dev)
    dh = torch.randn((b, s, w), generator=g, device=dev)
    whole = (rs.rglru_scan(a, x),)
    whole += rs.rglru_scan_bwd(a, whole[0], dh)[:2]
    parts = []
    for ah, xh, dhh in _halves((a, x, dh), 2):
        hh = rs.rglru_scan(ah, xh)
        parts.append((hh, *rs.rglru_scan_bwd(ah, hh, dhh)[:2]))
    rows = [{"kernel": "rglru_scan", "shape": [b, s, w],
             "split": f"channels / {SPLIT_SCAN_RANKS}",
             **{name: torch.equal(torch.cat([p[i] for p in parts], 2),
                                  whole[i])
                for i, name in enumerate(("h", "da", "db"))}}]
    del a, x, dh, whole, parts

    b, s, h, n = SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, 40, 64
    r, k, v, logw, u, do, _, _ = _wkv_bwd_inputs(torch, b, s, h, n, False,
                                                 (-6.0, -1.0), 17)
    fwd = wk.rwkv6_wkv(r, k, v, logw, u, states=True)
    bwd = wk.rwkv6_wkv_bwd(r, k, v, logw, u, do, fwd[2])[:5]
    parts_f, parts_b = [], []
    for rh, kh, vh, lh, doh, uh in zip(
            *zip(*_halves((r, k, v, logw, do), 2)),
            (c.contiguous() for c in u.chunk(SPLIT_SCAN_RANKS, 0))):
        f = wk.rwkv6_wkv(rh, kh, vh, lh, uh, states=True)
        parts_f.append(f)
        parts_b.append(wk.rwkv6_wkv_bwd(rh, kh, vh, lh, uh, doh, f[2])[:5])
    fwd_same = {name: torch.equal(torch.cat([p[i] for p in parts_f], d),
                                  fwd[i])
                for i, (name, d) in enumerate((("o", 2), ("state", 1),
                                               ("chunk_states", 1)))}
    segs = (wk.bwd_segments(b, s, h, n)[0],
            wk.bwd_segments(b, s, h // SPLIT_SCAN_RANKS, n)[0])
    errs, rel, same = {}, {}, {}
    for i, (name, d) in enumerate((("dr", 2), ("dk", 2), ("dv", 2),
                                   ("dlogw", 2), ("du", 0))):
        got = torch.cat([p[i] for p in parts_b], d)
        same[name] = torch.equal(got, bwd[i])
        err = (got - bwd[i]).abs()
        errs[name] = err.max().item()
        rel[name] = errs[name] / bwd[i].abs().max().item()
        lim = WKV_BWD_RTOL * (bwd[i].abs().max() + bwd[i].abs())
        if not bool((err <= lim).all()) or (segs[0] == segs[1]
                                            and not same[name]):
            raise AssertionError(f"split rwkv6_wkv_bwd {name}: the halves "
                                 f"differ from the whole call by "
                                 f"{errs[name]} (segments {segs})")
    rows.append({"kernel": "rwkv6_wkv", "shape": [b, s, h, n],
                 "split": f"heads / {SPLIT_SCAN_RANKS}", **fwd_same})
    rows.append({"kernel": "rwkv6_wkv_bwd", "shape": [b, s, h, n],
                 "split": f"heads / {SPLIT_SCAN_RANKS}",
                 "segments_whole": segs[0], "segments_half": segs[1],
                 "bit_identical": same, "max_abs_err": errs,
                 "max_err_of_largest": rel,
                 "rtol_of_largest": WKV_BWD_RTOL})
    log({"phase": "distributed_split_scans", "cases": rows})
    bad = [(row["kernel"], key) for row in rows[:2]
           for key, same_bits in row.items() if same_bits is False]
    if bad:
        raise AssertionError(f"split scans: {bad} differ from the whole "
                             f"call")
    del r, k, v, logw, u, do, fwd, bwd, parts_f, parts_b
    gc.collect()
    torch.cuda.empty_cache()


def _replay_ms(torch, graph, n: int) -> list:
    """Host wall of ``n`` replays of ``graph``, each synchronised (ms)."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def _greedy(torch, step, first_logits, n: int):
    """``n`` greedy steps of ``step(token) -> logits`` from
    ``first_logits``: each step's logits and the tokens fed, on the
    host, and each step's wall (ms)."""
    logits, outs, toks, walls = first_logits, [], [], []
    for _ in range(n):
        tok = logits.argmax(-1).to(torch.int32)
        toks.append(tok.cpu())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = step(tok)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        outs.append(logits.cpu())
    return outs, toks, walls


def dist_serve_shape(cfg):
    """(prompt positions, max_len, greedy steps) of a serving cell: the
    vlm's positions are its patches and 200 tokens, its cache holds them
    and the steps' tokens; whisper decodes past its ring."""
    if cfg.family == "vlm":
        seq = cfg.num_patches + DIST_SERVE_SEQ
        return seq, seq + DIST_SERVE_STEPS, DIST_SERVE_STEPS
    steps = (DIST_WHISPER_STEPS if cfg.family == "encdec"
             else DIST_SERVE_STEPS)
    return DIST_SERVE_SEQ, DIST_SERVE_MAX_LEN, steps


def dist_serve_prompt(torch, cfg, b: int, seq: int):
    """A host prompt batch of ``b`` rows and ``seq`` positions: tokens
    from a generator seeded with 7 (the vlm's seq - num_patches of
    them), then, from the same generator as ``train_batches`` draws
    them, the enc-dec family's ``frames`` (b, 1500, d) or the vlm's
    ``patches`` (b, num_patches, d) in bf16: rows that differ."""
    gen = torch.Generator().manual_seed(7)
    n_tok = seq - cfg.num_patches if cfg.family == "vlm" else seq
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, n_tok),
                                     generator=gen, dtype=torch.int32)}
    stub = {"encdec": ("frames", cfg.encoder_positions),
            "vlm": ("patches", cfg.num_patches)}.get(cfg.family)
    if stub:
        batch[stub[0]] = torch.randn((b, stub[1], cfg.d_model),
                                     generator=gen).to(torch.bfloat16)
    return batch


def unsharded_serve(torch, cfg, prompt, max_len: int, steps: int):
    """The unsharded path on weights drawn on the card from seed 0:
    ``model.prefill_fn`` of the host batch ``prompt`` as one captured
    graph (``StepGraph``) and a ``DecodeGraph`` over
    ``decode_step_inplace``, ``steps`` greedy steps; the logits, tokens
    and final cache on the host, the weights freed."""
    from repro_torch.models import model
    from repro_torch.models.init import init_params
    from repro_torch.serve.decode_graph import DecodeGraph
    from repro_torch.step_graph import StepGraph
    from repro_torch.tree import copy_tree_

    dev = torch.device("cuda")
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    b = prompt["tokens"].shape[0]
    pfn = model.prefill_fn(cfg, max_len)
    dfn = model.decode_inplace_fn(cfg)
    pre = {"params": params,
           "batch": {k: v.to(dev) for k, v in prompt.items()},
           "cache": model.init_cache(cfg, b, max_len, dev),
           "logits": torch.zeros((b, cfg.vocab_size), device=dev)}

    def prefill(bufs):
        logits, cache = pfn(bufs["params"], bufs["batch"])
        bufs["logits"].copy_(logits)
        copy_tree_(bufs["cache"], cache, "cache")

    pg = StepGraph(prefill, pre, dev, "graph")
    dec = {"params": params, "token": torch.zeros((b,), dtype=torch.int32,
                                                   device=dev),
           "cache": model.init_cache(cfg, b, max_len, dev),
           "logits": torch.zeros((b, cfg.vocab_size), device=dev)}

    def decode(bufs):
        bufs["logits"].copy_(dfn(bufs["params"], bufs["token"],
                                 bufs["cache"]))

    dg = DecodeGraph(decode, dec, dev, "graph")
    pg()
    prefill_ms = _replay_ms(torch, pg, 3)
    first = pre["logits"].clone()
    copy_tree_(dec["cache"], pre["cache"], "cache")

    def step(tok):
        dec["token"].copy_(tok)
        dg()
        return dec["logits"]

    outs, toks, walls = _greedy(torch, step, first, steps)
    out = {"logits": [first.cpu()] + outs, "tokens": toks,
           "cache": _host(dec["cache"]),
           "row": {"prefill_ms": float(sum(prefill_ms) / len(prefill_ms)),
                   "prefill_ms_all": prefill_ms,
                   "decode_ms": float(sum(walls[1:]) / (len(walls) - 1)),
                   "capture_s": pg.capture_s + dg.capture_s,
                   "capture_gb": (pg.capture_bytes + dg.capture_bytes) / 1e9,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}}
    del params, pre, dec, pg, dg, first, outs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sharded_vs_unsharded_serve(torch, cfg, mesh, phase: str):
    """Phase 13's serving cell (the module note): the unsharded path
    first (:func:`unsharded_serve`), then the same weights drawn again on
    the card and shared, without a copy, by a captured
    ``ShardedPrefillStep`` and a captured
    ``ShardedDecodeStep``: the prefill, the cache loaded, the same
    greedy steps.  Every logit, token and cache leaf must be
    bit-identical; the line gives both paths' prefill and decode-step ms
    and their ratios, the sharded capture seconds and pool bytes, the
    peaks, one decode step's collectives by kind and the kernels'
    launches (exact per direct call; replays counted).  The shapes are
    :func:`dist_serve_shape`'s, the prompt :func:`dist_serve_prompt`'s
    (with whisper's frames or llava's patches); whisper's cell also
    checks that every row decoded past its ring.  Returns the launches
    made."""
    from repro_torch.launch.strategy import (ShardedDecodeStep,
                                             ShardedPrefillStep)
    from repro_torch.models.init import init_params
    from repro_torch.tree import flatten

    gc.collect()
    torch.cuda.empty_cache()
    at_start = {"allocated": torch.cuda.memory_allocated() / 1e9,
                "reserved": torch.cuda.memory_reserved() / 1e9}
    t_cell = time.perf_counter()
    b = DIST_SERVE_BATCH
    seq, max_len, steps = dist_serve_shape(cfg)
    prompt = dist_serve_prompt(torch, cfg, b, seq)
    torch.cuda.reset_peak_memory_stats()
    ref = unsharded_serve(torch, cfg, prompt, max_len, steps)
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda")
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    reset_counts()
    t0 = time.perf_counter()
    pre = ShardedPrefillStep(cfg, mesh, params, b, seq, max_len, "graph")
    dec = ShardedDecodeStep(cfg, mesh, params, b, max_len, "graph")
    build_s = time.perf_counter() - t0
    peak_build = torch.cuda.max_memory_allocated() / 1e9
    pre(prompt)
    prefill_ms = _replay_ms(torch, pre.graph, 3)
    first = pre.logits.clone()
    dec.load_cache(pre.cache)
    outs, toks, walls = _greedy(torch, dec, first, steps)
    counts, tc_counts = read_counts(), read_tc_counts()
    n_moe = cfg.num_layers - cfg.first_k_dense if cfg.num_experts else 0
    n_attn = n_attention_layers(cfg)
    per_pre = {"flash_attention": n_attn, "moe_gmm": 3 * n_moe,
               "rglru_scan": (cfg.num_layers - n_attn
                              if cfg.family == "hybrid" else 0),
               "rwkv6_wkv": cfg.num_layers if cfg.family == "ssm" else 0}
    # whisper's decode step runs flash in each decoder layer's
    # cross-attention (one query against the 1500 encoder states)
    per_dec = {"flash_attention": (cfg.num_layers if cfg.family == "encdec"
                                   else 0),
               "moe_gmm": 3 * n_moe, "rglru_scan": 0, "rwkv6_wkv": 0}
    pg, dg = pre.graph, dec.graph
    want = {k: pg.calls * per_pre[k] + dg.calls * per_dec[k]
            for k in DIST_SERVE_KERNELS}
    got = {k: counts[k] for k in DIST_SERVE_KERNELS}
    if got != want or {k: tc_counts[k] for k in TC_KERNELS} != {
            k: want[k] for k in TC_KERNELS}:
        raise AssertionError(f"{phase}: launches {got} (tensor cores "
                             f"{tc_counts}), want {want} per direct call")
    launches = {k: (pg.calls + pg.replays) * per_pre[k]
                + (dg.calls + dg.replays) * per_dec[k]
                for k in DIST_SERVE_KERNELS}
    cache = _local_host(dec.cache)
    logits = [first.cpu()] + outs
    differ = [f"logits {i}" for i, (x, y) in enumerate(
        zip(ref["logits"], logits)) if not torch.equal(x, y)]
    differ += [f"token {i}" for i, (x, y) in enumerate(
        zip(ref["tokens"], toks)) if not torch.equal(x, y)]
    names = flatten(_leaf_names(cache))[0]
    differ += [f"cache {n}" for n, x, y in zip(
        names, flatten(ref["cache"])[0], flatten(cache)[0])
        if not torch.equal(x, y)]
    # whisper: each row's last write went past its ring's end (wrapped)
    ring_crossed = (bool((cache["pos"] > cache["ring"]).all())
                    if "ring" in cache else None)
    c = dec.collectives.stats()
    row = {"prefill_ms": float(sum(prefill_ms) / len(prefill_ms)),
           "prefill_ms_all": prefill_ms,
           "decode_ms": float(sum(walls[1:]) / (len(walls) - 1)),
           "build_s": build_s,
           "prefill_capture_s": pg.capture_s,
           "decode_capture_s": dg.capture_s,
           "prefill_capture_gb": pg.capture_bytes / 1e9,
           "decode_capture_gb": dg.capture_bytes / 1e9,
           "peak_build_gb": peak_build,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "decode_collectives": {"count_by_kind": c.count_by_kind,
                                  "bytes_by_kind": c.bytes_by_kind},
           "prefill_collectives": pre.collectives.stats().count_by_kind}
    log({"phase": phase, "arch": cfg.name, "num_layers": cfg.num_layers,
         "param_dtype": str(cfg.param_dtype), "moe_impl": cfg.moe_impl,
         "batch": b, "seq": seq, "max_len": max_len, "steps": steps,
         "ring_crossed": ring_crossed,
         "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
         "at_start_gb": at_start, "unsharded": ref["row"], "sharded": row,
         "prefill_ms_ratio": row["prefill_ms"] / ref["row"]["prefill_ms"],
         "decode_ms_ratio": row["decode_ms"] / ref["row"]["decode_ms"],
         "launches_per_call": {"prefill": per_pre, "decode": per_dec},
         "launches": launches, "identical": not differ,
         "differ": differ[:20], "cache_leaves": len(names),
         "seconds": time.perf_counter() - t_cell})
    if differ:
        raise AssertionError(f"{phase}: the sharded steps differ from the "
                             f"unsharded path in {len(differ)} places: "
                             f"{differ[:20]}")
    if ring_crossed is False:
        raise AssertionError(f"{phase}: rows at {cache['pos'].tolist()} did "
                             f"not decode past their rings "
                             f"{cache['ring'].tolist()}")
    if cfg.num_experts and cfg.moe_impl == "ep" and not c.count_by_kind.get(
            "all-to-all"):
        raise AssertionError(f"{phase}: no all-to-all in the EP decode "
                             f"step's collectives {c.count_by_kind}")
    del pre, dec, params, ref, cache, logits, outs
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def distributed_serve(torch, mesh, cells):
    """Phase 13's serving sub-phase: the split softmax and the split scans
    held on the card, then each (cfg, phase) of ``cells`` (smollm-135m,
    deepseek-moe-16b, recurrentgemma-2b, rwkv6-3b, whisper-medium,
    llava-next-mistral-7b) through the sharded prefill and decode steps
    against the unsharded path; returns the launches made."""
    t0 = time.perf_counter()
    split_softmax_cases(torch)
    split_scan_cases(torch)
    launches = {}
    for cfg, phase in cells:
        for k, n in sharded_vs_unsharded_serve(torch, cfg, mesh,
                                               phase).items():
            launches[k] = launches.get(k, 0) + n
    missing = [k for k in DIST_SERVE_KERNELS if not launches.get(k)]
    log({"phase": "distributed_serve", "seconds": time.perf_counter() - t0,
         "launches": launches})
    if missing:
        raise AssertionError(f"distributed_serve: {missing} never launched")
    return launches


def distributed(torch, train_cells, serve_cells):
    """Phase 13 (the module note): the training cells ((cfg, batch, seq,
    phase) each) and the serving sub-phase (``serve_cells``, (cfg, phase)
    each) on a 1 x 1 mesh through NCCL; returns the launches made and
    each training cell's sharded argument bytes (its static state plus
    batch, by phase)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_dev_mesh

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    init_s = init_distributed()
    done = False
    try:
        mesh = make_dev_mesh(1, 1)
        log({"phase": "distributed_init", "nccl_init_s": init_s,
             "mesh_s": time.perf_counter() - t0 - init_s,
             "backend": dist.get_backend(),
             "world_size": dist.get_world_size(),
             "nccl_version": torch.cuda.nccl.version(),
             "at_start_gb": {
                 "allocated": torch.cuda.memory_allocated() / 1e9,
                 "reserved": torch.cuda.memory_reserved() / 1e9}})
        launches, sharded, arg_bytes = {}, {}, {}
        for cfg, b, s, phase in train_cells:
            both, own, arg_bytes[phase] = sharded_vs_train_step(
                torch, cfg, b, s, mesh, phase)
            for k, n in both.items():
                launches[k] = launches.get(k, 0) + n
            for k, n in own.items():
                sharded[k] = sharded.get(k, 0) + n
        missing = [k for k in DIST_KERNELS if not sharded.get(k)]
        log({"phase": "distributed", "seconds": time.perf_counter() - t0,
             "launches": {k: launches.get(k, 0) for k in DIST_KERNELS},
             "sharded_launches": {k: sharded.get(k, 0)
                                  for k in DIST_KERNELS}})
        if missing:
            raise AssertionError(f"distributed: {missing} never launched "
                                 f"inside the sharded steps")
        for k, n in distributed_serve(torch, mesh, serve_cells).items():
            launches[k] = launches.get(k, 0) + n
        done = True
    finally:
        # on a failure the traceback ends the run: destroying the group
        # could wait forever on NCCL work that a failed capture left
        # unlaunched
        if done:
            dist.destroy_process_group()
    return launches, arg_bytes


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log({"torch": torch.__version__, "cuda": torch.version.cuda,
         "device": torch.cuda.get_device_name(0),
         "count": torch.cuda.device_count()})
    t_start = t0 = time.perf_counter()
    # phase 12's host work, beside the build on the host cores it leaves
    # idle, joined before any timed phase
    host_work = [start_host_work("dryrun_mesh_records"),
                 start_host_work("analysis_counts")]
    part_builds = start_gmm_bwd_part_builds()
    try:
        reports = _build.build()
    except BaseException:
        for proc, *_ in [*part_builds.values(), *host_work]:
            proc.kill()
            proc.wait()
        raise
    gmm_bwd_parts = gmm_bwd_part_entries(part_builds)
    build_s = time.perf_counter() - t0
    dry_recs, counts = (join_host_work(w) for w in host_work)
    log({"phase": "build", "seconds": build_s,
         "host_work": {w: {k: r[k] for k in ("subprocess_s", "waited_s")}
                       for w, r in (("dryrun_mesh_records", dry_recs),
                                    ("analysis_counts", counts))},
         "ptxas": {k: [ln.strip() for ln in v.splitlines()
                       if "Used" in ln or "spill" in ln]
                   for k, v in reports.items()}})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    floor_ms = launch_floor(torch)
    flash = flash_cases(torch)
    paged = paged_cases(torch)
    gmm = gmm_cases(torch)
    scan = rglru_cases(torch, floor_ms)
    wkv = wkv_cases(torch)

    cfg = get_config("smollm-135m")
    if cfg.compute_dtype != torch.bfloat16 or cfg.num_layers != 30:
        raise AssertionError(f"smollm-135m is not at full width: {cfg}")
    c_cli, _ = serve_cli(cfg)
    c_eng, params, serving = serve_engine(torch, cfg, 24, 64, "serve_engine")
    graph_vs_eager(torch, cfg, params)
    prefill_graph_vs_eager(torch, cfg, params)
    logits_kernel_vs_plain(torch, cfg, params, serving, LOGIT_ATOL)
    del params, serving
    gc.collect()
    torch.cuda.empty_cache()
    # the static engine through the CLI, and arrival-shaped streams
    c_static = serve_static(torch, cfg, None, 16, 64, cli=True)
    c_arrival = serve_cli_arrival(cfg)

    # the reference's serve_bf16 variant: 32.8 GB of bf16 params
    ds = dataclasses.replace(get_config("deepseek-moe-16b"),
                             param_dtype=torch.bfloat16)
    if (ds.num_layers, ds.d_model, ds.num_experts, ds.experts_per_token,
            ds.num_shared_experts, ds.first_k_dense, ds.vocab_size) != (
            28, 2048, 64, 6, 2, 1, 102400):
        raise AssertionError(f"deepseek-moe-16b is not at full width: {ds}")
    c_ds, params, serving = serve_engine(torch, ds, 12, 48,
                                         "serve_engine_deepseek")
    graph_vs_eager(torch, ds, params)
    prefill_graph_vs_eager(torch, ds, params)
    logits_kernel_vs_plain(torch, ds, params, serving, None)
    del params, serving
    gc.collect()
    torch.cuda.empty_cache()

    # granite-3-8b at its published widths, fp32 params (33.5 GB) and bf16
    # compute: the cast tree (17.1 GB) is freed before graph_vs_eager and
    # the static server each cast their own from the raw tree, so the
    # card never holds two cast trees beside it
    gr = get_config("granite-3-8b")
    if (gr.num_layers, gr.d_model, gr.num_heads, gr.num_kv_heads,
            gr.head_dim, gr.d_ff, gr.vocab_size, gr.compute_dtype,
            gr.param_dtype) != (40, 4096, 32, 8, 128, 12800, 49155,
                                torch.bfloat16, torch.float32):
        raise AssertionError(f"granite-3-8b is not at full width: {gr}")
    c_gr, params, serving = serve_engine(torch, gr, 12, 48,
                                         "serve_engine_granite")
    logits_kernel_vs_plain(torch, gr, params, serving, None)
    del serving
    gc.collect()
    torch.cuda.empty_cache()
    graph_vs_eager(torch, gr, params)
    prefill_graph_vs_eager(torch, gr, params)
    add_counts(c_static, serve_static(torch, gr, params))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # the recurrent families, fp32 params and bf16 compute, per-slot path
    rg = get_config("recurrentgemma-2b")
    if (rg.num_layers, rg.d_model, rg.num_heads, rg.num_kv_heads,
            rg.head_dim, rg.lru_width, rg.vocab_size, rg.compute_dtype) != (
            26, 2560, 10, 1, 256, 2560, 256000, torch.bfloat16):
        raise AssertionError(f"recurrentgemma-2b is not at full width: {rg}")
    c_rg, params, serving = serve_engine(torch, rg, 12, 48,
                                         "serve_engine_recurrentgemma")
    graph_vs_eager(torch, rg, params)
    prefill_graph_vs_eager(torch, rg, params)
    logits_kernel_vs_plain(torch, rg, params, serving, None)
    add_counts(c_static, serve_static(torch, rg, params))
    del params, serving
    gc.collect()
    torch.cuda.empty_cache()
    rw = get_config("rwkv6-3b")
    if (rw.num_layers, rw.d_model, rw.rwkv_heads, rw.d_ff, rw.vocab_size,
            rw.compute_dtype) != (32, 2560, 40, 8960, 65536, torch.bfloat16):
        raise AssertionError(f"rwkv6-3b is not at full width: {rw}")
    c_rw, params, serving = serve_engine(torch, rw, 12, 48,
                                         "serve_engine_rwkv6")
    graph_vs_eager(torch, rw, params)
    prefill_graph_vs_eager(torch, rw, params)
    logits_kernel_vs_plain(torch, rw, params, serving, None)
    add_counts(c_static, serve_static(torch, rw, params))
    del params, serving
    gc.collect()
    torch.cuda.empty_cache()

    # phase 5b: the enc-dec and VLM families at their published widths,
    # fp32 params and bf16 compute, per-slot path; as for granite, the
    # logit check runs first and its cast tree is freed before the
    # executors of graph_vs_eager and the static server cast their own
    wh = get_config("whisper-medium")
    if (wh.encoder_layers, wh.num_layers, wh.encoder_positions, wh.d_model,
            wh.num_heads, wh.num_kv_heads, wh.head_dim, wh.d_ff,
            wh.vocab_size, wh.compute_dtype, wh.param_dtype) != (
            24, 24, 1500, 1024, 16, 16, 64, 4096, 51865, torch.bfloat16,
            torch.float32):
        raise AssertionError(f"whisper-medium is not at full width: {wh}")
    c_wh, params, serving = serve_engine(torch, wh, 12, 48,
                                         "serve_engine_whisper")
    logits_kernel_vs_plain(torch, wh, params, serving, None)
    del serving
    gc.collect()
    torch.cuda.empty_cache()
    graph_vs_eager(torch, wh, params)
    prefill_graph_vs_eager(torch, wh, params)
    add_counts(c_static, serve_static(torch, wh, params))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    ll = get_config("llava-next-mistral-7b")
    if (ll.num_layers, ll.d_model, ll.num_heads, ll.num_kv_heads,
            ll.head_dim, ll.d_ff, ll.vocab_size, ll.num_patches,
            ll.compute_dtype, ll.param_dtype) != (
            32, 4096, 32, 8, 128, 14336, 32000, 1152, torch.bfloat16,
            torch.float32):
        raise AssertionError(f"llava-next-mistral-7b is not at full width: "
                             f"{ll}")
    # max_len holds the patches, the longest prompt and its new tokens,
    # so the ring keeps every patch
    c_ll, params, serving = serve_engine(
        torch, ll, 12, 48, "serve_engine_llava",
        max_len=ll.num_patches + 300 + 48)
    logits_kernel_vs_plain(torch, ll, params, serving, None)
    del serving
    gc.collect()
    torch.cuda.empty_cache()
    graph_vs_eager(torch, ll, params)
    prefill_graph_vs_eager(torch, ll, params)
    add_counts(c_static, serve_static(torch, ll, params))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # phase 6: training smollm-135m at full width
    flash_train = flash_train_fwd_cases(torch)
    flash_bwd = flash_bwd_cases(torch)
    train_grads_kernel_vs_plain(torch, cfg)
    train_head(torch, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    c_train, m_train = train_runs(torch, cfg)

    # phase 7: training deepseek-moe-16b at its published widths, depth
    # cut 28 -> 2 (the dense first layer and one MoE layer)
    dst = dataclasses.replace(get_config("deepseek-moe-16b"),
                              num_layers=MOE_TRAIN_LAYERS)
    if (dst.d_model, dst.num_heads, dst.head_dim, dst.num_experts,
            dst.experts_per_token, dst.d_ff, dst.num_shared_experts,
            dst.first_k_dense, dst.vocab_size, dst.compute_dtype,
            dst.param_dtype) != (2048, 16, 128, 64, 6, 1408, 2, 1, 102400,
                                 torch.bfloat16, torch.float32):
        raise AssertionError(f"deepseek-moe-16b is not at full width: {dst}")
    gmm_bwd, gmm_train = gmm_bwd_cases(torch, gmm_bwd_parts,
                                       reports.get("moe_gmm_bwd", ""))
    train_grads_kernel_vs_plain(torch, dst, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ)
    gc.collect()
    torch.cuda.empty_cache()
    c_train_moe, m_train_moe = train_cut_runs(
        torch, dst, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, "train_moe")
    gc.collect()
    torch.cuda.empty_cache()

    # phase 8: training recurrentgemma-2b at its published widths, depth
    # cut 26 -> 6 (layers 0-5: two periods of RG-LRU, RG-LRU, attention)
    hyb = dataclasses.replace(get_config("recurrentgemma-2b"),
                              num_layers=HYBRID_TRAIN_LAYERS)
    if (hyb.d_model, hyb.num_heads, hyb.num_kv_heads, hyb.head_dim,
            hyb.d_ff, hyb.lru_width, hyb.attention_window, hyb.vocab_size,
            hyb.compute_dtype, hyb.param_dtype, hyb.remat) != (
            2560, 10, 1, 256, 7680, 2560, 2048, 256000, torch.bfloat16,
            torch.float32, True):
        raise AssertionError(f"recurrentgemma-2b is not at full width: "
                             f"{hyb}")
    scan_bwd = rglru_bwd_cases(torch)
    scan_train = rglru_cases(torch, floor_ms, RGLRU_TRAIN_SHAPES)
    flash_fwd_hyb = flash_train_fwd_cases(torch, (FLASH_FWD_HYBRID_CASE,),
                                          expand_kv=True)
    flash_bwd_hyb = flash_bwd_cases(torch, FLASH_BWD_HYBRID_CASES,
                                    expand_kv=True,
                                    ptxas_report=reports.get(
                                        "flash_attention_bwd", ""))
    train_grads_kernel_vs_plain(torch, hyb, HYBRID_TRAIN_BATCH,
                                HYBRID_TRAIN_SEQ, must_move=SCAN_LEAVES)
    gc.collect()
    torch.cuda.empty_cache()
    c_train_hyb, m_train_hyb = train_cut_runs(
        torch, hyb, HYBRID_TRAIN_BATCH, HYBRID_TRAIN_SEQ, "train_hybrid")
    gc.collect()
    torch.cuda.empty_cache()

    # phase 9: training rwkv6-3b at its published widths, depth cut 32 -> 8
    ssm = dataclasses.replace(get_config("rwkv6-3b"),
                              num_layers=SSM_TRAIN_LAYERS)
    if (ssm.d_model, ssm.rwkv_heads, ssm.rwkv_head_dim, ssm.d_ff,
            ssm.vocab_size, ssm.compute_dtype, ssm.param_dtype,
            ssm.remat) != (2560, 40, 64, 8960, 65536, torch.bfloat16,
                           torch.float32, True):
        raise AssertionError(f"rwkv6-3b is not at full width: {ssm}")
    wkv_bwd, wkv_train = wkv_bwd_cases(torch, reports.get("rwkv6_wkv", ""))
    train_grads_kernel_vs_plain(
        torch, dataclasses.replace(ssm, num_layers=SSM_GRAD_LAYERS),
        SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, must_move=WKV_LEAVES)
    gc.collect()
    torch.cuda.empty_cache()
    c_train_ssm, m_train_ssm = train_cut_runs(
        torch, ssm, SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, "train_ssm")
    gc.collect()
    torch.cuda.empty_cache()

    # phase 10: training whisper-medium at its published widths and full
    # depth, 8 x 448 tokens beside 8 x 1500 frames
    wht = get_config("whisper-medium")
    if (wht.encoder_layers, wht.num_layers, wht.encoder_positions,
            wht.d_model, wht.num_heads, wht.num_kv_heads, wht.head_dim,
            wht.d_ff, wht.vocab_size, wht.compute_dtype, wht.param_dtype,
            wht.remat) != (24, 24, 1500, 1024, 16, 16, 64, 4096, 51865,
                           torch.bfloat16, torch.float32, True):
        raise AssertionError(f"whisper-medium is not at full width: {wht}")
    flash_fwd_wh = flash_train_fwd_cases(torch, FLASH_ENCDEC_CASES)
    flash_bwd_wh = flash_bwd_cases(torch, FLASH_ENCDEC_CASES)
    train_grads_kernel_vs_plain(torch, wht, ENCDEC_TRAIN_BATCH,
                                ENCDEC_TRAIN_SEQ, must_move=ENCDEC_LEAVES)
    gc.collect()
    torch.cuda.empty_cache()
    c_train_encdec, m_train_encdec = train_cut_runs(
        torch, wht, ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ, "train_encdec")
    gc.collect()
    torch.cuda.empty_cache()

    # phase 11: training llava-next-mistral-7b at its published widths,
    # depth cut 32 -> 5, one stream of 1152 patches and 2,944 tokens
    llt = dataclasses.replace(get_config("llava-next-mistral-7b"),
                              num_layers=VLM_TRAIN_LAYERS)
    if (llt.d_model, llt.num_heads, llt.num_kv_heads, llt.head_dim,
            llt.d_ff, llt.vocab_size, llt.num_patches, llt.compute_dtype,
            llt.param_dtype, llt.remat) != (
            4096, 32, 8, 128, 14336, 32000, 1152, torch.bfloat16,
            torch.float32, True):
        raise AssertionError(f"llava-next-mistral-7b is not at full width: "
                             f"{llt}")
    flash_fwd_ll = flash_train_fwd_cases(torch, FLASH_VLM_CASES)
    flash_bwd_ll = flash_bwd_cases(torch, FLASH_VLM_CASES)
    train_grads_kernel_vs_plain(torch, llt, VLM_TRAIN_BATCH, VLM_TRAIN_SEQ,
                                must_move=VLM_LEAVES)
    gc.collect()
    torch.cuda.empty_cache()
    c_train_vlm, m_train_vlm = train_cut_runs(
        torch, llt, VLM_TRAIN_BATCH, VLM_TRAIN_SEQ, "train_vlm")
    gc.collect()
    torch.cuda.empty_cache()

    # phase 12: the compile-time analysis of the six training cells (its
    # counts and the dry run's mesh records were made beside the build)
    analysis(torch, [m_train, m_train_moe, m_train_hyb, m_train_ssm,
                     m_train_encdec, m_train_vlm], counts)

    # phase 13: the sharded steps through NCCL at world size 1
    bf16_params = {"param_dtype": torch.bfloat16}
    c_dist, dist_arg_bytes = distributed(torch, (
        (cfg, TRAIN_BATCH, TRAIN_SEQ, "distributed_smollm"),
        (dataclasses.replace(dst, moe_impl="ep"), MOE_TRAIN_BATCH,
         MOE_TRAIN_SEQ, "distributed_deepseek_ep"),
        (dataclasses.replace(hyb, num_layers=DIST_HYBRID_LAYERS),
         HYBRID_TRAIN_BATCH, HYBRID_TRAIN_SEQ, "distributed_hybrid"),
        (dataclasses.replace(ssm, num_layers=DIST_SSM_LAYERS),
         SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, "distributed_ssm"),
        (dataclasses.replace(wht, encoder_layers=DIST_ENCDEC_LAYERS,
                             num_layers=DIST_ENCDEC_LAYERS),
         ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ, "distributed_encdec"),
        (dataclasses.replace(llt, num_layers=DIST_VLM_LAYERS),
         VLM_TRAIN_BATCH, VLM_TRAIN_SEQ, "distributed_vlm")), (
        (cfg, "distributed_serve_smollm"),
        (dataclasses.replace(ds, moe_impl="ep"),
         "distributed_serve_deepseek_ep"),
        (dataclasses.replace(rg, **bf16_params),
         "distributed_serve_recurrentgemma"),
        (dataclasses.replace(rw, **bf16_params),
         "distributed_serve_rwkv6"),
        (dataclasses.replace(wh, **bf16_params),
         "distributed_serve_whisper"),
        (dataclasses.replace(ll, **bf16_params),
         "distributed_serve_llava")))
    dryrun_mesh(dry_recs, dist_arg_bytes["distributed_smollm"])

    # the summary: the main paths' shapes and dtypes (bf16 flash at the
    # longest smollm prompt, bf16 paged at smollm's mixed batch, the bf16
    # grouped matmul at deepseek's decode and its backward at deepseek's
    # training wi / wg product, both fp32 scans at their models'
    # 300-token prefill, both reverses at their training shapes) with the
    # launches of every serving and training run
    runs = (c_cli, c_eng, c_static, c_arrival, c_ds, c_gr, c_rg, c_rw,
            c_wh, c_ll, c_train, c_train_moe, c_train_hyb, c_train_ssm,
            c_train_encdec, c_train_vlm, c_dist)

    def summary(rows, name, source, replaces, pick):
        r = [x for x in rows if pick(x)][0]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "instance": r.get("instance", "cuda_core"),
                "launches": sum(c.get(name, 0) for c in runs),
                "max_abs_err": max(x["max_abs_err"] for x in rows
                                   if x["dtype"] == r["dtype"]),
                "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"]}

    def case(rows, pick, keys=()):
        """One case line's shape ``keys`` and its figures."""
        r = [x for x in rows if pick(x)][0]
        return {k: r[k] for k in (*keys, "max_abs_err", "kernel_ms",
                                  "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")}

    bf16, fp32 = "torch.bfloat16", "torch.float32"

    def granite(x, b):          # bf16 at granite-3-8b's heads, b rows
        return x["dtype"] == bf16 and x["hq"] == 32 and x["b"] == b

    log({"phase": "total", "seconds": time.perf_counter() - t_start})
    log({"kernels": [
        dict(summary(paged, "paged_attention",
                     "src/repro_torch/kernels/csrc/paged_attention.cu",
                     "src/repro/kernels/paged_attention/"
                     "paged_attention.py:110",
                     lambda x: x["dtype"] == bf16 and x["window"] == 0
                     and x["d"] == 64 and x["nb"] == 3),
             # granite-3-8b's decode: 8 rows, d 128, group 4, 3 pages
             granite_shape=case(paged, lambda x: granite(x, 8),
                                ("b", "hq", "hkv", "d", "nb"))),
        dict(summary(flash + flash_train + flash_fwd_hyb + flash_fwd_wh
                     + flash_fwd_ll, "flash_attention",
                     "src/repro_torch/kernels/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention/flash_attention.py:70",
                     lambda x: x["dtype"] == bf16 and x["sq"] == 300
                     and x["window"] == 0 and x["d"] == 64),
             # the training path's forward: bf16, 8 x 2048, with LSE
             train_shape={k: r[k] for k in (
                 "b", "sq", "lse_max_abs_err", "kernel_ms", "plain_ms",
                 "bound_ms", "bound_by", "library_ms")
                 for r in flash_train if r["dtype"] == bf16},
             # the hybrid's training forward: bf16, 1 x 4096, d 256,
             # group 10, window 2048
             hybrid_train_shape=case(
                 flash_fwd_hyb, lambda x: x["dtype"] == bf16,
                 ("b", "hq", "hkv", "d", "sq", "window", "lse_max_abs_err",
                  "library")),
             # the enc-dec and vlm training forwards with the LSE: bf16,
             # whisper's encoder, cross and decoder self attention at
             # batch 8, llava's 1 x 4096
             encdec_vlm_train_shapes=[
                 case(flash_fwd_wh + flash_fwd_ll,
                      lambda x, c=c: x["dtype"] == bf16 and x["case"] == c,
                      ("case", "b", "hq", "hkv", "d", "sq", "skv", "causal",
                       "lse_max_abs_err", "library"))
                 for c in ("whisper_encoder", "whisper_cross",
                           "whisper_decoder_self", "llava_train")],
             # granite-3-8b's prefills: one 300-token prompt (the
             # continuous engine), 8 x 200 (the static engine)
             granite_shape=[
                 case(flash, lambda x: granite(x, 1) and x["sq"] == 300,
                      ("b", "hq", "hkv", "d", "sq", "instance")),
                 case(flash, lambda x: granite(x, 8) and x["sq"] == 200,
                      ("b", "hq", "hkv", "d", "sq", "instance"))],
             # the static engine's batch-8 prefills of smollm-135m and
             # recurrentgemma-2b
             static_shape=[
                 case(flash, lambda x, hq=hq: x["dtype"] == bf16
                      and x["b"] == 8 and x["hq"] == hq,
                      ("b", "hq", "hkv", "d", "sq", "window", "instance"))
                 for hq in (9, 10)],
             # whisper-medium: the encoder and the cross-attention of one
             # decode query and of a 200-token prompt to the 1500 states,
             # non-causal, at batch 1 (the per-slot executor) and 8 (the
             # static server), and the static server's causal 8 x 200
             whisper_shape=[
                 case(flash, lambda x, b=b, sq=sq, skv=skv: x["dtype"] == bf16
                      and x["hq"] == 16 and x["d"] == 64 and x["b"] == b
                      and x["sq"] == sq and x["skv"] == skv,
                      ("b", "hq", "hkv", "d", "sq", "skv", "causal",
                       "instance", "kernel_call_ms"))
                 for b in (1, 8) for sq, skv in ((1500, 1500), (1, 1500),
                                                 (200, 1500))]
             + [case(flash, lambda x: x["dtype"] == bf16 and x["hq"] == 16
                     and x["d"] == 64 and x["b"] == 8 and x["causal"]
                     and x["sq"] == 200,
                     ("b", "hq", "hkv", "d", "sq", "skv", "causal",
                      "instance", "kernel_call_ms"))],
             # llava-next-mistral-7b's prefill, 1152 patches + 200, at
             # batch 1 and 8
             llava_shape=[
                 case(flash, lambda x, b=b: x["dtype"] == bf16
                      and x["sq"] == FLASH_LLAVA_SQ and x["b"] == b,
                      ("b", "hq", "hkv", "d", "sq", "skv", "causal",
                       "instance"))
                 for b in (1, 8)]),
        # no Pallas kernel: the reference differentiates its XLA
        # attention; the line is the smollm training shape, with
        # recurrentgemma-2b's (d 256, group 10, window 2048), whisper's
        # three and llava's beside it
        dict(summary(flash_bwd + flash_bwd_hyb + flash_bwd_wh + flash_bwd_ll,
                     "flash_attention_bwd",
                     "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                     "src/repro/models/attention.py:52",
                     lambda x: x["dtype"] == bf16
                     and x["case"] == "smollm_train"),
             d256_shape=case(flash_bwd_hyb, lambda x: x["dtype"] == bf16,
                             ("b", "hq", "hkv", "d", "sq", "window",
                              "instance", "library", "launch_ms",
                              "ptxas", "sass_hgmma")),
             encdec_vlm_train_shapes=[
                 case(flash_bwd_wh + flash_bwd_ll,
                      lambda x, c=c: x["dtype"] == bf16 and x["case"] == c,
                      ("case", "b", "hq", "hkv", "d", "sq", "skv", "causal",
                       "instance", "library", "kernel_call_ms",
                       "fp32_cuda_core_ms"))
                 for c in ("whisper_encoder", "whisper_cross",
                           "whisper_decoder_self", "llava_train")]),
        dict(summary(gmm, "moe_gmm",
                     "src/repro_torch/kernels/csrc/moe_gmm.cu",
                     "src/repro/kernels/moe_gmm/moe_gmm.py:39",
                     lambda x: x["dtype"] == bf16
                     and x["case"] == "decode_wi"),
             # the training path's forward: the wi product at C = 960
             train_shape=case(gmm_train, lambda x: True,
                              ("e", "c", "k", "f", "filled_rows",
                               "instance"))),
        # no Pallas kernel: the reference differentiates the einsums of
        # its expert FFN; the line is the training wi / wg product
        dict(summary(gmm_bwd, "moe_gmm_bwd",
                     "src/repro_torch/kernels/csrc/moe_gmm_bwd.cu",
                     "src/repro/models/moe.py:64",
                     lambda x: x["dtype"] == bf16
                     and x["case"] == "train_wi"),
             **{k: r[k] for r in gmm_bwd
                if r["dtype"] == bf16 and r["case"] == "train_wi"
                for k in ("design", "sass_hgmma", "ptxas",
                          "kernel_split_ms")},
             wo_shape=case(gmm_bwd, lambda x: x["dtype"] == bf16
                           and x["case"] == "train_wo",
                           ("e", "c", "k", "f", "filled_rows",
                            "kernel_split_ms"))),
        # the static engine's batch-8 prefill of 200 tokens as batch8
        dict(summary(scan + scan_train, "rglru_scan",
                     "src/repro_torch/kernels/csrc/rglru_scan.cu",
                     "src/repro/kernels/rglru_scan/rglru_scan.py:45",
                     lambda x: x["dtype"] == fp32 and x["s"] == 300
                     and not x["h0"]),
             batch8=case(scan, lambda x: x["dtype"] == fp32
                         and x["b"] == 8, ("b", "s", "w")),
             # the hybrid's training forward, fp32, 1 x 4096, from zeros
             train_shape=case(scan_train, lambda x: x["dtype"] == fp32,
                              ("b", "s", "w"))),
        # no Pallas kernel: the reference differentiates its associative
        # scan; the line is the hybrid's training shape, fp32, from zeros
        summary(scan_bwd, "rglru_scan_bwd",
                "src/repro_torch/kernels/csrc/rglru_scan.cu",
                "src/repro/models/rglru.py:55",
                lambda x: x["dtype"] == fp32 and x["s"] == HYBRID_TRAIN_SEQ
                and not x["h0"]),
        dict(summary(wkv, "rwkv6_wkv",
                     "src/repro_torch/kernels/csrc/rwkv6_wkv.cu",
                     "src/repro/kernels/rwkv6_wkv/rwkv6_wkv.py:69",
                     lambda x: x["dtype"] == fp32 and x["s"] == 300
                     and x["decay"] == "usual"),
             batch8=case(wkv, lambda x: x["dtype"] == fp32 and x["b"] == 8,
                         ("b", "s", "h", "n")),
             # the ssm's training forward, 1 x 4096, with its chunk states
             train_shape={k: r[k] for r in wkv_train if r["chunk_states"]
                          for k in ("b", "s", "h", "n", "kernel_ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")}),
        # no Pallas kernel: the reference differentiates its chunked WKV;
        # the line is the ssm's training shape, fp32, from zeros
        dict(summary(wkv_bwd, "rwkv6_wkv_bwd",
                     "src/repro_torch/kernels/csrc/rwkv6_wkv.cu",
                     "src/repro/models/rwkv.py:75",
                     lambda x: x["case"] == "zeros"),
             **{k: r[k] for r in wkv_bwd if r["case"] == "zeros"
                for k in ("segments", "blocks", "blocks_per_sm",
                          "registers", "local_bytes", "launch_ms")},
             batch2=case(wkv_bwd, lambda x: x["case"] == "batch2",
                         ("b", "s", "h", "n", "segments", "blocks"))),
    ]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
