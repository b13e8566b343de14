#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (accelerate_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card (written for an H100), nvcc, and the repository around
this file; imports nothing of JAX and nothing of the JAX package. Phases, in
order; any failure exits non-zero:

1. environment: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; builds every kernel of ``accelerate_tpu_torch/ops/csrc`` (one
   nvcc per source, all at once) and prints each build's register and spill
   report.
2. kernel vs plain version: ``flash_fwd`` on a case matrix (the training
   and the main-path shapes in bf16; non-causal, window, segments, softcap
   with sm_scale, GQA rep 1/4/8, head_dim 64/80/96/128/256, fp16, fp32, ragged
   lengths such as S=1000 and B=3 x S=200, phase 14's families at the
   forward and 8 x 1024 backward shapes they run, and Gemma2-9B's attention,
   B=4 S=2048 H=16 G=8 D=256 with softcap 50 and sm_scale 256^-0.5, causal
   and with a 1024 window) against ``flash_fwd_reference`` on the same
   inputs, under the tolerances of ``TOLERANCE``, printing each case's route
   (``wgmma`` for 16-bit inputs at head_dim 64/80/96/128/256, else
   ``mma.sync``: the f32 cases hold ``mma.sync`` at 64 to 256); a repeat
   launch must be bit-identical. Then, at the training and the main-path
   shapes, both routes of the forward, each forced and held to the same
   tolerance with a repeat bit-identical, its plain version and
   ``F.scaled_dot_product_attention`` (the yardstick, never used by the
   port) timed beside the bound.
3. forward: ``LlamaForCausalLM`` at Llama-3-8B widths and full depth, bf16,
   random weights from a seeded generator, on 4 x 2048 tokens; the flash
   kernel must launch once per layer, on the wgmma route, and the logits
   must be finite. On a small input at the same widths, the flash forward is
   held against the einsum-attention forward, and the stacked-layer model
   built from the same weights against the sequential one.
4. generate: 4 prompts of 96/200/333/512 tokens, 32 new tokens each, greedy,
   bf16 KV cache; a repeat call must return the same tokens.
4b. speculative and beam-search decoding, on the same model:
   exactness first, at the same widths with 2 layers in f32 (TF32 off): on
   a prompt repeating a seeded 64-token snippet, ``prompt_lookup_generate``
   and ``assisted_generate`` (the model as its own draft, where every round
   accepts all K drafts, and a seeded 1-layer draft) equal greedy
   ``generate`` token for token, and so does ``beam_search_generate`` with
   one beam; each sampled decoder run twice from one generator seed gives
   the same tokens. Then at full depth in bf16 on a 512-token prompt (the
   snippet 8 times), 64 new tokens: tokens/s of plain ``generate``, of
   prompt lookup (ngram 2, K 5) and of assisted decoding with a seeded
   2-layer draft, with their rounds, mean accepted drafts a round and the
   prefix they share with ``generate`` (bf16 rounds a K+1-token chunk and a
   1-token step differently, so it is reported, not asserted); beam search
   with 4 beams on prompts of 200 and 333 tokens, 32 new: ms a step, the
   peak memory above the weights, and a repeat call identical; one
   profiled verify round beside one profiled decode step.
4c. the serving engine (``ServingEngine``: chunked prefill, paged KV,
   prefix cache, async ticks, each step a CUDA graph), on the same model:
   exactness first, at the same widths with 2 layers in f32 (TF32 off): 12
   staggered greedy requests (prompts of 5-700 tokens, 32 new) on 4 slots,
   dense and paged, sync and async, equal ``generate`` token for token; a
   repeated prompt restores its cached prefix and gives the same tokens;
   a pool sized to force a preemption gives token-exact streams; a sampled
   request gives the same tokens alone and beside others. Then at full depth
   in bf16, 8 slots x 2048 tokens, 256-token chunks, an external prefix cache
   (restores by copy): 24 requests from a seeded schedule (prompts of
   96-1536 tokens, half behind one shared 512-token prefix, 64-128 new)
   arriving over 1 s. No flash kernel launches, every step was captured
   once at warmup (decode, chunk, restore) and nothing after, every request
   completes. Reported: TTFT p50/p95, ITL p50/p99, decode tokens/s, host
   us a tick, prefix hits, peak pages in use, 4 streams' agreed prefix with
   batch-1 ``generate`` (bf16 rounds a batch-8 product otherwise: not
   asserted), and one steady tick (all slots) as a graph replay and eagerly,
   with a profiled replay's device busy share and kernel count.
4d. speculative, quantized and multi-tenant serving (see ``phase_serving_extras``).
4e. the serving fleet, on the same model: exactness first, at the same
   widths with 2 layers in f32: 2 replicas (4 slots x 768) behind the
   asyncio HTTP gateway with a ``FleetSupervisor``; 4c's 12 staggered greedy
   requests over HTTP, half as SSE streams; a ``ChaosSchedule`` kill of
   replica 0 at decode tick 12 mid-stream. Every stream equals ``generate``
   (the failed-over ones too), the supervisor restarts replica 0, which
   comes back HEALTHY and serves a stream equal to ``generate``. Then at
   full depth in bf16: 2 replicas sharing the weights, each 4c's shape (8
   slots x 2048, 256-token chunks and pages, async) with one shared prefix
   cache, behind the asyncio gateway and a supervisor; ``loadgen`` drives
   4c's 24-request schedule over HTTP (SSE), and a chaos kill of replica 0
   comes at decode tick 40. Every request ends 200 with its full token
   count, one or more fail over, replica 0 restarts HEALTHY, the survivor
   captures nothing after warmup, ``/metrics`` passes promlint, no flash
   kernel launches. Reported beside the card's name and power limit:
   loadgen's TTFT p50/p95 and ITL p50/p99 beside 4c's in-process ones,
   decode tokens/s summed over the replicas, each replica's graphed tick
   alone and while the other replays its own, the restart's seconds,
   device memory before the kill, at the restart's peak and after it, and
   the gateway loop thread's CPU microseconds per streamed token.
4f. big-model inference (``big_modeling``), on the same model: exactness
   first, at the same widths with 2 layers in f32: the model exported to an
   HF directory in 2 GB shards and loaded back by
   ``load_hf_checkpoint_and_dispatch`` all on the card, all in host memory,
   all on disk (lazy references into the shards), on an explicit mixed map
   and on the solver's ``"auto"`` map (card, host and disk); each tier's
   logits within ``BIG["exact_atol"]`` of the resident model's and its greedy
   tokens equal to ``generate``'s (32, or 8 where the head streams from
   disk); ``disk_offload`` with memmap copies; ``cpu_offload_with_hook``,
   after whose ``offload()`` no weights of it stay on the card; int8
   ``load_and_quantize_hf_checkpoint`` against its dequantized weights. Then
   at full depth in bf16: the resident model exported in 5 GB shards, and on
   each tier (card, host, disk, ``"auto"`` under ``max_memory={0: "8GiB"}``)
   the load's seconds, a 4 x 2048 forward (32 wgmma flash launches; the
   host tier also with ``prefetch=False``), batch-1 decode from a 512-token
   prompt (16 new, 4 on disk), and the peak card memory, which must stay
   within the resident weights + 2 x the largest streamed block + an
   allowance (the resident forward's own activation peak, +10 %), beside a
   plain pinned host-to-card copy of one layer's bytes. Free disk and
   ``MemAvailable`` are checked first.
5. profile: device time of one forward and of decode steps, by kernel kind
   (torch.profiler), and the device's busy share of the wall time.

2b (after 2). backward kernels vs plain version: ``flash_bwd`` (the dK/dV
   kernel and the dQ kernel, each on its own route, counted: 16-bit inputs
   at head_dim 64/80/96/128/256 run both on wgmma, f32 both on ``mma.sync``) on
   phase 2's case matrix against ``flash_bwd_reference`` on the same inputs
   under ``BWD_TOLERANCE``; a repeat launch must give bit-identical
   gradients. At the training and the main-path shapes: the dK/dV and the
   dQ kernel of each route (the two routes of each in turns, each forced and
   held to the tolerance), the plain backward and the SDPA backward (the
   yardstick) timed beside the bounds.
6. train (the Llama-3-8B model is freed first): the tier-1 model
   (``accelerate_tpu_torch.bench.run_bench``: hidden 2048, 10 layers, bf16
   over f32 masters, AdamW, fused LM-head loss, clip 1.0) for 3 + 20 steps on
   8 x 1024 tokens; exactly 10 forward, 10 dK/dV and 10 dQ launches a step,
   all on the wgmma route, finite losses that fall. At the same widths with
   2 layers in f32, the parameter gradients through the kernels (the
   mma.sync route: f32) against einsum attention; one step with remat
   gives the first step's loss with 2 forward launches a layer.
7. profile of one train step by kernel kind, and the device's busy share.
8. the training loop a user writes, on the tier-1 model with "dots" remat
   (bf16 over f32 masters, AdamW, a warmup-then-cosine ``LRScheduler``):
   a seeded corpus of 64-2048-token documents packed into 1024-token rows
   (``segment_ids``, ``positions``, ``labels``) read by a shuffled
   ``NumpyDataLoader`` of batch 8 with async prefetch; accumulation 2,
   ``backward``, ``clip_grad_norm_`` at the sync step, ``step``, for 6
   updates. The flash launches of that loop are counted (per microbatch two
   forward launches a layer, the forward recomputed under "dots", and one
   dK/dV and one dQ, all wgmma). A second run saves its state after update
   3 (``blocking=False``), a fresh one loads it, skips the 6 microbatches
   read and runs updates 4-6: bit-identical to the first run. The loop's
   first update against ``compile_train_step`` on the same two microbatches;
   a packed microbatch's loss through the kernels against einsum attention,
   and the kernels alone on its ``segment_ids`` against their plain
   versions under phase 2's tolerances;
   the peak memory of "dots" between "nothing" and no remat;
   ``find_executable_batch_size`` from 128 x 1024 tokens without remat,
   through at least one real ``torch.OutOfMemoryError``. The second update
   of the run that saves runs under ``Accelerator.profile``: its Chrome
   trace must name the three wgmma flash kernels. Times beside the card's
   name and power limit.

9. several processes (the earlier models freed), the first three
   subprocesses side by side: ``accelerate-tpu-torch env`` must name the
   card and the NCCL version;
   ``accelerate-tpu-torch test`` runs the omnibus script in a process group
   of one over NCCL ("All omnibus checks passed.", "1 process(es)");
   ``launch --num_processes 1`` runs the collectives script, every
   collective on CUDA tensors through NCCL, and every "... ok" line must
   appear. Then ``launch --num_processes 1 --mixed_precision bf16
   chip_smoke.py --multiprocess-child OUT`` trains the tier-1 model
   (``bench.build_train_step``: 3 + 10 steps in ``run_bench``'s batch
   order) inside the process group: NCCL at world size 1; 10 forward, 10
   dK/dV and 10 dQ launches a step, all wgmma, counted in the child; the
   gradient all-reduce once a step; and its 13 losses equal, bit for bit,
   the first 13 of phase 6's ``run_bench`` in this process without a
   process group. Reported beside the card's name and power limit: ms a
   step launched and here, the reduction's ms a step (timed alone in the
   child on the model's gradient shapes, CUDA events), the bucket count,
   the child's start-up seconds (launch to ``init_process_group`` done).
   ``main_multiprocess()`` runs it alone, with its own reference steps.
   A child's non-zero exit fails the phase with its last lines.

10. sharded training state (``parallel/sharding.py``, ``host_offload.py``):
   ``launch --num_processes 1 --mixed_precision bf16 chip_smoke.py
   --sharded-child OUT`` trains the tier-1 model at world size 1 over NCCL
   under ``FullyShardedDataParallelPlugin`` FULL_SHARD with activation
   checkpointing ("dots"), then SHARD_GRAD_OP, 3 + 10 steps each in
   ``run_bench``'s batch order: every parameter the policy shards is
   gathered a decoder layer at a time through the layout (at one rank the
   gather and the reduce-scatter are the identity), twice a layer a step
   under FULL_SHARD with remat, once under SHARD_GRAD_OP; 20 + 10 + 10
   and 10 + 10 + 10 wgmma launches a step; each mode's 13 losses equal the
   first 13 of phase 6's bit for bit. Then here, without a process group,
   ``cpu_offload=True``: 3 + 10 steps, their losses equal phase 6's, the
   Adam moments pinned in host memory between steps, the peak card memory
   below phase 6's; reported with the step's ms, the moments' bytes, the
   moments' host-to-card and card-to-host GB/s against a plain pinned copy
   of the same bytes. ``main_sharded()`` runs it alone, with its own
   reference steps.

11. device meshes and in-model parallelism (``parallel/mesh.py``,
   ``pipeline.py``, ``ops/ring_attention.py``, ``inference.py``):
   ``launch --num_processes 1 --mixed_precision bf16 --dp 1 --fsdp 1 --tp 1
   --cp 1 --pp 1 chip_smoke.py --mesh-child OUT`` trains the tier-1 model
   at world size 1 over NCCL on the mesh the flags build, 3 + 10 steps in
   ``run_bench``'s batch order, in four modes: (a) with
   ``TensorParallelPlugin(tp_size=1)`` and ``PipelineParallelPlugin(pp_size=1)``,
   (b) ``attention_backend="ring"``, (c) ``"ulysses"``, (d)
   ``HYBRID_SHARD`` with activation checkpointing; each prints its 13
   losses' ends, step ms, peak GiB and wgmma launches a step (10 + 10 + 10,
   20 + 10 + 10 under (d)'s remat), and its 13 losses must equal phase 6's
   bit for bit (else the first step and relative gap where they part are
   printed and the phase fails). Then here ``prepare_pipeline`` over
   Llama-3-8B in bf16 at full depth, stacked from phase 3's weights (the
   same seed), ``num_microbatches=2``, on phase 3's 4 x 2048 tokens: its
   logits against phase 3's (relative L2 at most 1e-3 on every 256th
   position's logits, top-1 agreement at least 0.99 over every position),
   its ms beside phase 3's, and 32 flash launches in the call (one per
   layer; at pp=1 the whole batch is one pass). ``main_mesh()`` runs it
   alone (with its own reference steps and 8B forward).

12. Mixture-of-Experts at Mixtral-8x7B widths (``ops/moe.py``,
   ``models/mixtral.py``, ``ExpertParallelPlugin``), random bf16 weights
   from a seeded generator: (a) 8 layers (23.7 GB) on 4 x 2048 tokens at the
   training capacity factor 1.25: ms, peak, each layer's dropped pairs and
   experts' loads, 8 wgmma forward launches, finite logits; on 1 x 256
   tokens every layer's attention through the flash kernel against einsum
   attention on the same hidden states (5e-2), and layer 0's index dispatch
   against the reference's one-hot einsums at f32 (1e-5). (b) ``generate``
   on it, batch 1, a 512-token prompt, 32 new, greedy: tokens/s, no flash
   launch, a repeat identical; at f32, 2 layers and hidden 256, token-exact
   with the greedy loop over uncached forwards that route without drops
   (the drops at 1.25 printed). (c) 2 layers (3.165 B), 4 x 1024, bf16 over
   f32 masters, fused AdamW, ``mixtral_lm_loss``, clip 1.0, 3 + 10 steps:
   launched by ``launch --num_processes 1 --ep 1`` with
   ``ExpertParallelPlugin(ep_size=1)`` over NCCL, then here without a
   group; their 13 losses equal bit for bit, 2 + 2 + 2 wgmma launches a
   step; step ms, peak, router losses, drops. (d) 2 layers exported to an
   HF directory by ``save_hf_checkpoint`` and loaded by
   ``load_hf_checkpoint_and_dispatch`` on the "auto" map under a card
   budget that leaves the last layer and the head in host memory: its 1 x
   2048 logits against the resident model's (1e-3). (e) (c)'s trainer
   launched from a config file that the ``config`` questionnaire wrote
   from scripted answers on a piped stdin, with ``--tp 1 --cp 1 --pp 1
   --ep 1`` and the tensor, context (ring) and pipeline plugins at size 1,
   over NCCL: its 13 losses equal (c)'s bit for bit, 2 + 2 + 2 wgmma
   launches a step; step ms, peak and its seconds. Prints the phase's
   seconds. ``main_moe()`` runs it alone.

13 (after 4f, on the same model). tensor-parallel serving slices
   (``serving/mesh_exec.py``) at tp 1: the card's machine has one GPU and
   NCCL takes one rank a card, so tp above 1 runs only over gloo on the CPU
   (the tests). (a) 4c's exact set (f32, 2 layers, 12 staggered requests on
   4 slots) through ``ServingEngine(tp=1)`` in three modes (plain, int8 KV,
   4 LoRA tenants over int8 weights): every stream equal to 4c/4d's plain
   engine's in the same mode, and in the plain mode to ``generate``. (b)
   Llama-3-8B at full depth in bf16, 4c's shape (8 slots x 2048, 256-token
   chunks, an external prefix cache, whose blocks the slice keeps on the
   host) and 24-request schedule through ``ServingEngine(tp=1)``: graphed
   tick and chunk ms, TTFT p50/p95, ITL p50/p99, host us a tick, one
   block's host round trip, ``kv_cache_per_chip_bytes`` beside 4c's from
   the same run; 0 captures after warmup, 0 flash launches. (c) the fleet
   ``serve --tp 1`` builds (``ReplicaSet.from_mesh``) on the exact set's
   model behind the asyncio gateway and a supervisor: the 12 requests over
   HTTP all 200 and equal to ``generate``, a kill of the slice, its restart
   on the same device, the longest prompt again a prefix hit from what the
   dead slice cached, device memory before the kill and after the restart.
   (d) ``launch --num_processes 1 --tp 1 chip_smoke.py --tp-serving-child
   OUT``: (a)'s plain set over NCCL, its streams equal (a)'s. Prints the
   phase's seconds. ``main_tp_serving()`` runs it alone.

14 (after 12, the earlier models freed). the model families (``models/``)
   at their published widths: GPT-2 XL, Phi-2, GPT-J-6B, BLOOM-560m,
   GPT-NeoX-20B and OPT-30B (cut to 16 of its 48 layers), random weights
   from a seeded generator on the card. (a) At f32 with 2 layers: the
   logits on 1 x 256 tokens through the flash kernels (f32: the mma.sync
   route) against einsum attention within 2e-5 x max(max|ref|, 1) (BLOOM
   attends by its ALiBi einsum: no kernel), cached greedy ``generate``
   token-exact with the uncached argmax loop, ``save_hf_checkpoint`` ->
   ``load_hf_checkpoint_and_dispatch`` on the card tier (OPT on the host
   tier too) bit-identical to the resident logits, and for GPT-2 and OPT
   positions past the learned table refused before the lookup (the
   streamed model's ``position_bound`` and the resident forward). (b) A
   bf16 forward on 4 x 2048 tokens (GPT-2 XL 8 x 1024, its table's
   length): ms, tokens/s, peak GiB, the route (wgmma for every flash
   family: head_dim 64, 80, 96, 128 and 256), one flash launch a layer
   (BLOOM none); then Gemma2-9B (``LlamaConfig.gemma2_9b``, 42 layers,
   head_dim 256, softcap 50, ``query_pre_attn_scalar``) the same way, 42
   wgmma launches, and at 2 layers in bf16 on 1 x 1024 (layer 0's window
   cut to 512) each layer's attention through the flash kernel against the
   einsum core within 5e-2 relative L2. (c) batch-1 ``generate`` from a
   512-token prompt, 32 new: tokens/s, a repeat identical. (d) 2 layers at
   GPT-J's and Phi-2's widths, 8 x 1024, bf16 over f32 masters, fused
   AdamW, clip 1.0, ``compile_train_step``: 3 + 10 steps, step ms and peak,
   2 wgmma forward + 2 wgmma dK/dV + 2 wgmma dQ launches a step, finite
   losses, batch 0's falling. (e) a
   BERT-base step (32 x 128, bf16) and a ResNet-50 step (64 x 224^2,
   channels-last, bf16, batch statistics): ms and samples or images/s; the
   port's ``examples/nlp_example_torch.py`` (5 epochs) and
   ``cv_example_torch.py`` (1 epoch) as subprocesses on the card, at
   eval_acc >= 0.8 and acc >= 0.9. Then each family's kernels at its
   shapes (which phases 2 and 2b hold against the plain versions): the
   forward, dK/dV and dQ on both routes, each forced and held to the
   tolerances, timed in turns beside the plain version, SDPA and the bound
   at the real head_dim.
   Prints the phase's seconds. ``main_families()`` runs it alone, with
   phase 2's and 2b's D=80 and family cases.

15 (after 14, the earlier models freed). T5 at T0pp's widths (d_model 4096,
   64 heads of 64, d_ff 10240, gated GELU, untied head; ``T5Config.t0pp``)
   and ViT-B/16, random weights from a seeded generator on the card; both
   attend by the einsum core, and the phase fails if a flash kernel
   launches. (a) At f32 (TF32 off) with 2 + 2 layers: batch 2 with one
   padded row, sources of 3, 130 and 512 tokens, 16 new: cached
   ``seq2seq_generate`` token-exact with the uncached loop (a teacher-forced
   forward and an argmax a step on the same padded source); ``generate``
   hands T5 to it; ``StreamedModel.seq2seq_generate`` on the pinned-host
   tier (``cpu_offload``) token-exact with the resident model at 130 and
   512; ``relative_position_bucket`` on the card equal to the CPU's table
   for -4096..4096; the HF round trips (export, convert, export) of T5 and
   ViT-B/16 bit-identical. (b) T0pp at 24 + 24 layers (11.1 B parameters,
   22.3 GB in bf16): a teacher-forced forward on 4 x 512 source and 4 x
   128 target tokens (ms, tokens/s, peak), batch-4 ``seq2seq_generate``
   from 512-token sources, 32 new (tokens/s, ms a token, a repeat
   identical), each profiled once. (c) T0pp's widths cut to 6 + 6 layers
   all in pinned host memory (a full 11 B pinned copy would round up to
   ~36 GiB in the pinned pool's power-of-two blocks): one forward's ms and
   8 cached tokens' ms a token, the peak card memory within 2 x the largest
   block + the resident forward's activation peak (phase 4f's bound). (d)
   2 + 2 layers at T0pp's widths, 8 x 512 sources and 8 x 128 targets, bf16
   over f32 masters, fused AdamW, clip 1.0, ``seq2seq_lm_loss`` with
   dropout 0.1 from the accelerator's generator: 3 + 10 steps, step ms and
   peak, finite losses, batch 0's falling. (e) ViT-B/16: a bf16 forward on
   64 x 224^2 (ms, images/s) and a bf16-over-f32-masters train step on 64
   images (ms, images/s, peak). Prints the phase's seconds.
   ``main_seq2seq_vision()`` runs it alone.

16 (after 15). The fp8 training path, ``estimate-memory`` and the native
   host IO. (a) The fp8 GEMM at the tier-1 projections' shapes (x [8192,
   2048] against [2048, 2048], [2048, 1024], [2048, 5632], [5632, 2048]),
   forward, dx and dW, HYBRID and E4M3, on the operands as ``Fp8Dense`` lays
   them out: ``torch._scaled_mm`` (cuBLASLt, ``use_fast_accum=False``)
   within ``FP8_TOLERANCE`` (2 bf16 ulps) of the largest output of the
   widened product, a repeat bit-identical; ms as the model calls it and of
   the product alone, beside a bf16 ``torch.matmul`` (a yardstick); the
   E5M2 x E5M2 product on its widened route against the CPU's. (b)
   ``PipelinedLlamaForCausalLM(tier1_llama_config(use_fp8=True))`` under
   ``Accelerator(mixed_precision="fp8")`` and ``compile_train_step(...,
   max_grad_norm=1.0)``, phase 6's weights and batches, the batches read by
   a ``TokenBinDataLoader`` from a token file written from phase 6's seed:
   3 + 20 steps; step ms, tokens/s, MFU by phase 6's formula, peak memory;
   10 + 10 + 10 wgmma flash launches and 210 fp8 GEMMs a step (none in
   ``lm_head``); after step 1 every scale differs from 1 and slot 0 of each
   history is the amax it recorded; losses finite and falling, the last
   within ``FP8_REL_TOL`` (0.12, ``benchmarks/fp8.py:25``) of phase 6's.
   (c) ``estimate-memory llama3-8b`` counts phase 3's parameters. (d) The
   native library builds; ``load_safetensors_model`` of a 1.07 GB
   checkpoint written here is bit-identical to ``SafetensorsFile``'s read,
   GB/s at 1 and 8 threads. ``main_fp8()`` runs it alone.

Prints the fp8 GEMM's JSON line, the kernels' JSON line (each kernel with its launches in phase 9,
``multiprocess_launches``, in phase 10, ``sharded_launches``, in phase
11, ``mesh_launches``, in phase 12, ``moe_launches``, in phase 13,
``tp_serving_launches``, in phase 14, ``families_launches``, with its
timings at the families' shapes in ``families``, in phase 15,
``seq2seq_vision_launches``, 0, and in phase 16's fp8 steps,
``fp8_launches``) and the card's line, and
as its last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Main-path attention shape: Llama-3-8B widths (32 query heads, 8 kv heads,
# head_dim 128), batch 4 x 2048 tokens, causal, bf16.
MAIN = dict(B=4, S=2048, H=32, G=8, D=128)
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}  # H100 SXM, dense
PEAK_BYTES = 3.35e12
# (atol, rtol) on out, and atol on lse, per input dtype. N(0,1) inputs; a
# 16-bit output differs from the reference by its rounding, about one ulp.
TOLERANCE = {"bfloat16": (2e-2, 1e-2, 1e-2), "float16": (5e-3, 2e-3, 1e-3),
             "float32": (1e-4, 1e-4, 1e-4)}
# Backward tolerances. fp32: tests/test_flash_attention.py's 5e-4 (atol and
# rtol). 16-bit: max|grad - ref| <= tol * max(max|ref|, 1). The kernels and
# the plain version round P and dS to 16 bits at the same points, but from
# f32 values summed in another order, so a rounding may land one ulp apart
# (2^-8 relative in bf16, 2^-11 in fp16) and the output's cast adds half an
# ulp: a few ulps of the largest gradient entry. The floor of 1 (the scale of
# the N(0, 1) inputs) covers gradients that are zero but for rounding, as dq
# and dk are with a window of 1.
BWD_TOLERANCE = {"bfloat16": 2e-2, "float16": 4e-3, "float32": 5e-4}
# Training shape of the tier-1 model (accelerate_tpu_torch.bench): batch 8 x
# 1024 tokens, 16 query heads, 8 kv heads, head_dim 128, causal, bf16.
TRAIN = dict(B=8, S=1024, H=16, G=8, D=128)
TRAIN_LABEL = "training shape, tier-1 llama causal"
# Gemma2-9B's attention shape at phase 14's forward size: B=4 x S=2048, 16
# query heads, 8 kv heads, head_dim 256.
GEMMA2_SHAPE = (4, 2048, 16, 8, 256)
GEMMA2_LABEL = "Gemma2-9B softcap 50 + sm_scale 256^-0.5"
MAIN_LABEL = "main-path llama3-8b causal"
PROMPT_LENGTHS = (96, 200, 333, 512)
NEW_TOKENS = 32
# Phase 4b: speculative decoding on prompts that repeat a seeded snippet,
# and beam search.
SPEC = dict(snippet=64, repeats=8, new=64, ngram=2, num_draft=5, draft_layers=2,
            exact_repeats=4, exact_new=40, beam_prompts=(200, 333), beams=4, beam_new=32)
# Phase 4c: the serving engine. Exactness at 2 layers in f32 on 4 slots,
# then full depth in bf16 on 8 slots of 2048 tokens, 256-token chunks.
SERVE = dict(exact_requests=12, exact_prompts=(5, 700), exact_new=32, exact_slots=4,
             exact_max_len=768, preempt=(250, 64, 18), chunk=256, slots=8, max_len=2048, requests=24,
             prompts=(96, 1536), shared_prefix=512, new=(64, 128), arrival_s=1.0,
             prefix_cache_gib=4, seed=41)
# Phase 4d: speculative, quantized and multi-tenant serving. Exactness on
# 4c's set; full depth in 4c's shape and schedule (modes b-d on its first
# 12 requests); a sliding-window model at Mistral-7B's shapes.
EXTRA = dict(spec_tokens=4, spec_lookup=3, exact_window=64, lora_rank=16,
             lora_targets=("q_proj", "k_proj", "v_proj", "o_proj"), adapters=4, cut_requests=12,
             draft=dict(hidden_size=2048, intermediate_size=8192, num_hidden_layers=16,
                        tie_word_embeddings=True),
             window=dict(config=dict(vocab_size=32000, rope_theta=10000.0, sliding_window=4096,
                                     max_position_embeddings=32768),
                         slots=4, max_len=8192, requests=6, prompts=(5000, 7000), new=128,
                         seed=43))
# Phase 4e: the serving fleet. Exactness on 4c's f32 set with a kill at
# decode tick 12 of replica 0; full depth in 4c's shape and schedule with a
# kill at tick 40. The watchdog's hang timeout stays far above any tick.
FLEET = dict(exact_seed=51, exact_kill_tick=12, kill_tick=40, hang_timeout_s=30.0)
# Phase 4f: big-model inference. Exactness at 2 layers in f32 (an HF
# directory in 2 GB shards; logits on 1 x 256 tokens, greedy tokens from a
# 100-token prompt); then full depth in bf16 (5 GB shards): a 4 x 2048
# forward and batch-1 decode from a 512-token prompt on each tier.
BIG = dict(exact_seed=71, exact_len=256, exact_prompt=100, exact_new=32, exact_disk_new=8,
           exact_shard="2GB", exact_atol=1e-5, quant_atol=1e-4, shard="5GB", forward=(4, 2048),
           prompt=512, new=16, disk_new=4, auto_budget="8GiB")


#: Phase 4c's numbers from this run, which phase 4e prints beside its own.
SERVING_4C: dict = {}


def fail(message: str):
    print(f"chip_smoke: FAILED: {message}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_inputs(B, S, H, G, D, dtype, seed, segments=False):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, G, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, G, D), generator=gen, device="cuda").to(dtype)
    seg = None
    if segments:
        # Three packed segments per row, boundaries drawn from the seed.
        cuts = torch.sort(torch.randint(8, S - 8, (B, 2), generator=gen, device="cuda")).values
        pos = torch.arange(S, device="cuda")[None, :]
        seg = (1 + (pos >= cuts[:, :1]).int() + (pos >= cuts[:, 1:]).int()).to(torch.int32)
    return q, k, v, seg


def kernel_bound(ops: float, nbytes: float, dtype):
    """Least time (ms) for work of ``ops`` operations at the dtype's peak
    and ``nbytes`` moved at the memory rate: the larger of the two, and
    which of them it is ("bytes" or "operations")."""
    t_ops = ops / PEAK_FLOPS[str(dtype).split(".")[-1]]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def itemsize(dtype) -> int:
    import torch

    return torch.finfo(dtype).bits // 8


def attention_bound(B, S, H, G, D, dtype, causal=True):
    """Bound (ms, by) of the attention forward: visible (q, k) pairs need
    4 * D operations each (two products); each input is read once and each
    output (out, lse) written once."""
    pairs = S * (S + 1) // 2 if causal else S * S
    nbytes = itemsize(dtype) * (B * S * H * D * 2 + B * S * G * D * 2) + 4 * B * H * S
    return kernel_bound(4.0 * B * H * D * pairs, nbytes, dtype)


def phase_environment():
    import torch

    print(card_line())
    print(f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | torch "
          f"{torch.__version__} | cuda {torch.version.cuda} | python {sys.version.split()[0]}")
    from accelerate_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libraries = _build.build()
    print(f"built {sorted(libraries)} in {time.perf_counter() - t0:.1f} s")
    for name, path in libraries.items():
        log = path.with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        kernel = ""
        for line in lines:
            if "Compiling entry function" in line:
                kernel = ptxas_kernel_name(line)
            elif "registers" in line or "spill" in line:
                print(f"  {name} {kernel}: {line.strip()}")


def ptxas_kernel_name(line: str) -> str:
    """``kernel<type, D>`` from a ptxas "Compiling entry function" line's
    mangled name (e.g. ``flash_fwd_sm90_kernel<bf16, 80>``)."""
    import re

    mangled = line.split("'")[1] if "'" in line else line
    found = re.search(r"\d+(flash_\w+?_kernel)I", mangled)
    dtype = next((t for key, t in (("__nv_bfloat16", "bf16"), ("__half", "fp16"))
                  if key in mangled), "f32")
    dims = re.findall(r"Li(\d+)E", mangled)
    return f"{found.group(1) if found else mangled}<{', '.join([dtype, *dims])}>"


def kernel_cases():
    import torch

    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    # (label, B, S, H, G, D, dtype, segments, kwargs)
    return [
        (TRAIN_LABEL, *TRAIN.values(), bf16, False, dict(causal=True)),
        (MAIN_LABEL, *MAIN.values(), bf16, False, dict(causal=True)),
        ("non-causal", 2, 256, 4, 4, 128, bf16, False, dict(causal=False)),
        ("window 100 < S", 1, 512, 4, 2, 64, bf16, False, dict(sliding_window=100)),
        ("window 1", 1, 256, 2, 2, 64, bf16, False, dict(sliding_window=1)),
        ("segments causal", 2, 256, 4, 2, 128, bf16, True, dict(causal=True)),
        ("segments non-causal", 2, 256, 4, 2, 128, bf16, True, dict(causal=False)),
        ("segments + window 70", 1, 256, 4, 2, 64, bf16, True, dict(sliding_window=70)),
        ("softcap 50 + sm_scale, D=256", 1, 512, 8, 4, 256, bf16, False,
         dict(logit_softcap=50.0, sm_scale=256.0 ** -0.5)),
        ("softcap 5 + window 96 + sm_scale 0.17", 1, 512, 4, 2, 128, bf16, False,
         dict(logit_softcap=5.0, sliding_window=96, sm_scale=0.17)),
        ("softcap non-causal", 1, 256, 4, 4, 64, bf16, False,
         dict(causal=False, logit_softcap=7.0)),
        ("gqa rep 1", 2, 512, 8, 8, 128, bf16, False, {}),
        ("gqa rep 4", 2, 512, 8, 2, 128, bf16, False, {}),
        ("gqa rep 8", 2, 512, 8, 1, 128, bf16, False, {}),
        ("D=64", 2, 384, 4, 2, 64, bf16, False, {}),
        ("D=256", 2, 384, 4, 2, 256, bf16, False, {}),
        ("D=96", 1, 256, 4, 2, 96, bf16, False, {}),
        ("D=80 (Phi-2's)", 2, 512, 8, 8, 80, bf16, False, {}),
        ("D=80 window 100 + segments", 1, 384, 4, 2, 80, bf16, True, dict(sliding_window=100)),
        # The dQ kernel's tiles at 80, 96 and 256: ragged ends at batch > 1,
        # GQA, non-causal segments, fp16 with a window.
        ("B=3 S=200 causal, D=96", 3, 200, 4, 2, 96, bf16, False, {}),
        ("B=3 S=200 causal, D=256", 3, 200, 4, 2, 256, bf16, False, {}),
        ("gqa rep 8, D=80", 2, 512, 8, 1, 80, bf16, False, {}),
        ("segments non-causal, D=256", 2, 256, 4, 2, 256, bf16, True, dict(causal=False)),
        ("fp16 D=80 window 100", 1, 512, 4, 2, 80, f16, False, dict(sliding_window=100)),
        ("fp16 D=96 softcap 30 + sm_scale 0.1, non-causal", 1, 256, 4, 4, 96, f16, False,
         dict(causal=False, logit_softcap=30.0, sm_scale=0.1)),
        ("fp16", 2, 512, 8, 2, 128, f16, False, {}),
        ("fp16 D=256 window", 1, 512, 4, 2, 256, f16, False, dict(sliding_window=200)),
        ("fp32", 2, 256, 4, 2, 128, f32, False, {}),
        ("fp32 D=256 softcap window segments", 1, 256, 4, 2, 256, f32, True,
         dict(logit_softcap=30.0, sliding_window=100)),
        ("fp32 non-causal D=64", 1, 256, 4, 1, 64, f32, False, dict(causal=False)),
        ("fp32 D=80", 1, 256, 4, 2, 80, f32, False, {}),
        ("fp32 D=96 window 70 + segments", 1, 256, 4, 2, 96, f32, True,
         dict(sliding_window=70)),
        ("ragged S=200 non-causal", 1, 200, 4, 2, 64, bf16, False, dict(causal=False)),
        ("ragged S=200 causal fp32", 1, 200, 4, 2, 128, f32, False, {}),
        ("S=1000 causal (not a multiple of 128)", 1, 1000, 4, 2, 128, bf16, False, {}),
        ("B=3 S=200 causal (rows past S beside the next batch's)", 3, 200, 4, 2, 128, bf16, False,
         {}),
        ("gqa rep 8 + window 100 + segments, D=64", 2, 512, 8, 1, 64, bf16, True,
         dict(sliding_window=100)),
        ("fp16 softcap 20 + sm_scale 0.1, D=128", 1, 512, 4, 2, 128, f16, False,
         dict(logit_softcap=20.0, sm_scale=0.1)),
        *family_cases(),
        # Gemma2-9B's attention (LlamaConfig.gemma2_9b): softcap 50, sm_scale
        # query_pre_attn_scalar ** -0.5; its 4096 window, cut to 1024 here so
        # that it cuts at S=2048.
        (GEMMA2_LABEL, *GEMMA2_SHAPE, bf16, False,
         dict(causal=True, logit_softcap=50.0, sm_scale=256.0 ** -0.5)),
        (GEMMA2_LABEL + ", window 1024", *GEMMA2_SHAPE, bf16, False,
         dict(sliding_window=1024, logit_softcap=50.0, sm_scale=256.0 ** -0.5)),
    ]


def route_of(kernel: str, dtype, D) -> str:
    """The route kernel ``kernel`` ("forward", "dkdv" or "dq") takes at this
    dtype and head_dim (``flash_cuda._wgmma_route``)."""
    from accelerate_tpu_torch.ops.flash_cuda import _wgmma_route

    return "wgmma" if _wgmma_route(kernel, dtype, D) else "mma.sync"


def in_turns(fns: dict, iters: int = 20) -> dict:
    """Times each of ``fns`` (name -> callable) twice, in the order a, b, b,
    a, ..., and returns each one's mean ms: the versions share the card's
    state (clocks, power) as evenly as one run allows."""
    names = list(fns)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(timed_ms(fns[n], iters=iters))
    return {n: sum(t) / len(t) for n, t in times.items()}


def check_forward(label, q, k, v, seg, kw):
    """``flash_fwd`` on one case against ``flash_fwd_reference`` under
    ``TOLERANCE``, and a repeat launch bit-identical; fails otherwise."""
    import torch

    from accelerate_tpu_torch.ops.flash_cuda import flash_fwd, flash_fwd_reference

    (B, S, H, D), G, dtype = q.shape, k.shape[2], q.dtype
    out, lse = flash_fwd(q, k, v, segment_ids=seg, **kw)
    torch.cuda.synchronize()
    again, again_lse = flash_fwd(q, k, v, segment_ids=seg, **kw)
    torch.cuda.synchronize()
    identical = torch.equal(out, again) and torch.equal(lse, again_lse)
    ref, ref_lse = flash_fwd_reference(q, k, v, segment_ids=seg, **kw)
    atol, rtol, lse_tol = TOLERANCE[str(dtype).split(".")[-1]]
    d_out = (out.float() - ref.float()).abs()
    err = d_out.max().item()
    excess = (d_out - rtol * ref.float().abs()).max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    ok = (torch.isfinite(out.float()).all().item() and excess <= atol and err_lse <= lse_tol)
    route = route_of("forward", dtype, D)
    print(f"  [{'ok' if ok and identical else 'FAIL'}] {label} ({route}): B={B} "
          f"S={S} H={H} G={G} D={D} {str(dtype).split('.')[-1]} max|dout|={err:.3e} "
          f"max|dlse|={err_lse:.3e} (out {atol:g} + {rtol:g}|ref|, lse {lse_tol:g}); repeat "
          f"launch {'bit-identical' if identical else 'DIFFERS'}")
    if not ok:
        fail(f"flash_fwd disagrees with flash_fwd_reference on case {label!r}")
    if not identical:
        fail(f"a repeat flash_fwd launch gave another result on case {label!r}")


def phase_kernels():
    """Every case on its route against the plain version, and a repeat
    launch bit-identical; then both routes timed at the training and the
    main-path shapes. Returns {"train": ..., "main": ...} timings."""
    for i, (label, B, S, H, G, D, dtype, segments, kw) in enumerate(kernel_cases()):
        q, k, v, seg = make_inputs(B, S, H, G, D, dtype, seed=100 + i, segments=segments)
        check_forward(label, q, k, v, seg, kw)
        del q, k, v, seg

    timings = {}
    for key, shape, label in (("train", TRAIN, TRAIN_LABEL), ("main", MAIN, MAIN_LABEL)):
        timings[key] = forward_timings(*shape.values(), seed=7)
        t = timings[key]
        print(f"  flash forward, {label} {shape_text(shape)} (CUDA events): wgmma "
              f"{t['ms']['wgmma']:.4f} ms, mma.sync {t['ms']['mma.sync']:.4f} ms (bound "
              f"{t['bound_ms']:.4f} ms, {t['bound_by']}; wgmma at "
              f"{100 * t['bound_ms'] / t['ms']['wgmma']:.1f} % of it); plain {t['plain_ms']:.3f} "
              f"ms; SDPA {t['library_ms']:.4f} ms; max|dout| wgmma {t['err']['wgmma']:.3e}, "
              f"mma.sync {t['err']['mma.sync']:.3e}")
    return timings


def shape_text(shape) -> str:
    """A shape dict, or a (B, S, H, G, D) tuple, as "B=.. S=.. H=.. G=.. D=.. causal bf16"."""
    shape = shape if isinstance(shape, dict) else dict(zip("BSHGD", shape))
    return " ".join(f"{k}={v}" for k, v in shape.items()) + " causal bf16"


def forward_timings(B, S, H, G, D, seed, routes=("wgmma", "mma.sync")):
    """The forward of each of ``routes`` at one causal bf16 shape, each
    compared with the plain version once, then timed in turns beside the
    plain version, SDPA and the bound."""
    import torch
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import flash_cuda as fc

    q, k, v, _ = make_inputs(B, S, H, G, D, torch.bfloat16, seed=seed)
    args = (q, k, v, True, None, None, None, None)
    launches = {"wgmma": lambda: fc._fwd_wgmma(*args), "mma.sync": lambda: fc._fwd_mma(*args)}
    routes = {n: launches[n] for n in routes}
    # Each route forced at this shape, held to TOLERANCE, a repeat identical.
    ref, ref_lse = fc.flash_fwd_reference(q, k, v, causal=True)
    atol, rtol, lse_tol = TOLERANCE["bfloat16"]
    err = {}
    for name, fn in routes.items():
        (out, lse), (again, again_lse) = fn(), fn()
        diff = (out.float() - ref.float()).abs()
        err[name] = diff.max().item()
        ok = ((diff - rtol * ref.float().abs()).max().item() <= atol
              and (lse - ref_lse).abs().max().item() <= lse_tol)
        if not (ok and torch.equal(out, again) and torch.equal(lse, again_lse)):
            fail(f"the {name} forward at {shape_text((B, S, H, G, D))} disagrees with the plain "
                 f"version (max|dout| {err[name]:.3e}) or with a repeat launch")
        del out, lse, again, again_lse, diff
    del ref, ref_lse
    ms = in_turns(routes)
    plain_ms = timed_ms(lambda: fc.flash_fwd_reference(q, k, v, causal=True), iters=3, warmup=1)
    # The yardstick: one library call computing the same attention, in its
    # [B, H, S, D] layout (the layout change is not timed).
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library_ms = timed_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                                 enable_gqa=True), iters=20)
    bound_ms, bound_by = attention_bound(B, S, H, G, D, torch.bfloat16)
    return dict(ms=ms, err=err, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def backward_bounds(B, S, H, G, D, dtype, causal=True):
    """Bounds (ms, by) of the two backward kernels: per visible (q, k) pair
    and head column, dK/dV does 8 operations (four products: S, dP, dV, dK)
    and dQ 6 (S, dP, dQ). Bytes: each reads q, k, v, dO, lse and delta once;
    dK/dV writes dk and dv, dQ writes dq."""
    pairs = S * (S + 1) // 2 if causal else S * S
    unit = B * H * D * pairs
    item = itemsize(dtype)
    read = item * (2 * B * S * H * D + 2 * B * S * G * D) + 2 * 4 * B * H * S
    dkdv = kernel_bound(8.0 * unit, read + item * 2 * B * S * G * D, dtype)
    dq = kernel_bound(6.0 * unit, read + item * B * S * H * D, dtype)
    return dkdv, dq


def sdpa_backward_yardstick(q, k, v, d_out):
    """Time of the library's attention backward on the same inputs:
    ``torch.autograd.grad`` through a retained ``scaled_dot_product_attention``
    graph, causal. K and V are expanded to the query heads (outside the
    timed region) so every SDPA backend takes them. Returns (ms, backend)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    rep = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt = k.repeat_interleave(rep, dim=2).transpose(1, 2).detach().requires_grad_()
    vt = v.repeat_interleave(rep, dim=2).transpose(1, 2).detach().requires_grad_()
    dot = d_out.transpose(1, 2)
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        try:
            with sdpa_kernel(backend):
                o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
                torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True)
        except RuntimeError:
            continue
        with sdpa_kernel(backend):
            ms = timed_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True),
                          iters=20)
        return ms, backend.name
    fail("no SDPA backend takes the yardstick's inputs")


def check_backward(label, q, k, v, seg, kw, seed):
    """``flash_bwd`` (dK/dV, then dQ, each on its route, as the counts must
    show) on one case, with a seeded ``d_out``, against
    ``flash_bwd_reference`` under ``BWD_TOLERANCE``, and a repeat launch
    bit-identical; fails otherwise."""
    import torch

    from accelerate_tpu_torch.ops.flash_cuda import flash_bwd, flash_bwd_reference, flash_fwd

    (B, S, H, D), G, dtype = q.shape, k.shape[2], q.dtype
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d_out = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    out, lse = flash_fwd(q, k, v, segment_ids=seg, **kw)
    route, dq_route = route_of("dkdv", dtype, D), route_of("dq", dtype, D)
    reset_counts()
    grads = flash_bwd(q, k, v, out, lse, d_out, segment_ids=seg, **kw)
    torch.cuda.synchronize()
    repeat = flash_bwd(q, k, v, out, lse, d_out, segment_ids=seg, **kw)
    torch.cuda.synchronize()
    counts = read_counts()
    expected = expected_counts(0, 2, wgmma=route == "wgmma", dq_wgmma=dq_route == "wgmma")
    if counts != expected:
        fail(f"flash_bwd launches {counts} on case {label!r}, expected {expected}")
    refs = flash_bwd_reference(q, k, v, out, lse, d_out, segment_ids=seg, **kw)
    name = str(dtype).split(".")[-1]
    report, ok = [], True
    for g_name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        diff = (g.float() - r.float()).abs()
        scale = r.float().abs().max().item()
        if name == "float32":
            excess = (diff - BWD_TOLERANCE[name] * r.float().abs()).max().item()
            ok = ok and excess <= BWD_TOLERANCE[name]
        else:
            ok = ok and diff.max().item() <= BWD_TOLERANCE[name] * max(scale, 1.0)
        ok = ok and bool(torch.isfinite(g.float()).all())
        report.append(f"max|d{g_name[1:]}|={diff.max().item():.3e} (max|ref| {scale:.3g})")
    identical = all(torch.equal(a, b) for a, b in zip(grads, repeat))
    bound = (f"{BWD_TOLERANCE[name]:g} + {BWD_TOLERANCE[name]:g}|ref|" if name == "float32"
             else f"{BWD_TOLERANCE[name]:g} max(max|ref|, 1)")
    print(f"  [{'ok' if ok and identical else 'FAIL'}] {label} (dK/dV {route}, dQ {dq_route}): "
          f"B={B} S={S} H={H} G={G} D={D} {name} {' '.join(report)} (limit "
          f"{bound}); repeat launch {'bit-identical' if identical else 'DIFFERS'}")
    if not ok:
        fail(f"flash_bwd disagrees with flash_bwd_reference on case {label!r}")
    if not identical:
        fail(f"a repeat flash_bwd launch gave other gradients on case {label!r}")


def phase_backward():
    """Every case through ``flash_bwd`` (dK/dV, then dQ, both on the case's
    route, as the counts must show) against the plain version, a repeat
    bit-identical; then both kernels of each route timed at the training
    and the main-path shapes. Returns {"train": ..., "main": ...} timings."""
    for i, (label, B, S, H, G, D, dtype, segments, kw) in enumerate(kernel_cases()):
        q, k, v, seg = make_inputs(B, S, H, G, D, dtype, seed=300 + i, segments=segments)
        check_backward(label, q, k, v, seg, kw, seed=400 + i)
        del q, k, v, seg

    timings = {}
    for key, shape, label in (("train", TRAIN, TRAIN_LABEL), ("main", MAIN, MAIN_LABEL)):
        timings[key] = backward_timings(*shape.values(), seed=9)
        t = timings[key]
        ms, err = t["ms"], t["err"]
        print(f"  flash backward, {label} {shape_text(shape)} (CUDA events): dK/dV wgmma "
              f"{ms['wgmma']:.4f} ms, mma.sync {ms['mma.sync']:.4f} ms (bound "
              f"{t['dkdv_bound'][0]:.4f} ms, {t['dkdv_bound'][1]}; wgmma at "
              f"{100 * t['dkdv_bound'][0] / ms['wgmma']:.1f} % of it); dQ wgmma "
              f"{ms['dq wgmma']:.4f} ms, mma.sync {ms['dq mma.sync']:.4f} ms (bound "
              f"{t['dq_bound'][0]:.4f} ms, {t['dq_bound'][1]}; wgmma at "
              f"{100 * t['dq_bound'][0] / ms['dq wgmma']:.1f} % of it, "
              f"{ms['dq mma.sync'] / ms['dq wgmma']:.2f}x faster than mma.sync); plain backward "
              f"{t['plain_ms']:.3f} ms; SDPA backward ({t['backend']}, K/V expanded to "
              f"{shape['H']} heads, all three grads) {t['library_ms']:.4f} ms; max|dk, dv| wgmma "
              f"{err['wgmma']:.3e}, mma.sync {err['mma.sync']:.3e}; max|dq| wgmma "
              f"{err['dq wgmma']:.3e}, mma.sync {err['dq mma.sync']:.3e}")
        pair = ms["wgmma"] + ms["dq wgmma"]
        print(f"  dK/dV + dQ (wgmma), {label}: {ms['wgmma']:.4f} + {ms['dq wgmma']:.4f} = "
              f"{pair:.4f} ms against SDPA's whole backward {t['library_ms']:.4f} ms: "
              f"{pair / t['library_ms']:.2f}x its time")
    return timings


def backward_timings(B, S, H, G, D, seed, routes=("wgmma", "mma.sync")):
    """The dK/dV and the dQ kernel of each of ``routes`` at one causal bf16
    shape, each forced, held to ``BWD_TOLERANCE`` against the plain
    backward with a repeat launch bit-identical, then timed (the routes of
    each kernel in turns) beside the plain backward, SDPA's backward and
    the bounds."""
    import torch

    from accelerate_tpu_torch.ops import flash_cuda as fc

    q, k, v, _ = make_inputs(B, S, H, G, D, torch.bfloat16, seed=seed)
    d_out = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(seed + 1),
                        device="cuda").to(torch.bfloat16)
    out, lse = fc.flash_fwd(q, k, v, causal=True)
    launch = fc._BackwardLaunch(q, k, v, out, lse, d_out, causal=True, sm_scale=None,
                                sliding_window=None, segment_ids=None, logit_softcap=None)
    refs = fc.flash_bwd_reference(q, k, v, out, lse, d_out, causal=True)
    kernels = {"wgmma": (launch.dkdv_wgmma, launch.dq_wgmma),
               "mma.sync": (launch.dkdv_mma, launch.dq_mma)}
    dq_routes = {f"dq {n}": kernels[n][1] for n in routes}
    routes = {n: kernels[n][0] for n in routes}
    tol = BWD_TOLERANCE["bfloat16"]
    err = {}
    for name, fn, grads, ref in [(n, f, slice(1, 3), refs[1:]) for n, f in routes.items()] + [
            (n, f, slice(0, 1), refs[:1]) for n, f in dq_routes.items()]:
        fn()
        first = [g.clone() for g in launch.grads[grads]]
        fn()
        same = all(torch.equal(a, b) for a, b in zip(first, launch.grads[grads]))
        err[name] = max((g.float() - r.float()).abs().max().item() for g, r in zip(first, ref))
        ok = all((g.float() - r.float()).abs().max().item()
                 <= tol * max(r.float().abs().max().item(), 1.0) for g, r in zip(first, ref))
        if not (ok and same):
            fail(f"the {name} backward kernel at {shape_text((B, S, H, G, D))} disagrees with the "
                 f"plain version (max|d| {err[name]:.3e}) or with a repeat launch")
        del first
    del refs
    ms = in_turns(routes)
    ms.update(in_turns(dq_routes))
    plain_ms = timed_ms(lambda: fc.flash_bwd_reference(q, k, v, out, lse, d_out, causal=True),
                        iters=2, warmup=1)
    library_ms, backend = sdpa_backward_yardstick(q, k, v, d_out)
    dkdv_bound, dq_bound = backward_bounds(B, S, H, G, D, torch.bfloat16)
    return dict(ms=ms, err=err, plain_ms=plain_ms, library_ms=library_ms, backend=backend,
                dkdv_bound=dkdv_bound, dq_bound=dq_bound)


def build_model():
    import torch

    from accelerate_tpu_torch import LlamaConfig, LlamaForCausalLM, policy_for

    cfg = LlamaConfig.llama3_8b()
    policy = policy_for("bf16")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=policy.compute_dtype, generator=gen).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  llama3_8b: {cfg.num_hidden_layers} layers (full depth), {n_params / 1e9:.3f} B "
          f"params in bf16, built in {time.perf_counter() - t0:.1f} s")
    return model, policy, gen


#: Phase 3's input ids, forward ms, logits at every 256th position and
#: top-1 tokens, for phase 11.
PHASE3: dict = {}


def phase_forward(model, policy, gen):
    import torch

    from accelerate_tpu_torch import PipelinedLlamaForCausalLM
    from accelerate_tpu_torch.ops.flash_cuda import flash_fwd

    cfg = model.config
    B, S = MAIN["B"], MAIN["S"]
    ids = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    with torch.inference_mode():
        model(ids[:1, :256])  # warm-up: library handles, allocator
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        logits = policy.cast_to_output(model(ids))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        launches = counts["flash_fwd_sm90"]
        if counts["flash_fwd"] != cfg.num_hidden_layers or launches != cfg.num_hidden_layers:
            fail(f"flash_fwd launched {counts['flash_fwd']} times in one forward, "
                 f"{launches} on the wgmma route; expected {cfg.num_hidden_layers} of each")
        if tuple(logits.shape) != (B, S, cfg.vocab_size) or not torch.isfinite(logits).all():
            fail(f"forward logits: shape {tuple(logits.shape)} or non-finite values")
        print(f"  forward {B}x{S} tokens: {seconds * 1e3:.1f} ms, {B * S / seconds:.0f} tokens/s, "
              f"flash_fwd launches {launches} (one per layer, wgmma route), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        # What phase 11's pipelined inference is held against.
        PHASE3.update(ids=ids.cpu(), ms=seconds * 1e3, sample=logits[:, ::256].float().cpu(),
                      top1=logits.argmax(-1).cpu())
        del logits

        # Same widths, small input: flash attention against einsum attention.
        small = ids[:1, :256]
        flash_logits = model(small).float()
        cfg.attention_backend = "einsum"
        try:
            einsum_logits = model(small).float()
        finally:
            cfg.attention_backend = "auto"
        rel = ((flash_logits - einsum_logits).norm() / einsum_logits.norm()).item()
        agree = (flash_logits.argmax(-1) == einsum_logits.argmax(-1)).float().mean().item()
        print(f"  flash vs einsum forward (1x256, bf16): relative L2 {rel:.3e}, "
              f"top-1 agreement {agree:.4f} (limit: relative L2 <= 5e-2)")
        if not rel <= 5e-2:
            fail("flash forward disagrees with the einsum forward")

        # The stacked-layer layout (the training bench's model) from the same
        # weights: the same logits, the kernel once per layer.
        stacked = PipelinedLlamaForCausalLM(cfg, device="cuda", dtype=policy.compute_dtype)
        stacked.load_state_dict(
            PipelinedLlamaForCausalLM.from_sequential_params(model.state_dict()))
        flash_fwd.launches = 0
        stacked_logits = stacked(small).float()
        rel_stacked = ((stacked_logits - flash_logits).norm() / flash_logits.norm()).item()
        print(f"  stacked-layer forward (1x256): relative L2 {rel_stacked:.3e} against the "
              f"sequential one (limit 1e-3), flash_fwd launches {flash_fwd.launches}")
        if flash_fwd.launches != cfg.num_hidden_layers or not rel_stacked <= 1e-3:
            fail("the stacked-layer forward disagrees with the sequential one")
        del stacked
        torch.cuda.empty_cache()
    return launches


def phase_generate(model, gen):
    import torch

    from accelerate_tpu_torch import generate

    prompts = [torch.randint(0, model.config.vocab_size, (1, n), generator=gen, device="cuda")
               for n in PROMPT_LENGTHS]

    def serve(max_new):
        outs, seconds = [], []
        for p in prompts:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(generate(model, p, max_new_tokens=max_new, cache_dtype=torch.bfloat16))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        return outs, seconds

    first, _ = serve(NEW_TOKENS)
    repeat, seconds = serve(NEW_TOKENS)
    _, prefill_seconds = serve(1)
    for p, a, b in zip(prompts, first, repeat):
        if a.shape != (1, p.shape[1] + NEW_TOKENS) or not torch.equal(a[:, :p.shape[1]], p):
            fail(f"generate returned shape {tuple(a.shape)} for a {p.shape[1]}-token prompt")
        if not torch.equal(a, b):
            fail("a repeat greedy generate returned other tokens")
        if int(a.min()) < 0 or int(a.max()) >= model.config.vocab_size:
            fail("generate returned token ids outside the vocabulary")
    decode_s = sum(seconds) - sum(prefill_seconds)
    decode_tokens = len(prompts) * (NEW_TOKENS - 1)
    print(f"  generate {len(prompts)} prompts ({'/'.join(map(str, PROMPT_LENGTHS))} tokens) x "
          f"{NEW_TOKENS} new, greedy, bf16 cache: {sum(seconds):.3f} s; prefill "
          f"{'/'.join(f'{s * 1e3:.1f}' for s in prefill_seconds)} ms; decode "
          f"{decode_tokens / decode_s:.1f} tokens/s (batch 1); repeat call identical")


def snippet_prompt(vocab, repeats, gen):
    """A prompt that repeats one seeded ``SPEC["snippet"]``-token snippet."""
    import torch

    snippet = torch.randint(0, vocab, (1, SPEC["snippet"]), generator=gen, device="cuda")
    return snippet.repeat(1, repeats)


def agreed_prefix(a, b, start: int) -> int:
    """New tokens ``a`` and ``b`` share from position ``start`` on."""
    differ = (a[0, start:] != b[0, start:]).nonzero()
    return int(differ[0, 0]) if differ.numel() else a.shape[1] - start


def timed_call(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def speculation_exactness(cfg):
    """Phase 4b's exact half: 2 layers at the model's widths in f32."""
    import dataclasses

    import torch

    from accelerate_tpu_torch import (LlamaForCausalLM, assisted_generate, beam_search_generate,
                                      generate, prompt_lookup_generate)
    from accelerate_tpu_torch import generation

    gen = torch.Generator(device="cuda").manual_seed(21)
    small = dataclasses.replace(cfg, num_hidden_layers=2)
    model = LlamaForCausalLM(small, device="cuda", dtype=torch.float32, generator=gen).eval()
    draft = LlamaForCausalLM(dataclasses.replace(cfg, num_hidden_layers=1), device="cuda",
                             dtype=torch.float32, generator=gen).eval()
    prompt = snippet_prompt(cfg.vocab_size, SPEC["exact_repeats"], gen)
    new, K, f32 = SPEC["exact_new"], SPEC["num_draft"], torch.float32
    plain = generate(model, prompt, max_new_tokens=new, cache_dtype=f32)
    checks = {"prompt_lookup_generate": lambda: prompt_lookup_generate(
                  model, prompt, max_new_tokens=new, ngram=SPEC["ngram"], num_draft=K,
                  cache_dtype=f32),
              "assisted_generate, itself as draft": lambda: assisted_generate(
                  model, model, prompt, max_new_tokens=new, num_draft=K, cache_dtype=f32),
              "assisted_generate, 1-layer draft": lambda: assisted_generate(
                  model, draft, prompt, max_new_tokens=new, num_draft=K, cache_dtype=f32),
              "beam_search_generate, 1 beam": lambda: beam_search_generate(
                  model, prompt, max_new_tokens=new, num_beams=1, cache_dtype=f32)}
    for name, call in checks.items():
        out = call()
        stats = generation.last_speculation
        extra = (f"; {stats.rounds} rounds, {stats.accepted} of {stats.rounds * K} drafts accepted"
                 if name.startswith(("prompt", "assisted")) else "")
        print(f"  f32, 2 layers at the model's widths, {prompt.shape[1]}-token prompt, {new} new: "
              f"{name} {'equals' if torch.equal(out, plain) else 'DIFFERS FROM'} greedy "
              f"generate{extra}")
        if not torch.equal(out, plain):
            fail(f"{name} is not token-exact with generate at f32")
        if name.endswith("itself as draft"):
            rounds = -(-(new - 1) // (K + 1))
            if stats.rounds != rounds or stats.accepted != rounds * K:
                fail(f"the model as its own draft took {stats.rounds} rounds and accepted "
                     f"{stats.accepted} drafts; expected {rounds} rounds and all {rounds * K}")
    sampled = dict(max_new_tokens=new, num_draft=K, cache_dtype=f32, do_sample=True, top_k=50)
    for name, call in {
            "prompt_lookup_generate": lambda g: prompt_lookup_generate(
                model, prompt, generator=g, **sampled),
            "assisted_generate": lambda g: assisted_generate(
                model, draft, prompt, generator=g, **sampled)}.items():
        outs = [call(torch.Generator(device="cuda").manual_seed(7)) for _ in range(2)]
        print(f"  sampled {name} (top_k 50), twice from seed 7: "
              f"{'identical' if torch.equal(*outs) else 'DIFFERENT'}")
        if not torch.equal(*outs):
            fail(f"sampled {name} is not deterministic under one generator seed")
    del model, draft
    free_cuda()


def phase_speculative(model, gen):
    """Phase 4b (see the module docstring)."""
    import dataclasses

    import torch

    from accelerate_tpu_torch import (LlamaForCausalLM, assisted_generate, beam_search_generate,
                                      generate, prompt_lookup_generate)
    from accelerate_tpu_torch import generation

    card = card_line()
    cfg = model.config
    speculation_exactness(cfg)

    prompt = snippet_prompt(cfg.vocab_size, SPEC["repeats"], gen)
    S, new, K = prompt.shape[1], SPEC["new"], SPEC["num_draft"]
    draft = LlamaForCausalLM(dataclasses.replace(cfg, num_hidden_layers=SPEC["draft_layers"]),
                             device="cuda", dtype=next(model.parameters()).dtype,
                             generator=torch.Generator(device="cuda").manual_seed(22)).eval()
    bf16 = torch.bfloat16
    runs = {"generate": lambda: generate(model, prompt, max_new_tokens=new, cache_dtype=bf16),
            "prompt_lookup_generate": lambda: prompt_lookup_generate(
                model, prompt, max_new_tokens=new, ngram=SPEC["ngram"], num_draft=K,
                cache_dtype=bf16),
            f"assisted_generate, {SPEC['draft_layers']}-layer draft": lambda: assisted_generate(
                model, draft, prompt, max_new_tokens=new, num_draft=K, cache_dtype=bf16)}
    for call in runs.values():
        call()  # warm-up
    _, prefill_s = timed_call(lambda: generate(model, prompt, max_new_tokens=1, cache_dtype=bf16))
    plain = None
    for name, call in runs.items():
        out, seconds = timed_call(call)
        stats = dataclasses.replace(generation.last_speculation)
        if plain is None:
            plain = out
            print(f"  bf16, full depth, {S}-token prompt (a 64-token snippet x {SPEC['repeats']}), "
                  f"{new} new ({card}): generate {new / seconds:.2f} tokens/s ({seconds:.3f} s; "
                  f"prefill {prefill_s * 1e3:.1f} ms, decode "
                  f"{(new - 1) / (seconds - prefill_s):.2f} tokens/s)")
            continue
        agreed = agreed_prefix(out, plain, S)
        print(f"  {name}: {new / seconds:.2f} tokens/s ({seconds:.3f} s), {stats.rounds} rounds, "
              f"{stats.accepted_per_round:.2f} drafts accepted a round of {K}, "
              f"{stats.reads} device reads; agrees with generate on the first {agreed} of {new} "
              f"new tokens")
        if out.shape != plain.shape or not torch.equal(out[:, :S], prompt):
            fail(f"{name} returned shape {tuple(out.shape)}")
        if stats.reads != stats.rounds + 1 or stats.committed != new:
            fail(f"{name}: {stats.reads} reads for {stats.rounds} rounds, {stats.committed} "
                 f"tokens committed")
    del draft
    free_cuda()

    for n in SPEC["beam_prompts"]:
        ids = torch.randint(0, cfg.vocab_size, (1, n), generator=gen, device="cuda")
        beams, beam_new = SPEC["beams"], SPEC["beam_new"]

        def beam(max_new):
            return beam_search_generate(model, ids, max_new_tokens=max_new, num_beams=beams,
                                        cache_dtype=bf16)

        beam(2)  # warm-up
        _, one_s = timed_call(lambda: beam(1))
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        first, seconds = timed_call(lambda: beam(beam_new))
        peak = torch.cuda.max_memory_allocated() - base
        repeat, _ = timed_call(lambda: beam(beam_new))
        L = -(-(n + beam_new) // 128) * 128
        cache_bytes = (cfg.num_hidden_layers * 2 * beams * L * cfg.num_key_value_heads
                       * cfg.head_dim * 2)
        print(f"  beam search, {beams} beams, {n}-token prompt, {beam_new} new ({card}): "
              f"{(seconds - one_s) * 1e3 / (beam_new - 1):.2f} ms a step, peak "
              f"{peak / 2**30:.3f} GiB above the weights (cache {cache_bytes / 2**30:.3f} GiB), "
              f"repeat call {'identical' if torch.equal(first, repeat) else 'DIFFERENT'}")
        if not torch.equal(first, repeat) or first.shape != (1, n + beam_new):
            fail("a repeat beam search returned other tokens")
        # A step gathers the cache a layer at a time: a second whole cache
        # (at least twice the cache) must never be held.
        if peak > 1.5 * cache_bytes + 64 * 2**20:
            fail(f"beam search peaked at {peak / 2**30:.3f} GiB above the weights, more than "
                 f"one cache of {cache_bytes / 2**30:.3f} GiB and change")

    # One verify round beside one decode step, at the 512-token context.
    with torch.inference_mode():
        cache = generation._cache_factory(model)(1, 640, bf16, ring_slack=K + 1 + 128)
        model(prompt, cache=cache, cache_pos=0)
        chunk = prompt[:, -(K + 1):]

        def verify():
            logits, _ = model(chunk, cache=cache, cache_pos=S)
            m, emit = generation.speculative_emit(logits[0], chunk[0, 1:], None, None, None,
                                                  prompt.dtype)
            return torch.cat([m.reshape(1), emit]).tolist()

        def decode():
            logits, _ = model(chunk[:, :1], cache=cache, cache_pos=S)
            return logits[:, -1].argmax(-1).tolist()

        verify()
        decode()
        v = device_breakdown(f"verify round ({K + 1} tokens, 512-token context)", verify)
        d = device_breakdown("decode step (1 token, 512-token context)", decode)
    if not (v and d):
        fail("torch.profiler saw no device time in a verify round or a decode step")
    print(f"  verify round / decode step: wall {v['wall_ms']:.3f} / {d['wall_ms']:.3f} ms, "
          f"device busy {v['busy_ms']:.3f} / {d['busy_ms']:.3f} ms "
          f"({100 * v['busy_ms'] / v['wall_ms']:.1f} / "
          f"{100 * d['busy_ms'] / d['wall_ms']:.1f} % of wall), kernels {v['kernels']:.0f} / "
          f"{d['kernels']:.0f}")


def stream_prompts(vocab, lengths, gen):
    """Seeded prompts of the given lengths, as int32 arrays [1, S]."""
    import torch

    return [torch.randint(0, vocab, (1, n), generator=gen, device="cuda").int().cpu().numpy()
            for n in lengths]


def submit_waves(engine, work, waves=3, pause=0.05, **kw):
    """Submit ``(prompt, max_new)`` pairs in ``waves`` groups ``pause``
    seconds apart, so later requests join a batch already decoding."""
    reqs, per = [], -(-len(work) // waves)
    for w in range(waves):
        for prompt, new in work[w * per:(w + 1) * per]:
            reqs.append(engine.submit(prompt, max_new_tokens=new, **kw))
        time.sleep(pause)
    return reqs


def engine_checks(engine, label):
    """After warmup and a round of traffic: every step was captured as a
    CUDA graph at warmup and nothing was captured since."""
    watcher = engine.compile_watcher
    steps = sorted(engine.captured_steps)
    want = ["chunk", "decode", "restore"] if "restore" in watcher.counts() else ["chunk", "decode"]
    if steps != want or watcher.events:
        fail(f"{label}: graphs captured {steps} (expected {want}), captures after warmup "
             f"{watcher.events}")
    return steps


def serving_exactness(cfg):
    """Phase 4c's exact half: 2 layers at the model's widths in f32."""
    import dataclasses

    import numpy as np
    import torch

    from accelerate_tpu_torch import LlamaForCausalLM, ServingEngine, generate

    gen = torch.Generator(device="cuda").manual_seed(31)
    small = dataclasses.replace(cfg, num_hidden_layers=2)
    model = LlamaForCausalLM(small, device="cuda", dtype=torch.float32, generator=gen).eval()
    f32, new = torch.float32, SERVE["exact_new"]
    lo, hi = SERVE["exact_prompts"]
    lengths = [int(n) for n in torch.randint(lo, hi + 1, (SERVE["exact_requests"],),
                                             generator=gen, device="cuda").tolist()]
    work = [(p, new) for p in stream_prompts(cfg.vocab_size, lengths, gen)]

    def reference(prompt, max_new):
        out = generate(model, torch.from_numpy(prompt).long().cuda(), max_new_tokens=max_new,
                       cache_dtype=f32)
        return out[0, prompt.shape[1]:].cpu().numpy()

    refs = [reference(p, n) for p, n in work]
    longest = max(range(len(work)), key=lambda i: work[i][0].shape[1])
    shape = dict(max_slots=SERVE["exact_slots"], max_len=SERVE["exact_max_len"],
                 prefill_chunk=SERVE["chunk"], cache_dtype=f32)
    for paged in (False, True):
        for async_ticks in (False, True):
            label = f"{'paged' if paged else 'dense'}, {'async' if async_ticks else 'sync'}"
            engine = ServingEngine(model, paged=paged, async_ticks=async_ticks, **shape)
            try:
                # The longest prompt twice: the repeat admits by restoring its
                # cached chunk-aligned prefix (by copy dense, by page aliasing
                # paged).
                twice = [engine.submit(work[longest][0], max_new_tokens=new).result(300)
                         for _ in range(2)]
                hits = engine.serving_metrics()["prefix_cache_hit_chunks"]
                outs = [r.result(300) for r in submit_waves(engine, work)]
                same = sum(np.array_equal(o, r) for o, r in zip(outs, refs))
                steps = engine_checks(engine, label)
            finally:
                engine.shutdown(drain=False, timeout=300)
            repeat_ok = all(np.array_equal(t, refs[longest]) for t in twice)
            print(f"  f32, 2 layers at the model's widths, {label}, {len(work)} staggered "
                  f"requests (prompts {min(lengths)}-{max(lengths)} tokens, {new} new) on "
                  f"{shape['max_slots']} slots: {same} of {len(work)} streams equal generate; the "
                  f"{work[longest][0].shape[1]}-token prompt repeated restored {hits} chunks and "
                  f"{'equals' if repeat_ok else 'DIFFERS FROM'} generate; graphs {steps}, none "
                  f"captured after warmup")
            if same != len(work) or not repeat_ok or hits < 1:
                fail(f"the {label} engine is not token-exact with generate at f32")

    # A pool sized to force a preemption: 4 streams of 250 + 32 tokens in
    # 64-token pages fill 16 pages at admission (the chunk covers 256) and
    # need a fifth page each while decoding; 18 pages make the third to
    # cross evict the newest.
    length, page, pages = SERVE["preempt"]
    pre = [(p, new) for p in stream_prompts(cfg.vocab_size, [length] * 4, gen)]
    engine = ServingEngine(model, page_size=page, max_pages=pages, prefix_cache_mb=0, **shape)
    try:
        outs = [r.result(300) for r in [engine.submit(p, max_new_tokens=n) for p, n in pre]]
        preempted = engine.serving_metrics()["preemptions"]
        engine_checks(engine, "preemption")
    finally:
        engine.shutdown(drain=False, timeout=300)
    same = sum(np.array_equal(o, reference(p, n)) for o, (p, n) in zip(outs, pre))
    print(f"  paged pool of {pages} x {page}-token pages, 4 streams of {length} + {new} tokens: "
          f"{preempted} preemptions, {same} of 4 streams equal generate")
    if preempted < 1 or same != 4:
        fail("the forced preemption did not happen or a resumed stream is not token-exact")

    # Sampled: the same seed alone and in a mixed batch.
    sampled = dict(do_sample=True, top_k=50, **shape)
    streams = []
    for mix in (False, True):
        engine = ServingEngine(model, **sampled)
        try:
            others = [engine.submit(p, max_new_tokens=n, seed=11) for p, n in work[:3]] if mix else []
            streams.append(engine.submit(work[3][0], max_new_tokens=new, seed=7).result(300))
            [r.result(300) for r in others]
        finally:
            engine.shutdown(drain=False, timeout=300)
    print(f"  sampled (top_k 50), seed 7 alone and beside 3 other streams: "
          f"{'identical' if np.array_equal(*streams) else 'DIFFERENT'}")
    if not np.array_equal(*streams):
        fail("a sampled stream changed with the batch around it")
    del model
    free_cuda()


def serving_schedule(vocab, gen):
    """Phase 4c's seeded traffic: (arrival s, prompt, max_new) sorted by
    arrival; half the prompts start with one shared system prefix."""
    import torch

    n, (lo, hi) = SERVE["requests"], SERVE["prompts"]
    prefix = torch.randint(0, vocab, (1, SERVE["shared_prefix"]), generator=gen, device="cuda")
    lengths = torch.randint(lo, hi + 1, (n,), generator=gen, device="cuda").tolist()
    news = torch.randint(SERVE["new"][0], SERVE["new"][1] + 1, (n,), generator=gen,
                         device="cuda").tolist()
    arrivals = sorted((torch.rand(n, generator=gen, device="cuda") * SERVE["arrival_s"]).tolist())
    out = []
    for i in range(n):
        if i % 2 == 0:
            tail = max(lengths[i], SERVE["shared_prefix"] + 1) - SERVE["shared_prefix"]
            ids = torch.cat([prefix, torch.randint(0, vocab, (1, tail), generator=gen,
                                                   device="cuda")], dim=1)
        else:
            ids = torch.randint(0, vocab, (1, lengths[i]), generator=gen, device="cuda")
        out.append((arrivals[i], ids.int().cpu().numpy(), int(news[i])))
    return out


def percentile(values, q):
    s = sorted(values)
    return s[min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))] if s else float("nan")


def replay_tick(engine, graphed: bool):
    """One decode tick of ``engine`` (stopped) with every slot active on
    a full page table, replayed from its graph or run eagerly."""
    import numpy as np
    import torch

    S, Np = engine.max_slots, engine._pages_per_slot
    table = (1 + np.arange(S * Np) % engine.total_pages).reshape(S, Np)
    parts = [("active", np.ones(S, np.int64)), ("table", table)]

    def tick():
        if graphed:
            engine._launch("decode", engine._decode_step, engine._decode_in,
                           engine._decode_stage[0], parts)
        else:
            engine._decode_in.copy_(torch.from_numpy(np.concatenate(
                [parts[0][1], table.reshape(-1)])).cuda())
            engine._decode_step()
        engine._decode_host_out[0].copy_(engine._decode_out.view(-1))

    return tick


def replay_chunk(engine):
    """One prompt chunk of ``engine`` (stopped) into slot 0 at offset 0,
    replayed from its graph."""
    import numpy as np

    C, Np = engine._chunk, engine._pages_per_slot
    parts = [("ids", np.zeros(C, np.int64)), ("slot", [0]), ("offset", [0]), ("true_len", [C]),
             ("seed", [0]), ("row", 1 + np.arange(Np) % engine.total_pages)]

    def chunk():
        engine._launch("chunk", engine._chunk_step, engine._chunk_in, engine._chunk_stage, parts)
        engine._chunk_host_out.copy_(engine._chunk_out)

    return chunk


def steady_tick(engine, card):
    """Time one steady decode tick of the stopped ``engine`` (all slots
    active) as a graph replay and eagerly, and a prompt chunk's replay;
    profile a tick both ways and a chunk."""
    import torch

    with torch.inference_mode(), torch.cuda.stream(engine._stream):
        graphed, eager, chunk = (replay_tick(engine, True), replay_tick(engine, False),
                                 replay_chunk(engine))
        graphed_ms = timed_ms(graphed, 20)
        eager_ms = timed_ms(eager, 5)
        chunk_ms = timed_ms(chunk, 10)
        profiled = {mode: device_breakdown(f"decode tick ({engine.max_slots} slots, {mode})", fn,
                                           top=8)
                    for mode, fn in (("graph replay", graphed), ("eager", eager))}
        device_breakdown(f"prompt chunk ({engine._chunk} tokens, graph replay)", chunk, top=6)
    print(f"  decode tick, {engine.max_slots} slots ({card}): graph replay {graphed_ms:.3f} ms "
          f"({engine.max_slots * 1e3 / graphed_ms:.0f} tokens/s), eager {eager_ms:.3f} ms; "
          f"a {engine._chunk}-token chunk, graph replay {chunk_ms:.3f} ms")
    for mode, tick in profiled.items():
        # The profiler may not see inside a graph: then CUDA events above stand.
        print(f"  profiled {mode} tick: " + (
            f"device busy {tick['busy_ms']:.3f} of {tick['wall_ms']:.3f} ms wall "
            f"({100 * tick['busy_ms'] / tick['wall_ms']:.1f}%), {tick['kernels']:.0f} kernels"
            if tick else "no device time seen (not measured)"))
    if not any(profiled.values()):
        fail("torch.profiler saw no device time in a decode tick, graphed or eager")
    return graphed_ms, chunk_ms


def phase_serving(model):
    """Phase 4c (see the module docstring). The traffic comes from its own
    seed, so the whole script and ``main_serving`` drive the same requests."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import ServingEngine, generate
    from accelerate_tpu_torch.serving import PrefixCache, RequestStatus

    card = card_line()
    cfg = model.config
    serving_exactness(cfg)

    schedule = serving_schedule(cfg.vocab_size,
                                torch.Generator(device="cuda").manual_seed(SERVE["seed"]))
    bf16, C = torch.bfloat16, SERVE["chunk"]
    t0 = time.perf_counter()
    # An external prefix cache (as a fleet shares one): its hits restore by
    # copy, through the restore step, so all three steps run.
    engine = ServingEngine(model, max_slots=SERVE["slots"], max_len=SERVE["max_len"],
                           prefill_chunk=C, cache_dtype=bf16, trace_capacity=1 << 15,
                           prefix_cache=PrefixCache(SERVE["prefix_cache_gib"] << 30))
    warm_s = time.perf_counter() - t0
    warm = dict(engine.compile_watcher.counts())
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        reqs = []
        for arrival, prompt, new in schedule:
            time.sleep(max(0.0, arrival - (time.perf_counter() - t0)))
            reqs.append(engine.submit(prompt, max_new_tokens=new, ignore_eos=True))
        for r in reqs:
            r.wait(600)
        wall = time.perf_counter() - t0
        launched = read_counts()
        steps = engine_checks(engine, "full depth")
        if launched != {k: 0 for k in launched}:
            fail(f"the serving engine launched flash kernels: {launched}")
        bad = [r for r in reqs if r.status is not RequestStatus.COMPLETED]
        if bad or any(len(r.tokens) != new for r, (_, _, new) in zip(reqs, schedule)):
            fail(f"{len(bad)} of {len(reqs)} requests did not complete: {bad[:3]}")
        s = engine.serving_metrics()
        itl = [dur * 1e3 for _, _, dur, name, _, _, _ in engine.trace_events() if name == "itl"]
    finally:
        engine.shutdown(drain=False, timeout=600)
    tokens = sum(len(r.tokens) for r in reqs)
    prompt_tokens = sum(p.shape[1] for _, p, _ in schedule)
    print(f"  bf16, full depth, {SERVE['slots']} slots x {SERVE['max_len']} tokens, chunk {C}, "
          f"paged, async ({card}): warmup {warm_s:.1f} s capturing {warm}; {len(reqs)} requests "
          f"({prompt_tokens} prompt tokens, {tokens} new, half behind one "
          f"{SERVE['shared_prefix']}-token prefix) arriving over {SERVE['arrival_s']} s, all "
          f"done in {wall:.3f} s ({tokens / wall:.1f} new tokens/s overall); graphs {steps}, "
          f"none captured after warmup; no flash launch")
    SERVING_4C.update(ttft_p50=s["ttft_ms_p50"], ttft_p95=s["ttft_ms_p95"],
                      itl_p50=percentile(itl, 0.5), itl_p99=percentile(itl, 0.99),
                      tokens_per_s=s["decode_tokens_per_sec"],
                      host_us_per_tick=s["host_us_per_tick"],
                      kv_bytes=engine.kv_cache_per_chip_bytes())
    print(f"  TTFT p50 {s['ttft_ms_p50']:.1f} ms, p95 {s['ttft_ms_p95']:.1f} ms; ITL p50 "
          f"{percentile(itl, 0.5):.2f} ms, p99 {percentile(itl, 0.99):.2f} ms ({len(itl)} "
          f"samples); decode {s['decode_tokens_per_sec']:.1f} tokens/s over "
          f"{s['decode_ticks']} ticks, slot occupancy {s['slot_occupancy']:.3f}; host "
          f"{s['host_us_per_tick']:.1f} us a tick (max {s['host_us_per_tick_max']:.1f}); "
          f"prefill {s['prefill_chunks']} chunks, {s['prefill_ms_per_chunk']:.2f} ms each; "
          f"prefix hits {s['prefix_cache_hit_chunks']} chunks ({s['prefix_cache_hit_chunks'] * C} "
          f"tokens, hit rate {s['prefix_cache_hit_rate']:.3f}); pages in use at most "
          f"{s['pages_used_max']} of {s['pages_total']}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    # For reference: batch-1 generate on 4 of the streams (bf16 rounds a
    # batch-8 product unlike a batch-1 one: reported, not asserted).
    agreed = []
    for r, (_, prompt, new) in list(zip(reqs, schedule))[:4]:
        ref = generate(model, torch.from_numpy(prompt).long().cuda(), max_new_tokens=new,
                       cache_dtype=bf16)[0, prompt.shape[1]:].cpu().numpy()
        differ = np.flatnonzero(ref != np.asarray(r.tokens))
        agreed.append(f"{int(differ[0]) if differ.size else new}/{new}")
    print(f"  streams against batch-1 generate (bf16): agreed prefixes {', '.join(agreed)}")
    SERVING_4C["tick_ms"], SERVING_4C["chunk_ms"] = steady_tick(engine, card)
    del engine
    free_cuda()


# -- phase 4d: speculative, quantized and multi-tenant serving --------------------


def exact_requests(cfg, layers=2, **overrides):
    """Phase 4c's exact set: a seeded f32 model of 2 layers at the model's
    widths, its 12 staggered requests and their ``generate`` tokens."""
    import dataclasses

    import torch

    from accelerate_tpu_torch import LlamaForCausalLM

    gen = torch.Generator(device="cuda").manual_seed(31)
    small = dataclasses.replace(cfg, num_hidden_layers=layers, **overrides)
    model = LlamaForCausalLM(small, device="cuda", dtype=torch.float32, generator=gen).eval()
    lo, hi = SERVE["exact_prompts"]
    lengths = [int(n) for n in torch.randint(lo, hi + 1, (SERVE["exact_requests"],),
                                             generator=gen, device="cuda").tolist()]
    work = [(p, SERVE["exact_new"]) for p in stream_prompts(cfg.vocab_size, lengths, gen)]
    return model, work


def generate_ref(model, prompt, max_new):
    import torch

    from accelerate_tpu_torch import generate

    out = generate(model, torch.from_numpy(prompt).long().cuda(), max_new_tokens=max_new,
                   cache_dtype=torch.float32)
    return out[0, prompt.shape[1]:].cpu().numpy()


def serve_exact(model, work, label, refs, check=True, captures_ok=False, adapters_of=None,
                phase="4d", **kw):
    """Serve ``work`` staggered on an f32 engine; count the streams equal to
    ``refs`` (a list, or ``refs(adapter, prompt, max_new)``) and, when
    ``check``, fail unless all are and nothing was captured after warmup
    (``captures_ok``: monolithic buckets capture at first use). With
    ``adapters_of``, every third request is the base model's and the others
    alternate its tenants. Returns (streams, metrics, capture counts,
    captures after warmup, pool metrics)."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import ServingEngine

    shape = dict(max_slots=SERVE["exact_slots"], max_len=SERVE["exact_max_len"],
                 prefill_chunk=SERVE["chunk"], cache_dtype=torch.float32)
    shape.update(kw)
    tenants = list(adapters_of or {})
    names = [tenants[i % len(tenants)] if tenants and i % 3 else None for i in range(len(work))]
    engine = ServingEngine(model, **shape)
    try:
        for name in tenants:
            engine.register_adapter(name, adapters_of[name])
        reqs, per = [], -(-len(work) // 3)
        for w in range(3):
            for (p, n), name in list(zip(work, names))[w * per:(w + 1) * per]:
                reqs.append(engine.submit(p, max_new_tokens=n, adapter=name))
            time.sleep(0.05)
        outs = [r.result(300) for r in reqs]
        s = engine.serving_metrics()
        counts, events = engine.compile_watcher.counts(), engine.compile_watcher.events
        pages = engine.page_pool_metrics()
    finally:
        engine.shutdown(drain=False, timeout=300)
    ref_of = refs if not callable(refs) else [refs(name, p, n) for (p, n), name in zip(work, names)]
    same = [int(np.argmax(o != r)) if np.any(o != r) else len(o) for o, r in zip(outs, ref_of)]
    equal = sum(a == len(o) for a, o in zip(same, outs))
    print(f"  f32, {label}: {equal} of {len(work)} streams equal the reference"
          + ("" if check else f" (agreed tokens a stream: {same})")
          + f"; graphs {sorted(counts)}, captures after warmup {events}")
    if check and (equal != len(work) or (events and not captures_ok)):
        fail(f"{phase} exactness, {label}: {equal} of {len(work)} streams token-exact, captures "
             f"after warmup {events}")
    return outs, s, counts, events, pages


def serving_extras_exactness(cfg):
    """Phase 4d's exact half, on 4c's staggered set at f32 and 2 layers."""
    import dataclasses

    import torch

    from accelerate_tpu_torch import LlamaForCausalLM
    from accelerate_tpu_torch.adapters import (
        AdapterBank,
        LoRAConfig,
        dequantized_state_dict,
        merge_adapter,
        quantize_base_weights,
    )

    model, work = exact_requests(cfg)
    refs = [generate_ref(model, p, n) for p, n in work]
    K = EXTRA["spec_tokens"]

    # Speculation: prompt lookup, a seeded 1-layer draft, the model itself.
    serve_exact(model, work, f"prompt lookup (n-gram {EXTRA['spec_lookup']}, K {K})", refs,
                spec_lookup=EXTRA["spec_lookup"], spec_tokens=K)
    gen = torch.Generator(device="cuda").manual_seed(37)
    draft = LlamaForCausalLM(dataclasses.replace(cfg, num_hidden_layers=1), device="cuda",
                             dtype=torch.float32, generator=gen).eval()
    serve_exact(model, work, f"1-layer draft (K {K})", refs, draft_model=draft, spec_tokens=K)
    del draft
    own = [(p, 1 + 6 * (K + 1)) for p, _ in work]   # full chains: no verify cut short
    own_refs = [generate_ref(model, p, n) for p, n in own]
    # A pool for every slot's target and draft pages: no preemption, whose
    # resume would commit a token outside a verify.
    pages = 2 * SERVE["exact_slots"] * -(-SERVE["exact_max_len"] // SERVE["chunk"])
    _, s, _, _, _ = serve_exact(model, own, "the model drafting for itself", own_refs,
                                draft_model=model, spec_tokens=K, async_ticks=False,
                                max_pages=pages)
    print(f"    drafts accepted {s['spec_accepted_tokens']} of {s['spec_proposed_tokens']} "
          f"proposed, {s['spec_tokens_per_tick']:.3f} tokens a slot-tick summed")
    if s["spec_accepted_tokens"] != s["spec_proposed_tokens"]:
        fail("the model drafting for itself had a draft rejected")

    # int8 base weights against the fp engine on the dequantized weights.
    dq = LlamaForCausalLM(model.config, device="cuda", dtype=torch.float32)
    dq.load_state_dict(dequantized_state_dict(quantize_base_weights(model)))
    dq.eval()
    fp_on_dq, _, _, _, _ = serve_exact(dq, work, "fp engine on the dequantized weights",
                                       [generate_ref(dq, p, n) for p, n in work])
    serve_exact(model, work, "weights_dtype=int8 against it", fp_on_dq, weights_dtype="int8")

    # A mixed-adapter batch (base, two tenants) on the fp and the int8 base.
    lora = LoRAConfig(rank=EXTRA["lora_rank"], target_modules=EXTRA["lora_targets"])
    tenants = {f"t{i}": seeded_adapter(model, lora, 100 + i) for i in range(2)}
    for base, label, kw in ((model, "fp", {}), (dq, "int8", dict(weights_dtype="int8"))):
        refs_of = {}

        def ref(name, p, n, base=base):
            key = (name, p.tobytes(), n)
            if key not in refs_of:
                merged = base if name is None else merge_adapter(base, tenants[name])
                refs_of[key] = generate_ref(merged, p, n)
                del merged
            return refs_of[key]

        bank = AdapterBank(model, config=lora, max_adapters=3)
        serve_exact(model, work, f"adapters (base + 2 tenants, rank {lora.rank}) on the "
                    f"{label} base", ref, adapters=bank, adapters_of=tenants, **kw)
        del bank
    del dq

    # Monolithic prefill: one capture per 128-bucket used.
    _, _, counts, events, _ = serve_exact(model, work, "monolithic prefill (prefill_chunk=None)",
                                          refs, captures_ok=True, prefill_chunk=None,
                                          paged=False)
    buckets = sorted(n for n in counts if n.startswith("prefill_"))
    # The 128-bucket of each prompt (and of warmup's 1-token prompt), capped
    # at max_len.
    want = sorted({f"prefill_{min(-(-n // 128) * 128, SERVE['exact_max_len'])}"
                   for n in [1] + [p.shape[1] for p, _ in work]})
    print(f"    buckets captured {buckets} (each once), {len(events)} of them after warmup")
    if buckets != want or any(v != 1 for v in counts.values()) or len(events) != len(want) - 1:
        fail(f"monolithic prefill captured {counts}, expected one graph per bucket {want}")

    # int8 KV pages: reported, not asserted (quantized K/V).
    serve_exact(model, work, "kv_dtype=int8 against generate", refs, check=False,
                kv_dtype="int8")
    del model

    # A ring model (window 64 < max_len): token-exact, with freed pages.
    ring, rwork = exact_requests(cfg, sliding_window=EXTRA["exact_window"])
    rrefs = [generate_ref(ring, p, n) for p, n in rwork]
    _, _, _, _, pages = serve_exact(ring, rwork, f"sliding window {EXTRA['exact_window']} "
                                    "(64-token pages)", rrefs, page_size=64)
    print(f"    pages freed behind the window: {pages['window_pages_freed']}")
    if pages["window_pages_freed"] < 1:
        fail("the sliding-window engine freed no page")
    del ring
    free_cuda()


def seeded_adapter(model, lora, seed):
    """A random adapter for ``model``: ``a`` as LoRA initialises it, ``b``
    nonzero, both from a seeded generator on the card."""
    import torch

    from accelerate_tpu_torch.adapters import init_lora_params

    gen = torch.Generator(device="cuda").manual_seed(seed)
    ad = init_lora_params(gen, model, lora)
    for mod in ad.values():
        mod["b"] = 0.05 * torch.randn(mod["b"].shape, generator=gen, device="cuda")
    return ad


def tick_replay(engine):
    """One tick of the stopped ``engine`` with every slot active on a full
    page table (decode, or the speculative verify), replayed from its graph."""
    import numpy as np

    S, Np = engine.max_slots, engine._pages_per_slot
    table = (1 + np.arange(S * Np) % engine.total_pages).reshape(S, Np)
    parts = [("active", np.ones(S, np.int64)), ("table", table)]
    name, step = "decode", engine._decode_step
    if engine._spec_k is not None:
        name, step = "spec", engine._spec_step
        if engine._dtable is not None:
            parts.append(("dtable", table))
        parts.append(("remaining", np.full(S, engine._spec_k + 1, np.int64)))
        if engine._spec_mode == "lookup":
            parts.append(("proposals", np.zeros((S, engine._spec_k), np.int64)))

    def tick():
        engine._launch(name, step, engine._decode_in, engine._decode_stage[0], parts)
        engine._decode_host_out[0].copy_(engine._decode_out.view(-1))

    return tick


def serve_schedule(engine, schedule):
    """Submit ``schedule`` on its arrival times, wait, check completion and
    captures; returns (requests, wall s, metrics, ITL samples ms)."""
    import torch

    from accelerate_tpu_torch.serving import RequestStatus

    t0 = time.perf_counter()
    reqs = []
    for arrival, prompt, new, adapter in schedule:
        time.sleep(max(0.0, arrival - (time.perf_counter() - t0)))
        reqs.append(engine.submit(prompt, max_new_tokens=new, ignore_eos=True, adapter=adapter))
    for r in reqs:
        r.wait(900)
    wall = time.perf_counter() - t0
    bad = [r for r in reqs if r.status is not RequestStatus.COMPLETED]
    if bad or any(len(r.tokens) != item[2] for r, item in zip(reqs, schedule)):
        fail(f"{len(bad)} of {len(reqs)} requests did not complete: {bad[:3]}")
    if engine.compile_watcher.events:
        fail(f"captures after warmup: {engine.compile_watcher.events}")
    s = engine.serving_metrics()
    itl = [dur * 1e3 for _, _, dur, name, _, _, _ in engine.trace_events() if name == "itl"]
    torch.cuda.synchronize()
    return reqs, wall, s, itl


def full_depth_modes(model):
    """Phase 4d at full depth: 4c's engine shape and seeded schedule in four
    modes (speculation by lookup and by a draft model, int8 KV, int8 weights
    with 4 LoRA tenants)."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import LlamaConfig, LlamaForCausalLM, ServingEngine
    from accelerate_tpu_torch.adapters import AdapterBank, LoRAConfig

    card = card_line()
    cfg = model.config
    own = {t.data_ptr(): t.numel() * t.element_size() for t in model.state_dict().values()}
    schedule = serving_schedule(cfg.vocab_size,
                                torch.Generator(device="cuda").manual_seed(SERVE["seed"]))
    shape = dict(max_slots=SERVE["slots"], max_len=SERVE["max_len"], prefill_chunk=SERVE["chunk"],
                 cache_dtype=torch.bfloat16, trace_capacity=1 << 15)
    fp_pool = ServingEngine(model, autostart=False, **shape)
    fp_bytes = fp_pool.kv_cache_per_chip_bytes()
    fp_pool.shutdown()
    del fp_pool
    free_cuda()
    K, cut = EXTRA["spec_tokens"], EXTRA["cut_requests"]
    lora = LoRAConfig(rank=EXTRA["lora_rank"], target_modules=EXTRA["lora_targets"])
    tenants = [f"t{i}" for i in range(EXTRA["adapters"])]

    def draft_model():
        gen = torch.Generator(device="cuda").manual_seed(53)
        dcfg = LlamaConfig.llama3_8b(**EXTRA["draft"])
        return LlamaForCausalLM(dcfg, device="cuda", dtype=torch.bfloat16, generator=gen).eval()

    modes = [
        ("a", f"spec_lookup={EXTRA['spec_lookup']}, spec_tokens={K}", None,
         lambda: dict(spec_lookup=EXTRA["spec_lookup"], spec_tokens=K)),
        ("b", f"draft_model=Llama-3.2-1B shape, spec_tokens={K}", cut,
         lambda: dict(draft_model=draft_model(), spec_tokens=K,
                      max_pages=2 * SERVE["slots"] * -(-SERVE["max_len"] // SERVE["chunk"]))),
        ("c", "kv_dtype=int8", cut, lambda: dict(kv_dtype="int8")),
        ("d", f"weights_dtype=int8, {len(tenants)} LoRA adapters of rank {lora.rank} on q/k/v/o",
         cut, lambda: dict(weights_dtype="int8",
                           adapters=AdapterBank(model, config=lora,
                                                max_adapters=len(tenants) + 1))),
    ]
    results = {}
    for key, label, n_req, make in modes:
        work = schedule if n_req is None else schedule[:n_req]
        if n_req is not None:
            print(f"  mode ({key}) runs the first {n_req} of the {len(schedule)} requests of 4c's "
                  "schedule (to keep the script's time)")
        items = [(a, p, n, tenants[i % len(tenants)] if key == "d" else None)
                 for i, (a, p, n) in enumerate(work)]
        torch.cuda.reset_peak_memory_stats()
        kw = make()
        t0 = time.perf_counter()
        engine = ServingEngine(model, **shape, **kw)
        warm_s = time.perf_counter() - t0
        if key == "d":
            for i, name in enumerate(tenants):
                engine.register_adapter(name, seeded_adapter(model, lora, 200 + i))
        try:
            reqs, wall, s, itl = serve_schedule(engine, items)
            pool_bytes = engine.kv_cache_per_chip_bytes()
            bank = engine.adapters.counters() if engine.adapters is not None else None
            peak = torch.cuda.max_memory_allocated()
            # The int8 projections are a copy beside the caller's model.
            copy_bytes = sum(t.numel() * t.element_size()
                             for t in engine.module.state_dict().values()
                             if t.data_ptr() not in own)
        finally:
            engine.shutdown(drain=False, timeout=600)
        with torch.inference_mode(), torch.cuda.stream(engine._stream):
            tick = tick_replay(engine)
            tick_ms = timed_ms(tick, 10)
            device_breakdown(f"({key}) tick, graph replay", tick, top=5)
            del tick   # its closure holds the engine: drop it before the next mode
        tokens = sum(len(r.tokens) for r in reqs)
        line = (f"  ({key}) {label}, bf16, full depth ({card}): warmup {warm_s:.1f} s; "
                f"{len(reqs)} requests, {tokens} new tokens in {wall:.3f} s; graphed tick "
                f"{tick_ms:.3f} ms ({SERVE['slots']} slots); decode "
                f"{s['decode_tokens_per_sec']:.1f} "
                f"tokens/s over {s['decode_ticks']} ticks; TTFT p50 {s['ttft_ms_p50']:.1f} ms, p95 "
                f"{s['ttft_ms_p95']:.1f} ms; ITL p50 {percentile(itl, 0.5):.2f} ms, p99 "
                f"{percentile(itl, 0.99):.2f} ms ({len(itl)} samples); host "
                f"{s['host_us_per_tick']:.1f} us a tick; peak memory {peak / 2**30:.2f} GiB "
                f"(the bf16 model {sum(own.values()) / 2**30:.2f} GiB of it); "
                f"pool {pool_bytes / 2**30:.3f} GiB (4c's bf16 pool {fp_bytes / 2**30:.3f} GiB); "
                f"captures after warmup 0")
        if key in ("a", "b"):
            # A round is one slot's verify: K drafts proposed.
            per_round = K * s["spec_accepted_tokens"] / max(1, s["spec_proposed_tokens"])
            line += (f"; accepted drafts a slot's round {per_round:.3f}"
                     f" (accept rate {s['spec_accept_rate']:.4f}, lookup hit rate "
                     f"{s['spec_lookup_hit_rate']:.4f})")
        if bank is not None:
            line += f"; bank loads {bank['loads']}, evictions {bank['evictions']}"
        if copy_bytes:
            line += (f"; int8 weight copy {copy_bytes / 2**30:.2f} GiB beside the caller's bf16 "
                     "model, which stays resident while the caller holds it")
        print(line)
        results[key] = dict(tick_ms=tick_ms, pool_bytes=pool_bytes)
        del engine, kw, reqs
        free_cuda()
    if results["c"]["pool_bytes"] >= fp_bytes:
        fail(f"the int8 KV pool ({results['c']['pool_bytes']} B) is not below 4c's ({fp_bytes} B)")
    return results


def sliding_window_full_width():
    """Phase 4d's ring model at Mistral-7B's shapes: pages behind the
    window freed as streams advance."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import LlamaConfig, LlamaForCausalLM, ServingEngine

    card = card_line()
    W = EXTRA["window"]
    cfg = LlamaConfig.llama3_8b(**W["config"])
    gen = torch.Generator(device="cuda").manual_seed(W["seed"])
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, generator=gen).eval()
    build_s = time.perf_counter() - t0
    lo, hi = W["prompts"]
    lengths = torch.randint(lo, hi + 1, (W["requests"],), generator=gen, device="cuda").tolist()
    items = [(0.0, p, W["new"], None) for p in stream_prompts(cfg.vocab_size, lengths, gen)]
    engine = ServingEngine(model, max_slots=W["slots"], max_len=W["max_len"],
                           prefill_chunk=SERVE["chunk"], cache_dtype=torch.bfloat16,
                           prefix_cache_mb=0, trace_capacity=1 << 15)
    try:
        reqs, wall, s, itl = serve_schedule(engine, items)
        pages = engine.page_pool_metrics()
    finally:
        engine.shutdown(drain=False, timeout=600)
    with torch.inference_mode(), torch.cuda.stream(engine._stream):
        tick_ms = timed_ms(tick_replay(engine), 10)
    P = engine.page_size
    unfreed = sum(sorted((-(-(p.shape[1] + n) // P) for _, p, n, _ in items),
                         reverse=True)[:W["slots"]])
    print(f"  sliding window {cfg.sliding_window}, Mistral-7B shapes ({cfg.num_hidden_layers} "
          f"layers, vocab {cfg.vocab_size}), bf16 ({card}): built in {build_s:.1f} s; "
          f"{W['slots']} slots x {W['max_len']} tokens; {len(reqs)} requests of "
          f"{min(lengths)}-{max(lengths)} prompt tokens + {W['new']} new in {wall:.3f} s; pages "
          f"freed behind the window {pages['window_pages_freed']}; pages in use at most "
          f"{s['pages_used_max']} of {pages['pages_total']} (without freeing the {W['slots']} "
          f"largest streams hold {unfreed}); graphed tick {tick_ms:.3f} ms; TTFT p50 "
          f"{s['ttft_ms_p50']:.1f} ms, p95 {s['ttft_ms_p95']:.1f} ms; ITL p50 "
          f"{percentile(itl, 0.5):.2f} ms; decode {s['decode_tokens_per_sec']:.1f} tokens/s")
    if pages["window_pages_freed"] < 1:
        fail("the sliding-window engine freed no page at full width")
    del engine, model
    free_cuda()


def phase_serving_extras(model):
    """Phase 4d (see the module docstring)."""
    serving_extras_exactness(model.config)
    full_depth_modes(model)
    sliding_window_full_width()


# -- phase 4e: the serving fleet (router, supervisor, chaos, gateway) -----------------


def http_completion(url, body, timeout=600):
    """POST one completion: ``(status, final summary, streamed tokens)``;
    the streamed tokens are None for a JSON (non-stream) request."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url + "/v1/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            text = resp.read().decode()
            if not body.get("stream"):
                return resp.status, json.loads(text), None
            events = [json.loads(b[len("data: "):]) for b in text.split("\n\n")
                      if b.startswith("data: ")]
            return resp.status, events[-1], [e["token"] for e in events[:-1]]
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), None


def wait_until(predicate, timeout, what):
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            fail(f"timed out after {timeout} s waiting for {what}")
        time.sleep(0.01)


def fleet_exactness(cfg):
    """Phase 4e's exact half: 2 replicas of a 2-layer f32 model at the
    model's widths behind the asyncio gateway; a chaos kill of replica 0;
    every stream over HTTP token-exact with ``generate``."""
    import dataclasses
    import threading

    import torch

    from accelerate_tpu_torch import LlamaForCausalLM, ServingEngine, generate
    from accelerate_tpu_torch.serving import (ChaosSchedule, FleetSupervisor, GatewayConfig,
                                              ReplicaSet, ReplicaState, ServingGateway)

    gen = torch.Generator(device="cuda").manual_seed(FLEET["exact_seed"])
    small = dataclasses.replace(cfg, num_hidden_layers=2)
    model = LlamaForCausalLM(small, device="cuda", dtype=torch.float32, generator=gen).eval()
    f32, new = torch.float32, SERVE["exact_new"]
    lo, hi = SERVE["exact_prompts"]
    lengths = [int(n) for n in torch.randint(lo, hi + 1, (SERVE["exact_requests"],),
                                             generator=gen, device="cuda").tolist()]
    # The last prompt, shorter than a chunk (no cached prefix steers it),
    # goes to the restarted replica after the run.
    work = stream_prompts(cfg.vocab_size, lengths + [SERVE["chunk"] // 2], gen)
    refs = [generate(model, torch.from_numpy(p).long().cuda(), max_new_tokens=new,
                     cache_dtype=f32)[0, p.shape[1]:].tolist() for p in work]
    (last, last_ref), work, refs = (work[-1], refs[-1]), work[:-1], refs[:-1]
    shape = dict(max_slots=SERVE["exact_slots"], max_len=SERVE["exact_max_len"],
                 prefill_chunk=SERVE["chunk"], cache_dtype=f32)

    def factory():
        return ServingEngine(model, **shape)

    chaos = ChaosSchedule().kill(at_tick=FLEET["exact_kill_tick"])
    fleet = ReplicaSet([ServingEngine(model, chaos=chaos, **shape), factory()],
                       factories=[factory, factory])
    results = [None] * len(work)
    with FleetSupervisor(fleet, hang_timeout_s=FLEET["hang_timeout_s"], poll_interval_s=0.02,
                         restart_backoff_s=0.05) as sup, \
            ServingGateway(fleet, config=GatewayConfig(server="asyncio", port=0)) as gw:

        def call(i):
            results[i] = http_completion(gw.url, {"prompt": work[i].ravel().tolist(),
                                                  "max_new_tokens": new, "stream": i % 2 == 1})

        cpu0 = thread_cpu_s(gw._server._loop)
        threads = []
        per = -(-len(work) // 3)
        for wave in range(3):  # staggered: later requests join a batch already decoding
            for i in range(wave * per, min(len(work), (wave + 1) * per)):
                threads.append(threading.Thread(target=call, args=(i,)))
                threads[-1].start()
            time.sleep(0.05)
        for t in threads:
            t.join(600)
        gateway_cpu = thread_cpu_s(gw._server._loop) - cpu0
        wait_until(lambda: fleet.replica_states()[0] is ReplicaState.HEALTHY
                   and sup.restarts == 1, 300, "replica 0's restart")
        # Both replicas idle: the tie goes to replica 0, which must serve.
        again = http_completion(gw.url, {"prompt": last.ravel().tolist(), "max_new_tokens": new})
        survivor_captures = list(fleet.engine(1).compile_watcher.events)
    same = sum(code == 200 and final["tokens"] == ref and (toks is None or toks == ref)
               for (code, final, toks), ref in zip(results, refs))
    failovers = sum(final.get("failovers", 0) for _, final, _ in results)
    served_again = again[0] == 200 and again[1]["tokens"] == last_ref \
        and again[1]["replica_trail"] == [0]
    print(f"  f32, 2 layers at the model's widths ({card_line()}), 2 replicas x "
          f"{shape['max_slots']} slots behind the asyncio gateway, kill of replica 0 at decode "
          f"tick {FLEET['exact_kill_tick']}: "
          f"{same} of {len(work)} streams over HTTP ({len(work) // 2} JSON, {len(work) // 2} SSE) "
          f"equal generate; {failovers} failovers; supervisor events "
          f"{[e['kind'] for e in sup.events()]}; replica 0 back HEALTHY and "
          f"{'served a stream equal to generate' if served_again else 'DID NOT SERVE'}; "
          f"captures after warmup on the survivor {survivor_captures}; gateway loop thread "
          f"{gateway_cpu * 1e6 / (len(work) * new):.1f} us of CPU per token")
    if same != len(work) or failovers < 1 or not served_again or survivor_captures:
        fail("the fleet is not token-exact across a failover, or replica 0 did not come back")


class FixedSchedule:
    """An ``ArrivalSchedule`` stand-in for ``loadgen.run_open_loop``: the
    arrival offsets of a given schedule."""

    def __init__(self, offsets):
        import numpy as np

        self._offsets = np.asarray(offsets, dtype=float)
        self.n = len(self._offsets)

    def offsets(self):
        return self._offsets.copy()

    def describe(self):
        return {"n": self.n, "dist": "phase 4c's seeded schedule",
                "span_s": float(self._offsets[-1] - self._offsets[0])}


class FixedProfile:
    """A ``TrafficProfile`` stand-in: the given request bodies, in order."""

    def __init__(self, bodies):
        self._bodies = list(bodies)
        self._next = 0

    def sample(self, vocab_size=None):
        body = self._bodies[self._next]
        self._next += 1
        return body

    def describe(self):
        return {"requests": len(self._bodies)}


def thread_cpu_s(loop):
    """CPU seconds the thread running asyncio ``loop`` has used."""
    import asyncio

    async def read():
        return time.thread_time()

    return asyncio.run_coroutine_threadsafe(read(), loop).result(60)


def tick_beside(engines, card):
    """Each replica's graphed decode tick (all slots) alone, and while the
    other replica replays its own tick on its stream without pause."""
    import threading

    import torch

    def timed(engine):
        with torch.inference_mode(), torch.cuda.stream(engine._stream):
            return timed_ms(replay_tick(engine, True), 20)

    alone = [timed(e) for e in engines]
    beside = []
    for i, engine in enumerate(engines):
        other = engines[1 - i]
        stop = threading.Event()

        def spin():
            with torch.inference_mode(), torch.cuda.stream(other._stream):
                tick = replay_tick(other, True)
                while not stop.is_set():
                    tick()

        t = threading.Thread(target=spin)
        t.start()
        time.sleep(0.2)
        try:
            beside.append(timed(engine))
        finally:
            stop.set()
            t.join(60)
        torch.cuda.synchronize()
    ref = SERVING_4C.get("tick_ms")
    print(f"  graphed decode tick, {engines[0].max_slots} slots ({card}): replica 0 alone "
          f"{alone[0]:.3f} ms, beside replica 1's {beside[0]:.3f} ms; replica 1 alone "
          f"{alone[1]:.3f} ms, beside replica 0's {beside[1]:.3f} ms; 4c's single engine "
          + (f"{ref:.3f} ms in this run" if ref else "not run in this call"))
    return alone, beside


def fleet_full_width(model):
    """Phase 4e at full depth: 2 replicas sharing the weights, behind the
    asyncio gateway with a supervisor; loadgen drives 4c's schedule over
    HTTP; a chaos kill of replica 0 at decode tick ``FLEET['kill_tick']``."""
    import gc
    import threading
    import weakref

    import torch

    from accelerate_tpu_torch import ServingEngine
    from accelerate_tpu_torch.loadgen import build_report, percentile as lg_percentile
    from accelerate_tpu_torch.loadgen import run_open_loop
    from accelerate_tpu_torch.observability import lint_prometheus_text
    from accelerate_tpu_torch.serving import (ChaosSchedule, FleetSupervisor, GatewayConfig,
                                              PrefixCache, ReplicaSet, ReplicaState,
                                              ServingGateway)

    card = card_line()
    cfg = model.config
    schedule = serving_schedule(cfg.vocab_size,
                                torch.Generator(device="cuda").manual_seed(SERVE["seed"]))
    weights = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    # One prefix cache for the fleet (restores by copy): a prefix the dead
    # replica cached is still a hit when its streams resume on the survivor.
    cache = PrefixCache(SERVE["prefix_cache_gib"] << 30)
    shape = dict(max_slots=SERVE["slots"], max_len=SERVE["max_len"], prefill_chunk=SERVE["chunk"],
                 cache_dtype=torch.bfloat16, trace_capacity=1 << 15, prefix_cache=cache)

    def factory():
        return ServingEngine(model, **shape)  # the same model: no copy of the weights

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    chaos = ChaosSchedule().kill(at_tick=FLEET["kill_tick"])
    fleet = ReplicaSet([ServingEngine(model, chaos=chaos, **shape), factory()],
                       factories=[factory, factory])
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    built = torch.cuda.memory_allocated()
    bodies = [{"prompt": p.ravel().tolist(), "max_new_tokens": new, "ignore_eos": True}
              for _, p, new in schedule]
    sched = FixedSchedule([a for a, _, _ in schedule])

    # Device memory through the run: sampled every 5 ms; the peak counter
    # is reset when replica 0 is seen dead, so it reads the restart's peak,
    # and a weak reference to the dead engine shows whether it is freed.
    samples, dead, stop = [], [], threading.Event()

    def sample_memory():
        while not stop.is_set():
            engine = fleet.replicas[0].engine
            if not dead and engine.error is not None:
                dead.append(weakref.ref(engine))
                torch.cuda.reset_peak_memory_stats()
            del engine
            samples.append((time.monotonic(), torch.cuda.memory_allocated()))
            time.sleep(0.005)

    sampler = threading.Thread(target=sample_memory, daemon=True)
    config = GatewayConfig(server="asyncio", port=0, shed_projected_pressure=False)
    sup = FleetSupervisor(fleet, hang_timeout_s=FLEET["hang_timeout_s"], poll_interval_s=0.02,
                          restart_backoff_s=0.05)
    try:
        with ServingGateway(fleet, config=config) as gw:
            sup.start()
            sampler.start()
            loop = gw._server._loop
            reset_counts()
            cpu0 = thread_cpu_s(loop)
            t0 = time.perf_counter()
            run = run_open_loop(gw.url, sched, FixedProfile(bodies), wall_deadline_s=600)
            wall = time.perf_counter() - t0
            gateway_cpu = thread_cpu_s(loop) - cpu0
            launched = read_counts()
            wait_until(lambda: fleet.replica_states()[0] is ReplicaState.HEALTHY
                       and sup.restarts == 1, 600, "replica 0's restart")
            gc.collect()
            torch.cuda.synchronize()
            after = torch.cuda.memory_allocated()
            restart_peak = torch.cuda.max_memory_allocated()
            stop.set()
            sampler.join(60)
            metrics_text = scrape_metrics(gw.url)
            survivor_captures = list(fleet.engine(1).compile_watcher.events)
            dead_stats = fleet._retired_stats.summary()
            live = [fleet.engine(i).serving_metrics() for i in range(2)]
            fm = fleet.fleet_metrics()
            sup.stop()  # before the gateway drains the replicas: no restart of a drained one
    finally:
        stop.set()
        sup.stop()
        fleet.shutdown(drain=False, timeout=600)
    report = build_report(run, sched)
    results = run["results"]
    if launched != {k: 0 for k in launched}:
        fail(f"the serving fleet launched flash kernels: {launched}")
    bad = [r.index for r, (_, _, new) in zip(results, schedule)
           if r.code != 200 or not r.completed or len(r.tokens) != new]
    if bad:
        fail(f"requests {bad} did not end 200 with their full token count")
    lint = lint_prometheus_text(metrics_text)
    failovers = sum(r.done.get("failovers", 0) for r in results)
    restarts = [e for e in sup.events() if e["kind"] == "restart"]
    kill_ts = next(e["ts"] for e in fleet.failover_reports[0]["flight_recorder"]["events"]
                   if e["kind"] == "chaos_kill")
    before = ([m for t, m in samples if t < kill_ts] or [float("nan")])[-1]
    freed = bool(dead) and dead[0]() is None
    if lint or failovers < 1 or not restarts or survivor_captures or not freed:
        fail(f"fleet: promlint {lint[:3]}, {failovers} failovers, restarts {restarts}, "
             f"captures after warmup on the survivor {survivor_captures}, dead engine "
             f"{'freed' if freed else 'STILL REFERENCED'}")
    ttfts = [r.ttft_s * 1e3 for r in results]
    itls = [g * 1e3 for r in results for g in r.token_gaps_s]
    tokens = sum(len(r.tokens) for r in results)
    decode_tps = (dead_stats["decode_tokens_per_sec"] + live[0]["decode_tokens_per_sec"]
                  + live[1]["decode_tokens_per_sec"])
    gib = 2 ** 30
    ref = SERVING_4C
    print(f"  bf16, full depth, 2 replicas x {SERVE['slots']} slots x {SERVE['max_len']} tokens "
          f"sharing the {weights / gib:.2f} GiB of weights, one {SERVE['prefix_cache_gib']} GiB "
          f"prefix cache, asyncio gateway, supervisor ({card}): both built and warmed in "
          f"{build_s:.1f} s; 4c's {len(results)} requests by loadgen over HTTP (SSE), kill of "
          f"replica 0 at decode tick {FLEET['kill_tick']}: all 200 with their full token "
          f"counts in {wall:.3f} s ({tokens} tokens); {failovers} failovers; replica 0 "
          f"restarted in {restarts[0]['warmup_s']:.3f} s (factory, warmup and graph capture) and "
          f"HEALTHY; no capture after warmup on the survivor; /metrics passes promlint; no "
          f"flash launch; pressure shedding off")
    print(f"  loadgen over HTTP ({card}): TTFT p50 {lg_percentile(ttfts, 50):.1f} ms, p95 "
          f"{lg_percentile(ttfts, 95):.1f} ms; ITL p50 {lg_percentile(itls, 50):.2f} ms, p99 "
          f"{lg_percentile(itls, 99):.2f} ms ({len(itls)} gaps); 4c in-process in this run: "
          + (f"TTFT p50 {ref['ttft_p50']:.1f} ms, p95 {ref['ttft_p95']:.1f} ms; ITL p50 "
             f"{ref['itl_p50']:.2f} ms, p99 {ref['itl_p99']:.2f} ms"
             if "ttft_p50" in ref else "not run in this call"))
    print(f"  ({card}) decode tokens/s summed over the replicas {decode_tps:.1f} (replica 0 "
          f"before the kill {dead_stats['decode_tokens_per_sec']:.1f}, after the restart "
          f"{live[0]['decode_tokens_per_sec']:.1f}, replica 1 "
          f"{live[1]['decode_tokens_per_sec']:.1f}; 4c's one engine "
          + (f"{ref['tokens_per_s']:.1f}" if "tokens_per_s" in ref else "not run")
          + f"); fleet failovers {fm['fleet_failovers']}, "
          f"fences {fm['fleet_fences']}, restarts {fm['fleet_restarts']}; gateway host "
          f"{gateway_cpu * 1e6 / max(1, tokens):.1f} us of its loop thread's CPU per streamed "
          f"token; loadgen conformance {report['conformance']}")
    print(f"  device memory allocated ({card}): weights {weights / gib:.2f} GiB; "
          f"{(built - base) / gib:.2f} GiB for the 2 engines; before the kill "
          f"{before / gib:.2f} GiB; restart peak {restart_peak / gib:.2f} GiB; after the "
          f"restart (dead engine collected) {after / gib:.2f} GiB")
    return fleet


def scrape_metrics(url):
    import urllib.request

    with urllib.request.urlopen(url + "/metrics", timeout=60) as resp:
        return resp.read().decode()


def phase_fleet(model):
    """Phase 4e (see the module docstring)."""
    fleet_exactness(model.config)
    free_cuda()
    fleet = fleet_full_width(model)
    tick_beside([fleet.engine(0), fleet.engine(1)], card_line())
    del fleet
    free_cuda()


def device_breakdown(label, fn, steps=1, top=4):
    """Profile ``fn`` once and print where the device time went: wall time,
    summed kernel time (the device's busy share of the wall), kernel time by
    kind and the ``top`` kernels. User-annotated ranges (such as the
    optimizer's ``Optimizer.step`` range, which the profiler also lists on
    the device) are not kernels and are left out of the sums. The profiler
    adds host overhead, so the wall time here is above the unprofiled one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    times = {e.key: e.self_device_time_total / 1e3 for e in kernels}  # ms
    count = sum(e.count for e in kernels)
    busy = sum(times.values())
    if busy <= 0:
        print(f"  profile {label}: the profiler saw no device time (not measured)")
        return

    def kind(name):
        for kernel in ("flash_fwd_sm90", "flash_bwd_dkdv_sm90", "flash_bwd_dq_sm90", "flash_fwd",
                       "flash_bwd_dkdv", "flash_bwd_dq"):
            if f"{kernel}_kernel" in name:
                return kernel
        if any(t in name.lower() for t in ("gemm", "xmma", "cutlass", "nvjet", "matmul")):
            return "matmul"
        return "other"

    by_kind = {}
    for name, ms in times.items():
        by_kind[kind(name)] = by_kind.get(kind(name), 0.0) + ms
    kinds = ", ".join(f"{k} {v / steps:.3f} ms" for k, v in sorted(by_kind.items(),
                                                                   key=lambda kv: -kv[1]))
    top = sorted(times.items(), key=lambda kv: -kv[1])[:top]
    print(f"  profile {label}: wall {wall_ms / steps:.3f} ms, device busy {busy / steps:.3f} ms "
          f"({100 * busy / wall_ms:.1f}% of wall), {count / steps:.0f} kernels; by kind: {kinds}")
    for name, ms in top:
        print(f"    {ms / steps:9.3f} ms  {name[:110]}")
    return dict(wall_ms=wall_ms / steps, busy_ms=busy / steps, kernels=count / steps)


def phase_profile(model, gen):
    import torch

    from accelerate_tpu_torch import init_kv_cache

    cfg = model.config
    ids = torch.randint(0, cfg.vocab_size, (MAIN["B"], MAIN["S"]), generator=gen, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (1, 512), generator=gen, device="cuda")
    steps = 8
    with torch.inference_mode():
        device_breakdown(f"forward {MAIN['B']}x{MAIN['S']}", lambda: model(ids))
        cache = init_kv_cache(cfg, 1, 640, torch.bfloat16, device="cuda")
        _, cache = model(prompt, cache=cache, cache_pos=0)
        tok = prompt[:, -1:]

        def decode():
            for t in range(steps):
                model(tok, cache=cache, cache_pos=512 + t)

        decode()  # warm-up
        device_breakdown(f"decode step (batch 1, 512-token context, per step of {steps})",
                         decode, steps=steps)


# ---------------------------------------------------------------------------
# Phase 4f: big-model inference
# ---------------------------------------------------------------------------

def streamed_block_bytes(streamed) -> int:
    """The largest block's bytes that a pass streams onto the card (its
    host and disk entries; its card entries count as resident)."""
    from accelerate_tpu_torch.big_modeling import LazyWeight

    store, largest = streamed.store, 0
    for spec in streamed.specs:
        total = 0
        for prefix in spec.prefixes:
            for name in store.names_under(prefix):
                if store.placement[name] in ("cpu", "disk"):
                    val = store.entries[name]
                    total += val.nbytes if isinstance(val, LazyWeight) else \
                        val.numel() * val.element_size()
        largest = max(largest, total)
    return largest


def mem_available_gb() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def check_room(directory, disk_gb, ram_gb, what):
    import shutil

    free = shutil.disk_usage(directory).free / 1e9
    avail = mem_available_gb()
    print(f"  {what}: {free:.1f} GB free on {directory}, MemAvailable {avail:.1f} GB "
          f"(needs {disk_gb:.1f} GB of disk and {ram_gb:.1f} GB of RAM)")
    if free < disk_gb:
        fail(f"{directory} has {free:.1f} GB free; {what} needs {disk_gb:.1f} GB "
             "(set TMPDIR to a larger disk)")
    if avail < ram_gb:
        fail(f"MemAvailable is {avail:.1f} GB; {what} needs {ram_gb:.1f} GB")


def timed_passes(streamed):
    """Wrap ``streamed``'s passes: each ends with a synchronize and appends
    its end time to the returned list (a decode token is one pass)."""
    import torch

    marks, run = [], streamed._run

    def wrapped(step, specs=None):
        out = run(step, specs)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return out

    streamed._run = wrapped
    return marks


def big_model_exactness(cfg):
    """Phase 4f's exact half: a 2-layer f32 model at the model's widths,
    exported to an HF directory in shards and loaded back on every tier;
    each tier's logits and greedy tokens against the resident model's."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from accelerate_tpu_torch import (LlamaForCausalLM, QuantizationConfig, cpu_offload_with_hook,
                                      dequantize_params, disk_offload, generate,
                                      init_empty_weights, load_and_quantize_hf_checkpoint,
                                      load_hf_checkpoint_and_dispatch, save_hf_checkpoint,
                                      save_model)
    from accelerate_tpu_torch.utils.modeling import compute_module_sizes
    from accelerate_tpu_torch.utils.quantization import quantized_nbytes

    f32, card = torch.float32, card_line()
    gen = torch.Generator(device="cuda").manual_seed(BIG["exact_seed"])
    small = dataclasses.replace(cfg, num_hidden_layers=2)
    model = LlamaForCausalLM(small, device="cuda", dtype=f32, generator=gen).eval()
    weights = sum(p.numel() * 4 for p in model.parameters())
    ids = torch.randint(0, cfg.vocab_size, (1, BIG["exact_len"]), generator=gen, device="cuda")
    prompt = ids[:, :BIG["exact_prompt"]]
    with torch.inference_mode():
        ref = model(ids)
    refs = {n: generate(model, prompt, max_new_tokens=n, cache_dtype=f32)
            for n in (BIG["exact_new"], BIG["exact_disk_new"])}
    with init_empty_weights():
        meta = LlamaForCausalLM(small)
    sizes = compute_module_sizes(meta)
    embed, layer = sizes["model.embed_tokens"], sizes["model.layers.0"]
    # The solver visits lm_head first (the JAX package's natural order) and,
    # once the model spills past the card, keeps room for the largest unit
    # (the head) on card 0: this budget puts the head on the card, the
    # embedding and layer 0 in host memory, layer 1 and the final norm on
    # disk (the head cannot share the card with the embedding and spill).
    auto_budget = {0: 2 * sizes["lm_head"], "cpu": embed + layer}
    # The maps whose head streams from disk decode fewer tokens: each token
    # reads the 2.1 GB head (and, all on disk, the 2.1 GB embedding) again.
    few, many = BIG["exact_disk_new"], BIG["exact_new"]
    ways = {"card {'': 0}": ({"": 0}, None, many),
            "host {'': 'cpu'}": ({"": "cpu"}, None, many),
            "disk {'': 'disk'} (lazy refs)": ({"": "disk"}, None, few),
            "explicit mixed (embed, layer 0 card; layer 1 host; norm, head disk)": (
                {"model.embed_tokens": 0, "model.layers.0": 0, "model.layers.1": "cpu",
                 "model.norm": "disk", "lm_head": "disk"}, None, few),
            "auto": ("auto", auto_budget, many)}
    root = tempfile.mkdtemp(prefix="chip_smoke_big_")
    try:
        check_room(root, 3.2 * weights / 1e9, 3 * weights / 1e9, "4f exactness")
        hf = os.path.join(root, "hf")
        t0 = time.perf_counter()
        save_hf_checkpoint(model, hf, small, "llama", max_shard_size=BIG["exact_shard"])
        shards = sorted(n for n in os.listdir(hf) if n.endswith(".safetensors"))
        print(f"  f32, 2 layers at the model's widths ({card}): HF directory of "
              f"{weights / 1e9:.2f} GB in {len(shards)} shards written in "
              f"{time.perf_counter() - t0:.1f} s; logits on 1 x {BIG['exact_len']} tokens "
              f"(limit: max |diff| <= {BIG['exact_atol']:g}), greedy tokens from a "
              f"{BIG['exact_prompt']}-token prompt (token-exact)")
        if len(shards) < 2:
            fail("the exactness checkpoint was not sharded")
        for label, (device_map, budget, new) in ways.items():
            t0 = time.perf_counter()
            streamed, _ = load_hf_checkpoint_and_dispatch(hf, device_map=device_map,
                                                          max_memory=budget, dtype=f32)
            load_s = time.perf_counter() - t0
            placed = sorted({str(p) for p in streamed.store.placement.values()})
            logits = streamed(ids)
            err = (logits - ref).abs().max().item()
            identical = torch.equal(logits, ref)
            tokens = streamed.generate(prompt, max_new_tokens=new, cache_dtype=f32)
            exact = torch.equal(tokens, refs[new])
            where = ""
            if device_map == "auto":
                where = " map " + ", ".join(
                    f"{k}: {v}" for k, v in sorted({
                        name.rsplit(".", 1)[0] if ".layers." not in name
                        else ".".join(name.split(".")[:3]): p
                        for name, p in streamed.store.placement.items()}.items()))
            print(f"    {label}: loaded in {load_s:.2f} s, tiers {placed},{where} logits max |diff| "
                  f"{err:.3e} ({'bit-identical' if identical else 'not bit-identical'}), "
                  f"{new} greedy tokens {'equal' if exact else 'DIFFER FROM'} generate's")
            if not (err <= BIG["exact_atol"] and exact):
                fail(f"the streamed model ({label}) disagrees with the resident model")
            if device_map == "auto" and set(placed) != {"0", "cpu", "disk"}:
                fail(f"the auto map used tiers {placed}, not card, host and disk")
            streamed.close()
            del streamed, logits, tokens

        port_dir = os.path.join(root, "port")
        save_model(None, model, port_dir, max_shard_size=BIG["exact_shard"])
        streamed = disk_offload(meta, port_dir, offload_folder=os.path.join(root, "offload"))
        copies = sum(n.endswith(".dat") for n in os.listdir(os.path.join(root, "offload")))
        err = (streamed(ids) - ref).abs().max().item()
        print(f"    disk_offload(offload_folder=...): {copies} memmap copies, logits max |diff| "
              f"{err:.3e}")
        if not err <= BIG["exact_atol"]:
            fail("disk_offload with memmap copies disagrees with the resident model")
        streamed.close()
        del streamed
        shutil.rmtree(port_dir)
        shutil.rmtree(os.path.join(root, "offload"))

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        streamed, hook = cpu_offload_with_hook(model)
        err = (streamed(ids) - ref).abs().max().item()
        during = torch.cuda.memory_allocated() - base
        hook.offload()
        torch.cuda.synchronize()
        left = torch.cuda.memory_allocated() - base
        print(f"    cpu_offload_with_hook: logits max |diff| {err:.3e}; card memory above the "
              f"baseline {during / 2**20:.1f} MiB after the forward (its logits), "
              f"{left / 2**20:.1f} MiB after hook.offload() and dropping them (limit 1 MiB)")
        if not (err <= BIG["exact_atol"] and left <= 2**20):
            fail("cpu_offload_with_hook disagrees, or left weights on the card after offload()")
        del streamed, hook

        qcfg = QuantizationConfig(load_in_8bit=True, compute_dtype=f32)
        t0 = time.perf_counter()
        _, _, qparams, apply = load_and_quantize_hf_checkpoint(hf, qcfg)
        q_s = time.perf_counter() - t0
        with torch.inference_mode():
            q_logits = apply(qparams, ids)
            deq = LlamaForCausalLM(small, device="cuda", dtype=f32)
            deq.load_state_dict(dequantize_params(qparams, f32))
            deq_logits = deq(ids)
        q_err = (q_logits - deq_logits).abs().max().item()
        rel = ((q_logits - ref).norm() / ref.norm()).item()
        agree = (q_logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
        qbytes = quantized_nbytes(qparams)
        print(f"    int8 load_and_quantize_hf_checkpoint: {q_s:.1f} s; logits against the "
              f"dequantized-weights forward max |diff| {q_err:.3e} (limit "
              f"{BIG['quant_atol']:g}); against the f32 model relative L2 {rel:.3e}, top-1 "
              f"agreement {agree:.4f}; {qbytes / 1e9:.3f} GB at rest against "
              f"{weights / 2e9:.3f} GB in bf16 ({qbytes / (weights / 2):.3f}x; the head stays "
              "f32)")
        if not q_err <= BIG["quant_atol"]:
            fail("the int8-loaded model disagrees with its dequantized weights")
        del qparams, apply, deq, q_logits, deq_logits
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del model, ref, refs
    free_cuda()


def big_model_full_depth(model, gen):
    """Phase 4f at full depth in bf16: the resident model exported to an HF
    directory, then every tier's load, forward, decode and peak memory."""
    import shutil
    import tempfile

    import torch

    from accelerate_tpu_torch import load_hf_checkpoint_and_dispatch, save_hf_checkpoint

    cfg, bf16, card = model.config, torch.bfloat16, card_line()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    B, S = BIG["forward"]
    ids = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    prompt = ids[:1, :BIG["prompt"]]
    layer_bytes = sum(p.numel() * p.element_size() for p in model.model.layers[0].parameters())

    # The activation allowance: the resident model's own peak above its
    # weights on the same input (logits included).
    with torch.inference_mode():
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model(ids)
        torch.cuda.synchronize()
        allowance = torch.cuda.max_memory_allocated() - before
    allowance = int(allowance * 1.1) + (64 << 20)

    # The yardstick: a plain pinned host-to-card copy of one layer's bytes.
    src = torch.empty(layer_bytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(layer_bytes, dtype=torch.uint8, device="cuda")
    copy_ms = timed_ms(lambda: dst.copy_(src, non_blocking=True), iters=10)
    del src, dst
    print(f"  bf16, full depth, {weights / 1e9:.2f} GB of weights ({card}): pinned host-to-card "
          f"copy of one layer's {layer_bytes / 1e6:.0f} MB: {copy_ms:.3f} ms "
          f"({layer_bytes / copy_ms / 1e6:.1f} GB/s); activation allowance "
          f"{allowance / 2**30:.2f} GiB (the resident forward's peak above its weights, "
          f"+10 % + 64 MiB)")

    root = tempfile.mkdtemp(prefix="chip_smoke_big8b_")
    try:
        check_room(root, 1.1 * weights / 1e9, 2.5 * weights / 1e9, "4f full depth")
        hf = os.path.join(root, "hf")
        t0 = time.perf_counter()
        save_hf_checkpoint(model, hf, cfg, "llama", max_shard_size=BIG["shard"])
        shards = sorted(n for n in os.listdir(hf) if n.endswith(".safetensors"))
        print(f"  exported to an HF directory in {time.perf_counter() - t0:.1f} s: {len(shards)} "
              f"shards of at most {BIG['shard']}")
        tiers = {"card": ({"": 0}, None), "host": ({"": "cpu"}, None),
                 "disk": ({"": "disk"}, None), "auto": ("auto", {0: BIG["auto_budget"]})}
        for tier, (device_map, budget) in tiers.items():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            avail0 = mem_available_gb()
            t0 = time.perf_counter()
            streamed, _ = load_hf_checkpoint_and_dispatch(hf, device_map=device_map,
                                                          max_memory=budget, dtype=bf16)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            host_gb = avail0 - mem_available_gb()
            resident = streamed.hbm_resident_bytes
            block = streamed_block_bytes(streamed)
            bound = resident + 2 * block + allowance
            if tier == "auto":
                cards = sum(1 for p in streamed.store.placement.values() if p == 0)
                layers_on_card = sorted({int(n.split(".")[2]) for n, p in
                                         streamed.store.placement.items()
                                         if p == 0 and ".layers." in n})
                print(f"    auto map under max_memory={budget}: {cards} of "
                      f"{len(streamed.store.placement)} tensors on the card (embedding, head, "
                      f"layers {layers_on_card[0]}-{layers_on_card[-1]} whole or in part), the "
                      "rest in host memory")
            passes = timed_passes(streamed)
            counts0 = read_counts()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            streamed(ids)  # the first forward after the load
            first_ms = (passes[-1] - t1) * 1e3
            counts = {k: v - counts0[k] for k, v in read_counts().items()}
            peak = torch.cuda.max_memory_allocated() - base
            t1 = time.perf_counter()
            streamed(ids)
            fwd_ms = (passes[-1] - t1) * 1e3
            if counts["flash_fwd_sm90"] != cfg.num_hidden_layers or \
                    counts["flash_fwd"] != cfg.num_hidden_layers:
                fail(f"the {tier} tier's forward launched flash_fwd {counts['flash_fwd']} times, "
                     f"{counts['flash_fwd_sm90']} on the wgmma route; expected "
                     f"{cfg.num_hidden_layers} of each")
            if peak > bound:
                fail(f"the {tier} tier's peak {peak / 2**30:.2f} GiB above the baseline exceeds "
                     f"resident + 2 x largest block + allowance = {bound / 2**30:.2f} GiB")
            extra = ""
            if tier == "host":
                streamed.prefetch = False
                t1 = time.perf_counter()
                streamed(ids)
                extra = (f", {(passes[-1] - t1) * 1e3:.1f} ms with prefetch=False; "
                         f"{(weights - resident) / 1e9:.2f} GB streamed a pass, "
                         f"{(weights - resident) / fwd_ms / 1e6:.1f} GB/s")
                streamed.prefetch = True
            if tier == "disk":
                extra = (f"; the first forward after the load {first_ms:.1f} ms against this "
                         "second one (the shards were just written, so both passes may read "
                         f"from the page cache; MemAvailable {mem_available_gb():.1f} GB)")
            new = BIG["disk_new"] if tier == "disk" else BIG["new"]
            del passes[:]
            tokens = streamed.generate(prompt, max_new_tokens=new, cache_dtype=bf16)
            decode_ms = (passes[-1] - passes[0]) * 1e3 / (len(passes) - 1)
            if tokens.shape != (1, BIG["prompt"] + new) or \
                    int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab_size:
                fail(f"the {tier} tier's generate returned shape {tuple(tokens.shape)} or "
                     "token ids outside the vocabulary")
            print(f"    {tier}: load {load_s:.2f} s (host memory taken {host_gb:.1f} GB); "
                  f"forward {B} x {S}: {fwd_ms:.1f} ms, flash_fwd launches "
                  f"{counts['flash_fwd_sm90']} (wgmma){extra}; decode {decode_ms:.1f} ms a "
                  f"token (batch 1, {BIG['prompt']}-token prompt, {new} new, greedy); peak "
                  f"{peak / 2**30:.2f} GiB above the baseline against resident "
                  f"{resident / 2**30:.2f} + 2 x block {block / 2**30:.3f} + allowance = "
                  f"{bound / 2**30:.2f} GiB")
            streamed.close()
            del streamed, tokens
            free_cuda()
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_big_model(model, gen):
    """Phase 4f: big-model inference (``big_modeling``), exactness at f32
    on 2 layers, then every tier at full depth in bf16."""
    big_model_exactness(model.config)
    big_model_full_depth(model, gen)


def reset_counts():
    from accelerate_tpu_torch.ops.flash_cuda import flash_bwd, flash_fwd

    flash_fwd.launches = flash_fwd.wgmma_launches = flash_fwd.mma_launches = 0
    flash_bwd.dkdv_launches = flash_bwd.dkdv_wgmma_launches = flash_bwd.dkdv_mma_launches = 0
    flash_bwd.dq_launches = flash_bwd.dq_wgmma_launches = flash_bwd.dq_mma_launches = 0


def read_counts() -> dict:
    """Launches since ``reset_counts``, by kernel: the totals of the forward,
    dK/dV and dQ (both routes), and each kernel of each route."""
    from accelerate_tpu_torch.ops.flash_cuda import flash_bwd, flash_fwd

    return {"flash_fwd": flash_fwd.launches, "flash_fwd_sm90": flash_fwd.wgmma_launches,
            "flash_fwd_mma": flash_fwd.mma_launches, "flash_bwd_dkdv": flash_bwd.dkdv_launches,
            "flash_bwd_dkdv_sm90": flash_bwd.dkdv_wgmma_launches,
            "flash_bwd_dkdv_mma": flash_bwd.dkdv_mma_launches, "flash_bwd_dq": flash_bwd.dq_launches,
            "flash_bwd_dq_sm90": flash_bwd.dq_wgmma_launches,
            "flash_bwd_dq_mma": flash_bwd.dq_mma_launches}


def expected_counts(forward: int, backward: int, wgmma: bool, dq_wgmma=None) -> dict:
    """``read_counts`` of ``forward`` forward and ``backward`` backward
    launches (dK/dV and dQ each): the forward and dK/dV on the wgmma route
    when ``wgmma`` (the two share their route predicate), dQ when
    ``dq_wgmma`` (default: ``wgmma``), else on mma.sync."""
    dq_wgmma = wgmma if dq_wgmma is None else dq_wgmma
    counts = {"flash_fwd": forward, "flash_fwd_sm90": 0, "flash_fwd_mma": 0,
              "flash_bwd_dkdv": backward, "flash_bwd_dkdv_sm90": 0, "flash_bwd_dkdv_mma": 0,
              "flash_bwd_dq": backward, "flash_bwd_dq_sm90": 0, "flash_bwd_dq_mma": 0}
    counts["flash_fwd_sm90" if wgmma else "flash_fwd_mma"] = forward
    counts["flash_bwd_dkdv_sm90" if wgmma else "flash_bwd_dkdv_mma"] = backward
    counts["flash_bwd_dq_sm90" if dq_wgmma else "flash_bwd_dq_mma"] = backward
    return counts


def free_cuda():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_train():
    """The tier-1 train step at full width, through the bench's entry point;
    then the flash-vs-einsum gradient check and the remat check."""
    from accelerate_tpu_torch.bench import run_bench

    reset_counts()
    result = run_bench()  # 3 warm-up steps, then 20 timed ones
    counts = read_counts()
    extra = result["extra"]
    steps, layers = extra["steps"], extra["config"]["layers"]
    losses = extra["losses"]
    print(f"  tier-1 llama ({extra['config']['n_params'] / 1e9:.3f} B params, {layers} layers, "
          f"f32 masters, bf16 compute, AdamW), {extra['config']['batch']} x "
          f"{extra['config']['seq']} tokens: step {extra['step_ms']:.2f} ms, "
          f"{result['value']:.0f} tokens/s, MFU {extra['mfu']:.4f} "
          f"({extra['achieved_tflops']:.1f} of {extra['peak_tflops']:g} TFLOP/s), peak memory "
          f"{extra['peak_memory_gib']:.2f} GiB")
    print(f"  loss step 1 {losses[0]:.5f} -> step {steps} {losses[-1]:.5f}; mean of the first 4 "
          f"{sum(losses[:4]) / 4:.5f}, of the last 4 {sum(losses[-4:]) / 4:.5f}; last grad norm "
          f"{extra['grad_norm']:.4f}; launches in {steps} steps: {counts}")
    expected = expected_counts(layers * steps, layers * steps, wgmma=True)
    if counts != expected:
        fail(f"flash launches {counts} in {steps} train steps, expected {expected} "
             f"({layers} of each per step, all on the wgmma route)")
    if not all(math.isfinite(x) for x in losses + [extra["grad_norm"]]):
        fail("a train step gave a non-finite loss or grad norm")
    if not sum(losses[-4:]) < sum(losses[:4]):
        fail("the loss did not fall over the train steps")
    free_cuda()

    check_counts = grad_check()
    free_cuda()

    # Remat: the first step again, every layer recomputed in the backward.
    reset_counts()
    remat = run_bench(iters=1, warmup=0, remat=True)
    remat_counts = read_counts()
    remat_loss = remat["extra"]["losses"][0]
    print(f"  remat=True, first step: loss {remat_loss:.7f} (without remat {losses[0]:.7f}), "
          f"grad norm {remat['extra']['grad_norm']:.6f}, peak memory "
          f"{remat['extra']['peak_memory_gib']:.2f} GiB, launches {remat_counts}")
    if abs(remat_loss - losses[0]) > 1e-6 * abs(losses[0]):
        fail("remat changed the first step's loss")
    if remat_counts != expected_counts(2 * layers, layers, wgmma=True):
        fail(f"remat step launches {remat_counts}: expected 2 forward launches per layer")
    free_cuda()
    return result, counts, check_counts


def grad_check():
    """The kernels inside the model: at the tier-1 widths with 2 layers, in
    f32 (the mma.sync route), on 1 x 256 tokens, the parameter gradients
    through the flash kernels must agree with those through einsum
    attention. Returns the flash run's launch counts."""
    import torch

    from accelerate_tpu_torch import PipelinedLlamaForCausalLM, fused_causal_lm_loss
    from accelerate_tpu_torch.bench import tier1_llama_config

    cfg = tier1_llama_config(num_hidden_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(1)
    model = PipelinedLlamaForCausalLM(cfg, device="cuda", dtype=torch.float32, generator=gen)
    ids = torch.randint(0, cfg.vocab_size, (1, 256), generator=gen, device="cuda")
    grads, launches = {}, {}
    for backend in ("auto", "einsum"):
        cfg.attention_backend = backend
        model.zero_grad(set_to_none=True)
        reset_counts()
        fused_causal_lm_loss(model)(dict(model.named_parameters()), {"input_ids": ids}).backward()
        torch.cuda.synchronize()
        launches[backend] = read_counts()
        grads[backend] = {n: p.grad.clone() for n, p in model.named_parameters()}
    cfg.attention_backend = "auto"
    worst = max(((grads["auto"][n] - g).norm() / g.norm()).item()
                for n, g in grads["einsum"].items())
    print(f"  flash vs einsum parameter gradients (tier-1 widths, 2 layers, f32, 1 x 256): worst "
          f"relative L2 {worst:.3e} (limit 1e-3); launches flash {launches['auto']}, einsum "
          f"{launches['einsum']}")
    if launches["auto"] != expected_counts(2, 2, wgmma=False) or any(launches["einsum"].values()):
        fail("the gradient check did not go through the kernels as expected")
    if not worst <= 1e-3:
        fail("gradients through the flash kernels disagree with einsum attention")
    return launches["auto"]


def phase_train_profile():
    from accelerate_tpu_torch.bench import build_train_step

    cfg, model, step, batches = build_train_step()
    for b in batches[:2]:
        step(b)  # warm-up
    device_breakdown("train step (tier-1, 8 x 1024 tokens)", lambda: step(batches[2]), top=16)
    del cfg, model, step, batches
    free_cuda()


# Phase 8: the training loop. Batch 8 x 1024 packed tokens, accumulation 2,
# 6 updates; the second run saves after update 3.
LOOP = dict(batch=8, seq=1024, accum=2, updates=6, save_after=3, warmup=2, lr=1e-4)


def loop_schedule(count):
    """Learning rate after ``count`` updates: linear warmup over
    ``LOOP["warmup"]`` updates, then cosine to 0 at ``LOOP["updates"]``."""
    warmup, total, lr = LOOP["warmup"], LOOP["updates"], LOOP["lr"]
    if count < warmup:
        return lr * (count + 1) / (warmup + 1)
    return 0.5 * lr * (1 + math.cos(math.pi * min(1.0, (count - warmup) / (total - warmup))))


def packed_rows(vocab, rows, seed=5):
    """A seeded corpus of documents of 64-2048 tokens packed into at least
    ``rows`` rows of ``LOOP["seq"]`` tokens; one dict of numpy arrays a row."""
    import numpy as np

    from accelerate_tpu_torch import pack_sequences

    rng = np.random.default_rng(seed)
    docs, total = [], 0
    while total < rows * LOOP["seq"]:
        n = int(rng.integers(64, 2049))
        docs.append(rng.integers(1, vocab, n))
        total += n
    packed = pack_sequences(docs, LOOP["seq"])
    return [{k: v[i] for k, v in packed.items()} for i in range(len(packed["input_ids"]))], docs


def build_loop(rows, accum=None, **config):
    """A fresh tier-1 run on the card, weights from seed 0: the accelerator
    and the prepared model, AdamW, shuffled prefetching loader and
    scheduler."""
    import torch

    from accelerate_tpu_torch import (Accelerator, LRScheduler, NumpyDataLoader,
                                      PipelinedLlamaForCausalLM)
    from accelerate_tpu_torch.bench import tier1_llama_config

    acc = Accelerator(mixed_precision="bf16",
                      gradient_accumulation_steps=accum or LOOP["accum"])
    cfg = tier1_llama_config(**({"remat": True, "remat_policy": "dots"} | config))
    module = PipelinedLlamaForCausalLM(cfg, device=acc.device, dtype=torch.float32,
                                       generator=torch.Generator(device=acc.device).manual_seed(0))
    model, opt, loader, sched = acc.prepare(
        module, torch.optim.AdamW(module.parameters(), lr=loop_schedule(0), weight_decay=1e-4),
        NumpyDataLoader(rows, batch_size=LOOP["batch"], shuffle=True, seed=3),
        LRScheduler(loop_schedule))
    return acc, model, opt, loader, sched


def run_loop(acc, model, opt, loader, sched, updates, after_update=None, keep=0):
    """The user's loop for ``updates`` optimizer steps. Returns per update
    (mean microbatch loss, grad norm, learning rate) as device tensors and
    floats, the first ``keep`` microbatches, and the mean wall ms of updates
    2 onwards. ``after_update(n)`` runs inside the loop after update n."""
    import torch

    from accelerate_tpu_torch import fused_causal_lm_loss

    loss_fn = fused_causal_lm_loss(model)
    history, losses, kept, t0 = [], [], [], None
    for batch in loader:
        if len(kept) < keep:
            kept.append({k: v.clone() for k, v in batch.items()})
        with acc.accumulate(model):
            losses.append(acc.backward(loss_fn, batch))
            if acc.sync_gradients:
                gnorm = acc.clip_grad_norm_(max_norm=1.0)
            opt.step()
            sched.step()
            opt.zero_grad()
        if not acc.sync_gradients:
            continue
        history.append(((losses[0] + losses[1]) / 2, gnorm, opt.param_groups[0]["lr"]))
        losses = []
        if len(history) == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        if after_update is not None:
            after_update(len(history))
        if len(history) == updates:
            break
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / max(1, updates - 1)
    return history, kept, ms


def drop(acc):
    """Release a run's device memory: the accelerator's prepared objects go,
    the caller drops its own references."""
    acc.free_memory()
    free_cuda()


def steady_update(rows, profile_label=None, **config):
    """Peak device memory (GiB) and wall ms of one steady-state loop update
    (the second: AdamW's moments exist) from a fresh run; with
    ``profile_label``, then one more update under the profiler."""
    import torch

    run = build_loop(rows, **config)
    marks = {}

    def mark(n):
        torch.cuda.synchronize()
        if n == 1:
            torch.cuda.reset_peak_memory_stats()
            marks["t0"] = time.perf_counter()
        else:
            marks["ms"] = (time.perf_counter() - marks["t0"]) * 1e3

    run_loop(*run, updates=2, after_update=mark)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if profile_label is not None:
        device_breakdown(profile_label, lambda: run_loop(*run, updates=1), top=8)
    drop(run[0])
    del run
    return peak, marks["ms"]


def check_loop_trace(prof, trace_dir, export_s):
    """The Chrome trace ``Accelerator.profile`` wrote of one loop update
    must exist under ``trace_dir`` and name the three wgmma flash kernels."""
    files = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
    if not files or prof.trace_files != files:
        fail(f"Accelerator.profile wrote {files} under {trace_dir}, expected {prof.trace_files}")
    with open(files[0]) as f:
        text = f.read()
    kernels = ("flash_fwd_sm90", "flash_bwd_dkdv_sm90", "flash_bwd_dq_sm90")
    missing = [k for k in kernels if f"{k}_kernel" not in text]
    print(f"  Accelerator.profile of update 2: {os.path.basename(files[0])}, "
          f"{os.path.getsize(files[0]) / 1e6:.1f} MB, written in {export_s:.2f} s; names "
          f"{', '.join(k for k in kernels if k not in missing)}; {len(prof.step_breakdowns)} "
          f"step snapshots (none: the loop calls no prof.step())")
    if missing:
        fail(f"the profile trace of a loop update names no {missing}")


def phase_loop():
    """Phase 8 (see the module docstring). Returns the flash launch counts
    of the uninterrupted loop and its number of microbatches."""
    import shutil
    import tempfile

    import torch

    from accelerate_tpu_torch import (ProfileKwargs, find_executable_batch_size,
                                      fused_causal_lm_loss)
    from accelerate_tpu_torch.bench import tier1_llama_config

    card = card_line()
    cfg = tier1_llama_config()
    micro = LOOP["updates"] * LOOP["accum"]
    rows, docs = packed_rows(cfg.vocab_size, rows=(micro + 8) * LOOP["batch"])
    print(f"  corpus: {len(docs)} documents of 64-2048 tokens ({sum(map(len, docs))} tokens) "
          f"packed into {len(rows)} rows of {LOOP['seq']}; batch {LOOP['batch']}, accumulation "
          f"{LOOP['accum']}, {LOOP['updates']} updates ({micro} microbatches)")

    # A: the uninterrupted loop, its flash launches counted.
    run = build_loop(rows)
    layers = run[1].config.num_hidden_layers
    torch.cuda.synchronize()
    reset_counts()
    straight, first_two, loop_ms = run_loop(*run, updates=LOOP["updates"], keep=2)
    counts = read_counts()
    expected = expected_counts(2 * layers * micro, layers * micro, wgmma=True)
    final = {n: p.detach().cpu() for n, p in run[1].named_parameters()}
    pipeline = run[0].input_pipeline_metrics()
    tokens = LOOP["batch"] * LOOP["seq"] * LOOP["accum"]
    print(f"  loop, {micro} microbatches: flash launches {counts} ({2 * layers} forward, "
          f"{layers} dK/dV and {layers} dQ a microbatch expected, all wgmma)")
    if counts != expected:
        fail(f"loop flash launches {counts}, expected {expected}")
    for i, (loss, gnorm, lr) in enumerate(straight, 1):
        print(f"    update {i}: loss {loss.item():.6f}, grad norm {gnorm.item():.6f}, lr {lr:.4e}")
        if not (math.isfinite(loss.item()) and math.isfinite(gnorm.item())):
            fail(f"update {i} of the loop gave a non-finite loss or grad norm")
    print(f"  input pipeline: {pipeline}")

    # The packed microbatch through the kernels and through einsum attention.
    model = run[1]
    with torch.no_grad():
        cast = {n: p.to(torch.bfloat16) for n, p in model.named_parameters()}
        flash_loss = fused_causal_lm_loss(model)(cast, first_two[0]).item()
        model.config.attention_backend = "einsum"
        try:
            einsum_loss = fused_causal_lm_loss(model)(cast, first_two[0]).item()
        finally:
            model.config.attention_backend = "auto"
    rel = abs(flash_loss - einsum_loss) / abs(einsum_loss)
    print(f"  packed microbatch (segment_ids, {int(first_two[0]['segment_ids'].max())} documents "
          f"in a row at most), trained weights: loss through the kernels {flash_loss:.6f}, "
          f"einsum attention {einsum_loss:.6f}, relative {rel:.3e} (limit 1e-2)")
    if not rel <= 1e-2:
        fail("the packed loss through the kernels disagrees with einsum attention")
    # The kernels alone on that microbatch's segment_ids, at the loop's
    # attention shape, against their plain versions under phase 2's
    # tolerances (N(0, 1) q, k, v and d_out; not counted as the loop's).
    seg = first_two[0]["segment_ids"]
    q, k, v, _ = make_inputs(*seg.shape, cfg.num_attention_heads, cfg.num_key_value_heads,
                             cfg.head_dim, torch.bfloat16, seed=11)
    label = "the loop's first packed microbatch, its segment_ids"
    check_forward(label, q, k, v, seg, dict(causal=True))
    check_backward(label, q, k, v, seg, dict(causal=True), seed=12)
    del cast, model, q, k, v, seg
    drop(run[0])
    del run

    # The fused step on the same two microbatches from the same weights.
    acc, model, opt, loader, sched = build_loop(rows)
    step = acc.compile_train_step(fused_causal_lm_loss(model), accumulation_steps=LOOP["accum"],
                                  max_grad_norm=1.0)
    stacked = {k: torch.stack([b[k] for b in first_two]) for k in first_two[0]}
    metrics = step(stacked)
    fused_loss, fused_gnorm = metrics["loss"], metrics["grad_norm"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LOOP["updates"] - 1):
        step(stacked)
    torch.cuda.synchronize()
    fused_ms = (time.perf_counter() - t0) * 1e3 / (LOOP["updates"] - 1)
    loop_loss, loop_gnorm = straight[0][0], straight[0][1]
    d_loss = abs(loop_loss.item() - fused_loss.item()) / abs(fused_loss.item())
    d_gnorm = abs(loop_gnorm.item() - fused_gnorm.item()) / abs(fused_gnorm.item())
    identical = torch.equal(loop_loss, fused_loss) and torch.equal(loop_gnorm, fused_gnorm)
    print(f"  first update, loop vs compile_train_step on the same 2 microbatches: loss "
          f"{loop_loss.item():.7f} vs {fused_loss.item():.7f} (relative {d_loss:.2e}, limit "
          f"1e-6), grad norm {loop_gnorm.item():.7f} vs {fused_gnorm.item():.7f} (relative "
          f"{d_gnorm:.2e}, limit 1e-5); {'bit-identical' if identical else 'not bit-identical'}")
    if not (d_loss <= 1e-6 and d_gnorm <= 1e-5):
        fail("the loop's first update disagrees with compile_train_step's")
    print(f"  step time, tier-1, bf16, dots remat, {tokens} packed tokens an update ({card}): "
          f"loop {loop_ms:.2f} ms ({tokens / loop_ms * 1e3:.0f} tokens/s; updates 2-"
          f"{LOOP['updates']}, async prefetch), compile_train_step {fused_ms:.2f} ms "
          f"({tokens / fused_ms * 1e3:.0f} tokens/s)")
    del step, model, opt, loader, sched, metrics
    drop(acc)
    del acc

    # B: save after update 3 in the background, then wait; C: load, resume.
    # B's second update runs under Accelerator.profile.
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        run = build_loop(rows)
        need = sum(p.numel() * 4 * 3 for p in run[1].parameters())  # masters, exp_avg(_sq)
        free = shutil.disk_usage(ckpt).free
        if free < 1.2 * need:
            fail(f"{ckpt} has {free / 1e9:.1f} GB free; the checkpoint needs {need / 1e9:.1f} GB "
                 "(set TMPDIR to a larger disk)")
        timing, session = {}, {}

        def save(n):
            if n == 1:
                session["prof"] = run[0].profile(
                    ProfileKwargs(output_trace_dir=trace_dir)).__enter__()
            if n == 2:
                t0 = time.perf_counter()
                session["prof"].__exit__(None, None, None)
                session["export_s"] = time.perf_counter() - t0
            if n == LOOP["save_after"]:
                t0 = time.perf_counter()
                run[0].save_state(ckpt, blocking=False)
                timing["snapshot"] = time.perf_counter() - t0
                run[0].wait_for_checkpoint()
                timing["save"] = time.perf_counter() - t0

        first, _, _ = run_loop(*run, updates=LOOP["save_after"], after_update=save)
        drop(run[0])
        del run
        check_loop_trace(session["prof"], trace_dir, session["export_s"])
        files = os.listdir(ckpt)
        size = sum(os.path.getsize(os.path.join(ckpt, f)) for f in files)

        acc, model, opt, loader, sched = build_loop(rows)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc.load_state(ckpt)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        loader = acc.skip_first_batches(loader, LOOP["save_after"] * LOOP["accum"])
        rest, _, _ = run_loop(acc, model, opt, loader, sched,
                              updates=LOOP["updates"] - LOOP["save_after"])
        resumed_params = {n: p.detach().cpu() for n, p in model.named_parameters()}
        del model, opt, loader, sched
        drop(acc)
        del acc
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        shutil.rmtree(trace_dir, ignore_errors=True)
    print(f"  checkpoint ({card}): {size / 1e9:.3f} GB in {len(files)} files; save_state(blocking=False) returned after {timing['snapshot']:.2f} s (host "
          f"copy), written after {timing['save']:.2f} s; load_state {load_s:.2f} s")
    same = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[2] == b[2]
               for a, b in zip(first + rest, straight))
    same_params = all(torch.equal(resumed_params[n], t) for n, t in final.items())
    for i in range(LOOP["save_after"], LOOP["updates"]):
        print(f"    update {i + 1} resumed: loss {rest[i - LOOP['save_after']][0].item():.7f}, "
              f"uninterrupted {straight[i][0].item():.7f}")
    print(f"  resume: updates 1-{LOOP['updates']} (loss, grad norm, lr) "
          f"{'bit-identical' if same else 'DIFFER'} to the uninterrupted run; final parameters "
          f"{'bit-identical' if same_params else 'DIFFER'}")
    if not (same and same_params and len(first + rest) == LOOP["updates"]):
        fail("the resumed run is not bit-identical to the uninterrupted one")
    del final, resumed_params

    # One steady-state update per remat policy: "dots" keeps more than
    # "nothing" and less than no remat.
    steady = {"nothing": steady_update(rows, remat_policy="nothing"),
              "dots": steady_update(rows, profile_label="loop update, dots remat (tier-1, "
                                    f"2 x {LOOP['batch']} x {LOOP['seq']} packed tokens)"),
              "remat=False": steady_update(rows, remat=False)}
    print(f"  steady-state update (the second) ({card}): " + ", ".join(
        f"{k}: peak {peak:.2f} GiB, {ms:.2f} ms" for k, (peak, ms) in steady.items()))
    peaks = {k: v[0] for k, v in steady.items()}
    if not peaks["nothing"] < peaks["dots"] < peaks["remat=False"]:
        fail("the dots peak does not lie between the nothing and the no-remat peaks")

    # find_executable_batch_size from a batch the card cannot hold.
    acc, model, opt, loader, sched = build_loop(rows, accum=1, remat=False)
    loss_fn = fused_causal_lm_loss(model)
    tried = []

    @find_executable_batch_size(starting_batch_size=128)
    def one_step(batch_size):
        tried.append(batch_size)
        opt.optimizer.zero_grad(set_to_none=True)
        ids = torch.randint(0, cfg.vocab_size, (batch_size, LOOP["seq"]), device=acc.device,
                            generator=torch.Generator(device=acc.device).manual_seed(batch_size))
        with acc.accumulate(model):
            loss = acc.backward(loss_fn, {"input_ids": ids})
            acc.clip_grad_norm_(max_norm=1.0)
            opt.step()
            opt.zero_grad()
        return loss.item()

    loss = one_step()
    print(f"  find_executable_batch_size, remat=False, from 128 x {LOOP['seq']} tokens: tried "
          f"{tried}, {len(tried) - 1} torch.OutOfMemoryError caught, ran at {tried[-1]} x "
          f"{LOOP['seq']} with loss {loss:.5f}")
    if len(tried) < 2 or not math.isfinite(loss):
        fail("find_executable_batch_size caught no out-of-memory error or gave a non-finite loss")
    del model, opt, loader, sched, loss_fn, one_step
    drop(acc)
    del acc
    return counts, micro


# ---------------------------------------------------------------------------
# Phase 9: several processes (a process group over NCCL, world size 1)
# ---------------------------------------------------------------------------

#: The launched trainer: run_bench's model and batches, 3 warm-up and 10
#: timed steps, run_bench's batch order (so its losses are the first 13 of
#: phase 6's run).
MP = dict(warmup=3, iters=10, reduce_iters=5, timeout=400)
MP_CHILD_FLAG = "--multiprocess-child"


def run_cli(args, timeout, env_extra=None, stdin_text=None):
    """``accelerate-tpu-torch <args>`` from this checkout, in a session of
    its own that is killed whole on a timeout; a non-zero exit fails the
    phase with the command's last lines. ``stdin_text`` is piped to its
    standard input (not a TTY)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [HERE] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    env.update(env_extra or {})
    cmd = [sys.executable, "-m", "accelerate_tpu_torch.commands.accelerate_cli", *args]
    proc = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True,
                            stdin=subprocess.PIPE if stdin_text is not None else None)
    try:
        out, err = proc.communicate(input=stdin_text, timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, err = proc.communicate()
        fail(f"`accelerate-tpu-torch {' '.join(args)}` timed out after {timeout} s:\n"
             f"{out[-3000:]}\n{err[-3000:]}")
    if proc.returncode != 0:
        fail(f"`accelerate-tpu-torch {' '.join(args)}` exited {proc.returncode}:\n"
             f"{out[-3000:]}\n{err[-3000:]}")
    return out


def multiprocess_child(out_path: str):
    """The launched trainer (``launch --num_processes 1 --mixed_precision
    bf16 chip_smoke.py --multiprocess-child OUT``): joins the process group,
    trains the tier-1 model as ``run_bench`` does, times the gradient
    reduction alone on the model's gradient shapes, and writes its numbers
    to ``OUT`` as JSON."""
    t_start = time.time()
    import torch

    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from accelerate_tpu_torch import PartialState
    from accelerate_tpu_torch.accelerator import _reduce_gradients
    from accelerate_tpu_torch.bench import build_train_step

    t_import = time.time()
    state = PartialState()
    t_group = time.time()
    cfg, model, step, batches = build_train_step()
    reduce_calls = _reduce_gradients.calls
    reset_counts()
    losses = []
    for i in range(MP["warmup"]):
        losses.append(step(batches[i % 4])["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(MP["iters"]):
        losses.append(step(batches[i % 4])["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / MP["iters"]
    counts = read_counts()
    reduce_calls = _reduce_gradients.calls - reduce_calls
    buckets = _reduce_gradients.buckets

    # The same steps again under no_sync(): no gradient reduction and no
    # label-count all-reduce, to split the launched step's cost.
    from accelerate_tpu_torch import Accelerator

    with Accelerator(mixed_precision="bf16").no_sync():
        step(batches[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(MP["iters"]):
            step(batches[i % 4])
        torch.cuda.synchronize()
    no_sync_step_ms = (time.perf_counter() - t0) * 1e3 / MP["iters"]

    # The reduction alone, on gradients of the model's shapes (f32, the
    # step's buckets): what each step paid for it.
    grads = [torch.zeros_like(p) for p in model.parameters()]
    from accelerate_tpu_torch.utils.dataclasses import DistributedDataParallelKwargs

    cap = DistributedDataParallelKwargs().bucket_cap_mb
    _reduce_gradients(grads, 1.0, cap)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(MP["reduce_iters"]):
        _reduce_gradients(grads, 1.0, cap)
    end.record()
    torch.cuda.synchronize()
    reduction_ms = start.elapsed_time(end) / MP["reduce_iters"]
    launched_at = float(os.environ["ATPU_SMOKE_LAUNCHED_AT"])
    result = dict(
        backend=state.backend, world=state.num_processes, rank=state.process_index,
        distributed_type=str(state.distributed_type), device=str(state.device),
        losses=torch.stack(losses).tolist(), step_ms=step_ms, no_sync_step_ms=no_sync_step_ms,
        counts=counts,
        reduce_calls=reduce_calls, buckets=buckets, reduction_ms=reduction_ms,
        gradient_bytes=sum(g.numel() * g.element_size() for g in grads),
        startup_s=t_group - launched_at, process_start_s=t_start - launched_at,
        import_s=t_import - t_start, init_process_group_s=t_group - t_import,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    with open(out_path, "w") as f:
        json.dump(result, f)
    print(f"multiprocess child done: rank {state.process_index} of {state.num_processes} "
          f"over {state.backend}")


def phase_multiprocess(reference=None):
    """Phase 9: ``env``, ``test`` and the collectives at world size 1 over
    NCCL, then the tier-1 trainer launched in a process group, held bit for
    bit against the same steps run here without one (``reference``: phase
    6's ``run_bench`` result, whose first 13 steps are the same; else they
    run here). Returns the child's numbers."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import torch

    name = torch.cuda.get_device_name(0)

    def timed_cli(args, timeout):
        return run_cli(args, timeout), time.perf_counter()

    # ``env``, ``test`` and the collectives run side by side: each launch
    # picks its own free port for its process group of one.
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        runs = {what: pool.submit(timed_cli, args, timeout) for what, args, timeout in (
            ("env", ["env"], 120), ("test", ["test"], 300),
            ("collectives", ["launch", "--num_processes", "1", "--module",
                             "accelerate_tpu_torch.test_utils.scripts.test_ops_multiprocess"],
             300))}
        done = {what: run.result() for what, run in runs.items()}
    (env_out, _), (out, test_end), (ops_out, ops_end) = (
        done["env"], done["test"], done["collectives"])
    nccl = [line for line in env_out.splitlines() if line.startswith("- NCCL version:")]
    print(f"  env (beside test): {nccl[0] if nccl else 'no NCCL line'}; card named: "
          f"{name in env_out}")
    if name not in env_out or not nccl:
        fail(f"`accelerate-tpu-torch env` printed no card name or NCCL version:\n"
             f"{env_out[-2000:]}")
    print(f"  test ({test_end - t0:.1f} s): "
          + "; ".join(line.strip() for line in out.splitlines()
                      if "ok" in line or "omnibus" in line))
    if "All omnibus checks passed." not in out or "1 process(es)" not in out \
            or "omnibus check on nccl" not in out:
        fail(f"`accelerate-tpu-torch test` did not pass at world size 1 over NCCL:\n"
             f"{out[-3000:]}")

    checks = ("gather ok", "gather(global array) ok", "gather_object ok", "broadcast ok",
              "reduce ok", "pad_across_processes ok", "broadcast_object_list ok",
              "split_between_processes ok", "checkpoint round-trip ok",
              "debug shape sanitizer ok")
    missing = [c for c in checks if f"[p0] {c}" not in ops_out]
    print(f"  collectives on cuda over nccl ({ops_end - t0:.1f} s, beside test): "
          f"{len(checks) - len(missing)} of {len(checks)} ok")
    if missing or "on cuda:0 over nccl" not in ops_out \
            or "All multi-process ops checks passed." not in ops_out:
        fail(f"the collectives check missed {missing}:\n{ops_out[-3000:]}")

    if reference is None:
        from accelerate_tpu_torch.bench import run_bench

        reference = run_bench(iters=MP["iters"], warmup=MP["warmup"])
        free_cuda()
    ref_losses = reference["extra"]["losses"][:MP["warmup"] + MP["iters"]]
    with tempfile.TemporaryDirectory(prefix="atpu_smoke_mp_") as tmp:
        result_path = os.path.join(tmp, "child.json")
        t0 = time.time()
        run_cli(["launch", "--num_processes", "1", "--mixed_precision", "bf16",
                 os.path.join(HERE, "chip_smoke.py"), MP_CHILD_FLAG, result_path],
                timeout=MP["timeout"], env_extra={"ATPU_SMOKE_LAUNCHED_AT": repr(t0)})
        wall_s = time.time() - t0
        with open(result_path) as f:
            child = json.load(f)
    steps = MP["warmup"] + MP["iters"]
    layers = reference["extra"]["config"]["layers"]
    print(f"  launched trainer ({wall_s:.1f} s of wall time): rank {child['rank']} of "
          f"{child['world']} over {child['backend']} on {child['device']}; start-up "
          f"{child['startup_s']:.2f} s (process start {child['process_start_s']:.2f} s, import "
          f"{child['import_s']:.2f} s, init_process_group {child['init_process_group_s']:.2f} s)")
    print(f"  step {child['step_ms']:.2f} ms launched ({child['no_sync_step_ms']:.2f} ms under "
          f"no_sync(), no gradient reduction) against {reference['extra']['step_ms']:.2f} ms "
          f"here without a process group; gradient "
          f"all-reduce {child['reduction_ms']:.3f} ms a step ({child['buckets']} buckets of "
          f"<= 25 MB, {child['gradient_bytes'] / 1e9:.3f} GB f32), run {child['reduce_calls']} "
          f"times in {steps} steps; peak memory {child['peak_memory_gib']:.2f} GiB; {card_line()}")
    print(f"  launches in {steps} steps: {child['counts']}")
    if child["backend"] != "nccl" or child["world"] != 1:
        fail(f"the launched trainer ran over {child['backend']} at world size {child['world']}")
    if child["counts"] != expected_counts(layers * steps, layers * steps, wgmma=True):
        fail(f"the launched trainer's flash launches {child['counts']}: expected {layers} of "
             f"each a step, all on the wgmma route")
    if child["reduce_calls"] != steps:
        fail(f"the gradient all-reduce ran {child['reduce_calls']} times in {steps} steps")
    if child["losses"] != ref_losses:
        diverged = next(i for i, (a, b) in enumerate(zip(child["losses"], ref_losses)) if a != b)
        fail(f"the launched losses part from the unlaunched ones at step {diverged + 1}: "
             f"{child['losses']} against {ref_losses}")
    print(f"  the {steps} launched losses equal the unlaunched ones bit for bit "
          f"({child['losses'][0]:.6f} -> {child['losses'][-1]:.6f})")
    child["reference_step_ms"] = reference["extra"]["step_ms"]
    return child


SHARDED = dict(warmup=3, iters=10, timeout=500, copy_iters=3)
SHARDED_CHILD_FLAG = "--sharded-child"
SHARDED_MODES = {
    "full_shard_remat": dict(sharding_strategy="FULL_SHARD", activation_checkpointing=True),
    "shard_grad_op": dict(sharding_strategy="SHARD_GRAD_OP"),
}


def sharded_steps(plugin_kwargs: dict) -> dict:
    """The tier-1 model under an FSDP plugin: 3 + 10 steps in ``run_bench``'s
    batch order, the last 10 timed; the flash launches, the layout's layer
    gathers and the peak memory (reset after the build, as ``run_bench``
    does)."""
    import torch

    from accelerate_tpu_torch import FullyShardedDataParallelPlugin
    from accelerate_tpu_torch.bench import build_train_step
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state()
    GradientState._reset_state()
    cfg, model, step, batches = build_train_step(
        accelerator_kwargs={"fsdp_plugin": FullyShardedDataParallelPlugin(**plugin_kwargs)})
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses = []
    for i in range(SHARDED["warmup"]):
        losses.append(step(batches[i % 4])["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(SHARDED["iters"]):
        losses.append(step(batches[i % 4])["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / SHARDED["iters"]
    layout = model.layout
    out = dict(losses=torch.stack(losses).tolist(), step_ms=step_ms, counts=read_counts(),
               gathers=layout.gathers, layers=cfg.num_hidden_layers,
               sharded_leaves=sum(d is not None for d in layout.dims.values()),
               leaves=len(layout.dims), peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
               distributed_type=str(AcceleratorState().distributed_type))
    return out, model, step


def sharded_child(out_path: str):
    """The launched trainer of phase 10 (``launch --num_processes 1
    --mixed_precision bf16 chip_smoke.py --sharded-child OUT``): each mode of
    ``SHARDED_MODES`` in turn, in the process group; writes the numbers to
    ``OUT`` as JSON."""
    import torch

    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from accelerate_tpu_torch import PartialState

    state = PartialState()
    result = dict(backend=state.backend, world=state.num_processes, device=str(state.device))
    for mode, kwargs in SHARDED_MODES.items():
        result[mode], model, step = sharded_steps(kwargs)
        del model, step
        free_cuda()
    with open(out_path, "w") as f:
        json.dump(result, f)
    print(f"sharded child done: rank {state.process_index} of {state.num_processes} "
          f"over {state.backend}")


def best_gbs(fns, nbytes: int) -> list:
    """GB/s of each of ``fns`` moving ``nbytes``, run in turns
    ``SHARDED["copy_iters"]`` times, each synchronised on the host clock:
    the best run of each."""
    import torch

    best = [float("inf")] * len(fns)
    for _ in range(SHARDED["copy_iters"]):
        for i, fn in enumerate(fns):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best[i] = min(best[i], time.perf_counter() - t0)
    return [nbytes / t / 1e9 for t in best]


def moments_of(opt) -> list:
    """The optimizer's state tensors shaped like their parameter."""
    return [v for p in opt._params() for v in opt.moments(p).values()]


def sharded_offload(ref_losses, ref_peak_gib, problems: list):
    """``cpu_offload=True`` without a process group: the moments live in
    pinned host memory between steps. Adds what is wrong to ``problems``;
    returns the numbers."""
    import torch

    from accelerate_tpu_torch.parallel.host_offload import tree_memory_kinds

    result, model, step = sharded_steps(dict(cpu_offload=True))
    opt = step.optimizer
    moments = moments_of(opt)
    kinds = opt.state_memory_kinds()
    pinned = all(t.is_pinned() for t in moments)
    count = len(moments)
    del moments
    nbytes = opt.state_bytes()
    seen = []

    def stream_in():
        opt._state_to("device")
        seen.append(tree_memory_kinds(moments_of(opt)))

    h2d, d2h = best_gbs([stream_in, lambda: opt._state_to("host")], nbytes)
    on_card = set().union(*seen)
    host = torch.empty(nbytes // 4, dtype=torch.float32, pin_memory=True)
    card = torch.empty_like(host, device="cuda")
    plain_h2d, plain_d2h = best_gbs([lambda: card.copy_(host, non_blocking=True),
                                     lambda: host.copy_(card, non_blocking=True)], nbytes)
    del host, card
    result.update(state_kinds=sorted(kinds), pinned=pinned, moment_bytes=nbytes,
                  moment_tensors=count, h2d_gbs=h2d, d2h_gbs=d2h, plain_h2d_gbs=plain_h2d,
                  plain_d2h_gbs=plain_d2h, kinds_streamed_in=sorted(on_card))
    layers = result["layers"]
    steps = SHARDED["warmup"] + SHARDED["iters"]
    print(f"  cpu_offload=True, unlaunched: step {result['step_ms']:.2f} ms; peak memory "
          f"{result['peak_memory_gib']:.2f} GiB against phase 6's {ref_peak_gib:.2f} GiB "
          f"({ref_peak_gib - result['peak_memory_gib']:.2f} GiB less); Adam moments "
          f"{nbytes / 1e9:.3f} GB in {count} tensors, between steps {sorted(kinds)} "
          f"(pinned: {pinned}); streamed in {h2d:.1f} GB/s, out {d2h:.1f} GB/s, against a "
          f"plain pinned copy of the same bytes {plain_h2d:.1f} / {plain_d2h:.1f} GB/s; "
          f"{card_line()}")
    print(f"  launches in {steps} offloaded steps: {result['counts']}")
    if kinds != {"pinned_host"} or not pinned:
        problems.append(f"the offloaded optimizer state is {sorted(kinds)} between steps, not "
                        "pinned host")
    if on_card != {"device"}:
        problems.append(f"the streamed-in moments are {sorted(on_card)}, not on the card")
    if result["counts"] != expected_counts(layers * steps, layers * steps, wgmma=True):
        problems.append(f"the offloaded steps' flash launches {result['counts']}")
    if result["losses"] != ref_losses:
        problems.append(f"the offloaded losses {result['losses']} differ from phase 6's "
                        f"{ref_losses}")
    if not result["peak_memory_gib"] < ref_peak_gib:
        problems.append(f"the offloaded peak {result['peak_memory_gib']:.2f} GiB is not below "
                        f"phase 6's {ref_peak_gib:.2f} GiB")
    del model, step, opt
    free_cuda()
    return result


def phase_sharded(reference=None):
    """Phase 10: the tier-1 trainer under FSDP, launched at world size 1 over
    NCCL (FULL_SHARD with remat, SHARD_GRAD_OP), then offloaded here; every
    run's losses must equal phase 6's bit for bit (``reference``: its
    ``run_bench`` result, else its 13 steps run here). Every mode is
    printed before a failure fails the phase. Returns the numbers, with the
    flash launches of all three runs summed in ``counts``."""
    import tempfile

    if reference is None:
        from accelerate_tpu_torch.bench import run_bench

        reference = run_bench(iters=SHARDED["iters"], warmup=SHARDED["warmup"])
        free_cuda()
    steps = SHARDED["warmup"] + SHARDED["iters"]
    ref_losses = reference["extra"]["losses"][:steps]
    ref_peak = reference["extra"]["peak_memory_gib"]
    with tempfile.TemporaryDirectory(prefix="atpu_smoke_sharded_") as tmp:
        result_path = os.path.join(tmp, "child.json")
        t0 = time.time()
        run_cli(["launch", "--num_processes", "1", "--mixed_precision", "bf16",
                 os.path.join(HERE, "chip_smoke.py"), SHARDED_CHILD_FLAG, result_path],
                timeout=SHARDED["timeout"])
        wall_s = time.time() - t0
        with open(result_path) as f:
            child = json.load(f)
    print(f"  launched trainer ({wall_s:.1f} s of wall time): world {child['world']} over "
          f"{child['backend']} on {child['device']}; phase 6 without a plugin: "
          f"{reference['extra']['step_ms']:.2f} ms a step, peak {ref_peak:.2f} GiB")
    problems = []
    if child["backend"] != "nccl" or child["world"] != 1:
        problems.append(f"the sharded trainer ran over {child['backend']} at world size "
                        f"{child['world']}")
    total = {k: 0 for k in read_counts()}
    for mode in SHARDED_MODES:
        run = child[mode]
        layers = run["layers"]
        remat = mode == "full_shard_remat"
        print(f"  {mode}: step {run['step_ms']:.2f} ms; peak memory {run['peak_memory_gib']:.2f} "
              f"GiB; {run['sharded_leaves']} of {run['leaves']} leaves sharded, "
              f"{run['gathers']} layer gathers in {steps} steps; {run['distributed_type']}; "
              f"losses {run['losses'][0]:.6f} -> {run['losses'][-1]:.6f}; launches "
              f"{run['counts']}; {card_line()}")
        if run["distributed_type"] != "FSDP":
            problems.append(f"{mode} ran as {run['distributed_type']}, not FSDP")
        if run["gathers"] != (2 if remat else 1) * layers * steps:
            problems.append(f"{mode} gathered {run['gathers']} layers in {steps} steps, "
                            f"expected {(2 if remat else 1) * layers * steps}")
        want = expected_counts((2 if remat else 1) * layers * steps, layers * steps, wgmma=True)
        if run["counts"] != want:
            problems.append(f"{mode}'s flash launches {run['counts']}, expected {want}")
        if run["losses"] != ref_losses:
            problems.append(f"{mode}'s losses {run['losses']} differ from phase 6's "
                            f"{ref_losses}")
        for k, v in run["counts"].items():
            total[k] += v
    offload = sharded_offload(ref_losses, ref_peak, problems)
    for k, v in offload["counts"].items():
        total[k] += v
    if problems:
        fail("phase 10: " + "; ".join(problems))
    print(f"  every sharded and offloaded run's {steps} losses equal phase 6's bit for bit")
    return dict(child=child, offload=offload, counts=total, steps=3 * steps,
                reference_step_ms=reference["extra"]["step_ms"], reference_peak_gib=ref_peak)


MESH = dict(warmup=3, iters=10, timeout=500, infer_iters=3)
MESH_CHILD_FLAG = "--mesh-child"
MESH_FLAGS = ["--dp", "1", "--fsdp", "1", "--tp", "1", "--cp", "1", "--pp", "1"]
#: Phase 11's modes: accelerator keywords (plugins by name) and config overrides.
MESH_MODES = {
    "mesh_tp1_pp1": dict(plugins=("tp", "pp"), config={}),
    "ring": dict(plugins=(), config={"attention_backend": "ring"}),
    "ulysses": dict(plugins=(), config={"attention_backend": "ulysses"}),
    "hybrid_shard_remat": dict(plugins=("hybrid",), config={}),
}


def mesh_steps(mode: dict) -> dict:
    """The tier-1 model on the launched process's mesh in one of
    ``MESH_MODES``: 3 + 10 steps in ``run_bench``'s batch order, the last 10
    timed; the flash launches, the layer gathers and the peak memory."""
    import torch

    from accelerate_tpu_torch import (
        FullyShardedDataParallelPlugin,
        PipelineParallelPlugin,
        TensorParallelPlugin,
    )
    from accelerate_tpu_torch.bench import build_train_step
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state()
    GradientState._reset_state()
    plugins = {"tp": ("tp_plugin", lambda: TensorParallelPlugin(tp_size=1)),
               "pp": ("pp_plugin", lambda: PipelineParallelPlugin(pp_size=1)),
               "hybrid": ("fsdp_plugin", lambda: FullyShardedDataParallelPlugin(
                   sharding_strategy="HYBRID_SHARD", activation_checkpointing=True))}
    kwargs = {plugins[k][0]: plugins[k][1]() for k in mode["plugins"]}
    cfg, model, step, batches = build_train_step(accelerator_kwargs=kwargs, **mode["config"])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses = []
    for i in range(MESH["warmup"]):
        losses.append(step(batches[i % 4])["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(MESH["iters"]):
        losses.append(step(batches[i % 4])["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / MESH["iters"]
    state = AcceleratorState()
    out = dict(losses=torch.stack(losses).tolist(), step_ms=step_ms, counts=read_counts(),
               layers=cfg.num_hidden_layers, mesh=dict(state.mesh.shape),
               gathers=model.layout.gathers if model.layout is not None else 0,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
               distributed_type=str(state.distributed_type),
               attention_backend=cfg.attention_backend)
    del model, step
    free_cuda()
    return out


def mesh_child(out_path: str):
    """The launched trainer of phase 11 (``launch --num_processes 1
    --mixed_precision bf16 --dp 1 --fsdp 1 --tp 1 --cp 1 --pp 1
    chip_smoke.py --mesh-child OUT``): each mode of ``MESH_MODES`` in turn,
    in the process group; writes the numbers to ``OUT`` as JSON."""
    import torch

    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from accelerate_tpu_torch import PartialState

    state = PartialState()
    result = dict(backend=state.backend, world=state.num_processes, device=str(state.device),
                  env={k: v for k, v in os.environ.items() if k.startswith("ACCELERATE_TPU_MESH")})
    for name, mode in MESH_MODES.items():
        result[name] = mesh_steps(mode)
    with open(out_path, "w") as f:
        json.dump(result, f)
    print(f"mesh child done: rank {state.process_index} of {state.num_processes} "
          f"over {state.backend}")


def first_gap(got: list, want: list):
    """``(step, relative gap)`` where two loss lists first differ, else None."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return i + 1, abs(a - b) / max(abs(b), 1e-30)
    return None


def pipelined_inference(problems: list) -> dict:
    """``prepare_pipeline`` over Llama-3-8B (bf16, full depth) stacked from
    phase 3's weights, ``num_microbatches=2``, on phase 3's 4 x 2048 tokens,
    against phase 3's logits (``PHASE3``); its ms, flash launches and peak."""
    import torch

    from accelerate_tpu_torch import PipelinedLlamaForCausalLM, prepare_pipeline

    model, policy, _ = build_model()  # phase 3's seed: the same weights
    cfg = model.config
    stacked_state = PipelinedLlamaForCausalLM.from_sequential_params(model.state_dict())
    del model
    free_cuda()
    stacked = PipelinedLlamaForCausalLM(cfg, device="cuda", dtype=policy.compute_dtype,
                                        num_microbatches=2).eval()
    stacked.load_state_dict(stacked_state)
    del stacked_state
    free_cuda()
    fwd = prepare_pipeline(stacked)
    ids = PHASE3["ids"].cuda()
    fwd(ids[:1, :256])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(MESH["infer_iters"]):
        reset_counts()
        t0 = time.perf_counter()
        logits = fwd(ids)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        if i < MESH["infer_iters"] - 1:
            del logits
    sample = logits[:, ::256].float().cpu()
    rel = ((sample - PHASE3["sample"]).norm() / PHASE3["sample"].norm()).item()
    agree = (logits.argmax(-1).cpu() == PHASE3["top1"]).float().mean().item()
    out = dict(ms=min(times), phase3_ms=PHASE3["ms"], rel_l2=rel, top1_agreement=agree,
               counts=counts, microbatches=fwd.num_microbatches,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
               shape=list(logits.shape))
    print(f"  PipelinedInferencer over llama3_8b (bf16, {cfg.num_hidden_layers} layers, "
          f"stacked, num_microbatches={fwd.num_microbatches}), {ids.shape[0]} x {ids.shape[1]} "
          f"tokens: best of {MESH['infer_iters']} {out['ms']:.1f} ms (phase 3's sequential "
          f"forward {PHASE3['ms']:.1f} ms); logits against phase 3's: relative L2 {rel:.3e} "
          f"(limit 1e-3), top-1 agreement {agree:.4f} (limit 0.99); flash launches in one call "
          f"{counts['flash_fwd_sm90']} wgmma of {counts['flash_fwd']} (pp=1: the whole batch in "
          f"one pass); peak {out['peak_memory_gib']:.1f} GiB; {card_line()}")
    if tuple(logits.shape) != (ids.shape[0], ids.shape[1], cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        problems.append(f"pipelined logits: shape {tuple(logits.shape)} or non-finite values")
    if not rel <= 1e-3 or not agree >= 0.99:
        problems.append(f"pipelined logits part from phase 3's: relative L2 {rel:.3e}, top-1 "
                        f"agreement {agree:.4f}")
    if counts != expected_counts(cfg.num_hidden_layers, 0, wgmma=True):
        problems.append(f"pipelined forward's flash launches {counts}, expected "
                        f"{cfg.num_hidden_layers} wgmma forward launches")
    del logits, fwd, stacked
    free_cuda()
    return out


def phase_mesh(reference=None):
    """Phase 11: the tier-1 trainer launched on a mesh at world size 1 over
    NCCL in ``MESH_MODES``, held bit for bit against phase 6
    (``reference``: its ``run_bench`` result, else its 13 steps run here);
    then pipelined inference over Llama-3-8B against phase 3 (whose numbers
    ``PHASE3`` holds; else they are made here). Every mode is printed before
    a failure fails the phase. Returns the numbers, with the flash launches
    of every run summed in ``counts``."""
    import tempfile

    if reference is None:
        from accelerate_tpu_torch.bench import run_bench

        reference = run_bench(iters=MESH["iters"], warmup=MESH["warmup"])
        free_cuda()
    steps = MESH["warmup"] + MESH["iters"]
    ref_losses = reference["extra"]["losses"][:steps]
    t_phase = time.time()
    with tempfile.TemporaryDirectory(prefix="atpu_smoke_mesh_") as tmp:
        result_path = os.path.join(tmp, "child.json")
        t0 = time.time()
        run_cli(["launch", "--num_processes", "1", "--mixed_precision", "bf16", *MESH_FLAGS,
                 os.path.join(HERE, "chip_smoke.py"), MESH_CHILD_FLAG, result_path],
                timeout=MESH["timeout"])
        wall_s = time.time() - t0
        with open(result_path) as f:
            child = json.load(f)
    print(f"  launched trainer ({wall_s:.1f} s of wall time): world {child['world']} over "
          f"{child['backend']} on {child['device']}, mesh variables {child['env']}; phase 6 "
          f"without a mesh: {reference['extra']['step_ms']:.2f} ms a step, peak "
          f"{reference['extra']['peak_memory_gib']:.2f} GiB")
    problems = []
    if child["backend"] != "nccl" or child["world"] != 1:
        problems.append(f"the mesh trainer ran over {child['backend']} at world size "
                        f"{child['world']}")
    total = {k: 0 for k in read_counts()}
    for name in MESH_MODES:
        run = child[name]
        layers = run["layers"]
        remat = name == "hybrid_shard_remat"
        per_step = {k: v / steps for k, v in run["counts"].items() if v}
        gap = first_gap(run["losses"], ref_losses)
        print(f"  {name}: mesh {run['mesh']}, {run['distributed_type']}, backend "
              f"{run['attention_backend']}; step {run['step_ms']:.2f} ms; peak "
              f"{run['peak_memory_gib']:.2f} GiB; launches a step {per_step}; losses "
              + ", ".join(f"{x:.6f}" for x in run["losses"])
              + ("; equal to phase 6's bit for bit" if gap is None else
                 f"; part from phase 6's at step {gap[0]}, relative gap {gap[1]:.3e}")
              + f"; {card_line()}")
        if any(v != 1 for v in run["mesh"].values()):
            problems.append(f"{name} ran on the mesh {run['mesh']}")
        want = expected_counts((2 if remat else 1) * layers * steps, layers * steps, wgmma=True)
        if run["counts"] != want:
            problems.append(f"{name}'s flash launches {run['counts']}, expected {want}")
        if remat and run["gathers"] != 2 * layers * steps:
            problems.append(f"{name} gathered {run['gathers']} layers in {steps} steps, "
                            f"expected {2 * layers * steps}")
        if gap is not None:
            problems.append(f"{name}'s losses part from phase 6's at step {gap[0]} "
                            f"(relative gap {gap[1]:.3e})")
        for k, v in run["counts"].items():
            total[k] += v
    train_counts = dict(total)
    if not PHASE3:
        model, policy, gen = build_model()
        phase_forward(model, policy, gen)
        del model, gen
        free_cuda()
    infer = pipelined_inference(problems)
    for k, v in infer["counts"].items():
        total[k] += v
    phase_s = time.time() - t_phase
    print(f"  phase 11 took {phase_s:.1f} s")
    if problems:
        fail("phase 11: " + "; ".join(problems))
    print(f"  every mesh mode's {steps} losses equal phase 6's bit for bit")
    return dict(child=child, infer=infer, counts=total, train_counts=train_counts,
                steps=len(MESH_MODES) * steps, seconds=phase_s,
                reference_step_ms=reference["extra"]["step_ms"])


MOE = dict(seed=81, forward_layers=8, forward=(4, 2048), small=(1, 256), prompt=512, new=32,
           exact_hidden=256, exact_intermediate=512, exact_prompt=48, exact_new=24,
           train_layers=2, train=(4, 1024), warmup=3, iters=10, timeout=600,
           stream_layers=2, stream_tokens=2048, stream_shard="2GB")
MOE_CHILD_FLAG = "--moe-child"
MOE_MESH_CHILD_FLAG = "--moe-mesh-child"
#: The questionnaire's answers for phase 12 (e), one a line: one machine,
#: bf16, every mesh axis 1, no debug checks.
MOE_MESH_ANSWERS = "1\n2\n1\n1\n1\n1\n1\n1\n2\n"
MOE_CAPACITY = 1.25  # MixtralConfig's training capacity factor
MOE_PATH = ("Mixtral-8x7B widths (phase 12): 8-layer forward on 4 x 2048 tokens, 2-layer train "
            "steps on 4 x 1024 launched (--ep 1, then from the questionnaire's config with --tp 1 "
            "--cp 1 --pp 1 --ep 1) and not, 2-layer streamed forward on 1 x 2048")


def moe_config(layers: int, **overrides):
    from accelerate_tpu_torch.models.mixtral import MixtralConfig

    return MixtralConfig.mixtral_8x7b(num_hidden_layers=layers, **overrides)


def routing_summary(model) -> str:
    """Each sparse layer's share of dropped (token, choice) pairs and its
    experts' loads, from the last forward."""
    import torch

    counters = model.routing_counters()
    drops = [float(c["dropped_fraction"]) for c in counters]
    loads = torch.stack([c["expert_load"] for c in counters]).cpu()
    share = loads / loads.sum(1, keepdim=True)
    return (f"dropped pairs per layer {', '.join(f'{d:.4f}' for d in drops)}; expert load "
            f"shares (min/max over layers) "
            + ", ".join(f"e{e} {share[:, e].min():.3f}/{share[:, e].max():.3f}"
                        for e in range(share.shape[1])))


def one_hot_moe(experts, router, x, top_k, capacity_factor):
    """The reference's one-hot form of the MoE layer (one group): dispatch
    and combine tensors from ``top_k_routing`` and four einsums."""
    import torch

    from accelerate_tpu_torch.ops.moe import expert_capacity, top_k_routing

    B, S, D = x.shape
    tokens = x.reshape(1, B * S, D)
    E = router.shape[1]
    C = expert_capacity(B * S, E, top_k, capacity_factor)
    dispatch, combine, _ = top_k_routing(tokens.float() @ router.float(), top_k, C)
    expert_in = torch.einsum("gnec,gnd->egcd", dispatch.to(x.dtype), tokens)
    h = torch.nn.functional.silu(torch.einsum("egcd,edf->egcf", expert_in, experts["gate_proj"]))
    h = h * torch.einsum("egcd,edf->egcf", expert_in, experts["up_proj"])
    out_e = torch.einsum("egcf,efd->egcd", h, experts["down_proj"])
    return torch.einsum("gnec,egcd->gnd", combine, out_e.float()).reshape(B, S, D).to(x.dtype)


def moe_forward(problems: list):
    """Phase 12 (a): the 8-layer Mixtral-8x7B forward in bf16 on 4 x 2048
    tokens (capacity factor 1.25, one routing group): ms, peak, drops and
    loads, 8 wgmma forward launches, finite logits; on 1 x 256 tokens the
    flash forward against einsum attention, and layer 0's index dispatch
    against the one-hot einsums at f32."""
    import torch

    from accelerate_tpu_torch.models.mixtral import MixtralForCausalLM
    from accelerate_tpu_torch.ops.moe import moe_mlp_apply

    cfg = moe_config(MOE["forward_layers"])
    gen = torch.Generator(device="cuda").manual_seed(MOE["seed"])
    t0 = time.perf_counter()
    model = MixtralForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, generator=gen).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  mixtral_8x7b widths, {cfg.num_hidden_layers} of 32 layers: {n_params / 1e9:.3f} B "
          f"params ({n_params * 2 / 1e9:.1f} GB in bf16), built in {time.perf_counter() - t0:.1f} s")
    B, S = MOE["forward"]
    ids = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    out = {}
    with torch.inference_mode():
        model(ids[:1, :256])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            reset_counts()
            t0 = time.perf_counter()
            logits, aux = model(ids)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        out.update(ms=min(times), counts=counts, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   drops=[float(c["dropped_fraction"]) for c in model.routing_counters()])
        print(f"  forward {B} x {S} tokens: best of 3 {out['ms']:.1f} ms "
              f"({B * S / out['ms'] * 1e3:.0f} tokens/s), peak {out['peak_gib']:.1f} GiB, flash "
              f"launches {counts['flash_fwd_sm90']} wgmma of {counts['flash_fwd']}; load-balance "
              f"loss {float(aux['load_balance_loss']):.4f}, z-loss "
              f"{float(aux['router_z_loss']):.4f}; {routing_summary(model)}; {card_line()}")
        if counts != expected_counts(cfg.num_hidden_layers, 0, wgmma=True):
            problems.append(f"the Mixtral forward's flash launches {counts}, expected "
                            f"{cfg.num_hidden_layers} wgmma forward launches")
        if tuple(logits.shape) != (B, S, cfg.vocab_size) or not torch.isfinite(logits).all():
            problems.append(f"Mixtral logits: shape {tuple(logits.shape)} or non-finite values")
        del logits

        # Same widths, small input: every layer's attention through the flash
        # kernel against einsum attention on the same hidden states (the
        # routing is not compared: a bf16 rounding can flip a top-k choice).
        small = ids[:MOE["small"][0], :MOE["small"][1]]
        positions = torch.arange(small.shape[1], device="cuda")[None].expand_as(small)
        h = model.embed_tokens(small)
        rel = 0.0
        for layer in model.layers:
            normed = layer.input_norm(h)
            flash_out = layer.self_attn(normed, positions).float()
            cfg.attention_backend = "einsum"
            try:
                einsum_out = layer.self_attn(normed, positions).float()
            finally:
                cfg.attention_backend = "auto"
            rel = max(rel, ((flash_out - einsum_out).norm() / einsum_out.norm()).item())
            h = layer(h, positions)[0]
        flash_logits, einsum_logits = model(small)[0], None
        cfg.attention_backend = "einsum"
        try:
            einsum_logits = model(small)[0]
        finally:
            cfg.attention_backend = "auto"
        agree = (flash_logits.argmax(-1) == einsum_logits.argmax(-1)).float().mean().item()
        print(f"  flash vs einsum attention in each of the {cfg.num_hidden_layers} layers "
              f"(1 x 256, bf16, same inputs): relative L2 {rel:.3e} at most (limit 5e-2); whole "
              f"forwards' top-1 agreement {agree:.4f} (reported: routing may flip)")
        if not rel <= 5e-2:
            problems.append(f"the Mixtral attention through the flash kernel parts from the "
                            f"einsum one ({rel:.3e})")

        mlp = model.layers[0].mlp
        experts = {k: getattr(mlp.experts, k).float() for k in ("gate_proj", "up_proj",
                                                                 "down_proj")}
        x = torch.randn((1, 256, cfg.hidden_size), generator=gen, device="cuda")
        got, routed = moe_mlp_apply(experts, mlp.router.float(), x, top_k=cfg.top_k,
                                    capacity_factor=cfg.capacity_factor, num_groups=1)
        want = one_hot_moe(experts, mlp.router.float(), x, cfg.top_k, cfg.capacity_factor)
        rel_moe = ((got - want).norm() / want.norm()).item()
        print(f"  index dispatch vs one-hot einsums (layer 0 at f32, 1 x 256, "
              f"{float(routed['dropped_fraction']):.4f} of the pairs dropped): relative L2 "
              f"{rel_moe:.3e} (limit 1e-5)")
        if not rel_moe <= 1e-5:
            problems.append(f"the index dispatch parts from the one-hot form ({rel_moe:.3e})")
        del experts, got, want
    out["rel_flash_einsum"], out["rel_index_one_hot"] = rel, rel_moe
    return model, gen, out


def moe_generate(model, gen, problems: list) -> dict:
    """Phase 12 (b): greedy ``generate`` on the 8-layer model, batch 1, a
    512-token prompt and 32 new tokens: no flash launch, a repeat identical;
    then at f32, 2 layers and small widths, token-exact with the greedy
    loop over uncached forwards while that forward drops nothing."""
    import torch

    from accelerate_tpu_torch import generate
    from accelerate_tpu_torch.models.mixtral import MixtralForCausalLM

    prompt = torch.randint(0, model.config.vocab_size, (1, MOE["prompt"]), generator=gen,
                           device="cuda")
    reset_counts()
    runs = []
    for new in (MOE["new"], MOE["new"], 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append((generate(model, prompt, max_new_tokens=new), time.perf_counter() - t0))
    counts = read_counts()
    decode_s = runs[1][1] - runs[2][1]
    out = dict(tokens_per_s=(MOE["new"] - 1) / decode_s,
               ms_per_token=decode_s * 1e3 / (MOE["new"] - 1), prefill_ms=runs[2][1] * 1e3)
    print(f"  generate batch 1, {MOE['prompt']}-token prompt, {MOE['new']} new, greedy: decode "
          f"{out['tokens_per_s']:.1f} tokens/s ({out['ms_per_token']:.2f} ms a token), prefill "
          f"{out['prefill_ms']:.1f} ms; flash launches {counts['flash_fwd']}; {card_line()}")
    if any(counts.values()):
        problems.append(f"the cached Mixtral generate launched a flash kernel: {counts}")
    if not torch.equal(runs[0][0], runs[1][0]):
        problems.append("a repeat greedy Mixtral generate returned other tokens")

    cfg = moe_config(2, hidden_size=MOE["exact_hidden"],
                     intermediate_size=MOE["exact_intermediate"])
    small_gen = torch.Generator(device="cuda").manual_seed(MOE["seed"] + 1)
    small = MixtralForCausalLM(cfg, device="cuda", dtype=torch.float32,
                               generator=small_gen).eval()
    ids = torch.randint(0, cfg.vocab_size, (1, MOE["exact_prompt"]), generator=small_gen,
                        device="cuda")
    def greedy_loop():
        ref, drops = ids, []
        for _ in range(MOE["exact_new"]):
            logits, _ = small(ref)
            drops.append(max(float(c["dropped_fraction"]) for c in small.routing_counters()))
            ref = torch.cat([ref, logits[:, -1].argmax(-1, keepdim=True)], dim=1)
        return ref, drops

    with torch.inference_mode():
        cached = generate(small, ids, max_new_tokens=MOE["exact_new"],
                          cache_dtype=torch.float32)
        trained_ref, drops = greedy_loop()  # at the training capacity factor 1.25
        cfg.capacity_factor = float(cfg.num_experts)  # no drops, as the cached path routes
        try:
            no_drop_ref, no_drops = greedy_loop()
        finally:
            cfg.capacity_factor = MOE_CAPACITY
    exact = bool(torch.equal(cached, no_drop_ref))
    first = next((i + 1 for i, d in enumerate(drops) if d > 0), None)
    print(f"  f32, 2 layers at hidden {cfg.hidden_size}: cached generate against the greedy "
          f"loop over uncached forwards routed without drops: "
          f"{'token-exact' if exact else 'parts'} over {MOE['exact_new']} tokens (their drops "
          f"{max(no_drops):.4f}); at the training capacity factor the uncached forwards drop up "
          f"to {max(drops):.4f} of the pairs (first at new token {first}) and the loop is "
          f"{'token-exact too' if torch.equal(cached, trained_ref) else 'parted'}")
    if not exact or max(no_drops) > 0:
        problems.append("the cached Mixtral generate parts from the greedy loop over uncached "
                        "forwards that drop nothing")
    del small
    out["exact"] = exact
    return out


def moe_train_steps(mesh_plugins: bool = False) -> dict:
    """Phase 12 (c)'s trainer: Mixtral-8x7B widths at 2 layers, f32
    masters and bf16 compute, fused AdamW, ``mixtral_lm_loss``, clip 1.0,
    ``ExpertParallelPlugin(ep_size=1)``; 3 + 10 steps on 4 seeded batches
    of 4 x 1024 tokens, the last 10 timed. In a process group when the
    launcher made one. ``mesh_plugins`` (phase 12 (e)) adds the tensor,
    context (ring attention) and pipeline plugins at size 1."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import (
        Accelerator,
        ContextParallelPlugin,
        ExpertParallelPlugin,
        PipelineParallelPlugin,
        TensorParallelPlugin,
        make_global_batch,
    )
    from accelerate_tpu_torch.models.mixtral import MixtralForCausalLM, mixtral_lm_loss
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state()
    GradientState._reset_state()
    plugins = {}
    if mesh_plugins:
        plugins = dict(tp_plugin=TensorParallelPlugin(tp_size=1),
                       cp_plugin=ContextParallelPlugin(cp_size=1, mode="ring"),
                       pp_plugin=PipelineParallelPlugin(pp_size=1))
    acc = Accelerator(mixed_precision="bf16", ep_plugin=ExpertParallelPlugin(ep_size=1),
                      **plugins)
    cfg = moe_config(MOE["train_layers"],
                     **({"attention_backend": "ring"} if mesh_plugins else {}))
    gen = torch.Generator(device=acc.device).manual_seed(MOE["seed"] + 2)
    model = MixtralForCausalLM(cfg, device=acc.device, dtype=torch.float32, generator=gen)
    model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                                    weight_decay=1e-4, fused=True))
    step = acc.compile_train_step(mixtral_lm_loss(model), max_grad_norm=1.0)
    rng = np.random.default_rng(MOE["seed"])
    B, S = MOE["train"]
    batches = [make_global_batch({"input_ids": rng.integers(0, cfg.vocab_size, size=(B, S))},
                                 acc) for _ in range(4)]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses = []
    for i in range(MOE["warmup"]):
        losses.append(step(batches[i % 4])["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(MOE["iters"]):
        losses.append(step(batches[i % 4])["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / MOE["iters"]
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    routing = model.module.routing_counters()  # the last step's forward
    state = AcceleratorState()
    out = dict(losses=torch.stack(losses).tolist(), step_ms=step_ms, counts=counts,
               peak_memory_gib=peak, layers=cfg.num_hidden_layers,
               n_params=sum(p.numel() for p in model.parameters()),
               load_balance_loss=sum(float(c["load_balance_loss"]) for c in routing) / len(routing),
               router_z_loss=sum(float(c["router_z_loss"]) for c in routing) / len(routing),
               drops=[float(c["dropped_fraction"]) for c in routing],
               mesh=dict(state.mesh.shape), backend=getattr(state, "backend", None),
               world=state.num_processes)
    del model, step, batches
    free_cuda()
    return out


def moe_child(out_path: str, mesh_plugins: bool = False):
    """Phase 12 (c)'s launched trainer (``launch --num_processes 1
    --mixed_precision bf16 --ep 1 chip_smoke.py --moe-child OUT``), or with
    ``mesh_plugins`` (e)'s (``launch --config_file F --num_processes 1 --tp
    1 --cp 1 --pp 1 --ep 1 chip_smoke.py --moe-mesh-child OUT``): writes
    ``moe_train_steps``' numbers to ``OUT`` as JSON."""
    import torch

    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from accelerate_tpu_torch import PartialState

    state = PartialState()
    result = moe_train_steps(mesh_plugins)
    result.update(backend=state.backend, env={k: v for k, v in os.environ.items()
                                              if k.startswith("ACCELERATE_TPU_MESH")},
                  mixed_precision=os.environ.get("ACCELERATE_TPU_MIXED_PRECISION"))
    with open(out_path, "w") as f:
        json.dump(result, f)
    print(f"moe child done: rank {state.process_index} of {state.num_processes} "
          f"over {state.backend}")


def moe_train(problems: list) -> dict:
    """Phase 12 (c): the 2-layer trainer launched at world size 1 over NCCL
    with ``--ep 1``, then (e) (``moe_mesh_train``), then here without a
    process group: their 13 losses equal bit for bit and finite, 2 + 2 + 2
    wgmma launches a step."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="atpu_smoke_moe_") as tmp:
        result_path = os.path.join(tmp, "child.json")
        t0 = time.time()
        run_cli(["launch", "--num_processes", "1", "--mixed_precision", "bf16", "--ep", "1",
                 os.path.join(HERE, "chip_smoke.py"), MOE_CHILD_FLAG, result_path],
                timeout=MOE["timeout"])
        wall_s = time.time() - t0
        with open(result_path) as f:
            child = json.load(f)
    # (e) before the in-process run: this process then holds no model yet.
    mesh_train = moe_mesh_train(problems, child)
    here = moe_train_steps()
    steps = MOE["warmup"] + MOE["iters"]
    layers = here["layers"]
    for label, run in (("launched", child), ("here", here)):
        per_step = {k: v / steps for k, v in run["counts"].items() if v}
        print(f"  {label}: {run['n_params'] / 1e9:.3f} B params ({layers} layers), mesh "
              f"{run['mesh']}, world {run['world']} over {run['backend']}; step "
              f"{run['step_ms']:.2f} ms; peak {run['peak_memory_gib']:.2f} GiB; load-balance "
              f"loss {run['load_balance_loss']:.4f}, z-loss {run['router_z_loss']:.4f}, "
              f"dropped pairs {', '.join(f'{d:.4f}' for d in run['drops'])}; launches a step "
              f"{per_step}; losses {run['losses'][0]:.6f} -> {run['losses'][-1]:.6f}"
              + (f" ({wall_s:.1f} s of wall time)" if label == "launched" else "")
              + f"; {card_line()}")
        if run["counts"] != expected_counts(layers * steps, layers * steps, wgmma=True):
            problems.append(f"the {label} Mixtral trainer's flash launches {run['counts']}, "
                            f"expected {layers} of each a step on the wgmma route")
        if not all(math.isfinite(x) for x in run["losses"]):
            problems.append(f"the {label} Mixtral trainer gave a non-finite loss")
    if child["backend"] != "nccl" or child["world"] != 1:
        problems.append(f"the launched Mixtral trainer ran over {child['backend']} at world "
                        f"size {child['world']}")
    gap = first_gap(child["losses"], here["losses"])
    if gap is not None:
        problems.append(f"the launched Mixtral losses part from the unlaunched ones at step "
                        f"{gap[0]} (relative gap {gap[1]:.3e})")
    else:
        print(f"  the {steps} launched losses equal the unlaunched ones bit for bit")
    if here["peak_memory_gib"] > 75:
        problems.append(f"the 2-layer trainer peaked at {here['peak_memory_gib']:.1f} GiB")
    return dict(child=child, here=here, steps=2 * steps, mesh_train=mesh_train,
                counts={k: child["counts"][k] + here["counts"][k] for k in here["counts"]})


def moe_mesh_train(problems: list, reference: dict) -> dict:
    """Phase 12 (e): (c)'s launched trainer again, its configuration file
    written by the ``config`` questionnaire from scripted answers on a
    piped (non-TTY) stdin, launched with ``--tp 1 --cp 1 --pp 1 --ep 1``
    and the tensor, context (ring) and pipeline plugins at size 1, over
    NCCL at world size 1: its 13 losses equal (c)'s launched ones bit for
    bit, 2 + 2 + 2 wgmma launches a step; step ms, peak and the seconds it
    took."""
    import tempfile

    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="atpu_smoke_moe_mesh_") as tmp:
        config_file = os.path.join(tmp, "asked.yaml")
        asked = run_cli(["config", "--config_file", config_file], timeout=120,
                        stdin_text=MOE_MESH_ANSWERS)
        with open(config_file) as f:
            written = f.read()
        result_path = os.path.join(tmp, "child.json")
        run_cli(["launch", "--config_file", config_file, "--num_processes", "1", "--tp", "1",
                 "--cp", "1", "--pp", "1", "--ep", "1", os.path.join(HERE, "chip_smoke.py"),
                 MOE_MESH_CHILD_FLAG, result_path], timeout=MOE["timeout"])
        with open(result_path) as f:
            child = json.load(f)
    seconds = time.time() - t0
    steps = MOE["warmup"] + MOE["iters"]
    layers = child["layers"]
    per_step = {k: v / steps for k, v in child["counts"].items() if v}
    ref_ms = reference["step_ms"]
    print(f"  (e) config questionnaire (piped answers: {'Mixed precision' in asked}) then "
          f"launch --tp 1 --cp 1 --pp 1 --ep 1: mesh {child['mesh']}, world {child['world']} "
          f"over {child['backend']}, mixed precision {child['mixed_precision']}; step "
          f"{child['step_ms']:.2f} ms against (c)'s launched {ref_ms:.2f} ms "
          f"({100 * (child['step_ms'] / ref_ms - 1):+.2f} %); peak "
          f"{child['peak_memory_gib']:.2f} GiB; launches a step {per_step}; {seconds:.1f} s; "
          f"{card_line()}")
    if "mixed_precision: \"bf16\"" not in written or child["mixed_precision"] != "bf16":
        problems.append("the questionnaire's config file did not carry bf16 to the launch")
    if child["backend"] != "nccl" or child["world"] != 1:
        problems.append(f"(e) ran over {child['backend']} at world size {child['world']}")
    if child["counts"] != expected_counts(layers * steps, layers * steps, wgmma=True):
        problems.append(f"(e)'s flash launches {child['counts']}, expected {layers} of each a "
                        "step on the wgmma route")
    gap = first_gap(reference["losses"], child["losses"])
    if gap is not None:
        problems.append(f"(e)'s losses part from (c)'s at step {gap[0]} (relative gap "
                        f"{gap[1]:.3e})")
    else:
        print(f"  (e)'s {steps} losses equal (c)'s launched ones bit for bit")
    return dict(child=child, seconds=seconds, steps=steps, counts=child["counts"])


def unit_of(name: str) -> str:
    """``layers.<i>`` for a decoder layer's parameter, else its top module."""
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] == "layers" else parts[0]


def moe_streamed(problems: list) -> dict:
    """Phase 12 (d): a 2-layer bf16 Mixtral at full width exported to an
    HF directory by the port's exporter (``save_hf_checkpoint``, family
    "mixtral": the router transposed, each expert's w1/w2/w3 apart), loaded
    back by ``load_hf_checkpoint_and_dispatch`` on the solver's "auto" map
    under a card budget that holds the embedding and layer 0 (the last layer
    and the head go to host memory, each layer's experts stacked from their
    per-expert tensors); its 1 x 2048 logits against the resident model's."""
    import tempfile

    import torch

    from accelerate_tpu_torch.big_modeling import load_hf_checkpoint_and_dispatch
    from accelerate_tpu_torch.models.mixtral import MixtralForCausalLM
    from accelerate_tpu_torch.utils.hf_interop import save_hf_checkpoint

    cfg = moe_config(MOE["stream_layers"])
    gen = torch.Generator(device="cuda").manual_seed(MOE["seed"] + 3)
    model = MixtralForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, generator=gen).eval()
    sizes: dict = {}
    for name, p in model.named_parameters():
        sizes[unit_of(name)] = sizes.get(unit_of(name), 0) + p.numel() * 2
    largest = max(p.numel() * 2 for p in model.parameters())
    total = sum(sizes.values())
    budget = sizes["embed_tokens"] + sizes["layers.0"] + largest + total // 100
    ids = torch.randint(0, cfg.vocab_size, (1, MOE["stream_tokens"]), generator=gen,
                        device="cuda")
    out = {}
    with torch.inference_mode():
        want = model(ids)[0]
    with tempfile.TemporaryDirectory(prefix="atpu_smoke_moe_hf_") as tmp:
        check_room(tmp, total / 1e9 * 1.1, total / 1e9 * 1.5, "the streamed Mixtral")
        t0 = time.perf_counter()
        save_hf_checkpoint(model, tmp, cfg, family="mixtral", max_shard_size=MOE["stream_shard"])
        out["export_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        streamed, _ = load_hf_checkpoint_and_dispatch(
            tmp, device_map="auto", dtype=torch.bfloat16,
            max_memory={0: budget, "cpu": 4 * total})
        out["load_s"] = time.perf_counter() - t0
        places = {}
        for name, place in streamed.store.placement.items():
            places.setdefault(str(place), set()).add(unit_of(name))
        streamed(ids[:, :256])  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        got = streamed(ids)
        torch.cuda.synchronize()
        out["ms"] = (time.perf_counter() - t0) * 1e3
        out["counts"] = read_counts()
        streamed.close()
    rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    out.update(rel_l2=rel, top1_agreement=agree, equal=bool(torch.equal(got, want)))
    print(f"  streamed Mixtral (bf16, {cfg.num_hidden_layers} layers, {total / 1e9:.2f} GB) "
          f"exported in {out['export_s']:.1f} s, loaded in {out['load_s']:.1f} s on the "
          f"\"auto\" map under {budget / 2**30:.2f} GiB of card ("
          + "; ".join(f"{k}: {', '.join(sorted(v))}" for k, v in sorted(places.items()))
          + f"); 1 x {ids.shape[1]} forward {out['ms']:.1f} ms, flash launches "
          f"{out['counts']['flash_fwd_sm90']} wgmma of {out['counts']['flash_fwd']}; logits "
          f"against the resident model's: {'bit-identical' if out['equal'] else 'differ'}, "
          f"relative L2 {rel:.3e} (limit 1e-3), top-1 agreement {agree:.4f}; {card_line()}")
    if "cpu" not in places or "layers.1" not in places.get("cpu", set()):
        problems.append(f"the streamed Mixtral's map left no layer on the host: {places}")
    if not rel <= 1e-3:
        problems.append(f"the streamed Mixtral's logits part from the resident ones ({rel:.3e})")
    if out["counts"] != expected_counts(cfg.num_hidden_layers, 0, wgmma=True):
        problems.append(f"the streamed Mixtral forward's flash launches {out['counts']}, "
                        f"expected {cfg.num_hidden_layers} wgmma forward launches")
    del model, want, got, streamed
    free_cuda()
    return out


def phase_moe() -> dict:
    """Phase 12: Mixture-of-Experts at Mixtral-8x7B widths (``ops/moe.py``,
    ``models/mixtral.py``, ``ExpertParallelPlugin``): (a) the 8-layer
    forward, (b) generate, (c) the 2-layer trainer launched with ``--ep 1``
    and not, (d) the 2-layer model streamed from its HF export, (e) the
    trainer launched from a questionnaire's config with the tp, cp and pp
    plugins at size 1. Every check is printed before a failure fails the
    phase.
    Returns the numbers, with the flash launches of the main-path runs
    summed in ``counts``."""
    t_phase = time.time()
    problems: list = []
    model, gen, forward = moe_forward(problems)
    decode = moe_generate(model, gen, problems)
    del model, gen
    free_cuda()
    train = moe_train(problems)
    mesh_train = train["mesh_train"]
    streamed = moe_streamed(problems)
    train_counts = {k: train["counts"][k] + mesh_train["counts"][k] for k in train["counts"]}
    counts = {k: forward["counts"][k] + train_counts[k] + streamed["counts"][k]
              for k in forward["counts"]}
    phase_s = time.time() - t_phase
    print(f"  phase 12 took {phase_s:.1f} s")
    if problems:
        fail("phase 12: " + "; ".join(problems))
    return dict(forward=forward, decode=decode, train=train, mesh_train=mesh_train,
                streamed=streamed, counts=counts, train_counts=train_counts,
                steps=train["steps"] + mesh_train["steps"], seconds=phase_s)


# -- phase 13: tensor-parallel serving slices, at tp 1 ---------------------------

TP_SERVE = dict(timeout=400, block_iters=10)
TP_CHILD_FLAG = "--tp-serving-child"


def slice_modes(cfg) -> dict:
    """Phase 13 (a): 4c's exact set (f32, 2 layers, 12 staggered requests on
    4 slots) through ``ServingEngine(tp=1)`` and through 4c/4d's plain
    engine in three modes; the slice's streams must equal the plain
    engine's, and in the plain mode ``generate``'s. Returns each mode's
    slice streams."""
    from accelerate_tpu_torch.adapters import AdapterBank, LoRAConfig

    model, work = exact_requests(cfg)
    refs = [generate_ref(model, p, n) for p, n in work]
    lora = LoRAConfig(rank=EXTRA["lora_rank"], target_modules=EXTRA["lora_targets"])
    tenants = {f"t{i}": seeded_adapter(model, lora, 300 + i) for i in range(EXTRA["adapters"])}
    modes = [("plain", {}, None), ("kv_dtype=int8", dict(kv_dtype="int8"), None),
             (f"{len(tenants)} LoRA tenants over weights_dtype=int8",
              dict(weights_dtype="int8"), tenants)]
    out = {}
    for label, kw, adapters_of in modes:
        def bank():
            return (dict(adapters=AdapterBank(model, config=lora, max_adapters=len(tenants) + 1))
                    if adapters_of else {})

        plain = serve_exact(model, work, f"plain engine, {label}", refs,
                            check=label == "plain", adapters_of=adapters_of, phase="13",
                            **kw, **bank())[0]
        out[label] = serve_exact(
            model, work, f"ServingEngine(tp=1), {label}, against the plain engine", plain,
            adapters_of=adapters_of, phase="13", tp=1, **kw, **bank())[0]
    del model
    free_cuda()
    return out


def slice_full_depth(model) -> dict:
    """Phase 13 (b): 4c's full-depth shape and seeded schedule through
    ``ServingEngine(tp=1)`` with an external prefix cache (host blocks)."""
    import torch

    from accelerate_tpu_torch import ServingEngine
    from accelerate_tpu_torch.serving import PrefixCache

    card = card_line()
    cfg = model.config
    schedule = serving_schedule(cfg.vocab_size,
                                torch.Generator(device="cuda").manual_seed(SERVE["seed"]))
    C = SERVE["chunk"]
    t0 = time.perf_counter()
    engine = ServingEngine(model, tp=1, max_slots=SERVE["slots"], max_len=SERVE["max_len"],
                           prefill_chunk=C, cache_dtype=torch.bfloat16, trace_capacity=1 << 15,
                           prefix_cache=PrefixCache(SERVE["prefix_cache_gib"] << 30))
    warm_s = time.perf_counter() - t0
    try:
        reset_counts()
        reqs, wall, s, itl = serve_schedule(engine, [(a, p, n, None) for a, p, n in schedule])
        launched = read_counts()
        steps = engine_checks(engine, "phase 13 (b)")
        if any(launched.values()):
            fail(f"the tp=1 slice launched flash kernels: {launched}")
        blocks = [b for _, b in engine.prefix_cache.entries()]
    finally:
        engine.shutdown(drain=False, timeout=600)
    if not blocks or any(b.device.type != "cpu" for b in blocks):
        fail("the tp=1 slice's prefix cache does not hold host blocks")
    tick_ms, chunk_ms = steady_tick(engine, card)
    # One prefix block's host round trip: the chunk step's block to the
    # host as the slice saves it, and back into the restore step's input.
    with torch.inference_mode(), torch.cuda.stream(engine._stream):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TP_SERVE["block_iters"]):
            engine._block_in.copy_(engine._host_block())
        torch.cuda.synchronize()
        block_ms = (time.perf_counter() - t0) * 1e3 / TP_SERVE["block_iters"]
    kv_bytes = engine.kv_cache_per_chip_bytes()
    tokens = sum(len(r.tokens) for r in reqs)
    c4 = SERVING_4C
    ref = (lambda key, fmt: format(c4[key], fmt) if key in c4 else "not run")
    print(f"  (b) ServingEngine(tp=1), bf16, full depth, {SERVE['slots']} slots x "
          f"{SERVE['max_len']}, chunk {C}, 4c's schedule ({card}): warmup {warm_s:.1f} s; "
          f"{len(reqs)} requests, {tokens} new tokens in {wall:.3f} s; graphs {steps}, 0 "
          f"captures after warmup, 0 flash launches")
    print(f"      beside 4c's engine in this run: graphed tick {tick_ms:.3f} ms (4c "
          f"{ref('tick_ms', '.3f')}); chunk {chunk_ms:.3f} ms (4c {ref('chunk_ms', '.3f')}); "
          f"TTFT p50 {s['ttft_ms_p50']:.1f} ms, p95 {s['ttft_ms_p95']:.1f} ms (4c "
          f"{ref('ttft_p50', '.1f')}, {ref('ttft_p95', '.1f')}); ITL p50 "
          f"{percentile(itl, 0.5):.2f} ms, p99 {percentile(itl, 0.99):.2f} ms (4c "
          f"{ref('itl_p50', '.2f')}, {ref('itl_p99', '.2f')}); host "
          f"{s['host_us_per_tick']:.1f} us a tick (4c {ref('host_us_per_tick', '.1f')}); "
          f"kv_cache_per_chip_bytes {kv_bytes} (4c {ref('kv_bytes', 'd')}); prefix hits "
          f"{s['prefix_cache_hit_chunks']} chunks, a {engine._block_bytes / 2**20:.0f} MiB "
          f"block's host round trip {block_ms:.3f} ms")
    if "kv_bytes" in c4 and kv_bytes != c4["kv_bytes"]:
        fail(f"the tp=1 slice holds {kv_bytes} K/V bytes, 4c's engine {c4['kv_bytes']}")
    out = dict(tick_ms=tick_ms, chunk_ms=chunk_ms, ttft_p50=s["ttft_ms_p50"],
               ttft_p95=s["ttft_ms_p95"], itl_p50=percentile(itl, 0.5),
               itl_p99=percentile(itl, 0.99), host_us_per_tick=s["host_us_per_tick"],
               block_ms=block_ms, kv_bytes=kv_bytes)
    del engine, reqs
    free_cuda()
    return out


def slice_fleet_http(cfg) -> dict:
    """Phase 13 (c): the fleet ``serve --tp 1`` builds (``ReplicaSet.from_mesh``,
    one slice on the card) around the exact set's model, behind the asyncio
    gateway and a supervisor; the 12 requests over HTTP, a kill of the
    slice, its restart on the same device, and a prefix the dead slice
    inserted served as a hit after the restart."""
    import threading

    import torch

    from accelerate_tpu_torch.commands.serve import build_replica_set, serve_command_parser
    from accelerate_tpu_torch.serving import (FleetSupervisor, GatewayConfig, ReplicaState,
                                              ServingGateway)

    model, work = exact_requests(cfg)
    refs = [generate_ref(model, p, n).tolist() for p, n in work]
    args = serve_command_parser().parse_args(
        ["--tp", "1", "--replicas", "1", "--max-slots", str(SERVE["exact_slots"]),
         "--max-len", str(SERVE["exact_max_len"]), "--prefill-chunk", str(SERVE["chunk"]),
         "--port", "0"])
    fleet, _ = build_replica_set(args, model=model, cache_dtype=torch.float32)
    if not fleet.leader or fleet.slice_plan is None or fleet.engine(0).tp != 1:
        fail("serve --tp 1 did not build a fleet of one tp=1 slice")
    results = [None] * len(work)
    with FleetSupervisor(fleet, hang_timeout_s=FLEET["hang_timeout_s"], poll_interval_s=0.02,
                         restart_backoff_s=0.05) as sup, \
            ServingGateway(fleet, config=GatewayConfig(server="asyncio", port=0)) as gw:

        def call(i):
            p, n = work[i]
            results[i] = http_completion(gw.url, {"prompt": p.ravel().tolist(),
                                                  "max_new_tokens": n, "stream": i % 2 == 1})

        threads = []
        per = -(-len(work) // 3)
        for wave in range(3):
            for i in range(wave * per, min(len(work), (wave + 1) * per)):
                threads.append(threading.Thread(target=call, args=(i,)))
                threads[-1].start()
            time.sleep(0.05)
        for t in threads:
            t.join(600)
        old = fleet.engine(0)
        device = old.device
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        fleet.kill_replica(0)
        wait_until(lambda: fleet.replica_states()[0] is ReplicaState.HEALTHY
                   and sup.restarts == 1, 300, "the slice's restart")
        new = fleet.engine(0)
        del old
        free_cuda()
        after = torch.cuda.memory_allocated()
        longest = max(range(len(work)), key=lambda i: work[i][0].shape[1])
        again = http_completion(gw.url, {"prompt": work[longest][0].ravel().tolist(),
                                         "max_new_tokens": work[longest][1]})
        hits = new.serving_metrics()["prefix_cache_hit_chunks"]
    same = sum(code == 200 and final["tokens"] == ref and (toks is None or toks == ref)
               for (code, final, toks), ref in zip(results, refs))
    codes = sorted({code for code, _, _ in results})
    again_ok = again[0] == 200 and again[1]["tokens"] == refs[longest]
    print(f"  (c) serve --tp 1 (ReplicaSet.from_mesh, one slice on {device}), f32, 2 layers, "
          f"asyncio gateway ({card_line()}): status codes {codes}; {same} of {len(work)} "
          f"streams over HTTP ({len(work) // 2} JSON, {len(work) // 2} SSE) equal generate; "
          f"killed and restarted on {new.device} ({sup.restarts} restart, supervisor events "
          f"{[e['kind'] for e in sup.events()]}); the {work[longest][0].shape[1]}-token prompt "
          f"again: {'equal to generate' if again_ok else 'NOT EQUAL'}, {hits} prefix chunks "
          f"hit that the dead slice cached; device memory {before / 2**30:.3f} GiB before the "
          f"kill, {after / 2**30:.3f} GiB after the restart")
    if codes != [200] or same != len(work) or not again_ok or hits < 1 or new.device != device:
        fail("phase 13 (c): the slice fleet over HTTP is not exact, or its restart lost the "
             "prefix cache or its device")
    del model, new
    free_cuda()
    return dict(before_gib=before / 2**30, after_gib=after / 2**30, hits=hits)


def tp_serving_child(out_path: str):
    """Phase 13 (d), launched by ``launch --num_processes 1 --tp 1
    chip_smoke.py --tp-serving-child OUT``: the exact set's plain mode through
    ``ServingEngine(tp=1)`` inside the process group; writes the streams."""
    import torch

    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from accelerate_tpu_torch import LlamaConfig, PartialState

    state = PartialState()
    model, work = exact_requests(LlamaConfig.llama3_8b())
    streams, _, _, _, _ = serve_exact(model, work, "launched ServingEngine(tp=1)",
                                      [generate_ref(model, p, n) for p, n in work],
                                      phase="13 (d)", tp=1)
    with open(out_path, "w") as f:
        json.dump(dict(backend=state.backend, world=state.num_processes,
                       streams=[s.tolist() for s in streams]), f)


def phase_tp_serving(model) -> dict:
    """Phase 13 (see the module docstring)."""
    import tempfile

    t_phase = time.time()
    print("  the card's machine has one GPU: the slices run at tp=1 here; tp above 1 runs only "
          "over gloo on the CPU (tests/torch_port/test_torch_serving_mesh.py)")
    modes = slice_modes(model.config)
    full = slice_full_depth(model)
    fleet = slice_fleet_http(model.config)
    with tempfile.TemporaryDirectory(prefix="atpu_smoke_tp_") as tmp:
        path = os.path.join(tmp, "child.json")
        t0 = time.time()
        run_cli(["launch", "--num_processes", "1", "--tp", "1",
                 os.path.join(HERE, "chip_smoke.py"), TP_CHILD_FLAG, path],
                timeout=TP_SERVE["timeout"])
        wall_s = time.time() - t0
        with open(path) as f:
            child = json.load(f)
    same = sum(a == list(b) for a, b in zip(child["streams"], modes["plain"]))
    print(f"  (d) launch --num_processes 1 --tp 1 ({wall_s:.1f} s of wall time): world "
          f"{child['world']} over {child['backend']}; {same} of {len(modes['plain'])} streams "
          f"equal (a)'s")
    if child["backend"] != "nccl" or child["world"] != 1 or same != len(modes["plain"]):
        fail("phase 13 (d): the launched slice is not NCCL at world size 1, or its streams "
             "differ from (a)'s")
    seconds = time.time() - t_phase
    print(f"  phase 13 took {seconds:.1f} s")
    return dict(full=full, fleet=fleet, seconds=seconds)


# Phase 14: the model families of A9. Published widths; depth as listed.
FAMILIES = dict(
    seed=141, exact_layers=2, exact_len=256, exact_prompt=100, exact_new=16, exact_tol=2e-5,
    forward=(4, 2048), gpt2_forward=(8, 1024), prompt=512, new=32, opt_layers=16,
    train=(8, 1024), train_layers=2, warmup=3, iters=10, bert=(32, 128), resnet=(64, 224),
    nlp_acc=0.8, cv_acc=0.9, script_timeout=400)
#: family (its HF model type) -> (model module, config class, model class,
#: published-width config factory); the order phase 14 runs them in.
FAMILY_MODELS = {
    "gpt2": ("gpt2", "GPT2Config", "GPT2LMHeadModel", "xl"),
    "phi": ("phi", "PhiConfig", "PhiForCausalLM", "phi_2"),
    "gptj": ("gptj", "GPTJConfig", "GPTJForCausalLM", "gptj_6b"),
    "bloom": ("bloom", "BloomConfig", "BloomForCausalLM", None),
    "gpt_neox": ("gpt_neox", "GPTNeoXConfig", "GPTNeoXForCausalLM", "neox_20b"),
    "opt": ("opt", "OPTConfig", "OPTForCausalLM", "opt_30b"),
}
FAMILY_LABELS = {"gpt2": "GPT-2 XL", "phi": "Phi-2", "gptj": "GPT-J-6B", "bloom": "BLOOM-560m",
                 "gpt_neox": "GPT-NeoX-20B", "opt": "OPT-30B", "gemma2": "Gemma2-9B"}
FAMILY_PATH = ("model families at published widths (phase 14): full-width forwards (OPT-30B "
               "cut to 16 of 48 layers), the 2-layer GPT-J and Phi-2 train steps")


def family_config(name: str, **overrides):
    """The family's published-width config (BLOOM's defaults are
    BLOOM-560m); OPT-30B cut to ``FAMILIES["opt_layers"]`` layers unless
    ``num_hidden_layers`` is given."""
    import dataclasses
    import importlib

    module, cfg_cls, _, factory = FAMILY_MODELS[name]
    cls = getattr(importlib.import_module(f"accelerate_tpu_torch.models.{module}"), cfg_cls)
    cfg = getattr(cls, factory)() if factory else cls()
    if name == "opt":
        overrides.setdefault("num_hidden_layers", FAMILIES["opt_layers"])
    return dataclasses.replace(cfg, **overrides)


def family_shapes() -> dict:
    """Phase 14's attention shapes (B, S, H, G, D) of each flash family,
    causal bf16: its full-width forward ("forward": 4 x 2048, GPT-2 XL's
    8 x 1024) and its backward at 8 x 1024 ("backward": (d)'s train shape
    for GPT-J and Phi-2; GPT-2 XL's and OPT-30B's are timed beside them).
    BLOOM attends by its ALiBi einsum and has none."""
    shapes = {}
    for name in ("gpt2", "opt", "gptj", "gpt_neox", "phi"):
        cfg = family_config(name)
        H, D = cfg.num_attention_heads, cfg.head_dim
        heads = (H, getattr(cfg, "num_key_value_heads", H), D)
        forward = FAMILIES["gpt2_forward"] if name == "gpt2" else FAMILIES["forward"]
        shapes[name] = dict(forward=(*forward, *heads), backward=(*FAMILIES["train"], *heads))
    return shapes


def family_cases() -> list:
    """``family_shapes`` as cases of ``kernel_cases``, so that phases 2 and
    2b hold the families' kernels against the plain versions at the shapes
    the families run (a shape two families or kinds share, once)."""
    import torch

    cases, seen = [], set()
    for name, shapes in family_shapes().items():
        for kind, shape in shapes.items():
            if shape not in seen:
                seen.add(shape)
                cases.append((f"{FAMILY_LABELS[name]} {kind} shape", *shape, torch.bfloat16,
                              False, dict(causal=True)))
    return cases


def family_model(name: str, cfg, dtype, seed: int):
    """The family's model on the card, random weights from a seeded
    generator."""
    import importlib

    import torch

    module, _, model_cls, _ = FAMILY_MODELS[name]
    cls = getattr(importlib.import_module(f"accelerate_tpu_torch.models.{module}"), model_cls)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return cls(cfg, device="cuda", dtype=dtype, generator=gen)


def family_route(name: str, cfg, dtype, kernel: str = "forward") -> str:
    """The route ``kernel`` takes in the family's uncached forward or its
    backward ("none" for BLOOM, which attends by its ALiBi einsum)."""
    return "none" if name == "bloom" else route_of(kernel, dtype, cfg.head_dim)


def family_exactness(name: str, problems: list) -> dict:
    """(a) at f32 with 2 layers at the published widths: the logits on 1 x
    256 tokens through the flash kernels (the mma.sync route: f32) against
    the einsum path; cached greedy ``generate`` against the uncached argmax
    loop; a ``save_hf_checkpoint`` -> ``load_hf_checkpoint_and_dispatch``
    round trip on the card tier (for OPT the host tier too), its logits
    bit-identical to the resident model's; for the learned-position
    families, ``position_bound`` and the model refusing past the table."""
    import shutil
    import tempfile

    import torch

    from accelerate_tpu_torch import generate, load_hf_checkpoint_and_dispatch
    from accelerate_tpu_torch.utils.hf_interop import save_hf_checkpoint

    cfg = family_config(name, num_hidden_layers=FAMILIES["exact_layers"])
    model = family_model(name, cfg, torch.float32, FAMILIES["seed"])
    gen = torch.Generator(device="cuda").manual_seed(FAMILIES["seed"] + 1)
    ids = torch.randint(0, cfg.vocab_size, (1, FAMILIES["exact_len"]), generator=gen,
                        device="cuda")
    out = {}
    with torch.inference_mode():
        reset_counts()
        logits = model(ids)
        torch.cuda.synchronize()
        counts = read_counts()
        if name != "bloom":
            cfg.attention_backend = "einsum"
            try:
                ref = model(ids)
            finally:
                cfg.attention_backend = "auto"
            err = (logits - ref).abs().max().item()
            scale = max(ref.abs().max().item(), 1.0)
            ok = err <= FAMILIES["exact_tol"] * scale
            if counts["flash_fwd_mma"] != cfg.num_hidden_layers:
                problems.append(f"{name}: {counts} flash launches at f32, expected "
                                f"{cfg.num_hidden_layers} mma.sync")
            print(f"  [{'ok' if ok else 'FAIL'}] {name} (a) f32, 2 layers, 1 x "
                  f"{FAMILIES['exact_len']}: flash (mma.sync, {counts['flash_fwd_mma']} "
                  f"launches) vs einsum logits max|d| {err:.3e} (limit "
                  f"{FAMILIES['exact_tol']:g} x max(max|ref|, 1) = "
                  f"{FAMILIES['exact_tol'] * scale:.3e})")
            if not ok:
                problems.append(f"{name}: flash logits disagree with einsum ({err:.3e})")
            out["flash_vs_einsum"] = err
        elif any(counts.values()):
            problems.append(f"bloom launched a flash kernel: {counts}")
        prompt = ids[:, :FAMILIES["exact_prompt"]]
        cached = generate(model, prompt, FAMILIES["exact_new"], cache_dtype=torch.float32)
        loop = prompt
        for _ in range(FAMILIES["exact_new"]):
            loop = torch.cat([loop, model(loop)[:, -1].argmax(-1, keepdim=True)], dim=1)
        exact = torch.equal(cached, loop)
        print(f"  [{'ok' if exact else 'FAIL'}] {name} (a) cached greedy generate "
              f"({FAMILIES['exact_new']} new from {FAMILIES['exact_prompt']}) "
              f"{'equals' if exact else 'DIFFERS from'} the uncached argmax loop")
        if not exact:
            problems.append(f"{name}: cached generate differs from the uncached loop")
        directory = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
        try:
            t0 = time.perf_counter()
            save_hf_checkpoint(model, directory, cfg, name)
            tiers = [("card", {"": 0})] + ([("host", {"": "cpu"})] if name == "opt" else [])
            for tier, device_map in tiers:
                streamed, _ = load_hf_checkpoint_and_dispatch(directory, device_map=device_map)
                same = torch.equal(streamed(ids), logits)
                print(f"  [{'ok' if same else 'FAIL'}] {name} (a) save_hf_checkpoint -> "
                      f"load_hf_checkpoint_and_dispatch, {tier} tier: logits "
                      f"{'bit-identical to' if same else 'DIFFER from'} the resident model's")
                if not same:
                    problems.append(f"{name}: the {tier} tier's logits differ")
                if name in ("gpt2", "opt"):
                    table = cfg.max_position_embeddings
                    refused = []
                    for call in (lambda: streamed.generate(ids[:, :1].expand(1, table - 3),
                                                           max_new_tokens=4),
                                 lambda: model(ids[:, :1].expand(1, table + 1))):
                        try:
                            call()
                            refused.append(False)
                        except ValueError:
                            refused.append(True)
                    torch.cuda.synchronize()  # a device-side assert would surface here
                    ok = all(refused) and streamed.position_bound == table
                    print(f"  [{'ok' if ok else 'FAIL'}] {name} (a) position_bound "
                          f"{streamed.position_bound}: generate past it and a {table + 1}-token "
                          f"forward {'refused' if ok else 'NOT refused'} before the lookup")
                    if not ok:
                        problems.append(f"{name}: positions past the table were not refused")
                streamed.close()
                del streamed
            out["round_trip_s"] = time.perf_counter() - t0
        finally:
            shutil.rmtree(directory, ignore_errors=True)
    del model
    free_cuda()
    return out


def family_full_width(name: str, problems: list) -> dict:
    """(b) and (c): the family at its published widths (the depth of
    ``family_config``) in bf16, random weights from a seeded generator: a
    timed forward on 4 x 2048 tokens (GPT-2 XL 8 x 1024, its table's
    length) with its flash launches, then batch-1 cached decode from a
    512-token prompt."""
    import torch

    from accelerate_tpu_torch import generate

    cfg = family_config(name)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = family_model(name, cfg, torch.bfloat16, FAMILIES["seed"] + 2)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    B, S = FAMILIES["gpt2_forward"] if name == "gpt2" else FAMILIES["forward"]
    gen = torch.Generator(device="cuda").manual_seed(FAMILIES["seed"] + 3)
    ids = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    route = family_route(name, cfg, torch.bfloat16)
    with torch.inference_mode():
        model(ids)  # warm-up at the shape: library handles, the allocator
        torch.cuda.synchronize()
        reset_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        logits = model(ids)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        counts = read_counts()
        finite = bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (
            B, S, cfg.vocab_size)
        del logits
        peak = torch.cuda.max_memory_allocated() / 2**30
        layers = cfg.num_hidden_layers
        want = 0 if route == "none" else layers
        key = {"wgmma": "flash_fwd_sm90", "mma.sync": "flash_fwd_mma"}.get(route)
        launched_ok = counts["flash_fwd"] == want and (key is None or counts[key] == want)
        if not finite:
            problems.append(f"{name}: full-width logits non-finite or misshapen")
        if not launched_ok:
            problems.append(f"{name}: flash launches {counts} in one forward, expected {want} "
                            f"on {route}")
        prompt = ids[:1, :FAMILIES["prompt"]]
        generate(model, prompt[:, :128], 2)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens = generate(model, prompt, FAMILIES["new"])
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        again = generate(model, prompt, FAMILIES["new"])
        repeat_ok = torch.equal(tokens, again)
        if not repeat_ok:
            problems.append(f"{name}: a repeat generate gave other tokens")
    label = FAMILY_LABELS[name]
    print(f"  [{'ok' if finite and launched_ok and repeat_ok else 'FAIL'}] {name} (b) {label}, "
          f"{layers} layers ({n_params / 1e9:.3f} B params, built in {build_s:.1f} s), bf16, "
          f"{B} x {S}: {ms:.1f} ms, {B * S / ms * 1e3:.0f} tokens/s, peak {peak:.2f} GiB; route "
          f"{route}, head_dim {cfg.head_dim}, flash launches {counts['flash_fwd']} a forward "
          f"(expected {want}); (c) decode 1 x {FAMILIES['prompt']} + {FAMILIES['new']}: "
          f"{FAMILIES['new'] / decode_s:.2f} tokens/s ({decode_s * 1e3 / FAMILIES['new']:.1f} ms "
          f"a token incl. prefill), repeat {'identical' if repeat_ok else 'DIFFERS'}")
    del model
    free_cuda()
    return dict(ms=ms, tokens_per_s=B * S / ms * 1e3, peak_gib=peak, route=route, counts=counts,
                layers=layers, n_params=n_params, launches=counts["flash_fwd"],
                decode_tokens_per_s=FAMILIES["new"] / decode_s, shape=(B, S),
                head_dim=cfg.head_dim, heads=cfg.num_attention_heads, build_s=build_s)


def gemma2_full_width(problems: list) -> dict:
    """(b) Gemma2-9B (``LlamaConfig.gemma2_9b``: head_dim 256, softcap 50,
    ``query_pre_attn_scalar`` 256, a 4096 window on every other layer) at
    full depth, 42 layers in bf16 from a seeded generator: a timed forward
    on 4 x 2048 tokens (the window spans them, so every layer takes the
    causal kernel), its peak and 42 wgmma forward launches, finite logits.
    Then at 2 layers in bf16 on 1 x 1024 tokens, layer 0's window cut to
    512 so that the banded kernel runs: each layer's attention through the
    flash kernel against the einsum core on the same hidden states (phase
    12's way), relative L2 within 5e-2 (bf16 rounds the two orders of the
    sums apart)."""
    import torch

    from accelerate_tpu_torch import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.gemma2_9b()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(FAMILIES["seed"] + 6)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, generator=gen).eval()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    B, S = FAMILIES["forward"]
    ids = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    layers = cfg.num_hidden_layers
    with torch.inference_mode():
        model(ids)  # warm-up at the shape
        torch.cuda.synchronize()
        reset_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        logits = model(ids)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        counts = read_counts()
        finite = bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (
            B, S, cfg.vocab_size)
        del logits
    peak = torch.cuda.max_memory_allocated() / 2**30
    launched_ok = counts == expected_counts(layers, 0, wgmma=True)
    del model
    free_cuda()
    if not finite:
        problems.append("gemma2: full-width logits non-finite or misshapen")
    if not launched_ok:
        problems.append(f"gemma2: flash launches {counts} in one forward, expected {layers} on "
                        f"wgmma")

    small = LlamaConfig.gemma2_9b(num_hidden_layers=2, layer_windows=(512, None))
    model = LlamaForCausalLM(small, device="cuda", dtype=torch.bfloat16, generator=gen).eval()
    x_ids = ids[:1, :1024]
    positions = torch.arange(x_ids.shape[1], device="cuda")[None]
    rel = []
    with torch.inference_mode():
        h = model.model.embed_tokens(x_ids) * torch.tensor(small.hidden_size ** 0.5,
                                                           dtype=torch.bfloat16, device="cuda")
        reset_counts()
        for layer in model.model.layers:
            normed = layer.input_norm(h)
            flash_out = layer.self_attn(normed, positions).float()
            small.attention_backend = "einsum"
            try:
                einsum_out = layer.self_attn(normed, positions).float()
            finally:
                small.attention_backend = "auto"
            rel.append(((flash_out - einsum_out).norm() / einsum_out.norm()).item())
            h = layer(h, positions)
        small_counts = read_counts()
    del model
    free_cuda()
    # Each layer: one flash launch beside its einsum twin, one more in the
    # layer's own forward.
    exact_ok = max(rel) <= 5e-2 and small_counts == expected_counts(2 * 2, 0, wgmma=True)
    if not exact_ok:
        problems.append(f"gemma2: flash vs einsum attention relative L2 {rel} (limit 5e-2) or "
                        f"launches {small_counts}")
    print(f"  [{'ok' if finite and launched_ok and exact_ok else 'FAIL'}] gemma2 (b) Gemma2-9B, "
          f"{layers} layers ({n_params / 1e9:.3f} B params, built in {build_s:.1f} s), bf16, "
          f"{B} x {S}: {ms:.1f} ms, {B * S / ms * 1e3:.0f} tokens/s, peak {peak:.2f} GiB; route "
          f"wgmma, head_dim {cfg.head_dim}, softcap {cfg.attn_logit_softcapping:g}, flash "
          f"launches {counts['flash_fwd_sm90']} wgmma of {counts['flash_fwd']} a forward "
          f"(expected {layers}); 2 layers at 1 x 1024 (layer 0's window 512): flash vs einsum "
          f"attention relative L2 {', '.join(f'{r:.3e}' for r in rel)} (limit 5e-2), "
          f"launches {small_counts['flash_fwd_sm90']} wgmma")
    return dict(ms=ms, tokens_per_s=B * S / ms * 1e3, peak_gib=peak, route="wgmma",
                counts=counts, layers=layers, n_params=n_params, launches=counts["flash_fwd"],
                decode_tokens_per_s=None, shape=(B, S), head_dim=cfg.head_dim,
                heads=cfg.num_attention_heads, build_s=build_s, rel_flash_einsum=rel)


def family_train(name: str, problems: list) -> dict:
    """(d) 2 layers at the family's widths, 8 x 1024, bf16 over f32
    masters, fused AdamW, ``causal_lm_loss``, clip 1.0, through
    ``Accelerator.compile_train_step``: 3 + 10 steps, step k on seeded
    batch k % 4, the last 10 timed; 2 + 2 + 2 flash launches a step on the
    route. Falling: step 12's loss (batch 0 again) below step 0's."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import Accelerator, causal_lm_loss, make_global_batch
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state()
    GradientState._reset_state()
    acc = Accelerator(mixed_precision="bf16")
    cfg = family_config(name, num_hidden_layers=FAMILIES["train_layers"])
    model = family_model(name, cfg, torch.float32, FAMILIES["seed"] + 4)
    model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                                    weight_decay=1e-4, fused=True))
    step = acc.compile_train_step(causal_lm_loss(model), max_grad_norm=1.0)
    rng = np.random.default_rng(FAMILIES["seed"])
    B, S = FAMILIES["train"]
    batches = [make_global_batch({"input_ids": rng.integers(0, cfg.vocab_size, size=(B, S))},
                                 acc) for _ in range(4)]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    steps = FAMILIES["warmup"] + FAMILIES["iters"]
    losses = [step(batches[k % 4])["loss"] for k in range(FAMILIES["warmup"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(batches[k % 4])["loss"] for k in range(FAMILIES["warmup"], steps)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / FAMILIES["iters"]
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = torch.stack(losses).tolist()
    last_of_batch_0 = losses[(steps - 1) // 4 * 4]
    route = family_route(name, cfg, torch.bfloat16)
    dq_route = family_route(name, cfg, torch.bfloat16, "dq")
    layers = cfg.num_hidden_layers
    want = expected_counts(layers * steps, layers * steps, wgmma=route == "wgmma",
                           dq_wgmma=dq_route == "wgmma")
    ok = (counts == want and all(math.isfinite(x) for x in losses)
          and last_of_batch_0 < losses[0])
    print(f"  [{'ok' if ok else 'FAIL'}] {name} (d) {FAMILY_LABELS[name]} widths, {layers} "
          f"layers, {B} x {S}, bf16 over f32 masters: {step_ms:.2f} ms a step, peak "
          f"{peak:.2f} GiB, batch 0's loss {losses[0]:.4f} -> {last_of_batch_0:.4f} (step "
          f"{(steps - 1) // 4 * 4}), last {losses[-1]:.4f}; launches a step "
          f"fwd {counts['flash_fwd'] / steps:g} and dK/dV {counts['flash_bwd_dkdv'] / steps:g} "
          f"on {route}, dQ {counts['flash_bwd_dq'] / steps:g} on {dq_route}")
    if not ok:
        problems.append(f"{name}: train step launches {counts} (expected {want}) or batch "
                        f"0's loss {losses[0]} -> {last_of_batch_0} not finite and falling")
    del model, step, batches
    free_cuda()
    return dict(step_ms=step_ms, peak_gib=peak, losses=losses, counts=counts, steps=steps,
                route=route, dq_route=dq_route, layers=layers)


def timed_steps(step, batch) -> float:
    """ms a step of ``step(batch)`` over ``FAMILIES["iters"]`` steps after
    ``FAMILIES["warmup"]``."""
    import torch

    for _ in range(FAMILIES["warmup"]):
        step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FAMILIES["iters"]):
        loss = step(batch)["loss"]
    torch.cuda.synchronize()
    if not math.isfinite(loss.item()):
        fail("a non-finite loss in phase 14 (e)")
    return (time.perf_counter() - t0) * 1e3 / FAMILIES["iters"]


#: The port's example scripts phase 14 (e) runs, with their arguments, the
#: accuracy each prints and the threshold ``tests/test_examples.py:82-102``
#: holds the JAX examples to.
FAMILY_EXAMPLES = (
    ("examples/nlp_example_torch.py", ["--epochs", "5", "--batch_size", "16"],
     r"eval_acc (\d\.\d+)", FAMILIES["nlp_acc"], "nlp"),
    ("examples/cv_example_torch.py", ["--epochs", "1", "--batch_size", "16"],
     r" acc (\d\.\d+)", FAMILIES["cv_acc"], "cv"))


def start_script(path: str, args: list):
    """A repository script started as a subprocess in a session of its
    own; :func:`finish_script` collects it."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [HERE] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.Popen([sys.executable, os.path.join(HERE, path), *args], cwd=HERE,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    return proc, path, time.perf_counter()


def finish_script(started, timeout: int):
    """``(stdout, seconds)`` of a :func:`start_script` subprocess, killed
    whole on a timeout; a non-zero exit fails the phase."""
    proc, path, t0 = started
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, err = proc.communicate()
        fail(f"{path} timed out after {timeout} s:\n{out[-3000:]}\n{err[-3000:]}")
    if proc.returncode != 0:
        fail(f"{path} exited {proc.returncode}:\n{out[-3000:]}\n{err[-3000:]}")
    return out, time.perf_counter() - t0


def small_models(problems: list, scripts: list) -> dict:
    """(e) a ``compile_train_step`` step of BERT-base (32 x 128, bf16) and
    of ResNet-50 (64 x 224 x 224 x 3, channels-last, bf16, batch
    statistics), then the two port example scripts' runs on the card
    (``scripts``: their :func:`finish_script` results, in
    ``FAMILY_EXAMPLES``' order), held to the JAX examples' thresholds."""
    import re

    import numpy as np
    import torch

    from accelerate_tpu_torch import Accelerator, make_global_batch
    from accelerate_tpu_torch.models import (
        BertConfig,
        BertForSequenceClassification,
        ResNet,
        ResNetConfig,
        classification_loss,
    )
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    out = {}
    rng = np.random.default_rng(FAMILIES["seed"])
    for kind in ("bert", "resnet"):
        AcceleratorState._reset_state()
        GradientState._reset_state()
        acc = Accelerator(mixed_precision="bf16")
        gen = torch.Generator(device="cuda").manual_seed(FAMILIES["seed"] + 5)
        if kind == "bert":
            cfg = BertConfig.base()
            B, S = FAMILIES["bert"]
            model = BertForSequenceClassification(cfg, device="cuda", generator=gen)
            batch = {"input_ids": rng.integers(0, cfg.vocab_size, (B, S)),
                     "attention_mask": np.ones((B, S), np.int64),
                     "token_type_ids": np.zeros((B, S), np.int64),
                     "labels": rng.integers(0, 2, B)}
        else:
            B, side = FAMILIES["resnet"]
            model = ResNet(ResNetConfig.resnet50(), device="cuda", generator=gen)
            model = model.to(memory_format=torch.channels_last)
            batch = {"pixel_values": rng.normal(size=(B, side, side, 3)).astype(np.float32),
                     "labels": rng.integers(0, 1000, B)}
        model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                                        weight_decay=1e-4, fused=True))
        if kind == "bert":
            loss_fn = classification_loss(model)
        else:
            module = model.module

            def loss_fn(params, b):
                logits = torch.func.functional_call(module, params, (b["pixel_values"],),
                                                    {"train": True})
                logp = torch.log_softmax(logits.float(), -1)
                return -logp.gather(-1, b["labels"].long()[:, None]).mean()
        step = acc.compile_train_step(loss_fn, max_grad_norm=1.0)
        torch.cuda.reset_peak_memory_stats()
        ms = timed_steps(step, make_global_batch(batch, acc))
        peak = torch.cuda.max_memory_allocated() / 2**30
        what = "samples" if kind == "bert" else "images"
        print(f"  [ok] (e) {'BERT-base, 32 x 128' if kind == 'bert' else 'ResNet-50, 64 x 224^2 x 3, channels-last'}, "
              f"bf16 over f32 masters: {ms:.2f} ms a step, {B / ms * 1e3:.0f} {what}/s, peak "
              f"{peak:.2f} GiB")
        out[kind] = dict(step_ms=ms, per_s=B / ms * 1e3, peak_gib=peak)
        del model, step
        free_cuda()
    for (script, args, pattern, limit, label), (text, seconds) in zip(FAMILY_EXAMPLES, scripts):
        accs = [float(a) for a in re.findall(pattern, text)]
        ok = bool(accs) and max(accs) >= limit
        print(f"  [{'ok' if ok else 'FAIL'}] (e) {script} {' '.join(args)} on the card: "
              f"accuracies {accs} (threshold {limit}), {seconds:.1f} s from its start (it ran "
              f"beside (a))")
        if not ok:
            problems.append(f"{script} did not reach {limit}: {accs}")
        out[label] = dict(accs=accs, seconds=seconds)
    return out


def family_kernel_timings() -> dict:
    """Each flash family's kernels at its ``family_shapes``, every route
    forced, held to the tolerances and timed in turns by phase 2's
    ``forward_timings`` and ``backward_timings``: the forward, dK/dV and dQ
    on both routes (wgmma and mma.sync, the old route forced so its time
    stays beside the new one), beside the plain version, SDPA and the bound
    at the real head_dim."""
    import torch

    out = {}
    for name, shapes in family_shapes().items():
        D = shapes["forward"][-1]
        fwd = forward_timings(*shapes["forward"], seed=150)
        bwd = backward_timings(*shapes["backward"], seed=160)
        out[name] = dict(route=route_of("forward", torch.bfloat16, D), forward=fwd, backward=bwd)
        fms, ms, err = fwd["ms"], bwd["ms"], bwd["err"]
        dq = " ".join(f"{k[3:]} {v:.4f} ms ({100 * bwd['dq_bound'][0] / v:.1f} %)"
                      for k, v in ms.items() if k.startswith("dq "))
        print(f"  {name} kernels, forward at {shape_text(shapes['forward'])}: wgmma "
              f"{fms['wgmma']:.4f} ms, mma.sync {fms['mma.sync']:.4f} ms "
              f"({fms['mma.sync'] / fms['wgmma']:.2f}x; bound {fwd['bound_ms']:.4f} ms, "
              f"{fwd['bound_by']}, wgmma at {100 * fwd['bound_ms'] / fms['wgmma']:.1f} %, "
              f"mma.sync at {100 * fwd['bound_ms'] / fms['mma.sync']:.1f} %), plain "
              f"{fwd['plain_ms']:.3f} ms, SDPA {fwd['library_ms']:.4f} ms, max|dout| wgmma "
              f"{fwd['err']['wgmma']:.3e}, mma.sync {fwd['err']['mma.sync']:.3e}; backward at "
              f"{shape_text(shapes['backward'])}: dK/dV wgmma {ms['wgmma']:.4f} ms, mma.sync "
              f"{ms['mma.sync']:.4f} ms ({ms['mma.sync'] / ms['wgmma']:.2f}x; bound "
              f"{bwd['dkdv_bound'][0]:.4f} ms, wgmma at "
              f"{100 * bwd['dkdv_bound'][0] / ms['wgmma']:.1f} %, mma.sync at "
              f"{100 * bwd['dkdv_bound'][0] / ms['mma.sync']:.1f} %), dQ {dq} (bound "
              f"{bwd['dq_bound'][0]:.4f}), plain {bwd['plain_ms']:.3f} ms, SDPA backward "
              f"({bwd['backend']}) {bwd['library_ms']:.4f} ms, max|dk,dv| wgmma "
              f"{err['wgmma']:.3e}, mma.sync {err['mma.sync']:.3e}, max|dq| wgmma "
              f"{err['dq wgmma']:.3e}, mma.sync {err['dq mma.sync']:.3e}")
        pair = ms["wgmma"] + ms["dq wgmma"]
        print(f"  {name} dK/dV + dQ (wgmma): {ms['wgmma']:.4f} + {ms['dq wgmma']:.4f} = "
              f"{pair:.4f} ms against SDPA's whole backward {bwd['library_ms']:.4f} ms: "
              f"{pair / bwd['library_ms']:.2f}x its time")
        free_cuda()
    return out


def phase_families() -> dict:
    """Phase 14: the model families of A9 at their published widths (see
    the module docstring). Returns the numbers and the flash launches of
    (b)-(d), which the kernels' line carries."""
    t_phase = time.perf_counter()
    problems = []
    # (e)'s example scripts run on the card beside (a)'s untimed exactness
    # checks, and are collected after it, before any timed part starts.
    scripts = [start_script(path, args) for path, args, *_ in FAMILY_EXAMPLES]
    print("  (a) exactness at f32, 2 layers at the published widths")
    exact = {name: family_exactness(name, problems) for name in FAMILY_MODELS}
    scripts = [finish_script(started, FAMILIES["script_timeout"]) for started in scripts]
    print(f"  (b, c) full-width forwards and batch-1 decode, bf16 (t = "
          f"{time.perf_counter() - t_phase:.1f} s)")
    full = {name: family_full_width(name, problems) for name in FAMILY_MODELS}
    full["gemma2"] = gemma2_full_width(problems)
    print(f"  (d) 2-layer train steps (t = {time.perf_counter() - t_phase:.1f} s)")
    train = {name: family_train(name, problems) for name in ("gptj", "phi")}
    # The launches of (b)'s timed forwards and (d)'s steps, by kernel.
    counts = {key: sum(r["counts"][key] for r in (*full.values(), *train.values()))
              for key in read_counts()}
    print(f"  (e) BERT-base, ResNet-50 and the port's example scripts (t = "
          f"{time.perf_counter() - t_phase:.1f} s)")
    small = small_models(problems, scripts)
    print(f"  the kernels at the families' shapes (t = {time.perf_counter() - t_phase:.1f} s)")
    timings = family_kernel_timings()
    seconds = time.perf_counter() - t_phase
    print(f"  phase 14: {seconds:.1f} s")
    if problems:
        fail("phase 14: " + "; ".join(problems))
    return dict(exact=exact, full=full, train=train, small=small, timings=timings,
                counts=counts, seconds=seconds)


# Phase 15: T5 (T0pp widths) and ViT-B/16, with seq2seq_generate and staged
# streaming. Their attention is the einsum core: no flash kernel runs.
SEQ2SEQ = dict(
    seed=151, exact_layers=2, exact_sources=(3, 130, 512), exact_new=16, stream_sources=(130, 512),
    forward=(4, 512, 128), generate=(4, 512, 32), stream_layers=6, stream_new=8,
    train=(8, 512, 128), train_layers=2, warmup=3, iters=10, vit_batch=64)
SEQ2SEQ_PATH = ("T5 at T0pp widths and ViT-B/16 (phase 15): einsum attention with a relative "
                "bias (T5) or none (ViT); no flash kernel")


def t5_model(layers: int, dtype, seed: int, **overrides):
    """T0pp's widths (``T5Config.t0pp``) at ``layers`` + ``layers`` layers on
    the card, random weights from a seeded generator, dropout off unless
    asked for."""
    import torch

    from accelerate_tpu_torch import T5Config, T5ForConditionalGeneration

    cfg = T5Config.t0pp(num_layers=layers, **{"dropout_rate": 0.0, **overrides})
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return T5ForConditionalGeneration(cfg, device="cuda", dtype=dtype, generator=gen)


def hf_round_trip(model, family: str, problems: list, config=None) -> tuple:
    """convert(export(state)) and export again: every tensor bit-identical,
    the key sets equal. Returns ``(the number of HF tensors, same)``."""
    import torch

    from accelerate_tpu_torch.utils.hf_interop import convert_hf_state_dict, export_hf_state_dict

    state = model.state_dict()
    hf = export_hf_state_dict(state, family, config=config)
    back = convert_hf_state_dict(hf, family, strict=True)
    again = export_hf_state_dict(back, family, config=config)
    same = (set(back) == set(state) and set(again) == set(hf)
            and all(torch.equal(back[k], v) for k, v in state.items())
            and all(torch.equal(again[k], v) for k, v in hf.items()))
    if not same:
        problems.append(f"(a) the {family} HF round trip is not bit-identical")
    return len(hf), same


def seq2seq_exactness(problems: list) -> dict:
    """(a) at f32 on T0pp's widths with 2 + 2 layers: cached
    ``seq2seq_generate`` against the uncached loop (a teacher-forced forward
    and an argmax a step, on the same padded source) for batch 2 with one
    padded row and sources of 3, 130 and 512 tokens; ``generate`` routing
    to it; ``StreamedModel.seq2seq_generate`` on the pinned-host tier
    against the resident tokens; the bucket table on the card against the
    CPU's; the T5 and ViT-B/16 HF round trips bit-identical."""
    import torch

    from accelerate_tpu_torch import (
        ViTConfig,
        ViTForImageClassification,
        cpu_offload,
        generate,
        seq2seq_generate,
    )
    from accelerate_tpu_torch.generation import _padded_source
    from accelerate_tpu_torch.models.t5 import relative_position_bucket

    S2 = SEQ2SEQ
    model = t5_model(S2["exact_layers"], torch.float32, S2["seed"])
    cfg, new = model.config, S2["exact_new"]
    gen = torch.Generator(device="cuda").manual_seed(S2["seed"] + 1)
    out, resident = {}, {}
    for S in S2["exact_sources"]:
        src = torch.randint(0, cfg.vocab_size, (2, S), generator=gen, device="cuda")
        mask = torch.ones_like(src)
        mask[1, max(1, S // 2):] = 0  # row 1 padded
        t0 = time.perf_counter()
        cached = seq2seq_generate(model, src, new, attention_mask=mask, cache_dtype=torch.float32)
        torch.cuda.synchronize()
        cached_s = time.perf_counter() - t0
        ids, pad_mask = _padded_source(src, mask)
        dec = cached[:, :1]
        with torch.inference_mode():
            for _ in range(new):
                logits = model(ids, dec, pad_mask)
                dec = torch.cat([dec, logits[:, -1].argmax(-1, keepdim=True).to(dec.dtype)], 1)
        same = torch.equal(cached, dec)
        resident[S] = (src, mask, cached)
        print(f"  [{'ok' if same else 'FAIL'}] (a) source {S} (bucket {ids.shape[1]}), batch 2, "
              f"row 1 padded after {max(1, S // 2)}: cached seq2seq_generate {tuple(cached.shape)} "
              f"{'equals' if same else 'DIFFERS FROM'} the uncached loop ({cached_s:.2f} s)")
        if not same:
            problems.append(f"(a) cached and uncached decoding differ at source {S}")
        out[S] = same
    src = resident[130][0]
    routed = generate(model, src, new, cache_dtype=torch.float32)
    direct = seq2seq_generate(model, src, new, cache_dtype=torch.float32)
    ok = routed.shape == (2, 1 + new) and torch.equal(routed, direct)
    print(f"  [{'ok' if ok else 'FAIL'}] (a) generate() hands T5 to seq2seq_generate: "
          f"{tuple(routed.shape)} decoder ids, equal")
    if not ok:
        problems.append("(a) generate() did not route T5 to seq2seq_generate")

    # The pinned-host tier: every block streamed, the encoder once.
    t0 = time.perf_counter()
    streamed = cpu_offload(model, execution_device="cuda")
    pin_s = time.perf_counter() - t0
    for S in S2["stream_sources"]:
        src, mask, cached = resident[S]
        t0 = time.perf_counter()
        got = streamed.seq2seq_generate(src, new, attention_mask=mask, cache_dtype=torch.float32)
        torch.cuda.synchronize()
        same = torch.equal(got, cached)
        print(f"  [{'ok' if same else 'FAIL'}] (a) StreamedModel.seq2seq_generate on the pinned-"
              f"host tier, source {S}: {'equals' if same else 'DIFFERS FROM'} the resident model "
              f"({time.perf_counter() - t0:.2f} s; pinned in {pin_s:.1f} s)")
        if not same:
            problems.append(f"(a) streamed decoding differs from the resident model at {S}")
    streamed.close()
    del streamed

    # The bucket table on the card against the CPU's.
    rel = torch.arange(-4096, 4097)
    tables = [(bi, relative_position_bucket(rel.cuda(), bi, 32, 128).cpu(),
               relative_position_bucket(rel, bi, 32, 128)) for bi in (True, False)]
    ok = all(torch.equal(card, cpu) for _, card, cpu in tables)
    print(f"  [{'ok' if ok else 'FAIL'}] (a) relative_position_bucket on the card equals the "
          "CPU's for -4096..4096 at (32, 128), bidirectional and causal")
    if not ok:
        problems.append("(a) the bucket table on the card differs from the CPU's")
    n_t5, same_t5 = hf_round_trip(model, "t5", problems)
    del model, routed, direct, resident
    free_cuda()
    vcfg = ViTConfig.base()
    vit = ViTForImageClassification(vcfg, device="cuda",
                                    generator=torch.Generator(device="cuda").manual_seed(1))
    n_vit, same_vit = hf_round_trip(vit, "vit", problems, config=vcfg)
    print(f"  [{'ok' if same_t5 and same_vit else 'FAIL'}] (a) HF round trips (export, "
          f"convert, export): T5 {n_t5} tensors (wi_0/wi_1), ViT-B/16 {n_vit} (the conv kernel "
          "[768, 3, 16, 16]), bit-identical")
    del vit
    free_cuda()
    return out


def t5_full_depth(problems: list) -> dict:
    """(b) T0pp at 24 + 24 layers in bf16: a teacher-forced forward (ms,
    tokens/s, peak) and batch-4 ``seq2seq_generate`` (tokens/s, ms a
    token, a repeat identical), each profiled once."""
    import torch

    from accelerate_tpu_torch import seq2seq_generate

    S2 = SEQ2SEQ
    t0 = time.perf_counter()
    model = t5_model(24, torch.bfloat16, S2["seed"] + 2)
    torch.cuda.synchronize()
    cfg = model.config
    params = sum(p.numel() for p in model.parameters())
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"  (b) T0pp, 24 + 24 layers, {params / 1e9:.3f} B parameters, {weights / 1e9:.2f} GB "
          f"in bf16, built in {time.perf_counter() - t0:.1f} s ({card_line()})")
    gen = torch.Generator(device="cuda").manual_seed(S2["seed"] + 3)
    B, S, T = S2["forward"]
    src = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    tgt = torch.randint(0, cfg.vocab_size, (B, T), generator=gen, device="cuda")
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        fwd_ms = timed_ms(lambda: model(src, tgt), iters=5)
        peak = torch.cuda.max_memory_allocated() / 2**30
        logits = model(src, tgt)
        finite = bool(torch.isfinite(logits).all())
        fwd_profile = device_breakdown(f"T0pp forward {B} x ({S} + {T})", lambda: model(src, tgt))
    tokens = B * (S + T)
    ok = finite and logits.shape == (B, T, cfg.vocab_size)
    print(f"  [{'ok' if ok else 'FAIL'}] (b) forward {B} x {S} source + {B} x {T} target tokens: "
          f"{fwd_ms:.2f} ms, {tokens / fwd_ms * 1e3:.0f} tokens/s, peak {peak:.2f} GiB, "
          f"logits finite")
    if not ok:
        problems.append("(b) T0pp's forward gave non-finite logits or a wrong shape")
    del logits
    B, S, new = S2["generate"]
    src = src[:B, :S]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = seq2seq_generate(model, src, new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    again = seq2seq_generate(model, src, new)
    same = torch.equal(first, again)
    dec_profile = device_breakdown(f"T0pp seq2seq_generate batch {B}, {new} new",
                                   lambda: seq2seq_generate(model, src, new))
    ok = same and first.shape == (B, 1 + new) and int(first.max()) < cfg.vocab_size
    print(f"  [{'ok' if ok else 'FAIL'}] (b) seq2seq_generate batch {B}, {S}-token sources, "
          f"{new} new (bf16 cache): {gen_s * 1e3:.1f} ms, {B * new / gen_s:.1f} tokens/s, "
          f"{gen_s * 1e3 / new:.2f} ms a token (the encoder's pass included); a repeat call "
          f"{'identical' if same else 'DIFFERS'}")
    if not ok:
        problems.append("(b) T0pp's seq2seq_generate is not repeatable or out of range")
    del model
    free_cuda()
    return dict(params=params, weights_gb=weights / 1e9, forward_ms=fwd_ms,
                forward_tokens_per_s=tokens / fwd_ms * 1e3, forward_peak_gib=peak,
                generate_tokens_per_s=B * new / gen_s, generate_ms_per_token=gen_s * 1e3 / new,
                forward_profile=fwd_profile, generate_profile=dec_profile)


def t5_streamed(problems: list) -> dict:
    """(c) T0pp's widths cut to 6 + 6 layers, streamed from pinned host
    memory: one forward's ms and 8 cached tokens' ms a token, the peak card
    memory held to phase 4f's bound (2 x the largest block + the resident
    forward's activation peak, +10 % + 64 MiB)."""
    import torch

    from accelerate_tpu_torch import cpu_offload

    S2 = SEQ2SEQ
    model = t5_model(S2["stream_layers"], torch.bfloat16, S2["seed"] + 4)
    cfg = model.config
    gen = torch.Generator(device="cuda").manual_seed(S2["seed"] + 5)
    B, S, T = S2["forward"]
    src = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    tgt = torch.randint(0, cfg.vocab_size, (B, T), generator=gen, device="cuda")
    with torch.inference_mode():
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ref = model(src, tgt)
        torch.cuda.synchronize()
        allowance = int((torch.cuda.max_memory_allocated() - before) * 1.1) + (64 << 20)
    t0 = time.perf_counter()
    streamed = cpu_offload(model, execution_device="cuda")
    pin_s = time.perf_counter() - t0
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    del model
    free_cuda()
    block = streamed_block_bytes(streamed)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    passes = timed_passes(streamed)
    torch.cuda.reset_peak_memory_stats()
    streamed(src, tgt)  # warm
    t0 = time.perf_counter()
    got = streamed(src, tgt)
    fwd_ms = (passes[-1] - t0) * 1e3
    err = (got.float() - ref.float()).abs().max().item()
    del passes[:]
    tokens = streamed.seq2seq_generate(src, S2["stream_new"])
    # passes: the encoder, then one a token.
    ms_token = (passes[-1] - passes[0]) * 1e3 / (len(passes) - 1)
    peak = torch.cuda.max_memory_allocated() - base
    bound = 2 * block + allowance
    ok = (peak <= bound and tokens.shape == (B, 1 + S2["stream_new"])
          and bool(torch.isfinite(got).all()))
    print(f"  [{'ok' if ok else 'FAIL'}] (c) T0pp widths, {cfg.num_layers} + {cfg.num_layers} "
          f"layers ({weights / 1e9:.2f} GB), all in pinned host memory (pinned in {pin_s:.1f} s): "
          f"forward {B} x ({S} + {T}) {fwd_ms:.1f} ms ({weights / fwd_ms / 1e6:.1f} GB/s "
          f"streamed), max |streamed - resident| {err:.3g}; cached decode batch {B}, "
          f"{S2['stream_new']} new: {ms_token:.1f} ms a token; peak {peak / 2**30:.2f} GiB above "
          f"the baseline against 2 x block {block / 2**30:.3f} + allowance "
          f"{allowance / 2**30:.2f} = {bound / 2**30:.2f} GiB")
    if not ok:
        problems.append(f"(c) the streamed T5's peak {peak} exceeds {bound}, or its output is "
                        "wrong")
    streamed.close()
    del streamed, got, ref
    free_cuda()
    return dict(layers=cfg.num_layers, weights_gb=weights / 1e9, forward_ms=fwd_ms,
                ms_per_token=ms_token, peak_gib=peak / 2**30, bound_gib=bound / 2**30,
                max_abs_err=err)


def t5_train(problems: list) -> dict:
    """(d) 2 + 2 layers at T0pp's widths, 8 x 512 sources and 8 x 128
    targets, bf16 over f32 masters, fused AdamW, clip 1.0,
    ``compile_train_step(seq2seq_lm_loss(model))``, dropout 0.1 from the
    accelerator's generator: 3 + 10 steps on seeded batch k % 4, step ms and
    peak; finite losses, batch 0's falling."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import Accelerator, make_global_batch, seq2seq_lm_loss
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    S2 = SEQ2SEQ
    AcceleratorState._reset_state()
    GradientState._reset_state()
    acc = Accelerator(mixed_precision="bf16")
    model = t5_model(S2["train_layers"], torch.float32, S2["seed"] + 6, dropout_rate=0.1)
    cfg = model.config
    model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                                    weight_decay=1e-4, fused=True))
    step = acc.compile_train_step(seq2seq_lm_loss(model), max_grad_norm=1.0)
    rng = np.random.default_rng(S2["seed"])
    B, S, T = S2["train"]
    batches = [make_global_batch({"input_ids": rng.integers(0, cfg.vocab_size, (B, S)),
                                  "labels": rng.integers(0, cfg.vocab_size, (B, T))}, acc)
               for _ in range(4)]
    steps = S2["warmup"] + S2["iters"]
    torch.cuda.reset_peak_memory_stats()
    losses = [step(batches[k % 4])["loss"] for k in range(S2["warmup"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(batches[k % 4])["loss"] for k in range(S2["warmup"], steps)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / S2["iters"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = torch.stack(losses).tolist()
    last0 = losses[(steps - 1) // 4 * 4]
    ok = all(math.isfinite(x) for x in losses) and last0 < losses[0]
    print(f"  [{'ok' if ok else 'FAIL'}] (d) T0pp widths, {cfg.num_layers} + {cfg.num_layers} "
          f"layers, {B} x {S} sources + {B} x {T} targets, bf16 over f32 masters, dropout 0.1: "
          f"{step_ms:.2f} ms a step, {B * (S + T) / step_ms * 1e3:.0f} tokens/s, peak "
          f"{peak:.2f} GiB; batch 0's loss {losses[0]:.4f} -> {last0:.4f} (step "
          f"{(steps - 1) // 4 * 4}), last {losses[-1]:.4f}")
    if not ok:
        problems.append(f"(d) T5's losses are not finite or batch 0's did not fall: {losses}")
    del model, step, batches
    free_cuda()
    return dict(step_ms=step_ms, peak_gib=peak, losses=losses)


def vit_base(problems: list) -> dict:
    """(e) ViT-B/16: a bf16 forward on 64 x 224^2 (ms, images/s), and a
    bf16-over-f32-masters ``compile_train_step`` step on 64 images (ms,
    images/s, peak)."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import (
        Accelerator,
        ViTConfig,
        ViTForImageClassification,
        make_global_batch,
    )
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    S2 = SEQ2SEQ
    cfg, B = ViTConfig.base(), S2["vit_batch"]
    gen = torch.Generator(device="cuda").manual_seed(S2["seed"] + 7)
    model = ViTForImageClassification(cfg, device="cuda", dtype=torch.bfloat16, generator=gen)
    x = torch.randn((B, cfg.image_size, cfg.image_size, cfg.num_channels), generator=gen,
                    device="cuda")
    with torch.inference_mode():
        fwd_ms = timed_ms(lambda: model(x), iters=10)
        finite = bool(torch.isfinite(model(x)).all())
    del model
    AcceleratorState._reset_state()
    GradientState._reset_state()
    acc = Accelerator(mixed_precision="bf16")
    model = ViTForImageClassification(cfg, device="cuda", generator=gen)
    model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                                    weight_decay=1e-4, fused=True))
    module = model.module

    def loss_fn(params, b, generator=None):
        logits = torch.func.functional_call(module, params, (b["pixel_values"],),
                                            {"generator": generator})
        logp = torch.log_softmax(logits.float(), -1)
        return -logp.gather(-1, b["labels"].long()[:, None]).mean()

    step = acc.compile_train_step(loss_fn, max_grad_norm=1.0)
    rng = np.random.default_rng(S2["seed"])
    batch = make_global_batch({"pixel_values": rng.normal(size=tuple(x.shape)).astype(np.float32),
                               "labels": rng.integers(0, cfg.num_labels, B)}, acc)
    torch.cuda.reset_peak_memory_stats()
    step_ms = timed_steps(step, batch)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  [{'ok' if finite else 'FAIL'}] (e) ViT-B/16, {B} x 224^2: bf16 forward "
          f"{fwd_ms:.2f} ms, {B / fwd_ms * 1e3:.0f} images/s; train step (bf16 over f32 masters, "
          f"fused AdamW, clip 1.0) {step_ms:.2f} ms, {B / step_ms * 1e3:.0f} images/s, peak "
          f"{peak:.2f} GiB")
    if not finite:
        problems.append("(e) ViT-B/16's forward gave non-finite logits")
    del model, step, batch
    free_cuda()
    return dict(forward_ms=fwd_ms, forward_images_per_s=B / fwd_ms * 1e3, step_ms=step_ms,
                step_images_per_s=B / step_ms * 1e3, peak_gib=peak)


def phase_seq2seq_vision() -> dict:
    """Phase 15: T5 at T0pp's widths and ViT-B/16 (see the module
    docstring). No flash kernel may launch: both attend by the einsum
    core. Returns the numbers and the launches (all 0)."""
    t_phase = time.perf_counter()
    problems = []
    reset_counts()
    print("  (a) exactness at f32, TF32 off, T0pp widths, 2 + 2 layers")
    exact = seq2seq_exactness(problems)
    print(f"  (b) T0pp at full depth, bf16 (t = {time.perf_counter() - t_phase:.1f} s)")
    full = t5_full_depth(problems)
    print(f"  (c) T5 streamed from pinned host memory (t = {time.perf_counter() - t_phase:.1f} s)")
    streamed = t5_streamed(problems)
    print(f"  (d) T5 train steps (t = {time.perf_counter() - t_phase:.1f} s)")
    train = t5_train(problems)
    print(f"  (e) ViT-B/16 (t = {time.perf_counter() - t_phase:.1f} s)")
    vit = vit_base(problems)
    counts = read_counts()
    if any(counts.values()):
        problems.append(f"a flash kernel launched: {counts}")
    seconds = time.perf_counter() - t_phase
    print(f"  phase 15: {seconds:.1f} s, flash launches {sum(counts.values())}")
    if problems:
        fail("phase 15: " + "; ".join(problems))
    return dict(exact=exact, full=full, streamed=streamed, train=train, vit=vit, counts=counts,
                seconds=seconds)


# ---------------------------------------------------------------------------
# Phase 16: the fp8 training path, estimate-memory, native host IO
# ---------------------------------------------------------------------------

#: The tier-1 projections' [in, out] kernels against x [8192, 2048] (q/o,
#: k/v, gate/up, down), both recipes whose products _scaled_mm runs.
FP8_SHAPES = ((2048, 2048), (2048, 1024), (2048, 5632), (5632, 2048))
FP8_TOKENS = 8 * 1024
#: Against the widened product (the same fp8 values, exact products, f32
#: accumulation) both outputs differ only by the order of the f32 sums and
#: the final rounding to bf16: at most 2 bf16 ulps of the largest output.
FP8_TOLERANCE = 2 ** -6
#: benchmarks/fp8.py:25: the final loss within 12 % of bf16's.
FP8_REL_TOL = 0.12
FP8_PATH = ("tier-1 fp8 train steps (phase 16): delayed-scaling e4m3/e5m2 projections, "
            "bf16 elsewhere")


def fp8_gemm_checks(problems: list) -> dict:
    """(a): every projection shape of the tier-1 step, forward, dx and dW,
    through ``_scaled_mm`` against the widened product, under HYBRID and
    E4M3, on the operands as ``Fp8Dense`` lays them out (the kernel a
    transposed view of the ``[out, in]`` weight); a repeat bit-identical;
    times as the model calls each product (with the fp8 transposes it
    makes) and of the product alone on operands laid out beforehand,
    beside a bf16 ``torch.matmul`` of the same shape (a yardstick). Then
    the E5M2 route (widened on the card) against the same product on the
    CPU."""
    import torch

    from accelerate_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(161)
    out, worst = {}, 0.0
    for recipe in ("HYBRID", "E4M3"):
        fwd, bwd = quant.FP8_FORMATS[recipe]
        for K, N in FP8_SHAPES:
            x = torch.randn((FP8_TOKENS, K), generator=gen, device="cuda").bfloat16()
            w = (torch.randn((N, K), generator=gen, device="cuda") * K ** -0.5).bfloat16().t()
            dy = (torch.randn((FP8_TOKENS, N), generator=gen, device="cuda") * 1e-4).bfloat16()

            def scale(t, dtype):
                return (quant._amax(t) / torch.finfo(dtype).max).reshape(())

            sx, sw, sg = scale(x, fwd), scale(w, fwd), scale(dy, bwd)
            qx, qw = quant._quantize(x, sx, fwd), quant._quantize(w, sw, fwd)
            qdy = quant._quantize(dy, sg, bwd)
            gemms = {"forward": (qx, qw, sx, sw), "dx": (qdy, qw.t(), sg, sw),
                     "dW": (qx.t(), qdy, sx, sg)}
            for what, (a, b, sa, sb) in gemms.items():
                before = quant.fp8_gemm.scaled_mm_launches
                got = quant.fp8_gemm(a, b, sa, sb, torch.bfloat16)
                again = quant.fp8_gemm(a, b, sa, sb, torch.bfloat16)
                if quant.fp8_gemm.scaled_mm_launches != before + 2:
                    problems.append(f"{recipe} {what} [{K}, {N}] did not run _scaled_mm")
                plain = quant._widened(a, b, sa * sb, torch.bfloat16)
                err = (got.float() - plain.float()).abs().max().item()
                rel = err / plain.float().abs().max().item()
                worst = max(worst, rel)
                if not torch.equal(got, again):
                    problems.append(f"{recipe} {what} [{K}, {N}]: a repeat launch differs")
                if not rel <= FP8_TOLERANCE:
                    problems.append(f"{recipe} {what} [{K}, {N}]: {rel:.3e} of the largest "
                                    f"output from the widened product (limit {FP8_TOLERANCE:.3e})")
                da, db = a.to(torch.bfloat16) * sa, b.to(torch.bfloat16) * sb
                ms = timed_ms(lambda: quant.fp8_gemm(a, b, sa, sb, torch.bfloat16), 20)
                a_laid, b_laid = a.contiguous(), quant._col_major(b)
                gemm_ms = timed_ms(lambda: quant.fp8_gemm(a_laid, b_laid, sa, sb,
                                                          torch.bfloat16), 20)
                plain_ms = timed_ms(lambda: quant._widened(a, b, sa * sb, torch.bfloat16), 5)
                bf16_ms = timed_ms(lambda: torch.matmul(da, db), 20)
                M_, K_, N_ = a.shape[0], a.shape[1], b.shape[1]
                flops = 2.0 * M_ * K_ * N_
                nbytes = M_ * K_ + K_ * N_ + 2 * M_ * N_
                bound = max(flops / 1979e12, nbytes / PEAK_BYTES) * 1e3
                out[f"{recipe} {what} [{M_}, {K_}] x [{K_}, {N_}]"] = dict(
                    rel_err=rel, ms=ms, gemm_ms=gemm_ms, plain_ms=plain_ms,
                    bf16_matmul_ms=bf16_ms, bound_ms=bound, tflops=flops / gemm_ms / 1e9)
                print(f"    {recipe:6s} {what:7s} [{M_}, {K_}] x [{K_}, {N_}]: {ms:.4f} ms as "
                      f"the model calls it, {gemm_ms:.4f} ms the product alone "
                      f"({flops / gemm_ms / 1e9:.0f} TFLOP/s; bound {bound:.4f} ms at 1979 "
                      f"TFLOP/s fp8), widened {plain_ms:.3f} ms, bf16 matmul {bf16_ms:.4f} ms; "
                      f"max abs err {err:.3e} = {rel:.2e} of the largest output")
    # E5M2 x E5M2: sm_90 has no such product, so the card widens.
    x = torch.randn((FP8_TOKENS, 2048), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((2048, 1024), generator=gen, device="cuda") * 2048 ** -0.5).bfloat16()
    sx = (quant._amax(x) / 57344.0).reshape(())
    sw = (quant._amax(w) / 57344.0).reshape(())
    qx, qw = quant._quantize(x, sx, quant.E5M2), quant._quantize(w, sw, quant.E5M2)
    before = quant.fp8_gemm.widened_launches
    got = quant.fp8_gemm(qx, qw, sx, sw, torch.bfloat16)
    if quant.fp8_gemm.widened_launches != before + 1:
        problems.append("the E5M2 product did not take the widened route")
    cpu = quant.fp8_gemm(qx.cpu(), qw.cpu(), sx.cpu(), sw.cpu(), torch.bfloat16)
    e5_err = (got.cpu().float() - cpu.float()).abs().max().item() / cpu.float().abs().max().item()
    e5_ms = timed_ms(lambda: quant.fp8_gemm(qx, qw, sx, sw, torch.bfloat16), 10)
    if not e5_err <= FP8_TOLERANCE:
        problems.append(f"E5M2 on the card vs the CPU: {e5_err:.3e}")
    print(f"    E5M2 x E5M2 (widened on the card) [8192, 2048] x [2048, 1024]: {e5_ms:.4f} ms, "
          f"{e5_err:.2e} of the largest output from the CPU's product")
    print(f"    worst _scaled_mm error {worst:.3e} of the largest output "
          f"(limit {FP8_TOLERANCE:.3e}, use_fast_accum=False)")
    return dict(gemms=out, worst=worst, e5m2=dict(ms=e5_ms, rel_err=e5_err))


def fp8_train(bf16: dict, problems: list) -> dict:
    """(b): the tier-1 step with fp8 projections at full width, phase 6's
    weights and data, the data read by a ``TokenBinDataLoader`` from a token
    file this phase writes."""
    import tempfile

    import numpy as np
    import torch

    from accelerate_tpu_torch import make_global_batch
    from accelerate_tpu_torch.bench import build_train_step, mfu_fields
    from accelerate_tpu_torch.native.io import TokenBinDataLoader
    from accelerate_tpu_torch.ops import quant
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state()  # the bf16 accelerators before: another precision
    GradientState._reset_state()
    cfg, model, step, batches = build_train_step(mixed_precision="fp8", use_fp8=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tokens.bin")
        rng = np.random.default_rng(0)  # phase 6's batches, in its order
        rows = [rng.integers(0, cfg.vocab_size, size=(8, 1024)) for _ in range(4)]
        np.concatenate(rows).astype(np.int32).tofile(path)
        loader = TokenBinDataLoader(path, seq_len=1024, batch_size=8, shuffle=False)
        data = [make_global_batch(b, next(model.module.parameters()).device) for b in loader]
    if len(data) != 4 or not all(torch.equal(d["input_ids"], b["input_ids"])
                                 for d, b in zip(data, batches)):
        problems.append("the token file's batches are not phase 6's")
    # Slot 0 of each history after step 1 against the amax it recorded.
    recorded = {}
    real_commit = quant.commit_fp8_meta

    def commit(m):
        if not recorded:
            recorded.update({name: mod.amax_pending.clone()
                             for name, mod in m.named_modules()
                             if isinstance(mod, quant.Fp8Dense)})
        real_commit(m)

    quant.commit_fp8_meta = commit
    reset_counts()
    gemms0 = (quant.fp8_gemm.launches, quant.fp8_gemm.scaled_mm_launches)
    torch.cuda.reset_peak_memory_stats()
    losses = []
    # Phase 6's order (run_bench): warm-up steps on batches 0, 1, 2, then
    # the timed ones from batch 0 again.
    order = [0, 1, 2] + [i % 4 for i in range(20)]
    try:
        losses.append(step(data[order[0]])["loss"])
        fp8_modules = {n: m for n, m in model.module.named_modules()
                       if isinstance(m, quant.Fp8Dense)}
        # Step 1 quantizes dy with the initial grad scale 1: below e5m2's
        # smallest subnormal (2**-16) it flushes to 0, so a projection whose
        # dy comes through another's dx (q/k/v, gate/up) records a 0 amax,
        # and the rule keeps its grad scale (TE's). Every other scale moves.
        held = 0
        for name, mod in fp8_modules.items():
            for i, (hist, scale) in enumerate(zip(quant._META_HISTS, quant._META_SCALES)):
                amax = recorded[name][..., i]
                if not torch.equal(getattr(mod, hist)[..., 0], amax):
                    problems.append(f"{name}.{hist}[..., 0] is not the amax step 1 recorded")
                moved = getattr(mod, scale) != 1
                if not torch.equal(moved, amax > 0):
                    problems.append(f"{name}.{scale}: moved {moved.tolist()} after step 1, "
                                    f"amaxes {amax.tolist()}")
                held += int((~moved).sum())
        for i in range(1, 3):
            losses.append(step(data[order[i]])["loss"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(3, 23):
            metrics = step(data[order[i]])
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 20
    finally:
        quant.commit_fp8_meta = real_commit
    still = [f"{n}.{scale}" for n, m in fp8_modules.items() for scale in quant._META_SCALES
             if bool((getattr(m, scale) == 1).any())]
    if still:
        problems.append(f"scales still 1 after {len(losses)} steps: {still}")
    counts = read_counts()
    steps = len(losses)
    gemms = ((quant.fp8_gemm.launches - gemms0[0]) / steps,
             (quant.fp8_gemm.scaled_mm_launches - gemms0[1]) / steps)
    losses = torch.stack(losses).tolist()
    n_params = sum(p.numel() for p in model.parameters())
    tokens_per_s = 8 * 1024 / dt
    flops = mfu_fields(tokens_per_s, cfg, 1024, n_params)
    peak = torch.cuda.max_memory_allocated() / 2**30
    rel_gap = abs(losses[-1] - bf16["loss"]) / abs(bf16["loss"])
    print(f"  (b) tier-1 fp8 step ({len(fp8_modules)} stacked Fp8Dense x {cfg.num_hidden_layers} "
          f"layers, history {cfg.fp8_amax_history_len}, HYBRID): step {dt * 1e3:.2f} ms (bf16 "
          f"step of phase 6: {bf16['step_ms']:.2f} ms), {tokens_per_s:.0f} tokens/s, MFU "
          f"{flops['mfu']:.4f} (phase 6's formula), peak {peak:.2f} GiB (bf16 "
          f"{bf16['peak_gib']:.2f} GiB)")
    print(f"      fp8 GEMMs a step {gemms[0]:g} ({gemms[1]:g} on _scaled_mm; expected "
          f"{7 * cfg.num_hidden_layers * 3}), flash launches in {steps} steps {counts}")
    print(f"      after step 1: every history's slot 0 is the amax it recorded; {held} of "
          f"{len(fp8_modules) * 3 * cfg.num_hidden_layers} scales held at 1 (a dy flushed to 0 "
          f"at grad scale 1), none after step {steps}")
    print(f"      loss step 1 {losses[0]:.5f} -> step {steps} {losses[-1]:.5f} (bf16 "
          f"{bf16['loss']:.5f}, relative gap {rel_gap:.4f}, limit {FP8_REL_TOL}); mean of the "
          f"first 4 {sum(losses[:4]) / 4:.5f}, of the last 4 {sum(losses[-4:]) / 4:.5f}")
    expected = expected_counts(cfg.num_hidden_layers * steps, cfg.num_hidden_layers * steps,
                               wgmma=True)
    if counts != expected:
        problems.append(f"flash launches {counts} in {steps} fp8 steps, expected {expected}")
    if gemms != (7 * cfg.num_hidden_layers * 3, 7 * cfg.num_hidden_layers * 3):
        problems.append(f"fp8 GEMMs a step {gemms}, expected 210 on _scaled_mm")
    if not all(math.isfinite(x) for x in losses):
        problems.append("an fp8 step gave a non-finite loss")
    if not sum(losses[-4:]) < sum(losses[:4]):
        problems.append("the fp8 loss did not fall")
    if not rel_gap < FP8_REL_TOL:
        problems.append(f"fp8 final loss {losses[-1]:.5f} vs bf16 {bf16['loss']:.5f}")
    del model, step
    free_cuda()
    return dict(step_ms=dt * 1e3, tokens_per_s=tokens_per_s, mfu=flops["mfu"], peak_gib=peak,
                losses=losses, bf16_loss=bf16["loss"], bf16_step_ms=bf16["step_ms"],
                rel_gap=rel_gap, gemms_per_step=gemms[0], counts=counts, steps=steps)


def estimate_check(numel_8b: int, problems: list) -> dict:
    """(c): ``estimate-memory llama3-8b``'s parameter count is the numel of
    phase 3's Llama-3-8B."""
    import contextlib
    import io

    from accelerate_tpu_torch.commands import estimate
    from accelerate_tpu_torch.utils.modeling import named_parameters

    model = estimate._on_meta(estimate._model_registry()["llama3-8b"])
    counted = sum(t.numel() for t in named_parameters(model).values())
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = estimate.estimate_command(estimate.estimate_command_parser().parse_args(
            ["llama3-8b", "--dtypes", "bfloat16"]))
    head = text.getvalue().splitlines()[0]
    print(f"  (c) estimate-memory llama3-8b: {counted} parameters (phase 3's model: {numel_8b}); "
          f"'{head}'")
    if rc != 0 or counted != numel_8b or f"({numel_8b / 1e9:.2f} B params)" not in head:
        problems.append(f"estimate-memory counts {counted}, phase 3's model {numel_8b}")
    return dict(params=counted, phase3_params=numel_8b)


def native_io(problems: list) -> dict:
    """(d): the native library builds here, and ``load_safetensors_model``
    of a 1.07 GB checkpoint written here is bit-identical to
    ``SafetensorsFile``'s read, at 1 and 8 threads (the page cache warm:
    the file was just written)."""
    import tempfile

    import torch

    from accelerate_tpu_torch import native
    from accelerate_tpu_torch.checkpointing import (
        SafetensorsFile,
        load_safetensors_model,
        save_safetensors,
    )

    if not native.available():
        problems.append("the native library did not build on this machine")
        return {}
    gen = torch.Generator().manual_seed(163)
    tensors = {f"layer.{i}.weight": torch.randn((4096, 4096), generator=gen).bfloat16()
               for i in range(32)}
    nbytes = sum(t.numel() * t.element_size() for t in tensors.values())
    out = {"gb": nbytes / 1e9}
    with tempfile.TemporaryDirectory() as tmp:
        save_safetensors(tensors, os.path.join(tmp, "model.safetensors"))
        reference = SafetensorsFile(os.path.join(tmp, "model.safetensors"))
        t0 = time.perf_counter()
        plain = {name: reference.read(name) for name in reference.keys()}
        out["safetensors_file_gbs"] = nbytes / (time.perf_counter() - t0) / 1e9
        for threads in (1, 8):
            t0 = time.perf_counter()
            loaded = load_safetensors_model(tmp, threads=threads)
            out[f"threads_{threads}_gbs"] = nbytes / (time.perf_counter() - t0) / 1e9
            flat = {f"layer.{i}.weight": loaded["layer"][str(i)]["weight"] for i in range(32)}
            if not all(torch.equal(flat[n], plain[n]) for n in plain):
                problems.append(f"load_safetensors_model(threads={threads}) differs")
    print(f"  (d) native host IO: available; {out['gb']:.2f} GB checkpoint (warm page cache): "
          f"load_safetensors_model {out['threads_1_gbs']:.2f} GB/s at 1 thread, "
          f"{out['threads_8_gbs']:.2f} GB/s at 8; SafetensorsFile.read {out['safetensors_file_gbs']:.2f} "
          "GB/s; bit-identical")
    return out


def phase_fp8(bf16: dict, numel_8b: int) -> dict:
    """Phase 16 (see the module docstring). ``bf16``: phase 6's final loss,
    step ms and peak; ``numel_8b``: phase 3's parameter count."""
    t_phase = time.perf_counter()
    problems = []
    print("  (a) the fp8 GEMM: _scaled_mm against the widened product")
    gemm = fp8_gemm_checks(problems)
    train = fp8_train(bf16, problems)
    estimated = estimate_check(numel_8b, problems)
    host = native_io(problems)
    seconds = time.perf_counter() - t_phase
    print(f"  phase 16: {seconds:.1f} s")
    if problems:
        fail("phase 16: " + "; ".join(problems))
    return dict(gemm=gemm, train=train, estimate=estimated, native=host, seconds=seconds,
                counts=train["counts"])


def main_fp8():
    """Phase 16 alone: builds the kernels, runs phase 6's bf16 steps for its
    reference loss, and counts Llama-3-8B's parameters on the meta device
    (phase 3's model is built only by the whole run)."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_environment()
    from accelerate_tpu_torch import LlamaConfig, LlamaForCausalLM
    from accelerate_tpu_torch.bench import run_bench
    from accelerate_tpu_torch.big_modeling import init_empty_weights

    with init_empty_weights():
        numel_8b = sum(p.numel() for p in LlamaForCausalLM(LlamaConfig.llama3_8b()).parameters())
    result = run_bench()
    free_cuda()
    out = phase_fp8(phase6_reference(result), numel_8b)
    print(json.dumps({"fp8": {k: out[k] for k in ("gemm", "estimate", "native", "seconds")}
                      | {"train": {k: v for k, v in out["train"].items() if k != "losses"}}}))


def phase6_reference(result: dict) -> dict:
    """What phase 16 compares with from phase 6's run."""
    extra = result["extra"]
    return dict(loss=extra["losses"][-1], step_ms=extra["step_ms"],
                peak_gib=extra["peak_memory_gib"])


def stage(title: str, t0: float = time.perf_counter()):
    """A phase's header line, with the seconds since the script started."""
    print(f"{title} (t = {time.perf_counter() - t0:.0f} s)", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    try:
        import accelerate_tpu_torch
    except ImportError as exc:
        fail(f"accelerate_tpu_torch is not beside chip_smoke.py: {exc}")
    if not os.path.abspath(accelerate_tpu_torch.__file__).startswith(HERE + os.sep):
        fail(f"accelerate_tpu_torch imported from {accelerate_tpu_torch.__file__}, not from {HERE}")
    # The plain versions compare in full f32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    stage("== 1. environment and build")
    phase_environment()
    stage("== 2. flash_fwd vs flash_fwd_reference")
    forward = phase_kernels()
    stage("== 2b. flash_bwd vs flash_bwd_reference")
    backward = phase_backward()
    stage("== 3. Llama-3-8B forward")
    model, policy, gen = build_model()
    numel_8b = sum(p.numel() for p in model.parameters())  # for phase 16 (c)
    launches_8b = phase_forward(model, policy, gen)
    stage("== 4. generate")
    reset_counts()
    phase_generate(model, gen)
    if any(read_counts().values()):
        fail("the cached generate path launched a flash kernel; its attention is the einsum core")
    stage("== 4b. speculative and beam-search decoding")
    reset_counts()
    phase_speculative(model, gen)
    if any(read_counts().values()):
        fail("a speculative or beam-search decoder launched a flash kernel; its attention is "
             "the einsum core")
    stage("== 4c. the serving engine")
    reset_counts()
    phase_serving(model)
    serving_counts = read_counts()
    if any(serving_counts.values()):
        fail("the serving engine launched a flash kernel; its attention is the einsum core")
    stage("== 4d. speculative, quantized and multi-tenant serving")
    reset_counts()
    phase_serving_extras(model)
    extras_counts = read_counts()
    if any(extras_counts.values()):
        fail("4d launched a flash kernel; the serving path's attention is the einsum core")
    stage("== 4e. the serving fleet: router, supervisor, chaos, HTTP gateway, loadgen")
    reset_counts()
    phase_fleet(model)
    fleet_counts = read_counts()
    if any(fleet_counts.values()):
        fail("4e launched a flash kernel; the serving path's attention is the einsum core")
    stage("== 4f. big-model inference: device maps, host and disk tiers, streamed forward")
    reset_counts()
    phase_big_model(model, gen)
    big_model_counts = read_counts()
    stage("== 13. tensor-parallel serving slices at tp 1: exactness, full depth, HTTP fleet, "
          "launched")
    reset_counts()
    phase_tp_serving(model)
    tp_serving_counts = read_counts()
    if any(tp_serving_counts.values()):
        fail("phase 13 launched a flash kernel; the serving path's attention is the einsum core")
    stage("== 5. where the device time goes")
    phase_profile(model, gen)
    layers_8b = model.config.num_hidden_layers
    del model, gen
    free_cuda()
    stage("== 6. train (tier-1 llama, bf16 over f32 masters)")
    result, counts, check_counts = phase_train()
    stage("== 7. where the device time of a train step goes")
    phase_train_profile()
    stage("== 8. the training loop: packed sequences, dots remat, save/load, resume")
    loop_counts, loop_microbatches = phase_loop()
    free_cuda()
    stage("== 9. several processes: env, test, collectives and the launched trainer over NCCL")
    mp = phase_multiprocess(result)
    free_cuda()
    stage("== 10. sharded training state: FSDP launched over NCCL, optimizer offload")
    sharded = phase_sharded(result)
    free_cuda()
    stage("== 11. device meshes: tp/pp plugins, ring, ulysses, HYBRID_SHARD; pipelined inference")
    mesh = phase_mesh(result)
    free_cuda()
    stage("== 12. Mixture-of-Experts at Mixtral-8x7B widths: forward, generate, --ep 1 trainer")
    moe = phase_moe()
    free_cuda()
    stage("== 14. the model families: GPT-2 XL, Phi-2, GPT-J-6B, BLOOM-560m, GPT-NeoX-20B, "
          "OPT-30B; BERT-base, ResNet-50, the port's examples")
    families = phase_families()
    free_cuda()
    stage("== 15. T5 at T0pp widths and ViT-B/16: seq2seq_generate, staged streaming, training")
    seq2seq = phase_seq2seq_vision()
    free_cuda()
    stage("== 16. the fp8 training path, estimate-memory, native host IO")
    fp8 = phase_fp8(phase6_reference(result), numel_8b)

    steps = result["extra"]["steps"]
    kernels = kernel_lines(forward, backward, counts, check_counts, steps, launches_8b, layers_8b)
    for entry in kernels:
        # read_counts names the mma.sync kernels by route ("flash_fwd_mma");
        # its "flash_fwd" is both routes' total.
        key = entry["name"] if entry["name"].endswith("_sm90") else entry["name"] + "_mma"
        entry["serving_launches"] = serving_counts[key]
        entry["serving_extras_launches"] = extras_counts[key]
        entry["serving_fleet_launches"] = fleet_counts[key]
        entry["big_model_launches"] = big_model_counts[key]
        entry["tp_serving_launches"] = tp_serving_counts[key]
        if entry["name"].endswith("_sm90"):
            entry["loop_launches"] = loop_counts[entry["name"]]
            entry["loop_launches_per_microbatch"] = loop_counts[entry["name"]] / loop_microbatches
            entry["loop_path"] = LOOP_PATH
        entry["multiprocess_launches"] = mp["counts"][key]
        entry["multiprocess_launches_per_step"] = mp["counts"][key] / len(mp["losses"])
        entry["sharded_launches"] = sharded["counts"][key]
        entry["sharded_launches_per_step"] = sharded["counts"][key] / sharded["steps"]
        entry["mesh_launches"] = mesh["counts"][key]
        entry["mesh_launches_per_step"] = mesh["train_counts"][key] / mesh["steps"]
        entry["moe_launches"] = moe["counts"][key]
        entry["moe_launches_per_step"] = moe["train_counts"][key] / moe["steps"]
        entry["moe_path"] = MOE_PATH
        add_family_entries(entry, key, families)
        entry["seq2seq_vision_launches"] = seq2seq["counts"][key]
        entry["seq2seq_vision_path"] = SEQ2SEQ_PATH
        entry["fp8_launches"] = fp8["counts"][key]
        entry["fp8_launches_per_step"] = fp8["counts"][key] / fp8["train"]["steps"]
        entry["fp8_path"] = FP8_PATH
    print(json.dumps({"fp8_gemm": {"route": "torch._scaled_mm (cuBLASLt), E5M2 x E5M2 widened",
                                   "replaces": "accelerate_tpu/ops/quant.py:98 and :116 (XLA "
                                               "dot_general, no Pallas kernel)",
                                   "launches_per_step": fp8["train"]["gemms_per_step"],
                                   "worst_rel_err": fp8["gemm"]["worst"],
                                   "gemms": fp8["gemm"]["gemms"]}}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def main_families():
    """Phase 14 alone. Builds the kernels first, and checks the cases of
    phases 2 and 2b at D=80, 96 and 256 and at the families' shapes: the
    families' forwards and train steps run the flash kernels."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_environment()
    family_labels = {case[0] for case in family_cases()}
    for i, (label, B, S, H, G, D, dtype, segments, kw) in enumerate(kernel_cases()):
        if D in (80, 96, 256) or label in family_labels:
            q, k, v, seg = make_inputs(B, S, H, G, D, dtype, seed=100 + i, segments=segments)
            check_forward(label, q, k, v, seg, kw)
            check_backward(label, q, k, v, seg, kw, seed=400 + i)
    families = phase_families()
    print(json.dumps({"families": {
        "full": {n: {k: f[k] for k in ("ms", "tokens_per_s", "peak_gib", "route", "launches",
                                       "decode_tokens_per_s", "layers")}
                 for n, f in families["full"].items()},
        "train": {n: {k: t[k] for k in ("step_ms", "peak_gib", "route")}
                  for n, t in families["train"].items()},
        "small": families["small"], "timings": families["timings"],
        "counts": families["counts"], "seconds": families["seconds"]}}))


def main_seq2seq_vision():
    """Phase 15 alone (no kernel is built: T5 and ViT attend by the einsum
    core, and the phase holds that no flash kernel launches)."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    out = phase_seq2seq_vision()
    print(json.dumps({"seq2seq_vision": {k: out[k] for k in ("full", "streamed", "vit",
                                                             "counts", "seconds")}
                      | {"train": {k: out["train"][k] for k in ("step_ms", "peak_gib")}}}))


def main_tp_serving():
    """Phase 13 alone (no kernel is built: the serving path runs none). 4c's
    numbers, which (b) prints beside its own, come only from a whole run."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    model, _, _ = build_model()
    reset_counts()
    result = phase_tp_serving(model)
    if any(read_counts().values()):
        fail("phase 13 launched a flash kernel")
    print(json.dumps({"tp_serving": result}))


def main_speculative():
    """Phase 4b alone (no kernel is built: the cached path runs none)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line())
    model, _, gen = build_model()
    reset_counts()
    phase_speculative(model, gen)
    if any(read_counts().values()):
        fail("a speculative or beam-search decoder launched a flash kernel")


def main_serving():
    """Phase 4c alone (no kernel is built: the serving path runs none)."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    model, _, _ = build_model()
    reset_counts()
    phase_serving(model)
    if any(read_counts().values()):
        fail("the serving engine launched a flash kernel")


def main_serving_extras():
    """Phase 4d alone (no kernel is built: the serving path runs none)."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    model, _, _ = build_model()
    reset_counts()
    phase_serving_extras(model)
    if any(read_counts().values()):
        fail("4d launched a flash kernel")


def main_fleet():
    """Phase 4e alone (no kernel is built: the serving path runs none)."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    model, _, _ = build_model()
    reset_counts()
    phase_fleet(model)
    if any(read_counts().values()):
        fail("4e launched a flash kernel")


def main_big_model():
    """Phase 4f alone. Builds the kernels first: its streamed forwards
    launch the flash forward."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_environment()
    model, _, gen = build_model()
    reset_counts()
    phase_big_model(model, gen)
    print(f"  flash launches in 4f: {read_counts()}")


def main_multiprocess():
    """Phase 9 alone. Builds the kernels first: the launched trainer runs
    the flash kernels; its reference steps run here."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_environment()
    mp = phase_multiprocess()
    print(json.dumps({"multiprocess": {k: mp[k] for k in (
        "step_ms", "no_sync_step_ms", "reference_step_ms", "reduction_ms", "buckets", "startup_s",
        "init_process_group_s", "reduce_calls")}}))


def main_sharded():
    """Phase 10 alone. Builds the kernels first: the sharded steps run the
    flash kernels; their reference steps run here."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_environment()
    sharded = phase_sharded()
    child, offload = sharded["child"], sharded["offload"]
    print(json.dumps({"sharded": {
        **{mode: {k: child[mode][k] for k in ("step_ms", "peak_memory_gib", "gathers")}
           for mode in SHARDED_MODES},
        "offload": {k: offload[k] for k in ("step_ms", "peak_memory_gib", "moment_bytes",
                                            "h2d_gbs", "d2h_gbs", "plain_h2d_gbs",
                                            "plain_d2h_gbs", "state_kinds")},
        **{k: sharded[k] for k in ("reference_step_ms", "reference_peak_gib", "counts")}}}))


def main_mesh():
    """Phase 11 alone. Builds the kernels first: the mesh modes run the
    flash kernels; their reference steps and phase 3's forward run here."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_environment()
    mesh = phase_mesh()
    print(json.dumps({"mesh": {
        **{name: {k: mesh["child"][name][k] for k in ("step_ms", "peak_memory_gib", "gathers")}
           for name in MESH_MODES},
        "infer": {k: mesh["infer"][k] for k in ("ms", "phase3_ms", "rel_l2", "top1_agreement",
                                                "peak_memory_gib")},
        "seconds": mesh["seconds"], "reference_step_ms": mesh["reference_step_ms"],
        "counts": mesh["counts"]}}))


def main_moe():
    """Phase 12 alone. Builds the kernels first: the Mixtral forwards and
    train steps run the flash kernels."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_environment()
    moe = phase_moe()
    train = moe["train"]
    print(json.dumps({"moe": {
        "forward": {k: moe["forward"][k] for k in ("ms", "peak_gib", "drops")},
        "decode": moe["decode"],
        "train": {k: train["here"][k] for k in ("step_ms", "peak_memory_gib", "load_balance_loss",
                                                "router_z_loss")},
        "launched_step_ms": train["child"]["step_ms"],
        "mesh_train": {k: moe["mesh_train"]["child"][k] for k in ("step_ms", "peak_memory_gib")}
        | {"seconds": moe["mesh_train"]["seconds"]},
        "streamed": {k: moe["streamed"][k] for k in ("ms", "rel_l2", "equal", "load_s")},
        "counts": moe["counts"],
        "seconds": moe["seconds"]}}))


def add_family_entries(entry: dict, key: str, families: dict):
    """Phase 14 on one kernel's entry: its launches in the families'
    timed full-width forwards and train steps, and, for each family at whose
    shape this kernel was timed, its timing there (``main_path``'s keys)
    with the family's own launches."""
    entry["families_launches"] = families["counts"][key]
    entry["families_path"] = FAMILY_PATH
    route = "wgmma" if entry["name"].endswith("_sm90") else "mma.sync"
    kind = ("forward" if entry["name"].startswith("flash_fwd") else
            "dq" if "_dq" in entry["name"] else "dkdv")
    rows = []
    for name, shapes in family_shapes().items():
        timing = families["timings"][name]
        t = timing["forward" if kind == "forward" else "backward"]
        ms_key = f"dq {route}" if kind == "dq" else route
        if ms_key not in t["ms"]:
            continue
        bound_ms, bound_by = ((t["bound_ms"], t["bound_by"]) if kind == "forward"
                              else t[f"{kind}_bound"])
        ran = families["full"] if kind == "forward" else families["train"]
        rows.append(dict(family=FAMILY_LABELS[name],
                         shape=shape_text(shapes["forward" if kind == "forward" else "backward"]),
                         ms=t["ms"][ms_key], plain_ms=t["plain_ms"], bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=t["library_ms"],
                         max_abs_err=t["err"][ms_key],
                         launches=ran[name]["counts"][key] if name in ran else 0))
    entry["families"] = rows


TRAIN_PATH = "tier-1 train steps (phase 6)"
LOOP_PATH = ("tier-1 training loop (phase 8): packed 1024-token rows with segment_ids, "
             "dots remat, accumulation 2")
CHECK_PATH = "f32 gradient check through the model (phase 6): tier-1 widths, 2 layers, 1 x 256"


def kernel_lines(forward, backward, counts, check_counts, steps, launches_8b, layers_8b):
    """The kernels' JSON entries, both routes. Times and errors at the
    training shape (``main_path``: at the Llama-3-8B shape) from phases 2
    and 2b; launches from the path each kernel runs on: the wgmma kernels
    from the train steps, the mma.sync ones from the f32 gradient check
    (16-bit inputs at head_dim 128 never reach them)."""
    csrc = "accelerate_tpu_torch/ops/csrc/"
    pallas = "accelerate_tpu/ops/flash_pallas.py"
    kernels = []

    def add(name, design, source, replaces, timings, ms_key, bound_key, library, launches,
            path):
        t, m = timings["train"], timings["main"]
        bound = (t["bound_ms"], t["bound_by"]) if bound_key is None else t[bound_key]
        main_bound = (m["bound_ms"], m["bound_by"]) if bound_key is None else m[bound_key]
        kernels.append(dict(
            name=name, route="cuda", design=design, source=csrc + source, replaces=replaces,
            launches=launches, path=path, shape=shape_text(TRAIN), max_abs_err=t["err"][ms_key],
            ms=t["ms"][ms_key], plain_ms=t["plain_ms"], bound_ms=bound[0], bound_by=bound[1],
            library_ms=t["library_ms"], library=library,
            main_path=dict(shape=shape_text(MAIN), max_abs_err=m["err"][ms_key],
                           ms=m["ms"][ms_key], plain_ms=m["plain_ms"], bound_ms=main_bound[0],
                           bound_by=main_bound[1], library_ms=m["library_ms"])))

    sdpa_bwd = f"SDPA backward ({backward['train']['backend']}), all three grads"
    add("flash_fwd_sm90", "wgmma", "flash_fwd_sm90.cu", f"{pallas}:92", forward, "wgmma", None,
        "SDPA forward", counts["flash_fwd_sm90"], TRAIN_PATH)
    kernels[-1]["launches_per_step"] = counts["flash_fwd_sm90"] / steps
    kernels[-1]["main_path"].update(launches=launches_8b, launches_per_forward=layers_8b)
    add("flash_fwd", "mma.sync", "flash_fwd.cu", f"{pallas}:92", forward, "mma.sync", None,
        "SDPA forward", check_counts["flash_fwd_mma"], CHECK_PATH)
    add("flash_bwd_dkdv_sm90", "wgmma", "flash_bwd_dkdv_sm90.cu", f"{pallas}:227", backward,
        "wgmma", "dkdv_bound", sdpa_bwd, counts["flash_bwd_dkdv_sm90"], TRAIN_PATH)
    kernels[-1]["launches_per_step"] = counts["flash_bwd_dkdv_sm90"] / steps
    add("flash_bwd_dkdv", "mma.sync", "flash_bwd.cu", f"{pallas}:227", backward, "mma.sync",
        "dkdv_bound", sdpa_bwd, check_counts["flash_bwd_dkdv_mma"], CHECK_PATH)
    add("flash_bwd_dq_sm90", "wgmma", "flash_bwd_dq_sm90.cu", f"{pallas}:305", backward,
        "dq wgmma", "dq_bound", sdpa_bwd, counts["flash_bwd_dq_sm90"], TRAIN_PATH)
    kernels[-1]["launches_per_step"] = counts["flash_bwd_dq_sm90"] / steps
    add("flash_bwd_dq", "mma.sync", "flash_bwd.cu", f"{pallas}:305", backward, "dq mma.sync",
        "dq_bound", sdpa_bwd, check_counts["flash_bwd_dq_mma"], CHECK_PATH)
    for entry in kernels:
        if entry["library"].startswith("SDPA backward"):
            entry["plain"] = "flash_bwd_reference, all three grads"
    return kernels


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == MP_CHILD_FLAG:
        multiprocess_child(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == SHARDED_CHILD_FLAG:
        sharded_child(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == MESH_CHILD_FLAG:
        mesh_child(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == MOE_CHILD_FLAG:
        moe_child(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == MOE_MESH_CHILD_FLAG:
        moe_child(sys.argv[2], mesh_plugins=True)
    elif len(sys.argv) == 3 and sys.argv[1] == TP_CHILD_FLAG:
        tp_serving_child(sys.argv[2])
    else:
        main()
