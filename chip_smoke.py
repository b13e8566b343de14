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
   with sm_scale, GQA rep 1/4/8, head_dim 64/128/256, fp16, fp32, ragged
   lengths such as S=1000 and B=3 x S=200) against ``flash_fwd_reference``
   on the same inputs, under the tolerances of ``TOLERANCE``, printing each
   case's route (``wgmma`` for 16-bit inputs at head_dim 64/128, else
   ``mma.sync``); a repeat launch must be bit-identical. Then, at the
   training and the main-path shapes, both routes of the forward, its plain
   version and ``F.scaled_dot_product_attention`` (the yardstick, never used
   by the port) timed beside the bound.
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
5. profile: device time of one forward and of decode steps, by kernel kind
   (torch.profiler), and the device's busy share of the wall time.

2b (after 2). backward kernels vs plain version: ``flash_bwd`` (the dK/dV
   and the dQ kernel of the case's route, counted) on phase 2's case matrix
   against ``flash_bwd_reference`` on the same inputs under
   ``BWD_TOLERANCE``; a repeat launch must give bit-identical gradients. At
   the training and the main-path shapes: the dK/dV and the dQ kernel of
   each route (the two routes of each in turns), the plain backward and the
   SDPA backward (the yardstick) timed beside the bounds.
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

Prints the kernels' JSON line and the card's line, and as its last line
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
        report = [ln.strip() for ln in lines if "registers" in ln or "spill" in ln]
        for line in report:
            print(f"  {name}: {line}")


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
        ("D=96 (padded to 128)", 1, 256, 4, 2, 96, bf16, False, {}),
        ("fp16", 2, 512, 8, 2, 128, f16, False, {}),
        ("fp16 D=256 window", 1, 512, 4, 2, 256, f16, False, dict(sliding_window=200)),
        ("fp32", 2, 256, 4, 2, 128, f32, False, {}),
        ("fp32 D=256 softcap window segments", 1, 256, 4, 2, 256, f32, True,
         dict(logit_softcap=30.0, sliding_window=100)),
        ("fp32 non-causal D=64", 1, 256, 4, 1, 64, f32, False, dict(causal=False)),
        ("ragged S=200 non-causal", 1, 200, 4, 2, 64, bf16, False, dict(causal=False)),
        ("ragged S=200 causal fp32", 1, 200, 4, 2, 128, f32, False, {}),
        ("S=1000 causal (not a multiple of 128)", 1, 1000, 4, 2, 128, bf16, False, {}),
        ("B=3 S=200 causal (rows past S beside the next batch's)", 3, 200, 4, 2, 128, bf16, False,
         {}),
        ("gqa rep 8 + window 100 + segments, D=64", 2, 512, 8, 1, 64, bf16, True,
         dict(sliding_window=100)),
        ("fp16 softcap 20 + sm_scale 0.1, D=128", 1, 512, 4, 2, 128, f16, False,
         dict(logit_softcap=20.0, sm_scale=0.1)),
    ]


def route_of(dtype, D) -> str:
    """The kernel route a forward or backward call of this dtype and
    head_dim takes (``flash_cuda._wgmma_route``)."""
    from accelerate_tpu_torch.ops.flash_cuda import _wgmma_route

    return "wgmma" if _wgmma_route(dtype, D) else "mma.sync"


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
    print(f"  [{'ok' if ok and identical else 'FAIL'}] {label} ({route_of(dtype, D)}): B={B} "
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
    return " ".join(f"{k}={v}" for k, v in shape.items()) + " causal bf16"


def forward_timings(B, S, H, G, D, seed):
    """Both routes of the forward at one causal bf16 shape, each checked
    against the plain version once, then timed in turns beside the plain
    version, SDPA and the bound."""
    import torch
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import flash_cuda as fc

    q, k, v, _ = make_inputs(B, S, H, G, D, torch.bfloat16, seed=seed)
    args = (q, k, v, True, None, None, None, None)
    routes = {"wgmma": lambda: fc._fwd_wgmma(*args), "mma.sync": lambda: fc._fwd_mma(*args)}
    ref, _ = fc.flash_fwd_reference(q, k, v, causal=True)
    err = {n: (fn()[0].float() - ref.float()).abs().max().item() for n, fn in routes.items()}
    del ref
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
    """``flash_bwd`` (dK/dV, then dQ, both on the case's route, as the
    counts must show) on one case, with a seeded ``d_out``, against
    ``flash_bwd_reference`` under ``BWD_TOLERANCE``, and a repeat launch
    bit-identical; fails otherwise."""
    import torch

    from accelerate_tpu_torch.ops.flash_cuda import flash_bwd, flash_bwd_reference, flash_fwd

    (B, S, H, D), G, dtype = q.shape, k.shape[2], q.dtype
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d_out = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    out, lse = flash_fwd(q, k, v, segment_ids=seg, **kw)
    route = route_of(dtype, D)
    reset_counts()
    grads = flash_bwd(q, k, v, out, lse, d_out, segment_ids=seg, **kw)
    torch.cuda.synchronize()
    repeat = flash_bwd(q, k, v, out, lse, d_out, segment_ids=seg, **kw)
    torch.cuda.synchronize()
    counts = read_counts()
    expected = expected_counts(0, 2, wgmma=route == "wgmma")
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
    print(f"  [{'ok' if ok and identical else 'FAIL'}] {label} (dK/dV and dQ {route}): B={B} "
          f"S={S} H={H} G={G} D={D} {name} {' '.join(report)} (limit "
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


def backward_timings(B, S, H, G, D, seed):
    """The dK/dV and the dQ kernel of each route at one causal bf16 shape,
    each checked against the plain backward once, then timed (the two
    routes of each kernel in turns) beside the plain backward, SDPA's
    backward and the bounds."""
    import torch

    from accelerate_tpu_torch.ops import flash_cuda as fc

    q, k, v, _ = make_inputs(B, S, H, G, D, torch.bfloat16, seed=seed)
    d_out = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(seed + 1),
                        device="cuda").to(torch.bfloat16)
    out, lse = fc.flash_fwd(q, k, v, causal=True)
    launch = fc._BackwardLaunch(q, k, v, out, lse, d_out, causal=True, sm_scale=None,
                                sliding_window=None, segment_ids=None, logit_softcap=None)
    refs = fc.flash_bwd_reference(q, k, v, out, lse, d_out, causal=True)
    routes = {"wgmma": launch.dkdv_wgmma, "mma.sync": launch.dkdv_mma}
    dq_routes = {"dq wgmma": launch.dq_wgmma, "dq mma.sync": launch.dq_mma}
    err = {}
    for name, fn in routes.items():
        fn()
        err[name] = max((g.float() - r.float()).abs().max().item()
                        for g, r in zip(launch.grads[1:], refs[1:]))
    for name, fn in dq_routes.items():
        fn()
        err[name] = (launch.grads[0].float() - refs[0].float()).abs().max().item()
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
    return graphed_ms


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
                      tokens_per_s=s["decode_tokens_per_sec"])
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
    SERVING_4C["tick_ms"] = steady_tick(engine, card)
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


def serve_exact(model, work, label, refs, check=True, captures_ok=False, adapters_of=None, **kw):
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
        fail(f"4d exactness, {label}: {equal} of {len(work)} streams token-exact, captures after "
             f"warmup {events}")
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


def expected_counts(forward: int, backward: int, wgmma: bool) -> dict:
    """``read_counts`` of ``forward`` forward and ``backward`` backward
    launches (dK/dV and dQ each), all on one route."""
    route = {"flash_fwd_sm90": forward, "flash_bwd_dkdv_sm90": backward,
             "flash_bwd_dq_sm90": backward} if wgmma else {
        "flash_fwd_mma": forward, "flash_bwd_dkdv_mma": backward, "flash_bwd_dq_mma": backward}
    counts = {"flash_fwd": forward, "flash_fwd_sm90": 0, "flash_fwd_mma": 0,
              "flash_bwd_dkdv": backward, "flash_bwd_dkdv_sm90": 0, "flash_bwd_dkdv_mma": 0,
              "flash_bwd_dq": backward, "flash_bwd_dq_sm90": 0, "flash_bwd_dq_mma": 0}
    counts.update(route)
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

    print("== 1. environment and build")
    phase_environment()
    print("== 2. flash_fwd vs flash_fwd_reference")
    forward = phase_kernels()
    print("== 2b. flash_bwd vs flash_bwd_reference")
    backward = phase_backward()
    print("== 3. Llama-3-8B forward")
    model, policy, gen = build_model()
    launches_8b = phase_forward(model, policy, gen)
    print("== 4. generate")
    reset_counts()
    phase_generate(model, gen)
    if any(read_counts().values()):
        fail("the cached generate path launched a flash kernel; its attention is the einsum core")
    print("== 4b. speculative and beam-search decoding")
    reset_counts()
    phase_speculative(model, gen)
    if any(read_counts().values()):
        fail("a speculative or beam-search decoder launched a flash kernel; its attention is "
             "the einsum core")
    print("== 4c. the serving engine")
    reset_counts()
    phase_serving(model)
    serving_counts = read_counts()
    if any(serving_counts.values()):
        fail("the serving engine launched a flash kernel; its attention is the einsum core")
    print("== 4d. speculative, quantized and multi-tenant serving")
    reset_counts()
    phase_serving_extras(model)
    extras_counts = read_counts()
    if any(extras_counts.values()):
        fail("4d launched a flash kernel; the serving path's attention is the einsum core")
    print("== 4e. the serving fleet: router, supervisor, chaos, HTTP gateway, loadgen")
    reset_counts()
    phase_fleet(model)
    fleet_counts = read_counts()
    if any(fleet_counts.values()):
        fail("4e launched a flash kernel; the serving path's attention is the einsum core")
    print("== 5. where the device time goes")
    phase_profile(model, gen)
    layers_8b = model.config.num_hidden_layers
    del model, gen
    free_cuda()
    print("== 6. train (tier-1 llama, bf16 over f32 masters)")
    result, counts, check_counts = phase_train()
    print("== 7. where the device time of a train step goes")
    phase_train_profile()
    print("== 8. the training loop: packed sequences, dots remat, save/load, resume")
    loop_counts, loop_microbatches = phase_loop()

    steps = result["extra"]["steps"]
    kernels = kernel_lines(forward, backward, counts, check_counts, steps, launches_8b, layers_8b)
    for entry in kernels:
        entry["serving_launches"] = serving_counts[entry["name"]]
        entry["serving_extras_launches"] = extras_counts[entry["name"]]
        entry["serving_fleet_launches"] = fleet_counts[entry["name"]]
        if entry["name"].endswith("_sm90"):
            entry["loop_launches"] = loop_counts[entry["name"]]
            entry["loop_launches_per_microbatch"] = loop_counts[entry["name"]] / loop_microbatches
            entry["loop_path"] = LOOP_PATH
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


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
    main()
