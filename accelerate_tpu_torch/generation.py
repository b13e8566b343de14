"""KV-cached autoregressive decoding: plain, speculative and beam search.

Counterpart of ``accelerate_tpu/generation.py``: ``generate`` /
``greedy_generate``, the speculative decoders ``prompt_lookup_generate``
(drafts from the sequence itself) and ``assisted_generate`` (drafts from a
smaller model) over the shared accept rule ``speculative_accept`` /
``speculative_emit``, ``beam_search_generate``, and ``seq2seq_generate``
for the encoder-decoder T5 (``generate`` hands it such a model; the other
decoders refuse one). The JAX package
compiles each decoder into a prefill and one ``lax.scan`` or
``lax.while_loop``; PyTorch runs eagerly, so here each is a Python loop of
cached forwards. The selection rules are the JAX package's, step for step:
repetition penalty before the warpers, ``min_new_tokens`` masking EOS, the
EOS latch (a sequence that emitted EOS keeps emitting it), the 128-bucketed
cache length and the edge-padded prompt. Greedy decoding (and beam search)
is token-exact against the JAX package on the same weights; sampling draws
from a ``torch.Generator`` (Philox, not JAX's threefry), so sampled tokens
agree in distribution only.

A speculative round reads the device once (:func:`_read`: the accepted
count and the emitted chain); :data:`last_speculation` counts the rounds,
the accepted drafts and the reads of the last speculative call.

Cache capability is registered in :func:`big_modeling.cache_factory_for`.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch


def supports_kv_cache(module) -> bool:
    """Whether ``module`` threads a KV cache through its forward: the
    families ``big_modeling.cache_factory_for`` knows (the Llama family and
    a ``StreamedModel`` of one), or a model with ``init_decode_cache``."""
    from .big_modeling import cache_factory_for

    return cache_factory_for(module) is not None or hasattr(module, "init_decode_cache")


def _make_selector(sampling, repetition_penalty: float = 1.0):
    """Token-selection fn (logits [B, V], generator, seen [B, V] bool) -> [B]
    ids. ``sampling`` is None for greedy, else (temperature, top_k, top_p).
    ``repetition_penalty`` applies the CTRL rule to already-seen tokens
    before the warpers: negative scores multiply by it, positive divide."""
    if repetition_penalty <= 0:
        raise ValueError(
            f"repetition_penalty must be > 0, got {repetition_penalty} "
            "(transformers semantics: >1 suppresses repeats, <1 boosts)")

    def apply_penalty(logits, seen):
        if repetition_penalty == 1.0:
            return logits
        logits = logits.float()
        penalized = torch.where(logits < 0, logits * repetition_penalty,
                                logits / repetition_penalty)
        return torch.where(seen, penalized, logits)

    if sampling is None:
        return lambda logits, generator, seen: torch.argmax(apply_penalty(logits, seen), dim=-1)
    warp = _make_warper(sampling)

    def select(logits, generator, seen):
        probs = torch.softmax(warp(apply_penalty(logits, seen)), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    return select


def _make_warper(sampling):
    """logits [B, V] -> warped f32 logits (temperature / top-k / top-p;
    excluded tokens at -inf). ``softmax(warped)`` is the sampling target."""
    temperature, top_k, top_p = sampling

    def warp(logits):
        logits = logits.float() / max(temperature, 1e-6)
        if top_k is not None and top_k > 0:
            k = min(top_k, logits.shape[-1])
            kth = torch.topk(logits, k, dim=-1).values[:, -1:]
            logits = logits.masked_fill(logits < kth, float("-inf"))
        if top_p is not None:
            sorted_logits = torch.sort(logits, dim=-1, descending=True).values
            cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
            # Keep the smallest prefix with cumulative mass >= top_p (always
            # keep the best token).
            keep = torch.cat([torch.ones_like(cum[:, :1], dtype=torch.bool),
                              cum[:, :-1] < top_p], dim=-1)
            cutoff = torch.where(keep, sorted_logits, float("inf")).amin(dim=-1, keepdim=True)
            logits = logits.masked_fill(logits < cutoff, float("-inf"))
        return logits

    return warp


def _suppress_eos(last, gen_index: int, eos_token_id, min_new_tokens: int):
    """Mask the EOS column of ``last`` [B, V] while generation index
    ``gen_index`` (1-based) is within ``min_new_tokens``: EOS is first
    allowed at new token min+1 (HF MinNewTokensLength)."""
    if eos_token_id is None or min_new_tokens < 1 or gen_index > min_new_tokens:
        return last
    last = last.clone()
    last[:, eos_token_id] = float("-inf")
    return last


def _mark_seen(seen, token_ids):
    """seen [B, V] bool |= one-hot union of token_ids [B] or [B, S]."""
    ids = token_ids if token_ids.ndim == 2 else token_ids[:, None]
    return seen.scatter(1, ids.long(), True)


def _next_token(last, generator, seen, done, select, eos_token_id, dtype):
    """Select one token from ``last`` [B, V], then apply the EOS latch.
    Returns ``(next_token [B], done [B])``."""
    nxt = select(last, generator, seen).to(dtype)
    if eos_token_id is not None:
        nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
        done = done | (nxt == eos_token_id)
    return nxt, done


_M32 = 0xFFFFFFFF


def _hash32(x):
    """A 32-bit integer mix (xorshift-multiply, three rounds) of int64
    values in ``[0, 2**32)``; products stay below 2**63, so nothing wraps."""
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    return (x >> 16) ^ x


def _gumbel(keys, vocab: int):
    """Gumbel noise [B, vocab] (f32) from ``keys`` [B, 2] int64 (seed,
    counter): a hash of (seed, counter, vocab index), nothing else, in
    torch ops (no generator state, so a CUDA graph can capture it)."""
    seed, counter = keys[:, 0], keys[:, 1]
    row = _hash32(_hash32(seed & _M32) ^ ((seed >> 32) & _M32))
    row = _hash32(row ^ _hash32(counter & _M32))
    col = _hash32((torch.arange(vocab, device=keys.device) + 0x9E3779B9) & _M32)
    bits = _hash32(row[:, None] ^ col[None, :])
    u = ((bits >> 9).float() + 0.5) * (2.0 ** -23)  # in (0, 1), exact in f32
    return -torch.log(-torch.log(u))


def _make_keyed_selector(sampling):
    """``select(logits [B, V], keys [B, 2], seen) -> [B]``: argmax when
    ``sampling`` is None, else Gumbel-max over the warped logits with noise
    keyed by ``keys`` (:func:`_gumbel`)."""
    if sampling is None:
        return lambda logits, keys, seen: torch.argmax(logits, dim=-1)
    warp = _make_warper(sampling)

    def select(logits, keys, seen):
        return torch.argmax(warp(logits) + _gumbel(keys, logits.shape[-1]), dim=-1)

    return select


def _chunk_prefill_token(logits, generator, select, eos_token_id, dtype, true_len, offset=0,
                         seen=None):
    """The prefill epilogue of the serving engine's chunk step: read the
    logits row of the last real prompt position, ``true_len - 1`` mapped
    into this chunk's window ``[offset, offset + W)`` and clamped so a chunk
    that does not hold it still indexes in bounds, and select token #1
    through :func:`_next_token`. ``true_len`` and ``offset`` are tensors
    [B] (or ints); the row is read with a tensor index, never on the host,
    so a CUDA graph can capture the call. Only the chunk holding
    ``true_len - 1`` selects a real token; the engine discards the others'.
    ``generator`` goes to ``select`` as it is (the engine passes its
    per-row draw keys). Returns ``(tok [B], done [B])``; the JAX package's
    epilogue also splits an rng carry, which the engine's position-keyed
    draws do not need."""
    B, W = logits.shape[:2]
    local = true_len - 1 - offset
    if not torch.is_tensor(local):
        local = torch.full((B,), local, device=logits.device)
    local = local.reshape(-1).expand(B).clamp(0, W - 1)
    last = logits[torch.arange(B, device=logits.device), local]
    if seen is None:
        seen = torch.zeros((B, 1), dtype=torch.bool, device=logits.device)
    done = torch.zeros((B,), dtype=torch.bool, device=logits.device)
    return _next_token(last, generator, seen, done, select, eos_token_id, dtype)


def _bucket128(n: int) -> int:
    """Ceil to the 128 bucket: the granularity of cache lengths and padded prompts."""
    return -(-n // 128) * 128


def _bucket_and_pad(ids, *modules_or_bounds):
    """EDGE-pad ``ids`` to the 128-bucket of its length (repeating each row's
    last token, so a repetition-penalty seen-set is unchanged), capped at
    every given module's position table (or int bound)."""
    S = ids.shape[1]
    P = _bucket128(S)
    for mb in modules_or_bounds:
        bound = mb if isinstance(mb, int) else _position_bound(mb)
        if bound is not None:
            P = min(P, int(bound))
    if P <= S:
        return ids
    return torch.cat([ids, ids[:, -1:].expand(ids.shape[0], P - S)], dim=1)


def _position_bound(module) -> Optional[int]:
    """The model's position table: a streamed model's ``position_bound``,
    else its config's ``max_position_embeddings`` (None: no table)."""
    if hasattr(module, "position_bound"):
        return module.position_bound
    return getattr(getattr(module, "config", None), "max_position_embeddings", None)


def _check_position_bound(module, total_len: int, label: str = "prompt + max_new_tokens"):
    """Refuse a decode that would run past the model's position table."""
    bound = _position_bound(module)
    if bound is not None and total_len > bound:
        raise ValueError(f"{label} = {total_len} exceeds max_position_embeddings = {bound} "
                         f"for {type(module).__name__}")


def _is_encoder_decoder(module) -> bool:
    """A T5-style model (``init_decode_cache``), or a streamed one whose
    block specs have an encoder stage."""
    return hasattr(module, "init_decode_cache") or any(
        getattr(spec, "stage", None) == "enc" for spec in getattr(module, "specs", ()))


def _cache_factory(module, role: Optional[str] = None, caller: str = "generate"):
    """The model's KV-cache factory; TypeError for an encoder-decoder model
    (the JAX package's message) and for a family without one."""
    from .big_modeling import cache_factory_for

    if _is_encoder_decoder(module):
        who = f"; the {role} model is encoder-decoder" if role else ""
        raise TypeError(f"{caller} supports decoder-only models{who}; use seq2seq_generate for "
                        "encoder-decoder families")
    factory = cache_factory_for(module)
    if factory is None:
        who = f" ({role})" if role else ""
        raise TypeError(f"{type(module).__name__}{who} does not thread a KV cache "
                        "(big_modeling.cache_factory_for)")
    return factory


def _device_of(module) -> torch.device:
    """The device a model computes on: its parameters', or a streamed
    model's execution device (``big_modeling.StreamedModel``)."""
    from .big_modeling import StreamedModel

    if isinstance(module, StreamedModel):
        return module.device
    return next(module.parameters()).device


@torch.inference_mode()
def generate(
    module,
    input_ids,
    max_new_tokens: int = 20,
    eos_token_id: Optional[int] = None,
    cache_dtype=None,
    do_sample: bool = False,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    repetition_penalty: float = 1.0,
    min_new_tokens: int = 0,
    generator: Optional[torch.Generator] = None,
):
    """KV-cached decoding: greedy by default, ancestral sampling with
    temperature / top-k / top-p when ``do_sample=True``, CTRL-style
    ``repetition_penalty`` over prompt and generated tokens.

    Args:
      module: a cache-threading model (``big_modeling.cache_factory_for``);
        it runs on the device its parameters are on.
      input_ids: [B, S] int prompt (tensor or array-like).
      max_new_tokens: decode steps.
      eos_token_id: sequences that emit it keep emitting it.
      cache_dtype: KV buffer dtype (default: bfloat16).
      do_sample / temperature / top_k / top_p: sampling knobs.
      repetition_penalty: >1 suppresses repeats, <1 boosts; before the warpers.
      min_new_tokens: EOS is masked until this many tokens are generated.
      generator: ``torch.Generator`` on the module's device for sampling
        (default: one seeded with 0).

    Returns [B, S + max_new_tokens] ids (prompt + completion). An
    encoder-decoder model goes to :func:`seq2seq_generate`, which returns
    decoder ids [B, 1 + max_new_tokens]: the prompt is the encoder's input.
    """
    sampling_kw = dict(do_sample=do_sample, temperature=temperature, top_k=top_k, top_p=top_p,
                       repetition_penalty=repetition_penalty, min_new_tokens=min_new_tokens,
                       generator=generator)
    if hasattr(module, "init_decode_cache"):
        return seq2seq_generate(module, input_ids, max_new_tokens=max_new_tokens,
                                eos_token_id=eos_token_id, cache_dtype=cache_dtype, **sampling_kw)
    factory = _cache_factory(module)
    device = _device_of(module)
    ids = torch.as_tensor(input_ids, device=device)
    if max_new_tokens <= 0:
        return ids
    B, S = ids.shape
    _check_position_bound(module, S + max_new_tokens)
    cache = factory(B, _bucket128(S + max_new_tokens), cache_dtype or torch.bfloat16,
                    ring_slack=128)
    ids_p = _bucket_and_pad(ids, module)
    logits, cache = module(ids_p, cache=cache, cache_pos=0)

    def step(tok, pos):
        return module(tok[:, None], cache=cache, cache_pos=pos)[0]

    # The penalty counts the prompt too; edge padding re-marks each row's
    # last real token, so the seen-set is exact.
    new_tokens = _decode_loop(logits[:, S - 1], ids_p, step, S, max_new_tokens, eos_token_id,
                              ids.dtype, **sampling_kw)
    return torch.cat([ids, new_tokens], dim=1)


def _decode_loop(last, seen_ids, step, start_pos: int, max_new_tokens: int, eos_token_id, dtype,
                 do_sample=False, temperature=1.0, top_k=None, top_p=None,
                 repetition_penalty=1.0, min_new_tokens=0, generator=None):
    """The decode loop of :func:`generate` and :func:`seq2seq_generate`:
    token 1 from the prefill's logits ``last`` [B, V], then ``max_new_tokens
    - 1`` cached steps, ``step(tok [B], pos) -> logits [B, 1, V]`` feeding
    the last token at ``start_pos``, ``start_pos + 1``, ... The
    repetition-penalty seen-set starts from ``seen_ids`` [B, S]. Returns the
    new tokens [B, max_new_tokens]."""
    B, device = last.shape[0], last.device
    sampling = (float(temperature), top_k, top_p) if do_sample else None
    select = _make_selector(sampling, float(repetition_penalty))
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    track_seen = repetition_penalty != 1.0
    if track_seen:
        seen = _mark_seen(torch.zeros((B, last.shape[-1]), dtype=torch.bool, device=device),
                          seen_ids)
    else:
        seen = torch.zeros((B, 1), dtype=torch.bool, device=device)
    last = _suppress_eos(last, 1, eos_token_id, min_new_tokens)
    tok = select(last, generator, seen).to(dtype)
    if track_seen:
        seen = _mark_seen(seen, tok)
    done = (tok == eos_token_id) if eos_token_id is not None else torch.zeros_like(tok, dtype=torch.bool)
    new_tokens = [tok]
    for i in range(max_new_tokens - 1):
        # This step emits generation index i+2 (the prefill token is index 1).
        last = _suppress_eos(step(tok, start_pos + i)[:, -1], i + 2, eos_token_id, min_new_tokens)
        tok, done = _next_token(last, generator, seen, done, select, eos_token_id, dtype)
        if track_seen:
            seen = _mark_seen(seen, tok)
        new_tokens.append(tok)
    return torch.stack(new_tokens, dim=1)


def _padded_source(ids, attention_mask=None):
    """An encoder's source [B, S] and its mask (all ones by default), both
    padded with 0s to the 128-bucket of S: ``(ids, mask)``."""
    B, S = ids.shape
    mask = (torch.ones((B, S), dtype=torch.int32, device=ids.device) if attention_mask is None
            else torch.as_tensor(attention_mask, device=ids.device))
    pad = _bucket128(S) - S
    if pad:
        ids = torch.nn.functional.pad(ids, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    return ids, mask


@torch.inference_mode()
def seq2seq_generate(
    module,
    input_ids,
    max_new_tokens: int = 20,
    decoder_start_token_id: int = 0,
    eos_token_id: Optional[int] = None,
    attention_mask=None,
    cache_dtype=None,
    do_sample: bool = False,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    repetition_penalty: float = 1.0,
    min_new_tokens: int = 0,
    generator: Optional[torch.Generator] = None,
):
    """KV-cached encoder-decoder decoding (T5: ``mode="encode"`` /
    ``"decode"`` and ``init_decode_cache``), with :func:`generate`'s
    selection rules.

    The source is padded to its 128-bucket with 0s and the pads masked
    through ``attention_mask`` (cross-attention would attend them
    otherwise). One encoder pass, one prefill of the start token that also
    computes each layer's cross K/V, then a loop of single-token steps that
    reuse them: a step costs the same whatever the source length. The
    repetition penalty counts the start token (transformers' rule over the
    decoder sequence).

    Returns [B, 1 + max_new_tokens] decoder ids, the start token first, on
    the model's device."""
    device = _device_of(module)
    ids = torch.as_tensor(input_ids, device=device)
    B = ids.shape[0]
    start = torch.full((B, 1), decoder_start_token_id, dtype=ids.dtype, device=device)
    if max_new_tokens <= 0:
        return start
    ids, mask = _padded_source(ids, attention_mask)
    enc = module(ids, attention_mask=mask, mode="encode")
    # The last token is returned, never fed back: positions 0..max_new - 1.
    cache = module.init_decode_cache(B, max_new_tokens, cache_dtype or torch.bfloat16)
    logits, cache, cross_kv = module(decoder_input_ids=start, attention_mask=mask, mode="decode",
                                     encoder_out=enc, cache=cache, cache_pos=0)

    def step(tok, pos):
        return module(decoder_input_ids=tok[:, None], attention_mask=mask, mode="decode",
                      encoder_out=enc, cache=cache, cache_pos=pos, cross_kv=cross_kv)[0]

    new_tokens = _decode_loop(
        logits[:, -1], start, step, 1, max_new_tokens, eos_token_id, ids.dtype,
        do_sample=do_sample, temperature=temperature, top_k=top_k, top_p=top_p,
        repetition_penalty=repetition_penalty, min_new_tokens=min_new_tokens, generator=generator)
    return torch.cat([start, new_tokens], dim=1)


def greedy_generate(module, input_ids, max_new_tokens: int = 20,
                    eos_token_id: Optional[int] = None, cache_dtype=None):
    """Greedy alias of :func:`generate`."""
    return generate(module, input_ids, max_new_tokens=max_new_tokens,
                    eos_token_id=eos_token_id, cache_dtype=cache_dtype)


# -- speculative decoding -------------------------------------------------------


def speculative_accept(warped_logits, draft, generator):
    """Exact speculative sampling over one verification chunk (the
    Leviathan/Chen rejection rule with a deterministic, delta, proposal).

    Args:
      warped_logits: [K+1, V] f32; position j's target distribution is
        ``softmax(warped_logits[j])`` (already temperature/top-k/top-p
        warped).
      draft: [K] proposed tokens.
      generator: ``torch.Generator`` on the logits' device.

    Returns ``(m, final)`` as device tensors: ``m`` draft tokens commit
    (draft j passes when ``u_j < p_j(draft_j)``), followed by ``final``,
    drawn from position ``m``'s distribution with the rejected draft token
    masked out (the residual ``max(p - delta, 0) / Z``) when ``m < K``, or
    from position K's full target when every draft passed. The emitted
    tokens follow the chain of target distributions exactly."""
    K = draft.shape[0]
    probs = torch.softmax(warped_logits, dim=-1)
    u = torch.rand(K, generator=generator, device=warped_logits.device)
    p_draft = probs[:K].gather(1, draft[:, None].long())[:, 0]
    m = torch.cumprod((u < p_draft).int(), dim=0).sum()
    row = warped_logits[torch.clamp(m, max=K)]
    rejected = draft[torch.clamp(m, max=K - 1)].long()
    masked = row.scatter(0, rejected[None], float("-inf"))
    row = torch.where(m < K, masked, row)
    final = torch.multinomial(torch.softmax(row, dim=-1), 1, generator=generator)[0]
    return m, final


def speculative_emit(logits, draft, generator, warp, eos_token_id, dtype, prior_done=None):
    """One verification chunk -> the emitted token chain, shared by the
    speculative decoders (and, in the JAX package, the serving engine).

    Args:
      logits: [K+1, V] target logits over ``[last_committed, draft]``.
      draft: [K] proposed tokens.
      generator: ``torch.Generator`` for the accept rule (unused when
        ``warp`` is None).
      warp: a warper from :func:`_make_warper`, or None for greedy.
      eos_token_id: the EOS id or None.
      dtype: the emitted tokens' dtype.
      prior_done: bool (or 0-dim bool tensor): the sequence already emitted
        EOS, so the whole chunk emits EOS.

    Returns ``(m, emit)`` as device tensors: ``emit`` [K+1] is the chain of
    which the caller commits the first ``min(m + 1, remaining)``; ``m``
    counts the accepted drafts. Greedy: the longest prefix of ``draft``
    that agrees with the EOS-latched argmax chain. Sampled: the count of
    :func:`speculative_accept`, with ``emit[m]`` its resample. Every
    position after the chain's first EOS emits EOS, so a committed prefix
    stops as :func:`generate` does."""
    K = draft.shape[0]
    done0 = torch.as_tensor(False if prior_done is None else prior_done, device=logits.device)
    if warp is None:
        emit = logits.argmax(dim=-1).to(dtype)
    else:
        m, final = speculative_accept(warp(logits), draft, generator)
        slots = torch.arange(K + 1, device=logits.device)
        padded = torch.cat([draft.to(dtype), torch.zeros(1, dtype=dtype, device=draft.device)])
        emit = torch.where(slots < m, padded, final.to(dtype))
    if eos_token_id is not None:
        is_eos = emit == eos_token_id
        after = torch.cat([torch.zeros(1, dtype=torch.bool, device=emit.device),
                           torch.cumsum(is_eos.int(), dim=0)[:-1] > 0])
        emit = torch.where(done0 | after, torch.full_like(emit, eos_token_id), emit)
    if warp is None:
        m = torch.cumprod((draft.to(dtype) == emit[:K]).int(), dim=0).sum()
    return m, emit


def speculative_emit_keyed(logits, draft, seed, pos, warp, eos_token_id, dtype, prior_done):
    """The serving engine's verify epilogue over ``S`` rows at once: the
    batched, generator-free form of :func:`speculative_emit`.

    Args:
      logits: [S, K+1, V] target logits over ``[carry, draft]``; row ``s``'s
        carry token sits at position ``pos[s]``, so logits ``j`` draw the
        token at position ``pos[s] + 1 + j``.
      draft: [S, K] proposed tokens (a delta proposal: each is one token,
        not a distribution).
      seed / pos: [S] int64, each row's sampling seed and carry position.
      warp: a warper from :func:`_make_warper`, or None for greedy.
      eos_token_id / dtype / prior_done ([S] bool): as in
        :func:`speculative_emit`.

    Returns ``(m [S], emit [S, K+1])``; the caller commits ``emit[s, :n]``
    with ``n = min(m + 1, remaining)``. Greedy: ``emit`` is the EOS-latched
    argmax chain and ``m`` the longest prefix of ``draft`` agreeing with
    it. Sampled: the token at position ``p`` is the Gumbel-max sample
    ``argmax(warp(logits) + g(seed, p))`` with the noise of
    :func:`_gumbel`, keyed by the seed and ``p`` only, as the engine's
    decode step draws it. Draft ``j`` passes when it equals that sample,
    which happens with probability ``p_j(draft_j)``: the rejection rule's
    acceptance for a delta proposal. At the first rejection the residual
    draw, a Gumbel-max over the row with the rejected draft masked out, is
    that same sample (it was not the draft), so the emitted chain follows
    the chain of target distributions exactly, and a seed gives the same
    tokens whether a position was drawn by a verify or by a decode or
    chunk step: whatever the slot, batch, ticking mode or preemption."""
    S, K1, V = logits.shape
    K = K1 - 1
    if warp is None:
        emit = logits.argmax(dim=-1).to(dtype)
    else:
        at = pos[:, None] + 1 + torch.arange(K1, device=logits.device)
        keys = torch.stack([seed[:, None].expand(S, K1), at], dim=-1).reshape(S * K1, 2)
        noise = _gumbel(keys, V).view(S, K1, V)
        emit = (warp(logits.reshape(S * K1, V)).view(S, K1, V) + noise).argmax(dim=-1).to(dtype)
    if eos_token_id is not None:
        is_eos = emit == eos_token_id
        after = torch.cat([prior_done[:, None],
                           torch.cumsum(is_eos.int(), dim=1)[:, :-1] > 0], dim=1)
        after = after | prior_done[:, None]
        emit = torch.where(after, torch.full_like(emit, eos_token_id), emit)
    m = torch.cumprod((draft.to(dtype) == emit[:, :K]).int(), dim=1).sum(dim=1)
    return m, emit


@dataclass
class SpeculationStats:
    """What one speculative call did: verification ``rounds``, draft tokens
    accepted (``accepted``, of ``num_draft`` a round), tokens committed
    (``committed``, the prefill's first token included) and host ``reads``
    of the device (the prompt and first token, then one a round)."""

    rounds: int = 0
    accepted: int = 0
    committed: int = 0
    reads: int = 0

    @property
    def accepted_per_round(self) -> float:
        return self.accepted / max(1, self.rounds)

    def reset(self):
        for f in fields(self):
            setattr(self, f.name, f.default)


#: The counters of the last ``prompt_lookup_generate`` / ``assisted_generate``.
last_speculation = SpeculationStats()


def _read(tensor) -> list:
    """The one way the speculative loops read the device: a blocking copy
    of ``tensor`` to a host list, counted in :data:`last_speculation`."""
    last_speculation.reads += 1
    return tensor.tolist()


def lookup_draft(buf: np.ndarray, cur: int, ngram: int, num_draft: int) -> np.ndarray:
    """Prompt-lookup draft: the ``num_draft`` tokens of ``buf`` after the
    most recent earlier occurrence (start ``i`` with ``i + ngram < cur``) of
    the last ``ngram`` committed tokens ``buf[cur - ngram:cur]``; with no
    occurrence, after ``i = -1``. The start is clipped into
    ``[0, len(buf) - num_draft]``, so a draft may read positions at or past
    ``cur``: what earlier rounds wrote there, as in the JAX package."""
    L = len(buf)
    best = -1
    if cur - 1 >= ngram:
        windows = np.lib.stride_tricks.sliding_window_view(buf[:cur - 1], ngram)
        hits = np.flatnonzero((windows == buf[cur - ngram:cur]).all(axis=1))
        if hits.size:
            best = int(hits[-1])
    start = min(max(best + ngram, 0), L - num_draft)
    return buf[start:start + num_draft]


def _first_token(last, warp, generator, dtype):
    """The prefill's token from its last-position logits [B, V]."""
    if warp is None:
        return last.argmax(dim=-1).to(dtype)
    probs = torch.softmax(warp(last), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(dtype)


def _speculate(ids, first, max_new_tokens: int, num_draft: int, buf_len: int, eos_token_id,
               propose, verify):
    """The speculative loop both decoders share, on a host copy of the
    committed tokens ``buf`` [buf_len].

    Each round, with ``cur`` tokens committed and ``last`` [1, 1] the last
    of them on the device: ``propose(buf, cur, last, m_prev)`` (``m_prev``
    the drafts the last round accepted, None in the first) gives the draft
    [1, K] on the device, ``verify(chunk, draft, cur)`` runs the target over
    ``chunk = [last, draft]`` at cache position ``cur - 1`` and returns
    ``speculative_emit``'s ``(m, emit)``; one read brings both back. The
    round commits ``min(m + 1, remaining)`` tokens; the whole chain is
    written at ``cur`` (positions past the commit may feed a later draft,
    as in the JAX package). After an EOS the rest of the output is EOS."""
    device = ids.device
    S = ids.shape[1]
    stats = last_speculation
    head = _read(torch.cat([ids[0], first.to(ids.dtype)]))
    buf = np.zeros(buf_len, np.int64)
    buf[:S + 1] = head
    n_gen = 1
    done = eos_token_id is not None and head[S] == eos_token_id
    m = None
    while n_gen < max_new_tokens and not done:
        cur = S + n_gen
        last = torch.as_tensor(buf[None, cur - 1:cur], dtype=ids.dtype).to(device)
        draft = propose(buf, cur, last, m)
        m, emit = verify(torch.cat([last, draft], dim=1), draft[0], cur)
        out = _read(torch.cat([m.reshape(1).to(emit.dtype), emit]))
        m, emit = out[0], out[1:]
        n_emit = min(m + 1, max_new_tokens - n_gen)
        buf[cur:cur + num_draft + 1] = emit
        if eos_token_id is not None:
            done = eos_token_id in emit[:n_emit]
        n_gen += n_emit
        stats.rounds += 1
        stats.accepted += m
    stats.committed = n_gen
    if eos_token_id is not None:
        buf[S + n_gen:S + max_new_tokens] = eos_token_id
    return torch.as_tensor(buf[None, :S + max_new_tokens], dtype=ids.dtype).to(device)


@torch.inference_mode()
def prompt_lookup_generate(
    module,
    input_ids,
    max_new_tokens: int = 20,
    eos_token_id: Optional[int] = None,
    cache_dtype=None,
    ngram: int = 2,
    num_draft: int = 5,
    do_sample: bool = False,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
):
    """Decoding sped up by prompt-lookup speculation (transformers'
    ``prompt_lookup_num_tokens``): greedy by default, distribution-exact
    sampling with ``do_sample=True``.

    Each round drafts ``num_draft`` tokens, those after the most recent
    earlier occurrence of the last ``ngram`` committed tokens
    (:func:`lookup_draft`), and verifies them in one cached forward of
    ``num_draft + 1`` tokens; the model's own predictions decide how many
    commit, so greedy output is exactly :func:`generate`'s. Rejected
    positions leave stale KV entries that the next chunk overwrites before
    a query attends them; ring caches mask them by stored position (their
    ``ring_slack`` covers a chunk plus the prompt's padding). Batch 1 only.

    Returns [1, S + max_new_tokens] ids on the model's device."""
    factory = _cache_factory(module, caller="prompt_lookup_generate")
    ids = torch.as_tensor(input_ids, device=_device_of(module))
    if ids.shape[0] != 1:
        raise ValueError(f"prompt_lookup_generate is batch-1 only (got batch {ids.shape[0]})")
    if ngram < 1 or num_draft < 1:
        raise ValueError(f"ngram and num_draft must be >= 1 (got {ngram}, {num_draft})")
    if max_new_tokens <= 0:
        return ids
    S, K = ids.shape[1], int(num_draft)
    # The last chunk starts at S + max_new_tokens - 2 and spans K + 1.
    _check_position_bound(module, S + max_new_tokens + K - 1,
                          label="prompt + max_new_tokens + speculative slack")
    L = _bucket128(S + max_new_tokens + K + 1)
    cache = factory(1, L, cache_dtype or torch.bfloat16, ring_slack=K + 1 + 128)
    warp = _make_warper((float(temperature), top_k, top_p)) if do_sample else None
    if generator is None:
        generator = torch.Generator(device=ids.device).manual_seed(0)
    last_speculation.reset()

    logits, cache = module(_bucket_and_pad(ids, module), cache=cache, cache_pos=0)
    first = _first_token(logits[:, S - 1], warp, generator, ids.dtype)

    def verify(chunk, draft, cur):
        logits, _ = module(chunk, cache=cache, cache_pos=cur - 1)
        return speculative_emit(logits[0], draft, generator, warp, eos_token_id, ids.dtype)

    def propose(buf, cur, last, m_prev):
        draft = lookup_draft(buf, cur, int(ngram), K)
        return torch.as_tensor(draft[None], dtype=ids.dtype).to(ids.device)

    return _speculate(ids, first, max_new_tokens, K, L, eos_token_id, propose, verify)


@torch.inference_mode()
def assisted_generate(
    module,
    draft_module,
    input_ids,
    max_new_tokens: int = 20,
    num_draft: int = 5,
    eos_token_id: Optional[int] = None,
    cache_dtype=None,
    do_sample: bool = False,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
):
    """Draft-model speculative decoding (transformers' assisted generation).

    Each round the draft model proposes ``num_draft`` tokens by greedy
    cached decode from the last committed token (and, after a round that
    accepted every draft, the last draft, whose KV its cache lacks: the
    JAX package leaves that hole, which costs acceptances, never tokens),
    and the target verifies them in one cached forward: greedy output is exactly the target's
    :func:`generate` output; ``do_sample=True`` samples the warped target
    exactly (the greedy draft is a delta proposal for
    :func:`speculative_accept`). Stale KV entries of rejected drafts, in
    both caches, are overwritten before a query attends them. Both models
    are decoder-only over the same vocabulary; batch 1 only.

    Returns [1, S + max_new_tokens] ids on the target's device."""
    factory = _cache_factory(module, "target", "assisted_generate")
    draft_factory = _cache_factory(draft_module, "draft", "assisted_generate")
    t_vocab = getattr(module.config, "vocab_size", None)
    d_vocab = getattr(draft_module.config, "vocab_size", None)
    if t_vocab != d_vocab:
        raise ValueError(f"target and draft must share a vocabulary (got {t_vocab} vs {d_vocab})")
    ids = torch.as_tensor(input_ids, device=_device_of(module))
    if ids.shape[0] != 1:
        raise ValueError(f"assisted_generate is batch-1 only (got batch {ids.shape[0]})")
    if num_draft < 1:
        raise ValueError(f"num_draft must be >= 1 (got {num_draft})")
    if max_new_tokens <= 0:
        return ids
    S, K = ids.shape[1], int(num_draft)
    _check_position_bound(module, S + max_new_tokens + K - 1,
                          label="prompt + max_new_tokens + speculative slack")
    # The draft decodes at positions up to S + max_new_tokens + K - 3.
    _check_position_bound(draft_module, S + max_new_tokens + K - 2,
                          label="prompt + max_new_tokens + draft slack")
    L = _bucket128(S + max_new_tokens + K + 1)
    dtype = cache_dtype or torch.bfloat16
    cache = factory(1, L, dtype, ring_slack=K + 1 + 128)
    dcache = draft_factory(1, L, dtype, ring_slack=K + 1 + 128)
    warp = _make_warper((float(temperature), top_k, top_p)) if do_sample else None
    if generator is None:
        generator = torch.Generator(device=ids.device).manual_seed(0)
    last_speculation.reset()

    ids_p = _bucket_and_pad(ids, module, draft_module)
    logits, cache = module(ids_p, cache=cache, cache_pos=0)
    first = _first_token(logits[:, S - 1], warp, generator, ids.dtype)
    draft_module(ids_p, cache=dcache, cache_pos=0)

    def propose(buf, cur, last, m_prev):
        # A round's K draft steps write the KV of the last committed token
        # and of drafts 1..K-1; when all K were accepted, draft K is
        # committed too but not in the draft's cache, so it goes in with
        # the next round's first step.
        start = cur - 2 if m_prev == K else cur - 1
        tok = last if start == cur - 1 else torch.as_tensor(
            buf[None, start:cur], dtype=ids.dtype).to(ids.device)
        toks = []
        for j in range(K):
            dlogits, _ = draft_module(tok, cache=dcache, cache_pos=start if j == 0 else cur - 1 + j)
            tok = dlogits[:, -1].argmax(dim=-1, keepdim=True).to(ids.dtype)
            toks.append(tok)
        return torch.cat(toks, dim=1)

    def verify(chunk, draft, cur):
        logits, _ = module(chunk, cache=cache, cache_pos=cur - 1)
        return speculative_emit(logits[0], draft, generator, warp, eos_token_id, ids.dtype)

    return _speculate(ids, first, max_new_tokens, K, L, eos_token_id, propose, verify)


# -- beam search -----------------------------------------------------------------


def _top_k_by_index(scores, k: int):
    """``torch.topk`` with ties to the lower index, as ``jax.lax.top_k``:
    a stable descending sort. Returns (values, indices) [..., k]."""
    values, indices = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _gather_cache_rows(cache, rows):
    """Every layer's cache buffers (``k``, ``v`` and a ring's ``pos``) follow
    their beams: row i takes row ``rows[i]``. One layer's buffers are copied
    at a time, so the peak grows by a layer, not by a cache."""
    for layer in cache:
        for name in layer:
            layer[name] = layer[name].index_select(0, rows)


@torch.inference_mode()
def beam_search_generate(
    module,
    input_ids,
    max_new_tokens: int = 20,
    num_beams: int = 4,
    eos_token_id: Optional[int] = None,
    length_penalty: float = 1.0,
    cache_dtype=None,
):
    """Beam search for decoder-only cache-threading models.

    The prompt is prefilled on its B rows, then the cache is repeated to
    B x num_beams rows (beams ride the batch axis). The first step takes
    the num_beams best distinct tokens; each later step scores num_beams x V
    continuations per sequence, keeps the best num_beams by summed log
    probability (ties to the lower index, as ``jax.lax.top_k``), and
    gathers the cache rows and token histories of the beams kept. A beam
    that emitted EOS is frozen: its one continuation is EOS at an unchanged
    score. The winner maximises score / generated_length **
    length_penalty, the length counting up to and including the first EOS.

    Returns [B, S + max_new_tokens] ids of the best beam per row, on the
    model's device."""
    factory = _cache_factory(module, caller="beam_search_generate")
    device = _device_of(module)
    ids = torch.as_tensor(input_ids, device=device)
    B, S = ids.shape
    if max_new_tokens <= 0:
        return ids
    _check_position_bound(module, S + max_new_tokens)
    K = num_beams
    cache = factory(B, _bucket128(S + max_new_tokens), cache_dtype or torch.bfloat16,
                    ring_slack=128)
    logits, cache = module(_bucket_and_pad(ids, module), cache=cache, cache_pos=0)
    logp = torch.log_softmax(logits[:, S - 1].float(), dim=-1)
    del logits  # the prompt's logits are not held beside the repeated cache
    for layer in cache:
        for name in layer:
            layer[name] = layer[name].repeat_interleave(K, dim=0)
    V = logp.shape[-1]
    beam_scores, first = _top_k_by_index(logp, K)                    # [B, K]
    tok_hist = torch.zeros((B, K, max_new_tokens), dtype=ids.dtype, device=device)
    tok_hist[:, :, 0] = first
    done = torch.zeros((B, K), dtype=torch.bool, device=device)
    if eos_token_id is not None:
        done = first == eos_token_id
        eos_only = torch.full((V,), -1e9, dtype=torch.float32, device=device)
        eos_only[eos_token_id] = 0.0
    row_base = torch.arange(B, device=device)[:, None] * K
    for step in range(max_new_tokens - 1):
        cur = tok_hist[:, :, step].reshape(B * K, 1)
        logits, cache = module(cur, cache=cache, cache_pos=S + step)
        logp = torch.log_softmax(logits[:, -1].float(), dim=-1).reshape(B, K, V)
        if eos_token_id is not None:
            logp = torch.where(done[:, :, None], eos_only, logp)
        cand = beam_scores[:, :, None] + logp
        beam_scores, top_idx = _top_k_by_index(cand.reshape(B, K * V), K)
        src = top_idx // V
        new_tok = (top_idx % V).to(ids.dtype)
        tok_hist = tok_hist.gather(1, src[:, :, None].expand(B, K, max_new_tokens))
        _gather_cache_rows(cache, (row_base + src).reshape(-1))
        done = done.gather(1, src)
        tok_hist[:, :, step + 1] = new_tok
        if eos_token_id is not None:
            done = done | (new_tok == eos_token_id)
    if eos_token_id is not None:
        is_eos = tok_hist == eos_token_id
        first_eos = is_eos.int().argmax(dim=-1)
        lengths = torch.where(is_eos.any(dim=-1), first_eos + 1,
                              torch.full_like(first_eos, max_new_tokens))
    else:
        lengths = torch.full((B, K), max_new_tokens, device=device)
    norm = beam_scores / lengths.float() ** length_penalty
    best = norm.argmax(dim=-1)
    return torch.cat([ids, tok_hist[torch.arange(B, device=device), best]], dim=1)
