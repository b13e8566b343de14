"""KV-cached autoregressive decoding.

Counterpart of ``accelerate_tpu/generation.py`` (``generate`` /
``greedy_generate``). The JAX package compiles a prefill and one
``lax.scan`` over the decode steps; PyTorch runs eagerly, so here the
prefill is one forward over the padded prompt and the decode is a Python
loop of single-token forwards against the cache. The selection rules are
the JAX package's, step for step: repetition penalty before the warpers,
``min_new_tokens`` masking EOS, the EOS latch (a sequence that emitted EOS
keeps emitting it), the 128-bucketed cache length and the edge-padded
prompt. Greedy decoding is token-exact against the JAX package on the same
weights; sampling draws from a ``torch.Generator`` (Philox, not JAX's
threefry), so sampled tokens agree in distribution only.

Cache capability is registered in :func:`big_modeling.cache_factory_for`.
"""

from __future__ import annotations

from typing import Optional

import torch


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


def _bucket128(n: int) -> int:
    """Ceil to the 128 bucket: the granularity of cache lengths and padded prompts."""
    return -(-n // 128) * 128


def _bucket_and_pad(ids, max_positions: int):
    """EDGE-pad ``ids`` to the 128-bucket of its length (repeating each row's
    last token, so a repetition-penalty seen-set is unchanged), capped at the
    model's position table."""
    S = ids.shape[1]
    P = min(_bucket128(S), max_positions)
    if P <= S:
        return ids
    return torch.cat([ids, ids[:, -1:].expand(ids.shape[0], P - S)], dim=1)


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

    Returns [B, S + max_new_tokens] ids (prompt + completion).
    """
    from .big_modeling import cache_factory_for

    factory = cache_factory_for(module)
    if factory is None:
        raise TypeError(f"{type(module).__name__} does not thread a KV cache "
                        "(big_modeling.cache_factory_for)")
    device = next(module.parameters()).device
    ids = torch.as_tensor(input_ids, device=device)
    if max_new_tokens <= 0:
        return ids
    B, S = ids.shape
    max_positions = module.config.max_position_embeddings
    if S + max_new_tokens > max_positions:
        raise ValueError(f"prompt + max_new_tokens = {S + max_new_tokens} exceeds "
                         f"max_position_embeddings = {max_positions}")
    cache = factory(B, _bucket128(S + max_new_tokens), cache_dtype or torch.bfloat16,
                    ring_slack=128)
    ids_p = _bucket_and_pad(ids, max_positions)

    sampling = (float(temperature), top_k, top_p) if do_sample else None
    select = _make_selector(sampling, float(repetition_penalty))
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    track_seen = repetition_penalty != 1.0

    logits, cache = module(ids_p, cache=cache, cache_pos=0)
    if track_seen:
        # The penalty counts the prompt too; edge padding re-marks each
        # row's last real token, so the seen-set is exact.
        seen = _mark_seen(torch.zeros((B, logits.shape[-1]), dtype=torch.bool, device=device),
                          ids_p)
    else:
        seen = torch.zeros((B, 1), dtype=torch.bool, device=device)
    last = _suppress_eos(logits[:, S - 1], 1, eos_token_id, min_new_tokens)
    tok = select(last, generator, seen).to(ids.dtype)
    if track_seen:
        seen = _mark_seen(seen, tok)
    done = (tok == eos_token_id) if eos_token_id is not None else torch.zeros_like(tok, dtype=torch.bool)
    new_tokens = [tok]
    for i in range(max_new_tokens - 1):
        logits, cache = module(tok[:, None], cache=cache, cache_pos=S + i)
        # This step emits generation index i+2 (the prefill token is index 1).
        last = _suppress_eos(logits[:, -1], i + 2, eos_token_id, min_new_tokens)
        tok, done = _next_token(last, generator, seen, done, select, eos_token_id, ids.dtype)
        if track_seen:
            seen = _mark_seen(seen, tok)
        new_tokens.append(tok)
    return torch.cat([ids, torch.stack(new_tokens, dim=1)], dim=1)


def greedy_generate(module, input_ids, max_new_tokens: int = 20,
                    eos_token_id: Optional[int] = None, cache_dtype=None):
    """Greedy alias of :func:`generate`."""
    return generate(module, input_ids, max_new_tokens=max_new_tokens,
                    eos_token_id=eos_token_id, cache_dtype=cache_dtype)
