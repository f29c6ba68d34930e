"""Autoregressive generation for the port's causal LM (dense KV cache).

The counterpart of the JAX package's ``core/generate.py`` for the serving
slice, as plain functions on tensors (PyTorch runs eagerly; there is no
``jit``):

* :func:`make_prefill` — ``prefill(prompt, prompt_lens=None) -> (cache,
  last_logits)``: the right-padded (B, P) prompt runs through the NORMAL
  forward (the flash kernel for ``attn="flash"``), each block hands back
  its post-RoPE K/V, and the decode cache is assembled from them with
  every row's cursor at its real length;
* :func:`make_decode_step` — ``step(cache, tok) -> (cache, logits)``: one
  batched single-token step against a caller-owned cache;
* :func:`init_cache` — a zeroed (batch, max_len) cache;
* :func:`make_generator` — the greedy offline episode on the same two
  cores, so the stepwise path and the episode cannot drift apart.

Weights live in the model, so none of these take ``params``.  The cache
is ``{"block_i": {"k", "v", "index"}}`` with k/v (B, max_len, H_kv, D) in
the model's dtype and a (B,) int32 cursor; decode updates it IN PLACE and
hands the same dict back.  Sampled decoding (temperature > 0) is a later
slice.
"""

from __future__ import annotations

from typing import Callable

import torch


def _cache_from_sown(kvs: dict, lens: torch.Tensor, max_len: int) -> dict:
    """Decode cache from the K/V each block returned in the forward: pad
    (B, P, H_kv, D) to max_len with zeros and set each row's cursor to its
    prompt length (pad K/V past a row's length sit above its cursor, where
    the causal mask hides them until decode overwrites them)."""
    cache = {}
    for name, (k, v) in kvs.items():
        b, p = k.shape[:2]
        entry = {"index": lens.to(torch.int32).expand(b).clone()}
        for leaf, x in (("k", k), ("v", v)):
            full = x.new_zeros((b, max_len) + tuple(x.shape[2:]))
            full[:, :p] = x
            entry[leaf] = full
        cache[name] = entry
    if not cache:
        raise ValueError("prefill returned no K/V — the model has no blocks")
    return cache


def _prefill_core(model, prompt, lens, max_len: int):
    """Prefill math shared by :func:`make_prefill` and
    :func:`make_generator`: cache plus the logits at each row's last real
    position."""
    logits, kvs = model(prompt, sow_kv=True)
    cache = _cache_from_sown(kvs, lens, max_len)
    rows = torch.arange(prompt.shape[0], device=logits.device)
    return cache, logits[rows, lens.long() - 1]  # (B, V)


def _decode_step_core(model, cache, tok, max_len: int, ragged: bool):
    """One batched decode step: append each row's token at its cursor,
    attend its causal prefix, return (cache, (B, V) next-token logits)."""
    logits = model(tok[:, None], cache=cache, max_len=max_len, ragged=ragged)
    return cache, logits[:, 0]


def _lens(prompt, prompt_lens):
    b, p = prompt.shape
    if prompt_lens is None:
        return torch.full((b,), p, dtype=torch.int32, device=prompt.device)
    return torch.as_tensor(prompt_lens, device=prompt.device).to(torch.int32)


def make_prefill(model, max_len: int) -> Callable:
    """``prefill(prompt, prompt_lens=None) -> (cache, last_logits)``.

    ``prompt`` is (B, P) int tokens on the model's device with P <=
    max_len; ``prompt_lens`` (B,) marks real lengths in a right-padded
    batch (None = full rows).  Returns the cache (K/V padded to max_len,
    cursors at the row lengths) and the (B, V) float32 logits at each
    row's last real position."""
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")

    @torch.no_grad()
    def prefill(prompt, prompt_lens=None):
        if prompt.shape[1] > max_len:
            raise ValueError(
                f"prompt length {prompt.shape[1]} exceeds max_len ({max_len})")
        return _prefill_core(model, prompt, _lens(prompt, prompt_lens), max_len)

    return prefill


def make_decode_step(model, max_len: int, ragged: bool = True) -> Callable:
    """``step(cache, tok) -> (cache, logits)``: one batched single-token
    decode across every cache row.  ``tok`` is (B,) int (each row's
    previous token); the logits are (B, V) float32 at the new positions.
    ``ragged=True`` keeps per-row cursors (the serving engine's case);
    ``ragged=False`` is the shared-cursor path for lockstep batches.  Rows
    the caller does not care about decode garbage into their OWN rows
    only."""
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")

    @torch.no_grad()
    def step(cache, tok):
        return _decode_step_core(model, cache, tok, max_len, ragged)

    return step


def init_cache(model, batch: int, max_len: int) -> dict:
    """A zeroed (batch, max_len) decode cache on the model's device, in its
    dtype — the serving engine's slot cache before any admission."""
    shape = (batch, max_len, model.heads_kv, model.head_dim)
    dev = model.device
    return {
        f"block_{i}": {
            "k": torch.zeros(shape, dtype=model.dtype, device=dev),
            "v": torch.zeros(shape, dtype=model.dtype, device=dev),
            "index": torch.zeros((batch,), dtype=torch.int32, device=dev),
        }
        for i in range(model.depth)
    }


def make_generator(model, max_len: int, max_new: int, temperature: float = 0.0,
                   eos_id: int | None = None, pad_id: int = 0,
                   with_lengths: bool = False) -> Callable:
    """Greedy ``gen(prompt, prompt_lens=None) -> (B, P + max_new)``.

    Row b of the result is ``prompt[b, :len_b]``, then up to ``max_new``
    generated tokens, then ``pad_id``.  ``eos_id`` stops a row at its EOS
    (kept in the output; later slots are ``pad_id``) and the loop ends once
    every row has stopped.  ``with_lengths=True`` also returns the (B,)
    count of real generated tokens per row.  ``prompt_lens=None`` decodes
    with the shared cursor, a ragged batch with per-row cursors."""
    if max_new < 1:
        raise ValueError(f"max_new must be >= 1, got {max_new}")
    if temperature != 0.0:
        raise NotImplementedError(
            "sampled generation (temperature > 0) is not in the PyTorch port "
            "yet (the sampling serving slice ports it)")
    if eos_id is not None and eos_id == pad_id:
        raise ValueError(
            f"eos_id and pad_id must differ (both {eos_id}): a pad fed back "
            "after a stop would immediately re-trigger the stop logic")

    @torch.no_grad()
    def gen(prompt, prompt_lens=None):
        b, p = prompt.shape
        if p + max_new > max_len:
            raise ValueError(
                f"prompt ({p}) + max_new ({max_new}) exceeds max_len ({max_len})")
        lens = _lens(prompt, prompt_lens)
        if prompt_lens is not None and (lens.shape != (b,) or int(lens.min()) < 1
                                        or int(lens.max()) > p):
            raise ValueError(
                f"prompt_lens must be ({b},) lengths in [1, P={p}], got "
                f"{lens.tolist()}")
        dev = prompt.device
        cache, last = _prefill_core(model, prompt, lens, max_len)
        tok = last.argmax(-1)
        finished = (torch.zeros(b, dtype=torch.bool, device=dev) if eos_id is None
                    else tok == eos_id)
        toks = torch.full((b, max_new), pad_id, dtype=torch.long, device=dev)
        toks[:, 0] = tok
        flen = torch.where(finished, 1, max_new)
        ragged = prompt_lens is not None
        for t in range(1, max_new):
            if eos_id is not None and bool(finished.all()):
                break
            cache, logits = _decode_step_core(model, cache, tok, max_len, ragged)
            nxt = logits.argmax(-1)
            if eos_id is not None:
                nxt = torch.where(finished, pad_id, nxt)
                stopped = finished | (nxt == eos_id)
                flen = torch.where(stopped & ~finished, t + 1, flen)
                finished = stopped
            toks[:, t] = nxt
            tok = nxt
        # each row's real prompt, its generated tokens at ITS length, pad
        keep = torch.arange(p, device=dev)[None, :] < lens[:, None]
        out = torch.full((b, p + max_new), pad_id, dtype=torch.long, device=dev)
        out[:, :p] = torch.where(keep, prompt.long(), pad_id)
        out.scatter_(1, lens.long()[:, None] + torch.arange(max_new, device=dev), toks)
        return (out, flen.to(torch.int32)) if with_lengths else out

    return gen
