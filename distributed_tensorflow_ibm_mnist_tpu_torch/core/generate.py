"""Autoregressive generation for the port's causal LM.

The counterpart of the JAX package's ``core/generate.py``, as plain
functions on tensors (PyTorch runs eagerly; there is no ``jit``):

* :func:`make_prefill` — ``prefill(prompt, prompt_lens=None) -> (cache,
  last_logits)``: the right-padded (B, P) prompt runs through the NORMAL
  forward (the flash kernel for ``attn="flash"``), each block hands back
  its post-RoPE K/V, and the decode cache is assembled from them with
  every row's cursor at its real length;
* :func:`make_decode_step` — ``step(cache, tok) -> (cache, logits)``: one
  batched single-token step against a caller-owned cache;
* :func:`make_decode_window` — ``window`` fused decode+pick steps per
  call (decode-ahead), greedy or sampled on a given key schedule;
* :func:`_sample_window_core` — the serving engine's window: per-row
  sampling planes as data, the token at generated index ``n`` picked with
  ``fold_in(base_key, n)``;
* :func:`make_verify_window` / :func:`_verify_sample_core` — the
  speculative verify: ONE forward over a (B, draft_len + 1) chunk of
  host-drafted tokens, accepted by argmax match (greedy) or rejection
  sampling, the cursor rewound in place to the acceptance point;
* :func:`init_cache` — a zeroed (batch, max_len) cache (int8 with scales
  for ``kv_cache_dtype="int8"``);
* :func:`make_generator` / :func:`generate` — the offline episode (greedy,
  or sampled with top-k / top-p) on the same cores, so the stepwise path
  and the episode cannot drift apart.

Weights live in the model, so none of these take ``params``.  The dense
cache is ``{"block_i": {"k", "v", "index"}}`` with k/v (B, max_len, H_kv,
D) in the model's dtype and a (B,) int32 cursor; the paged cache
(serving/kv_pool.py) holds ``pages_k``/``pages_v``/``block_table``
instead of k/v, and every decode function here runs on either.  Decode
updates the cache IN PLACE and hands the same dict back.  Nothing in a
window reads a value back to the host: on CUDA tensors the loop only
enqueues work.  The per-row picks use the key schedule of
serving/sampling.py (Threefry-2x32 in torch integer ops), equal to
``jax.random``'s bits.
"""

from __future__ import annotations

from typing import Callable

import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.models.causal_lm import check_decodable
from distributed_tensorflow_ibm_mnist_tpu_torch.models.transformer import (
    attention_heads,
    quantize_kv_int8,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.collectives import all_gather_dim


def _cache_from_sown(kvs: dict, lens: torch.Tensor, max_len: int,
                     kv_cache_dtype: str = "native") -> dict:
    """Decode cache from the K/V each block returned in the forward: pad
    (B, P, H_kv, D) to max_len with zeros and set each row's cursor to its
    prompt length (pad K/V past a row's length sit above its cursor, where
    the causal mask hides them until decode overwrites them).
    ``kv_cache_dtype="int8"`` quantizes them into the int8 layout (k/v
    int8 plus ``k_scale``/``v_scale``); the prefill itself ran at full
    precision."""
    cache = {}
    for name, (k, v) in kvs.items():
        b, p = k.shape[:2]
        entry = {"index": lens.to(torch.int32).expand(b).clone()}
        if kv_cache_dtype == "int8":
            (kq, ks), (vq, vs) = quantize_kv_int8(k), quantize_kv_int8(v)
            leaves = (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs))
        else:
            leaves = (("k", k), ("v", v))
        for leaf, x in leaves:
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
    cache = _cache_from_sown(kvs, lens, max_len,
                             getattr(model, "kv_cache_dtype", "native"))
    rows = torch.arange(prompt.shape[0], device=logits.device)
    return cache, logits[rows, lens.long() - 1]  # (B, V)


def _ring_prefill_core(model, ring, prompt, lens, max_len: int):
    """:func:`_prefill_core` through a sequence-parallel ``ring`` (a
    context-parallel engine's prefill): each rank of the ring's seq group
    runs its slice of the prompt's tokens, then the K/V slices are gathered
    over the group, so every rank holds the whole row, and each row's
    last-position logits come from the rank whose slice holds that
    position.  A length that does not divide the ring runs whole on every
    rank (the ring's ``dense`` inner)."""
    logits, kvs = model(prompt, sow_kv=True, attn_fn=ring)
    rows = torch.arange(prompt.shape[0], device=logits.device)
    last = lens.long() - 1
    if ring.local_span(prompt.shape[1], *attention_heads(model)) is not None:
        group, s_local = ring.mesh.seq_group, logits.shape[1]
        kvs = {name: tuple(all_gather_dim(t, 1, group) for t in kv) for name, kv in kvs.items()}
        mine = logits[rows, (last - ring.mesh.seq_index * s_local).clamp(0, s_local - 1)]
        logits = all_gather_dim(mine[None], 0, group)[last // s_local, rows]
    else:
        logits = logits[rows, last]
    cache = _cache_from_sown(kvs, lens, max_len, getattr(model, "kv_cache_dtype", "native"))
    return cache, logits  # (B, V)


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


def make_prefill(model, max_len: int, ring=None) -> Callable:
    """``prefill(prompt, prompt_lens=None) -> (cache, last_logits)``.

    ``prompt`` is (B, P) int tokens on the model's device with P <=
    max_len; ``prompt_lens`` (B,) marks real lengths in a right-padded
    batch (None = full rows).  Returns the cache (K/V padded to max_len,
    cursors at the row lengths) and the (B, V) float32 logits at each
    row's last real position.  ``ring`` (a ``parallel.ring_attention``
    callable over a serving mesh's cp group) runs the prompt sharded over
    its ranks (:func:`_ring_prefill_core`); every rank returns the same."""
    check_decodable(model)
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")

    @torch.no_grad()
    def prefill(prompt, prompt_lens=None):
        if prompt.shape[1] > max_len:
            raise ValueError(
                f"prompt length {prompt.shape[1]} exceeds max_len ({max_len})")
        if ring is not None:
            return _ring_prefill_core(model, ring, prompt, _lens(prompt, prompt_lens), max_len)
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
    check_decodable(model)
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")

    @torch.no_grad()
    def step(cache, tok):
        return _decode_step_core(model, cache, tok, max_len, ragged)

    return step


def init_cache(model, batch: int, max_len: int) -> dict:
    """A zeroed (batch, max_len) decode cache on the model's device, in its
    dtype (int8 with float32 ``k_scale``/``v_scale`` for
    ``kv_cache_dtype="int8"``) — the serving engine's slot cache before
    any admission.  A model cut for tensor parallelism gets the heads its
    blocks attend over on this rank: its H_kv / tp where tp divides the
    heads (``tensor_parallel.kv_cache_rule``), all of them on the generic
    path."""
    shape = (batch, max_len, attention_heads(model)[1], model.head_dim)
    dev = model.device
    int8 = getattr(model, "kv_cache_dtype", "native") == "int8"
    store = torch.int8 if int8 else model.dtype
    scale = shape[:3]

    def entry():
        e = {"k": torch.zeros(shape, dtype=store, device=dev),
             "v": torch.zeros(shape, dtype=store, device=dev)}
        if int8:
            e["k_scale"] = torch.zeros(scale, dtype=torch.float32, device=dev)
            e["v_scale"] = torch.zeros(scale, dtype=torch.float32, device=dev)
        e["index"] = torch.zeros((batch,), dtype=torch.int32, device=dev)
        return e

    return {f"block_{i}": entry() for i in range(model.depth)}


def _prng():
    """serving/sampling.py's key schedule, imported at first use: the
    serving package imports this module, so a top-level import would be
    circular."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.serving import sampling

    return sampling


def _neg(logits: torch.Tensor) -> float:
    return torch.finfo(logits.dtype).min


def _filter_topp_rows(logits, top_ps):
    """Per-row nucleus filter with ``top_p`` as DATA (the keep rule of
    :func:`_filter_logits`: ranks whose PRECEDING mass is < p survive, so
    the argmax always does).  ``top_ps`` is (B,) float32; rows with
    ``top_p <= 0`` or ``>= 1`` pass through unfiltered."""
    sorted_logits = logits.sort(dim=-1, descending=True).values
    cum = torch.softmax(sorted_logits, dim=-1).cumsum(-1)
    keep = torch.cat([torch.ones_like(cum[:, :1], dtype=torch.bool),
                      cum[:, :-1] < top_ps[:, None]], dim=-1)
    cutoff = torch.where(keep, sorted_logits, torch.inf).amin(-1, keepdim=True)
    filtered = torch.where(logits < cutoff, _neg(logits), logits)
    nucleus = (top_ps > 0.0) & (top_ps < 1.0)
    return torch.where(nucleus[:, None], filtered, logits)


def _filter_topk_rows(logits, top_ks):
    """Per-row top-k filter with ``top_k`` as DATA: the k highest logits
    survive, ties at the k-th value included.  ``top_ks`` is (B,) int;
    rows with ``top_k <= 0`` or ``>= vocab`` pass through unfiltered."""
    vocab = logits.shape[-1]
    sorted_desc = logits.sort(dim=-1, descending=True).values
    k = top_ks.long().clamp(1, vocab)
    kth = sorted_desc.gather(1, (k - 1)[:, None])
    filtered = torch.where(logits < kth, _neg(logits), logits)
    on = (top_ks > 0) & (top_ks < vocab)
    return torch.where(on[:, None], filtered, logits)


def _filter_minp_rows(logits, min_ps):
    """Per-row min-p filter with ``min_p`` as DATA: tokens whose
    probability is below ``min_p * max_prob`` are cut (the argmax always
    survives, so ``min_p = 1`` is greedy).  ``min_ps`` is (B,) float32;
    rows with ``min_p <= 0`` pass through unfiltered."""
    probs = torch.softmax(logits, dim=-1)
    cutoff = min_ps[:, None] * probs.amax(-1, keepdim=True)
    filtered = torch.where(probs < cutoff, _neg(logits), logits)
    return torch.where((min_ps > 0.0)[:, None], filtered, logits)


def _tempered_rows(logits, temps, topps, topks, minps):
    """The per-row SAMPLING distribution as filtered logits: temperature
    first, then top-k, nucleus and min-p (in that order).  Rows with
    ``temps <= 0`` divide by 1 (their pick is the argmax anyway; the
    placeholder keeps the math finite)."""
    safe_t = torch.where(temps > 0.0, temps, 1.0)[:, None]
    scaled = _filter_topk_rows(logits / safe_t, topks)
    scaled = _filter_topp_rows(scaled, topps)
    return _filter_minp_rows(scaled, minps)


def _pick_rows(logits, temps, topps, topks, minps, keys, sampled: bool = True):
    """Per-row pick: (B, V) float32 logits, the (B,) ``temps`` / ``topps``
    / ``topks`` / ``minps`` planes and (B, 2) already-folded ``keys`` ->
    ``((B,) int64 token, (B,) float32 logprob)``.  Rows with ``temps <= 0``
    take the argmax; the rest draw ``categorical`` from their filtered
    logits with their own key.  ``sampled=False`` is the caller's promise
    that no row samples, which skips the filters and the key schedule
    (the tokens are the same).  The logprob is ``log_softmax`` of the RAW
    logits at the emitted token, whatever the row's sampling."""
    tok = logits.argmax(-1)
    if sampled:
        drawn = _prng().categorical(keys, _tempered_rows(logits, temps, topps, topks, minps))
        tok = torch.where(temps > 0.0, drawn, tok)
    logp = torch.log_softmax(logits, dim=-1).gather(1, tok[:, None])[:, 0]
    return tok, logp


def _decode_window_core(model, cache, tok, active, rngs, max_len: int,
                        ragged: bool, pick, pad_id: int):
    """``window = len(rngs)`` fused decode+pick steps.  ``active`` (B,)
    bool is FROZEN for the window: inactive rows still decode (the batch
    shape is fixed) but emit ``pad_id``, which is also what they feed
    back.  Returns ``(cache, (B, window) tokens, (B,) last)``."""
    toks = []
    for rng in rngs:
        cache, logits = _decode_step_core(model, cache, tok, max_len, ragged)
        tok = torch.where(active, pick(logits, rng), pad_id)
        toks.append(tok)
    return cache, torch.stack(toks, dim=1), tok


def _single_key_categorical(key, logits):
    """``jax.random.categorical(key, logits)`` with ONE key over a (B, V)
    batch: the Gumbel noise is drawn over the flattened (B * V) shape."""
    g = _prng().gumbel(key.reshape(1, 2), logits.numel()).reshape(logits.shape)
    return (g.to(logits.dtype) + logits).argmax(-1)


def _static_pick(temperature: float, top_k: int, top_p: float):
    """The offline pick for fixed sampling settings: argmax at
    temperature 0, else ``categorical(rng, filter(logits / T))``."""
    def pick(logits, rng):
        if temperature == 0.0:
            return logits.argmax(-1)
        return _single_key_categorical(
            rng, _filter_logits(logits / temperature, top_k, top_p))

    return pick


def make_decode_window(model, max_len: int, window: int, ragged: bool = True,
                       temperature: float = 0.0, top_k: int = 0,
                       top_p: float = 0.0, pad_id: int = 0) -> Callable:
    """``win(cache, tok, active=None, rngs=None) -> (cache, tokens, last)``:
    ``window`` fused decode+pick steps per call (decode-ahead), the k-step
    sibling of :func:`make_decode_step`.  ``active`` (B,) bool freezes
    which rows are live (inactive rows emit ``pad_id``); ``rngs`` is
    (window, 2) key data, one key per step (required when ``temperature >
    0``, ignored for greedy).  Greedy windows are token-identical to
    ``window`` sequential steps; the window runs on a dense or a paged
    cache alike."""
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if temperature == 0.0 and (top_k or top_p):
        raise ValueError(
            "top_k/top_p filter a SAMPLING distribution; set temperature > 0")
    pick = _static_pick(temperature, top_k, top_p)

    @torch.no_grad()
    def win(cache, tok, active=None, rngs=None):
        b = tok.shape[0]
        if active is None:
            active = torch.ones((b,), dtype=torch.bool, device=tok.device)
        if rngs is None:
            if temperature != 0.0:
                raise ValueError(
                    "temperature > 0 samples from the model — pass rngs= "
                    "((window, 2) keys, one per step)")
            rngs = torch.zeros((window, 2), dtype=torch.int64, device=tok.device)
        return _decode_window_core(model, cache, tok.long(), active,
                                   _prng().key_words(torch.as_tensor(rngs, device=tok.device)),
                                   max_len, ragged, pick, pad_id)

    return win


def _sample_window_core(model, cache, tok, active, temps, topps, topks, minps,
                        keys, pos, window: int, max_len: int, ragged: bool,
                        pad_id: int, sampled: bool = True):
    """The serving engine's decode-ahead window: ``window`` fused
    decode+pick steps with the per-row sampling planes as data.

    ``temps``/``topps``/``minps`` are (B,) float32, ``topks`` (B,) int,
    ``keys`` (B, 2) BASE keys (int64 words), ``pos`` (B,) the per-row
    count of already-generated tokens.  The token at generated index ``n``
    is picked with ``fold_in(base_key, n)`` and ``pos`` advances for
    active rows only, so a stream is a pure function of (seed, prefix)
    however the host cuts it into windows.  Inactive rows emit ``pad_id``
    and logprob 0.  ``sampled=False`` promises no row samples (see
    :func:`_pick_rows`).  Returns ``(cache, (B, window) tokens, (B, window)
    logprobs, (B,) last, (B,) new pos)``; nothing is read back."""
    fold_in = _prng().fold_in
    step = active.long()
    pos = pos.long()
    toks, logps = [], []
    for _ in range(window):
        cache, logits = _decode_step_core(model, cache, tok, max_len, ragged)
        step_keys = fold_in(keys, pos) if sampled else None
        nxt, logp = _pick_rows(logits, temps, topps, topks, minps, step_keys, sampled)
        tok = torch.where(active, nxt, pad_id)
        toks.append(tok)
        logps.append(torch.where(active, logp, 0.0))
        pos = pos + step
    return cache, torch.stack(toks, dim=1), torch.stack(logps, dim=1), tok, pos


def _set_cursor(cache: dict, index: torch.Tensor) -> None:
    """Write ``index`` into every block's ``"index"`` leaf, in place (dense,
    int8 and paged caches keep the cursor under that key alike)."""
    for entry in cache.values():
        entry["index"].copy_(index)


def _verify_prologue(model, cache, chunk, max_len: int):
    """The verify window's forward: all k chunk positions appended at each
    row's cursor.  Returns ``(cursor before, (B, k, V) logits, (B, k)
    argmax)``."""
    idx0 = next(iter(cache.values()))["index"].clone()
    logits = model(chunk, cache=cache, max_len=max_len, ragged=True)
    return idx0, logits, logits.argmax(-1)


def _verify_epilogue(cache, idx0, out, acc, active, max_len: int, pad_id: int):
    """Emit ``acc + 1`` tokens of ``out`` on active rows (``pad_id``
    elsewhere), rewind every cursor in place to ``min(idx0 + acc + 1,
    max_len)`` (``idx0`` for inactive rows) and return ``(tokens, emit
    mask, last)``."""
    k = out.shape[1]
    n_emit = torch.where(active, acc + 1, 0)
    emit = active[:, None] & (torch.arange(k, device=out.device)[None, :] < n_emit[:, None])
    toks = torch.where(emit, out, pad_id)
    last = toks.gather(1, (n_emit - 1).clamp(min=0)[:, None])[:, 0]
    last = torch.where(active, last, pad_id)
    _set_cursor(cache, (idx0 + n_emit).clamp(max=max_len).to(torch.int32))
    return toks, emit, last


def _verify_window_core(model, cache, chunk, draft_lens, active, max_len: int,
                        pad_id: int):
    """ONE forward over a (B, k) proposed chunk: the greedy speculative
    verify, sibling of :func:`_decode_window_core`.

    ``chunk[:, 0]`` is each row's pending last token (not yet in the
    cache), ``chunk[:, 1:]`` up to k-1 drafts, ``draft_lens`` (B,) the
    real drafts a row holds.  Draft j is accepted iff every earlier one was
    and the model's argmax after ``chunk[:, :j+1]`` equals it, so the
    emitted tokens, the argmax chain ``preds[:, :acc+1]``, are exactly what
    sequential greedy decode emits.  The cursor, advanced to ``idx0 + k``
    by the forward, rewinds in place to ``idx0 + acc + 1``; the positions
    past it hold garbage the next chunk overwrites before anything attends
    them.  Returns ``(cache, (B, k) tokens, (B,) accepted, (B,) last)``."""
    chunk = chunk.long()
    k = chunk.shape[1]
    idx0, _, preds = _verify_prologue(model, cache, chunk, max_len)
    lanes = torch.arange(k - 1, device=chunk.device)[None, :]
    match = (preds[:, :-1] == chunk[:, 1:]) & (lanes < draft_lens[:, None])
    acc = torch.where(active, match.long().cumprod(1).sum(1), 0)
    toks, _, last = _verify_epilogue(cache, idx0, preds, acc, active, max_len, pad_id)
    return cache, toks, acc, last


def make_verify_window(model, max_len: int, draft_len: int,
                       pad_id: int = 0) -> Callable:
    """``verify(cache, chunk, draft_lens, active=None) -> (cache, tokens,
    accepted, last)``: the greedy speculative verify, ``k = draft_len + 1``
    positions a call (see :func:`_verify_window_core`).  Token-identical to
    plain greedy decode whatever the drafts; the cache may be dense, int8
    or paged."""
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")
    if draft_len < 1:
        raise ValueError(f"draft_len must be >= 1, got {draft_len}")
    k = draft_len + 1

    @torch.no_grad()
    def verify(cache, chunk, draft_lens, active=None):
        b, kk = chunk.shape
        if kk != k:
            raise ValueError(f"chunk must be (B, draft_len+1={k}), got (B, {kk})")
        if active is None:
            active = torch.ones((b,), dtype=torch.bool, device=chunk.device)
        return _verify_window_core(model, cache, chunk, draft_lens.long(), active,
                                   max_len, pad_id)

    return verify


def _verify_sample_core(model, cache, chunk, draft_lens, active, temps, topps,
                        topks, minps, keys, pos, max_len: int, pad_id: int,
                        sampled: bool = True):
    """The serving engine's speculative verify with REJECTION SAMPLING,
    the sampling sibling of :func:`_verify_window_core` (one forward, the
    same chunk contract and cursor rewind).

    Draft ``d_j`` of a sampled row is accepted with probability
    ``p_j(d_j)`` (the drafter is a point mass, so ``min(1, p/q) = p``)
    against a uniform draw; the first rejected lane emits a sample of the
    residual (``p_j`` with ``d_j`` cut), a fully accepted chunk its bonus
    token sampled plainly, so the emitted stream is distributed as plain
    sampling.  The token at generated index ``n`` owns ``K_n =
    fold_in(base, n)``: plain and bonus draws use ``K_n``, the accept
    uniform ``fold_in(K_n, 1)``, the residual ``fold_in(K_n, 2)``.  Rows
    with ``temps <= 0`` take the greedy core's argmax match exactly;
    ``sampled=False`` promises no row samples and skips the key schedule
    (the tokens are the same).  Returns ``(cache, (B, k) tokens, (B, k)
    logprobs, (B,) accepted, (B,) last)``; logprobs are ``log_softmax`` of
    the raw logits at the emitted tokens, 0 elsewhere."""
    chunk = chunk.long()
    b, k = chunk.shape
    dl = k - 1
    dev = chunk.device
    draft_lens = draft_lens.long()
    idx0, logits, preds = _verify_prologue(model, cache, chunk, max_len)
    d = chunk[:, 1:]
    valid = torch.arange(dl, device=dev)[None, :] < draft_lens[:, None]
    accept = preds[:, :-1] == d
    cand = preds
    if sampled:
        ks = _prng()
        vocab = logits.shape[-1]
        rep = lambda x: x.repeat_interleave(k)  # noqa: E731 - per position
        filt = _tempered_rows(logits.reshape(b * k, vocab), rep(temps), rep(topps),
                              rep(topks), rep(minps)).reshape(b, k, vocab)
        probs = torch.softmax(filt, dim=-1)
        posj = pos.long()[:, None] + torch.arange(k, device=dev)[None, :]
        pick_key = ks.fold_in(keys.repeat_interleave(k, dim=0), posj.reshape(-1))
        u_key = ks.fold_in(pick_key, torch.ones_like(posj.reshape(-1)))
        res_key = ks.fold_in(pick_key, torch.full_like(posj.reshape(-1), 2))
        u = ks.uniform(u_key).reshape(b, k)
        p_draft = probs[:, :-1].gather(-1, d[..., None])[..., 0]
        hot = temps[:, None] > 0.0
        accept = torch.where(hot, u[:, :dl] < p_draft, accept)
        # a candidate at every position: the residual resample where a draft
        # could have been rejected, a plain sample past the drafts; only
        # position acc is ever emitted
        res_logits = torch.where(
            torch.nn.functional.one_hot(d, vocab).bool(), _neg(filt), filt[:, :dl])
        cand_res = ks.categorical(res_key.reshape(b, k, 2)[:, :dl].reshape(b * dl, 2),
                                  res_logits.reshape(b * dl, vocab)).reshape(b, dl)
        cand_plain = ks.categorical(pick_key, filt.reshape(b * k, vocab)).reshape(b, k)
        cand_res = torch.cat([cand_res, torch.full((b, 1), pad_id, device=dev)], 1)
        jidx = torch.arange(k, device=dev)[None, :]
        cand = torch.where(jidx < draft_lens[:, None], cand_res, cand_plain)
        cand = torch.where(hot, cand, preds)
    acc = torch.where(active, (accept & valid).long().cumprod(1).sum(1), 0)
    jidx = torch.arange(k, device=dev)[None, :]
    drafts_pad = torch.cat([d, torch.full((b, 1), pad_id, device=dev)], 1)
    out = torch.where(jidx < acc[:, None], drafts_pad,
                      torch.where(jidx == acc[:, None], cand, pad_id))
    toks, emit, last = _verify_epilogue(cache, idx0, out, acc, active, max_len, pad_id)
    logps = torch.log_softmax(logits, dim=-1).gather(-1, toks[..., None])[..., 0]
    return cache, toks, torch.where(emit, logps, 0.0), acc, last


def _filter_logits(logits, top_k: int, top_p: float):
    """The offline generator's filters on (B, V) logits: ``top_k > 0``
    keeps the k highest logits; ``0 < top_p < 1`` keeps the smallest set
    of tokens whose softmax mass reaches p (nucleus), always including the
    argmax.  Both compose (k first, then p); cut tokens get the dtype's
    lowest value."""
    if top_k > 0:
        kth = logits.topk(top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, _neg(logits), logits)
    if 0.0 < top_p < 1.0:
        b = logits.shape[0]
        logits = _filter_topp_rows(
            logits, torch.full((b,), top_p, dtype=torch.float32, device=logits.device))
    return logits


def make_generator(model, max_len: int, max_new: int, temperature: float = 0.0,
                   top_k: int = 0, top_p: float = 0.0,
                   eos_id: int | None = None, pad_id: int = 0,
                   with_lengths: bool = False) -> Callable:
    """``gen(prompt, prompt_lens=None, rng=None) -> (B, P + max_new)``.

    Row b of the result is ``prompt[b, :len_b]``, then up to ``max_new``
    generated tokens, then ``pad_id``.  ``eos_id`` stops a row at its EOS
    (kept in the output; later slots are ``pad_id``) and the loop ends once
    every row has stopped.  ``with_lengths=True`` also returns the (B,)
    count of real generated tokens per row.  ``prompt_lens=None`` decodes
    with the shared cursor, a ragged batch with per-row cursors.

    ``temperature == 0`` decodes greedily; otherwise ``logits /
    temperature`` are filtered by ``top_k`` and/or ``top_p`` and sampled
    with ``rng`` (an int seed or (2,) uint32 key data) on JAX's schedule:
    ``split(rng, max_new)``, one key per generated position, each drawing
    Gumbel noise over the whole (B, V) batch."""
    check_decodable(model)
    if max_new < 1:
        raise ValueError(f"max_new must be >= 1, got {max_new}")
    if temperature == 0.0 and (top_k or top_p):
        raise ValueError(
            "top_k/top_p filter a SAMPLING distribution; set temperature > 0")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    if not 0.0 <= top_p <= 1.0:
        raise ValueError(f"top_p must be in [0, 1], got {top_p}")
    if eos_id is not None and eos_id == pad_id:
        raise ValueError(
            f"eos_id and pad_id must differ (both {eos_id}): a pad fed back "
            "after a stop would immediately re-trigger the stop logic")
    pick = _static_pick(temperature, top_k, top_p)

    @torch.no_grad()
    def gen(prompt, prompt_lens=None, rng=None):
        b, p = prompt.shape
        if p + max_new > max_len:
            raise ValueError(
                f"prompt ({p}) + max_new ({max_new}) exceeds max_len ({max_len})")
        if rng is None and temperature != 0.0:
            raise ValueError(
                "temperature > 0 samples from the model — pass rng= (an int "
                "seed or (2,) uint32 key data)")
        lens = _lens(prompt, prompt_lens)
        if prompt_lens is not None and (lens.shape != (b,) or int(lens.min()) < 1
                                        or int(lens.max()) > p):
            raise ValueError(
                f"prompt_lens must be ({b},) lengths in [1, P={p}], got "
                f"{lens.tolist()}")
        dev = prompt.device
        ks = _prng()
        rngs = ks.split(ks.key_words(ks.rng_key(0 if rng is None else rng)).to(dev), max_new)
        cache, last = _prefill_core(model, prompt, lens, max_len)
        tok = pick(last, rngs[0])
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
            nxt = pick(logits, rngs[t])
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


def generate(model, prompt, max_new: int, max_len: int | None = None,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
             rng=None, eos_id: int | None = None, pad_id: int = 0,
             prompt_lens=None, with_lengths: bool = False):
    """One-shot convenience over :func:`make_generator`; a 1-D ``prompt``
    is one row."""
    prompt = torch.as_tensor(prompt, device=model.device)
    if prompt.ndim == 1:
        prompt = prompt[None, :]
    if max_len is None:
        max_len = int(prompt.shape[1]) + max_new
    return make_generator(model, max_len, max_new, temperature, top_k, top_p,
                          eos_id=eos_id, pad_id=pad_id, with_lengths=with_lengths)(
        prompt, rng=rng, prompt_lens=prompt_lens)
