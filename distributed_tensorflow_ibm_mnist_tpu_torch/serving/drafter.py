"""Model-free n-gram (prompt-lookup) drafting for speculative decoding.

The port's copy of the JAX package's ``serving/drafter.py`` (host-side
numpy, so it carries over unchanged).  Served text repeats itself
(retrieved context quoted back, identifiers, templates): the most recent
earlier occurrence of the context's suffix n-gram predicts what comes
next.  A draft is only a proposal: the verify window (core/generate.py
``_verify_sample_core``) accepts exactly what the target model reproduces
(greedy) or what rejection sampling keeps (sampled), so a bad draft costs
verify lanes, never a wrong token.
"""

from __future__ import annotations

import numpy as np


class NgramDrafter:
    """Prompt-lookup drafter: propose the continuation of the most recent
    earlier occurrence of the context's suffix n-gram.

    For ``n`` from ``max_ngram`` down to ``min_ngram`` the last n tokens
    are the pattern; the first n with an earlier occurrence wins, and the
    ``draft_len`` tokens after that occurrence are proposed.  A match
    ``p`` tokens before the suffix means the stream is locally
    ``p``-periodic, so the proposal extends PERIODICALLY past the end of
    the context (token ``j`` is token ``j - p``, reading back into the
    draft itself).  No match returns an empty draft: the verify window
    still emits its one token.  ``max_context`` bounds the searched
    suffix (0 = unbounded)."""

    def __init__(self, draft_len: int, max_ngram: int = 3,
                 min_ngram: int = 1, max_context: int = 4096):
        if draft_len < 1:
            raise ValueError(f"draft_len must be >= 1, got {draft_len}")
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"{min_ngram}/{max_ngram}")
        if max_context < 0:
            raise ValueError(f"max_context must be >= 0, got {max_context}")
        self.draft_len = int(draft_len)
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)
        self.max_context = int(max_context)

    def draft(self, context) -> np.ndarray:
        """Up to ``draft_len`` proposed continuations of ``context`` (1-D
        ints: the prompt and every generated token, the last of which is
        the pending token the verify chunk leads with), as int32; possibly
        empty."""
        ctx = np.asarray(context, np.int32).ravel()
        if self.max_context and ctx.size > self.max_context:
            ctx = ctx[-self.max_context:]
        n_ctx = ctx.size
        for n in range(self.max_ngram, self.min_ngram - 1, -1):
            if n_ctx <= n:  # the pattern needs at least one earlier slot
                continue
            pat = ctx[-n:]
            # every window equal to the suffix, the suffix itself excluded
            wins = np.lib.stride_tricks.sliding_window_view(ctx[:-1], n)
            hits = np.nonzero((wins == pat[None, :]).all(axis=1))[0]
            if hits.size == 0:
                continue
            period = (n_ctx - n) - int(hits[-1])  # suffix start - match start
            out = np.empty((self.draft_len,), np.int32)
            for i in range(self.draft_len):
                j = n_ctx - period + i
                out[i] = ctx[j] if j < n_ctx else out[i - period]
            return out
        return np.zeros((0,), np.int32)
