"""Repetition-control logit rules as logits processors.

The JAX package's ``infer/logit_rules.py``: ``repetition_penalty``
(CTRL-style damping of tokens already generated) and
``no_repeat_ngram_size`` (a ban on completing an n-gram that already
occurred), with the semantics of transformers'
``RepetitionPenaltyLogitsProcessor`` and ``NoRepeatNGramLogitsProcessor``
over the generated region: prompt tokens are never penalized.
``bannable`` restricts both rules to plain-text ids, so they never fight
the timestamp rules (which run after them). Both rules are mask
arithmetic over the fixed-size token buffer, with no host sync.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from yoho_tpu_torch.core.device import div_exact
from yoho_tpu_torch.ops.decode_attention import is_row_pos

NEG_INF = torch.finfo(torch.float32).min


def make_repetition_rules(
    repetition_penalty: Optional[float] = None,
    no_repeat_ngram_size: int = 0,
    n_prompt: int = 0,
    bannable: Optional[np.ndarray] = None,
) -> Optional[Callable]:
    """Returns ``fn(logits (B, V) f32, tokens (B, T), pos) -> logits``
    or None when neither rule is active. ``pos`` is the buffer index about
    to be generated, an int or a per-row (B,) tensor (continuous batching,
    read on the device only): ``tokens[:, :pos]`` are decided, and
    positions ``>= n_prompt`` of them are the generated region."""
    penalty = (None if repetition_penalty in (None, 1.0)
               else float(repetition_penalty))
    n = int(no_repeat_ngram_size or 0)
    if penalty is None and n <= 1:
        return None
    if penalty is not None and penalty <= 0:
        raise ValueError(f"repetition_penalty must be > 0, got {penalty}")
    ban_const = None if bannable is None else np.asarray(bannable, bool)
    ban_on = {}  # (device, V) -> the bannable mask there, copied once

    def fn(logits: torch.Tensor, tokens: torch.Tensor, pos) -> torch.Tensor:
        b, v = logits.shape
        t = tokens.shape[1]
        dev = logits.device
        ban = ban_on.get((dev, v))
        if ban is None:
            ban = ban_on[(dev, v)] = (
                torch.ones((v,), dtype=torch.bool, device=dev) if ban_const is None
                else torch.as_tensor(ban_const[:v], device=dev))
        idx = torch.arange(t, device=dev)
        rows = is_row_pos(pos)
        pos_col = pos.long()[:, None] if rows else pos  # (B, 1) or an int
        if penalty is not None:
            # Generated ids scattered into a (B, V) "seen" mask; column V
            # takes the positions outside the generated region.
            gen = (idx[None, :] >= n_prompt) & (idx[None, :] < pos_col)
            hist = torch.where(gen, tokens, v)
            seen = torch.zeros((b, v + 1), dtype=torch.bool, device=dev).scatter_(
                1, hist, True)[:, :v] & ban
            logits = torch.where(
                seen, torch.where(logits > 0, div_exact(logits, penalty),
                                  logits * penalty), logits)
        if n > 1:
            # The (n-1)-gram about to be completed, against every window
            # of n-1 tokens of the history.
            last_idx = torch.clamp(pos_col - (n - 1) + torch.arange(n - 1, device=dev),
                                   0, t - 1)
            last = tokens.gather(1, last_idx) if rows else tokens[:, last_idx]
            win = torch.stack([tokens[:, j: t - n + 1 + j] for j in range(n - 1)],
                              dim=-1)
            match = (win == last[:, None, :]).all(dim=-1)
            j_idx = idx[: t - n + 1]
            valid = (match & (j_idx >= n_prompt)[None, :]
                     & (j_idx[None, :] + n - 1 < pos_col))
            if rows:  # no ban until a row has n-1 generated tokens
                valid = valid & (pos_col - (n - 1) >= n_prompt)
            elif pos - (n - 1) < n_prompt:  # fewer than n-1 tokens generated
                valid = torch.zeros_like(valid)
            follow = tokens[:, n - 1:]
            banned = torch.zeros((b, v + 1), dtype=torch.bool, device=dev).scatter_(
                1, torch.where(valid, follow, v), True)[:, :v] & ban
            logits = logits.masked_fill(banned, NEG_INF)
        return logits

    return fn
