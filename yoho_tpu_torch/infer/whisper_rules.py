"""Whisper timestamp decoding rules as a logits processor.

OpenAI's ``ApplyTimestampRules`` over (B, V) float32 logits and the token
buffer, line for line with the JAX package's ``infer/whisper_rules.py``:

  1. pairing: after a lone generated timestamp (including the forced
     initial one) timestamps are suppressed so text follows; after a
     ``text <|t|>`` close, text is suppressed so ``<|t|><|t|>`` or EOT
     follows;
  2. timestamps never decrease, and strictly increase except when the
     pair's second timestamp is due;
  3. the first generated token is a timestamp, at most
     ``max_initial_timestamp`` seconds (None disables the cap);
  4. when the total probability of timestamps beats the best
     non-timestamp token (EOT included), a timestamp is forced.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from yoho_tpu_torch.ops.decode_attention import is_row_pos

NEG_INF = torch.finfo(torch.float32).min


def make_timestamp_rules(table, prompt_len: int,
                         max_initial_timestamp: Optional[float] = 1.0
                         ) -> Callable:
    """Returns ``fn(logits (B, V) f32, tokens (B, T), pos) -> logits``;
    ``pos`` is the buffer index of the token about to be generated: an int
    (every row at the same index: the batched decode loop) or a per-row
    (B,) tensor (continuous batching), read on the device only."""
    ts_begin = table.timestamp_begin
    eot = table.eot
    max_initial_offset = (None if max_initial_timestamp is None
                          else int(round(max_initial_timestamp / 0.02)))

    def fn(logits: torch.Tensor, tokens: torch.Tensor, pos) -> torch.Tensor:
        b, v = logits.shape
        dev = logits.device
        vocab_ids = torch.arange(v, device=dev)
        is_ts_vocab = vocab_ids >= ts_begin
        # Plain text is [0, eot); the probability rule compares against
        # ALL non-timestamp ids [0, ts_begin), EOT and specials included.
        is_text_vocab = vocab_ids < eot

        rows = is_row_pos(pos)
        if rows:
            p = pos.long()
            last = tokens.gather(1, (p - 1)[:, None])[:, 0]
            penult = tokens.gather(1, torch.clamp(p - 2, min=0)[:, None])[:, 0]
            last_is_ts = (last >= ts_begin) & (p - 1 >= prompt_len)
            penult_is_ts = (p - 2 < prompt_len) | (penult >= ts_begin)
            pos_col = p[:, None]
        else:
            last_is_ts = tokens[:, pos - 1] >= ts_begin
            if pos - 1 < prompt_len:
                last_is_ts = torch.zeros_like(last_is_ts)
            # OpenAI: penultimate_was_timestamp = len(sampled) < 2 or
            # sampled[-2] >= ts_begin.
            penult_is_ts = tokens[:, pos - 2] >= ts_begin
            if pos - 2 < prompt_len:
                penult_is_ts = torch.ones_like(penult_is_ts)
            pos_col = pos

        needs_second = last_is_ts & ~penult_is_ts
        after_pair = last_is_ts & penult_is_ts
        mask = ((needs_second[:, None] & is_text_vocab[None, :])
                | (after_pair[:, None] & is_ts_vocab[None, :]))

        # Floor = max generated timestamp; strictly above it unless the
        # pair's second timestamp is due.
        positions = torch.arange(tokens.shape[1], device=dev)
        seen = (positions[None, :] < pos_col) & (positions[None, :] >= prompt_len)
        ts_vals = torch.where(seen & (tokens >= ts_begin), tokens, 0)
        ts_max = ts_vals.amax(dim=1)  # 0 when none seen
        ts_floor = torch.where(ts_max > 0, ts_max + (~needs_second).long(), 0)
        mask = mask | (is_ts_vocab[None, :] & (vocab_ids[None, :] < ts_floor[:, None]))

        init_mask = ~is_ts_vocab
        if max_initial_offset is not None:
            init_mask = init_mask | (vocab_ids > ts_begin + max_initial_offset)
        if rows:
            mask = torch.where((p == prompt_len)[:, None], mask | init_mask[None, :], mask)
        elif pos == prompt_len:
            mask = mask | init_mask[None, :]

        logits = logits.masked_fill(mask, NEG_INF)

        logprobs = torch.log_softmax(logits, dim=-1)
        ts_logprob = torch.logsumexp(
            logprobs.masked_fill(~is_ts_vocab[None, :], NEG_INF), dim=-1)
        max_text = logprobs.masked_fill(is_ts_vocab[None, :], NEG_INF).amax(dim=-1)
        force_ts = ts_logprob > max_text
        return logits.masked_fill(force_ts[:, None] & ~is_ts_vocab[None, :], NEG_INF)

    return fn
