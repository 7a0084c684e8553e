"""Autoregressive decoding with KV caches (greedy / temperature sampling).

The JAX package's ``infer/decode.py`` runs the loop as one
``lax.while_loop`` under ``jit``. PyTorch runs eagerly, so here the loop is
Python over device tensors with the same state: a static-shape token
buffer, per-layer caches, per-stream EOT tracking and the summed logprob.
The host waits on the device only for the early-exit check, which reads
``finished.all()`` once every ``_SYNC_EVERY`` steps.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

NEG_INF = torch.finfo(torch.float32).min
# Steps between two early-exit checks (each one a host-device sync).
# Streams that finished keep emitting EOT, so the tokens are the same as
# with a check after every step; fewer than this many steps run after the
# last stream ends.
_SYNC_EVERY = 8


def make_whisper_step_fn(model, cross_kvs):
    """step_fn(tokens, caches, pos) -> (ALL-position f32 logits (B, S, V),
    caches). The prefill logits also carry the <|nospeech|> distribution at
    the SOT position."""

    def step(tokens, caches, pos):
        return model.decode_step(tokens, caches, cross_kvs, pos)

    return step


def _suppress(logits: torch.Tensor, suppress_ids) -> torch.Tensor:
    if len(suppress_ids):
        ids = torch.as_tensor(list(suppress_ids), dtype=torch.long,
                              device=logits.device)
        logits = logits.index_fill(1, ids, NEG_INF)
    return logits


def greedy_decode(
    step_fn: Callable,
    caches,
    prompt: torch.Tensor,  # (B, P) — same prompt length for all streams
    max_len: int,
    eot_id: int,
    suppress_ids: Sequence[int] = (),
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    logits_fn: Optional[Callable] = None,
    return_aux: bool = False,
    no_speech_id: Optional[int] = None,
    sot_index: Optional[int] = None,
):
    """Decode up to ``max_len`` total tokens (prompt included).

    Returns ``(tokens (B, max_len) int64, lengths (B,) int64)``; after a
    stream emits ``eot_id`` its remaining positions hold ``eot_id``, and
    ``lengths`` counts tokens up to and including EOT. ``logits_fn(logits,
    tokens, pos)`` post-processes the f32 logits of each step (timestamp
    rules). ``return_aux=True`` adds ``sum_logprob`` (EOT included) and,
    with ``no_speech_id``, ``no_speech_prob`` read at ``sot_index``.
    """
    b, p = prompt.shape
    if p >= max_len:
        raise ValueError("prompt must be shorter than max_len")
    dev = prompt.device
    tokens = torch.full((b, max_len), eot_id, dtype=torch.long, device=dev)
    tokens[:, :p] = prompt

    # Prefill the whole prompt in one step; pick the first new token.
    logits_all, caches = step_fn(tokens[:, :p], caches, 0)
    no_speech_prob = None
    if no_speech_id is not None:
        src = logits_all[:, sot_index if sot_index is not None else -1]
        no_speech_prob = torch.softmax(src.float(), dim=-1)[:, no_speech_id]

    def pick(logits, pos):
        logits = _suppress(logits.float(), suppress_ids)
        if logits_fn is not None:
            logits = logits_fn(logits, tokens, pos)
        if temperature > 0.0:
            probs = torch.softmax(logits / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        if return_aux:
            lp = torch.log_softmax(logits, dim=-1).gather(1, nxt[:, None])[:, 0]
        else:
            lp = torch.zeros((b,), dtype=torch.float32, device=dev)
        return nxt, lp

    first, sum_lp = pick(logits_all[:, -1], p)
    tokens[:, p] = first
    finished = first == eot_id

    pos = p
    while pos + 1 < max_len:
        if (pos - p) % _SYNC_EVERY == 0 and bool(finished.all()):
            break
        logits, caches = step_fn(tokens[:, pos:pos + 1], caches, pos)
        nxt, lp = pick(logits[:, -1], pos + 1)
        nxt = torch.where(finished, eot_id, nxt)
        sum_lp = sum_lp + torch.where(finished, 0.0, lp)
        tokens[:, pos + 1] = nxt
        finished = finished | (nxt == eot_id)
        pos += 1

    # Length = index of the first EOT at/after the prompt, +1 (EOT
    # included); streams that never emitted EOT get max_len.
    is_eot = tokens[:, p:] == eot_id
    first_eot = is_eot.to(torch.int8).argmax(dim=1)
    lengths = torch.where(is_eot.any(dim=1), p + first_eot + 1, max_len)
    if return_aux:
        aux = {"sum_logprob": sum_lp}
        if no_speech_prob is not None:
            aux["no_speech_prob"] = no_speech_prob
        return tokens, lengths, aux
    return tokens, lengths
