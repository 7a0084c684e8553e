"""Autoregressive decoding with KV caches (greedy / temperature sampling).

The JAX package's ``infer/decode.py`` runs the loop as one
``lax.while_loop`` under ``jit``. Here the loop runs in chunks of
``_SYNC_EVERY`` steps over static device state (:class:`GreedyState`): a
token buffer padded by one chunk, a per-row position ``pos`` (B,) int32,
per-stream EOT flags and the summed logprob, all updated in place. One
chunk body (:func:`make_greedy_chunk`) is what the CPU runs eagerly and
what the card captures once as a CUDA graph and replays
(``infer/graphs.py``), so both run the same kernels in the same order. The
host waits on the device only for the early-exit check, which reads
``finished.all()`` once per chunk; every row sits at the same position, so
the host knows it without reading it. The steps of the last chunk that run
past ``max_len`` write the padding and add nothing to ``sum_logprob``: the
outputs are those of a loop that stops at ``max_len``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

NEG_INF = torch.finfo(torch.float32).min
# Steps between two early-exit checks (each one a host-device sync), and
# the steps of one chunk. Streams that finished keep emitting EOT, so the
# tokens are the same as with a check after every step; fewer than this
# many steps run after the last stream ends.
_SYNC_EVERY = 8


def make_whisper_step_fn(model, cross_kvs):
    """step_fn(tokens, caches, pos) -> (ALL-position f32 logits (B, S, V),
    caches). The prefill logits also carry the <|nospeech|> distribution at
    the SOT position."""

    def step(tokens, caches, pos):
        return model.decode_step(tokens, caches, cross_kvs, pos)

    return step


def make_yoho_step_fn(model, cross_kvs):
    """The same contract for the YOHO model; the step computes no
    voiceprints (they come from one teacher-forced pass after decoding,
    ``infer/speaker_pass.py``)."""

    def step(tokens, caches, pos):
        logits, _vp, caches = model.decode_step(tokens, caches, cross_kvs, pos,
                                                with_voiceprints=False)
        return logits, caches

    return step


def suppress_index(suppress_ids, device) -> Optional[torch.Tensor]:
    """The suppressed ids as a tensor on ``device``, made once a decode (a
    host list copied to the card at every step would be a host sync at
    every step); None for no ids."""
    if not len(suppress_ids):
        return None
    return torch.as_tensor(list(suppress_ids), dtype=torch.long, device=device)


def _suppress(logits: torch.Tensor, index: Optional[torch.Tensor]) -> torch.Tensor:
    """``logits`` with the ids of :func:`suppress_index`'s ``index`` at -inf."""
    return logits if index is None else logits.index_fill(1, index, NEG_INF)


def _sample(probs: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row from ``probs`` (B, V): ``torch.multinomial``'s own
    algorithm for one sample (argmax of p / q, q ~ Exp(1), from the same
    generator calls), without its validity checks, which read the device
    from the host and so cannot run inside a captured graph."""
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / q, dim=-1)


@dataclass(eq=False)
class GreedyState:
    """The greedy loop's device state, updated in place: ``tokens`` (B,
    max_len + _SYNC_EVERY) int64 (the last chunk's steps past ``max_len``
    write the padding), ``pos`` (B,) int32 the index of the last decided
    token, ``finished`` (B,) bool and ``sum_lp`` (B,) f32."""

    tokens: torch.Tensor
    pos: torch.Tensor
    finished: torch.Tensor
    sum_lp: torch.Tensor

    @classmethod
    def empty(cls, batch: int, max_len: int, device) -> "GreedyState":
        return cls(
            tokens=torch.empty((batch, max_len + _SYNC_EVERY), dtype=torch.long,
                               device=device),
            pos=torch.zeros((batch,), dtype=torch.int32, device=device),
            finished=torch.zeros((batch,), dtype=torch.bool, device=device),
            sum_lp=torch.zeros((batch,), dtype=torch.float32, device=device))

    @property
    def max_len(self) -> int:
        return self.tokens.shape[1] - _SYNC_EVERY


def make_pick(suppress: Optional[torch.Tensor], logits_fn: Optional[Callable],
              temperature: float, generator: Optional[torch.Generator],
              with_logprob: bool) -> Callable:
    """``pick(logits (B, V), tokens, pos) -> (next ids, logprob)``: the
    suppression, ``logits_fn`` (which sees the token buffer and ``pos``,
    the index about to be generated: an int or a per-row tensor), then the
    argmax or, above temperature 0, a draw; the logprob of the pick under
    the processed logits with ``with_logprob``, else zeros."""

    def pick(logits, tokens, pos):
        logits = _suppress(logits.float(), suppress)
        if logits_fn is not None:
            logits = logits_fn(logits, tokens, pos)
        if temperature > 0.0:
            nxt = _sample(torch.softmax(logits / temperature, dim=-1), generator)
        else:
            nxt = torch.argmax(logits, dim=-1)
        if with_logprob:
            lp = torch.log_softmax(logits, dim=-1).gather(1, nxt[:, None])[:, 0]
        else:
            lp = torch.zeros(nxt.shape, dtype=torch.float32, device=nxt.device)
        return nxt, lp

    return pick


def make_greedy_chunk(step_fn: Callable, caches, state: GreedyState, pick: Callable,
                      eot_id: int) -> Callable:
    """``chunk()``: ``_SYNC_EVERY`` decode steps over ``state``, in place,
    reading nothing back to the host. Each step feeds every row's last
    decided token at its own ``pos`` (the caches, the decode kernel and the
    logit rules take the per-row vector), writes the pick at ``pos + 1``
    and advances ``pos``; a finished row writes EOT, and only a row that is
    unfinished at a step below ``max_len`` adds to ``sum_lp``."""
    tokens, pos, finished, sum_lp = state.tokens, state.pos, state.finished, state.sum_lp
    max_len = state.max_len

    def chunk() -> None:
        for _ in range(_SYNC_EVERY):
            cur = tokens.gather(1, pos.long()[:, None])
            logits, _ = step_fn(cur, caches, pos)
            nxt_pos = pos + 1
            nxt, lp = pick(logits[:, -1], tokens, nxt_pos)
            nxt = torch.where(finished, eot_id, nxt)
            sum_lp.add_(torch.where(finished | (nxt_pos >= max_len), 0.0, lp))
            tokens.scatter_(1, nxt_pos.long()[:, None], nxt[:, None])
            finished.logical_or_(nxt == eot_id)
            pos.add_(1)

    return chunk


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
    program=None,
):
    """Decode up to ``max_len`` total tokens (prompt included).

    Returns ``(tokens (B, max_len) int64, lengths (B,) int64)``; after a
    stream emits ``eot_id`` its remaining positions hold ``eot_id``, and
    ``lengths`` counts tokens up to and including EOT. ``logits_fn(logits,
    tokens, pos)`` post-processes the f32 logits of each step (timestamp
    rules); ``pos`` is an int at the prefill's pick and a per-row (B,)
    tensor in the chunks. ``return_aux=True`` adds ``sum_logprob`` (EOT
    included) and, with ``no_speech_id``, ``no_speech_prob`` read at
    ``sot_index``.

    ``program``: None runs the chunk body eagerly over a state made here.
    Otherwise a ``graphs.ChunkGraph`` whose ``state`` is a
    :class:`GreedyState` of this batch and ``max_len``: its body is built
    from the first call's arguments (later calls pass the same caches and
    cross-K/V, and the same ``generator``) and each chunk goes through it.
    The prefill (S = P) runs eagerly before the first chunk either way.
    """
    b, p = prompt.shape
    if p >= max_len:
        raise ValueError("prompt must be shorter than max_len")
    dev = prompt.device
    if program is None:
        state = GreedyState.empty(b, max_len, dev)
    else:
        state = program.state
        if state.tokens.shape != (b, max_len + _SYNC_EVERY):
            raise ValueError(f"program state {tuple(state.tokens.shape)} is not for "
                             f"batch {b} at max_len {max_len}")
    tokens, pos, finished, sum_lp = state.tokens, state.pos, state.finished, state.sum_lp
    tokens.fill_(eot_id)
    tokens[:, :p] = prompt
    pick = make_pick(suppress_index(suppress_ids, dev), logits_fn, temperature,
                     generator, return_aux)
    if program is None:
        run = make_greedy_chunk(step_fn, caches, state, pick, eot_id)
    else:
        if program.body is None:
            program.body = make_greedy_chunk(step_fn, caches, state, pick, eot_id)
        run = program

    # Prefill the whole prompt in one step; pick the first new token.
    logits_all, _ = step_fn(tokens[:, :p], caches, 0)
    no_speech_prob = None
    if no_speech_id is not None:
        src = logits_all[:, sot_index if sot_index is not None else -1]
        no_speech_prob = torch.softmax(src.float(), dim=-1)[:, no_speech_id]
    first, lp0 = pick(logits_all[:, -1], tokens, p)
    tokens[:, p] = first
    finished.copy_(first == eot_id)
    sum_lp.copy_(lp0)
    pos.fill_(p)

    at = p  # every row's position: the host's copy, never read back
    while at + 1 < max_len and not bool(finished.all()):
        run()
        at += _SYNC_EVERY

    # Length = index of the first EOT at/after the prompt, +1 (EOT
    # included); streams that never emitted EOT get max_len.
    out = tokens[:, :max_len].clone()
    is_eot = out[:, p:] == eot_id
    first_eot = is_eot.to(torch.int8).argmax(dim=1)
    lengths = torch.where(is_eot.any(dim=1), p + first_eot + 1, max_len)
    if return_aux:
        aux = {"sum_logprob": sum_lp.clone()}
        if no_speech_prob is not None:
            aux["no_speech_prob"] = no_speech_prob
        return out, lengths, aux
    return out, lengths
