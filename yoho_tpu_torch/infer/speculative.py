"""Speculative greedy decoding (draft proposes, target verifies).

The JAX package's ``infer/speculative.py``: a small draft model proposes
``gamma`` tokens one at a time; the target checks all of them in one cached
decode step of S = gamma + 1 queries and commits the longest prefix it
agrees with plus one token of its own. The committed tokens are the
target's greedy tokens for any weights; only the number of target steps
changes.

JAX runs the rounds as one ``lax.while_loop`` with a traced write cursor.
PyTorch runs eagerly, and the decode kernel, the cache writes and the logit
rules take the cursor as a Python ``int``, so here the rounds are a host
loop: each round reads its commit count ``m`` and the all-finished flag
back from the device in one transfer, one host sync per round of up to
gamma + 1 tokens, and none elsewhere in the loop. Everything else is the
JAX design:

* both models share absolute cache positions; entries written past the
  commit point are invisible to later reads (causal mask) and are
  overwritten before they could be seen;
* the draft's first step of a round feeds two tokens (S = 2) at ``c - 2``:
  an idempotent rewrite that also fills the one-position cache gap a fully
  accepted round leaves behind;
* the batch runs in lockstep: ``m`` is the minimum acceptance over the
  unfinished streams, plus 1; every stream commits its own greedy tokens
  ``[p_0 .. p_{m-2}, g_{m-1}]``;
* the proposals are written into the token buffer before the rules see it,
  so ``logits_fn`` reads the context target greedy would read on the
  accepted prefix (the rules read only positions below their ``pos``); the
  committed block then overwrites them.

A batch whose every stream ends at its first token still runs one round,
which commits only end-of-text: testing for it would cost a second sync.

In bf16 the S = 1 and S = gamma + 1 products tile differently, so argmax
can flip inside logit ties of the last bits; token equality with greedy is
a float32 property, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from yoho_tpu_torch.infer.decode import _suppress, make_whisper_step_fn, suppress_index

# The target's verify step and the draft's step both need the logits of
# every input position, which the whisper step already returns.
make_verify_step_fn = make_whisper_step_fn


def _cache_len(caches) -> int:
    return min(c.max_len for c in caches)


def speculative_greedy_decode(
    target_step: Callable,  # (tokens (B, S), caches, pos) -> ((B, S, V), caches)
    draft_step: Callable,
    target_caches,
    draft_caches,
    prompt: torch.Tensor,  # (B, P), P >= 1
    max_len: int,
    eot_id: int,
    gamma: int = 4,
    suppress_ids: Sequence[int] = (),
    return_aux: bool = False,
    no_speech_id: Optional[int] = None,
    sot_index: Optional[int] = None,
    logits_fn: Optional[Callable] = None,
    stats: Optional[dict] = None,
):
    """Returns ``(tokens (B, max_len) int64, lengths (B,) int64)`` with the
    semantics of ``greedy_decode`` on the target model.

    Both cache sets must hold ``max_len + gamma + 2`` positions (the
    stale-write workspace past the horizon). ``return_aux`` adds
    ``sum_logprob``, the logprob of the committed tokens under the
    processed target logits with greedy's convention (up to and including
    a stream's first EOT, nothing past ``max_len``), and, with
    ``no_speech_id``, ``no_speech_prob`` from the target's prefill at
    ``sot_index``. ``logits_fn(logits (B, V), tokens, pos)`` is greedy's
    post-processor contract. ``stats``, when given, gains the counts of
    ``rounds``, ``committed`` tokens per stream (the sum of the rounds'
    ``m``) and host ``syncs``.
    """
    b, p = prompt.shape
    if not 1 <= p < max_len:
        raise ValueError(f"prompt length {p} must be in [1, {max_len})")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    ext = max_len + gamma + 2  # slack so block writes never clamp
    for name, caches in (("target", target_caches), ("draft", draft_caches)):
        if _cache_len(caches) < ext:
            raise ValueError(f"{name} caches hold {_cache_len(caches)} positions; "
                             f"speculative decoding needs max_len + gamma + 2 = {ext}")
    dev = prompt.device
    suppress = suppress_index(suppress_ids, dev)

    def processed(logits, pos):
        logits = _suppress(logits.float(), suppress)
        if logits_fn is not None:
            logits = logits_fn(logits, tokens, pos)
        return logits

    def pick_lp(logits, pos):  # -> (choice (B,), its logprob (B,))
        pl = processed(logits, pos)
        choice = torch.argmax(pl, dim=-1)
        return choice, torch.log_softmax(pl, dim=-1).gather(1, choice[:, None])[:, 0]

    tokens = torch.full((b, ext), eot_id, dtype=torch.long, device=dev)
    tokens[:, :p] = prompt

    # Prefill both models on the prompt; commit the first target token.
    t_logits, target_caches = target_step(tokens[:, :p], target_caches, 0)
    _, draft_caches = draft_step(tokens[:, :p], draft_caches, 0)
    no_speech_prob = None
    if no_speech_id is not None:
        src = t_logits[:, sot_index if sot_index is not None else -1]
        no_speech_prob = torch.softmax(src.float(), dim=-1)[:, no_speech_id]
    first, sum_lp = pick_lp(t_logits[:, -1], p)
    tokens[:, p] = first
    finished = first == eot_id

    idx = torch.arange(gamma + 1, device=dev)
    c = p + 1  # committed token count
    counts = {"rounds": 0, "committed": 0, "syncs": 0}
    while c < max_len:
        # Draft: gamma proposals, the first step S = 2 at c - 2.
        d_logits, draft_caches = draft_step(tokens[:, c - 2:c], draft_caches, c - 2)
        tokens[:, c] = torch.argmax(processed(d_logits[:, -1], c), dim=-1)
        for j in range(1, gamma):
            d_logits, draft_caches = draft_step(tokens[:, c + j - 1:c + j],
                                                draft_caches, c + j - 1)
            tokens[:, c + j] = torch.argmax(processed(d_logits[:, -1], c + j), dim=-1)
        proposals = tokens[:, c:c + gamma].clone()

        # Verify: one target step over [last, p_0 .. p_{gamma-1}]; row i
        # predicts position c + i from the proposal prefix p_0 .. p_{i-1}.
        t_logits, target_caches = target_step(tokens[:, c - 1:c + gamma],
                                              target_caches, c - 1)
        picks = [pick_lp(t_logits[:, i], c + i) for i in range(gamma + 1)]
        greedy = torch.stack([ch for ch, _ in picks], dim=1)  # (B, gamma + 1)
        lp_rows = torch.stack([lp for _, lp in picks], dim=1)

        # Lockstep acceptance; finished streams do not constrain the others.
        agree = (greedy[:, :-1] == proposals).long()
        n_i = torch.cumprod(agree, dim=1).sum(dim=1)
        m = torch.where(finished, gamma, n_i).min() + 1  # on the device
        g_pick = greedy.gather(1, (m - 1).expand(b, 1))
        block = torch.where(idx[None, :] < m - 1,
                            torch.nn.functional.pad(proposals, (0, 1)),
                            torch.where(idx[None, :] == m - 1, g_pick, eot_id))
        block = torch.where(finished[:, None], eot_id, block)
        tokens[:, c:c + gamma + 1] = block

        # Committed tokens are target argmaxes, so their logprobs are
        # lp_rows: up to and including the first EOT, and nothing past the
        # max_len horizon.
        committed = idx[None, :] < m
        blk_eot = ((block == eot_id) & committed).long()
        prior_eot = torch.cumsum(blk_eot, dim=1) - blk_eot
        alive = (committed & (prior_eot == 0) & ~finished[:, None]
                 & ((c + idx) < max_len)[None, :])
        sum_lp = sum_lp + torch.where(alive, lp_rows, 0.0).sum(dim=1)
        finished = finished | (blk_eot > 0).any(dim=1)

        # The one host sync of the round: the commit count and whether
        # every stream has finished.
        m_host, done = torch.stack([m, finished.all().long()]).tolist()
        counts["syncs"] += 1
        counts["rounds"] += 1
        counts["committed"] += m_host
        c += m_host
        if done:
            break
    if stats is not None:
        for k, v in counts.items():
            stats[k] = stats.get(k, 0) + v

    # Length = index of the first EOT at/after the prompt, +1; everything
    # from there on becomes EOT (uncommitted proposals must not leak out).
    tokens = tokens[:, :max_len]
    is_eot = tokens[:, p:] == eot_id
    first_eot = is_eot.to(torch.int8).argmax(dim=1)
    lengths = torch.where(is_eot.any(dim=1), p + first_eot + 1, max_len)
    tokens = torch.where(torch.arange(max_len, device=dev)[None, :] >= lengths[:, None],
                         eot_id, tokens)
    if return_aux:
        aux = {"sum_logprob": sum_lp}
        if no_speech_prob is not None:
            aux["no_speech_prob"] = no_speech_prob
        return tokens, lengths, aux
    return tokens, lengths
