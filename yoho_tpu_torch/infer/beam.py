"""Batched beam search with KV caches, as an eager loop.

The JAX package's ``infer/beam.py`` runs the search as one
``lax.while_loop``; here the loop is Python over device tensors, like
``infer/decode.py::greedy_decode``, with the same state: beams folded into a
(B*K) leading axis of the caches, a (B, K, max_len) token buffer, the
beams' summed logprobs and their EOT flags. Each step is one batched
decode step of the B*K rows, one top-k over the (B, K*V) candidates, and
one device-side gather of the token buffer and of every cache tensor by
the surviving beams. The JAX package skips an identity reorder with
``lax.cond``; eager code would need a host sync per step to test for it,
so the gather always runs (the tokens are the same either way).

The host waits on the device only for the early-exit check, once every
``_SYNC_EVERY`` steps. Steps that run after every beam has finished leave
the state as it is (their expansion is replaced by the identity on the
device), so the result equals a loop that stops at once.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from yoho_tpu_torch.infer.decode import _SYNC_EVERY, NEG_INF, _suppress


def tile_beams(x, k: int):
    """Repeat each batch row k times along axis 0: (B, ...) -> (B*K, ...),
    through tensors, lists, tuples and cache or K/V dataclasses."""
    if isinstance(x, torch.Tensor):
        return x.repeat_interleave(k, dim=0)
    if isinstance(x, (list, tuple)):
        return type(x)(tile_beams(e, k) for e in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: tile_beams(getattr(x, f.name), k) for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), torch.Tensor)})
    raise TypeError(f"cannot tile {type(x).__name__}")


def _gather_beams(caches, beam_src: torch.Tensor) -> None:
    """Reorders every cache tensor's (B*K) leading axis by the per-stream
    beam indices (B, K), one ``index_select`` each. The caches update in
    place, so each cache object takes the gathered tensor in place of its
    old one (one read and one write of the cache, no copy back)."""
    b, k = beam_src.shape
    rows = (torch.arange(b, device=beam_src.device)[:, None] * k + beam_src).reshape(-1)
    for cache in caches:
        for f in dataclasses.fields(cache):
            setattr(cache, f.name, getattr(cache, f.name).index_select(0, rows))


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis of a (B, N) tensor: the k
    largest values of each row in descending order, ties going to the
    lowest index (``torch.topk`` promises no order among ties). Returns
    (values, indices)."""
    n = x.shape[1]
    vals, idx = torch.topk(x, k, dim=-1)  # the right values; ties in any order
    kth = vals[:, -1:]
    # The entries above the k-th value are all in ``idx``, first; the rest
    # of the k are the lowest-index entries equal to it: a second top-k
    # over -index (exact in f32 below 2^24) finds them.
    n_above = (vals > kth).sum(dim=-1, keepdim=True)
    neg_index = -torch.arange(n, device=x.device, dtype=torch.float32)
    ties = torch.topk(torch.where(x == kth, neg_index, float("-inf")), k, dim=-1).indices
    j = torch.arange(k, device=x.device)
    idx = torch.where(j < n_above, idx, ties.gather(1, (j - n_above).clamp(min=0)))
    # Descending values, ties in index order.
    idx = torch.sort(idx, dim=-1).values
    vals = x.gather(1, idx)
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices
    return vals.gather(1, order), idx.gather(1, order)


def beam_search(
    step_fn: Callable,
    caches,  # caches built for batch B*K
    prompt: torch.Tensor,  # (B, P)
    max_len: int,
    eot_id: int,
    beams: int = 5,
    length_penalty: float = 1.0,
    suppress_ids: Sequence[int] = (),
    logits_fn=None,
    return_aux: bool = False,
    no_speech_id=None,
    sot_index=None,
):
    """Returns ``(tokens (B, max_len), lengths (B,), best scores (B,))``.

    ``step_fn`` runs on the folded (B*K) batch; it should close over the
    untiled (B, ...) cross K/V, which the attention layers read once for
    all K beams (``nn.layers._beam_fold``). Selection: the GNMT length
    penalty ``score / ((5 + generated) / 6) ** length_penalty``.
    ``return_aux=True`` adds ``sum_logprob`` (the best beam's raw summed
    logprob) and, with ``no_speech_id``, ``no_speech_prob`` read on beam 0
    at ``sot_index``.
    """
    b, p = prompt.shape
    k = beams
    if p >= max_len:
        raise ValueError("prompt must be shorter than max_len")
    dev = prompt.device
    tokens = torch.full((b, k, max_len), eot_id, dtype=torch.long, device=dev)
    tokens[:, :, :p] = prompt[:, None, :]
    # Beam 0 active, the rest at -inf so the first expansion has no copies.
    scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    finished = torch.zeros((b, k), dtype=torch.bool, device=dev)

    logits_all, caches = step_fn(tokens[:, :, :p].reshape(b * k, p), caches, 0)
    vocab = logits_all.shape[-1]
    no_speech_prob = None
    if no_speech_id is not None:
        src = logits_all[:, sot_index if sot_index is not None else -1]
        src = src.reshape(b, k, vocab)[:, 0].float()
        no_speech_prob = torch.softmax(src, dim=-1)[:, no_speech_id]

    eot_only = torch.full((vocab,), NEG_INF, dtype=torch.float32, device=dev)
    eot_only[eot_id] = 0.0

    def expand(logits, scores, finished, tokens, pos):
        # Suppression before the rules, as in greedy decode.
        logits = _suppress(logits.float(), suppress_ids)
        if logits_fn is not None:
            logits = logits_fn(logits, tokens.reshape(b * k, max_len), pos)
        logp = torch.log_softmax(logits, dim=-1).reshape(b, k, vocab)
        # Finished beams may only emit EOT, at no cost.
        logp = torch.where(finished[:, :, None], eot_only, logp)
        top_scores, top_idx = top_k((scores[:, :, None] + logp).reshape(b, k * vocab), k)
        return top_scores, top_idx // vocab, top_idx % vocab

    identity = torch.arange(k, device=dev).expand(b, k)
    pos = p - 1
    logits = logits_all[:, -1]
    while pos + 1 < max_len:
        if pos >= p and (pos - p) % _SYNC_EVERY == 0 and bool(finished.all()):
            break
        if pos >= p:
            logits, caches = step_fn(tokens.reshape(b * k, max_len)[:, pos:pos + 1],
                                     caches, pos)
            logits = logits[:, -1]
        top_scores, beam_src, tok = expand(logits, scores, finished, tokens, pos + 1)
        # Once every beam has finished the expansion is the identity (the
        # loop in the JAX package has stopped there).
        live = ~finished.all()
        beam_src = torch.where(live, beam_src, identity)
        tok = torch.where(live, tok, eot_id)
        scores = torch.where(live, top_scores, scores)
        tokens = tokens.gather(1, beam_src[:, :, None].expand(b, k, max_len))
        _gather_beams(caches, beam_src)
        finished = finished.gather(1, beam_src) | (tok == eot_id)
        tokens[:, :, pos + 1] = tok
        pos += 1

    # Lengths per beam: first EOT after the prompt, inclusive.
    is_eot = tokens[:, :, p:] == eot_id
    first_eot = is_eot.to(torch.int8).argmax(dim=-1)
    lengths = torch.where(is_eot.any(dim=-1), p + first_eot + 1, max_len)
    # GNMT length penalty over the generated tokens only.
    penalty = ((5.0 + (lengths - p).float()) / 6.0) ** length_penalty
    final = scores / penalty
    best = final.argmax(dim=1, keepdim=True)
    best_tokens = tokens.gather(1, best[:, :, None].expand(b, 1, max_len))[:, 0]
    out = (best_tokens, lengths.gather(1, best)[:, 0], final.gather(1, best)[:, 0])
    if return_aux:
        aux = {"sum_logprob": scores.gather(1, best)[:, 0]}
        if no_speech_prob is not None:
            aux["no_speech_prob"] = no_speech_prob
        return out + (aux,)
    return out
