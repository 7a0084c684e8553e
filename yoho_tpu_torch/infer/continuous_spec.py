"""Speculative decoding inside the continuous-batching slot engine.

The JAX package's ``infer/continuous_spec.py``: slot admission
(``infer/slot_engine.py``) composed with draft-verify decoding
(``infer/speculative.py``). The lockstep of the batched speculative
decoder goes away here: every slot carries its OWN cursor (a per-row
``pos``), so each slot commits its own accepted length per round and a
fast-accepting stream never waits for a slow one.

One round over all slots = gamma draft steps (S = 1 at per-row positions,
the first one S = 2 at ``c - 2``: an idempotent rewrite that also fills
the one-position cache gap a fully accepted round leaves behind) + ONE
target verify step of S = gamma + 1 at per-row positions (the multi-token
per-row cache write of ``nn/kv_cache.py`` and the decode kernel's per-row
causal read). The committed stream per slot equals target-only greedy
decoding: the batched decoder's argument, applied per row.

A chunk is ``max(1, chunk_tokens // (gamma + 1))`` rounds, so the
admission cadence stays about ``chunk_tokens`` committed tokens when every
proposal is rejected, and up to ``rounds * (gamma + 1)`` when all are
accepted. Like the greedy chunk, the rounds never wait for the device.

This module uses :class:`yoho_tpu_torch.infer.slot_engine.EngineSpec`
only: it never reaches into the engine object.
"""

from __future__ import annotations

import torch


def build_spec_programs(spec):
    """(admit, chunk) for a draft-carrying slot engine; ``spec`` is an
    :class:`~yoho_tpu_torch.infer.slot_engine.EngineSpec` with draft
    surfaces set. The calling convention is the greedy programs' (the
    state carries the draft's caches and cross-K/V)."""
    if not spec.draft:
        raise ValueError("build_spec_programs needs draft surfaces on the "
                         "EngineSpec (step_d/init_caches_d/encode_one_d)")
    from yoho_tpu_torch.infer.slot_engine import make_admit

    step, step_d, pick = spec.step, spec.step_d, spec.pick
    L, eot, gamma = spec.max_len, spec.eot, spec.gamma
    rounds = max(1, spec.chunk_tokens // (gamma + 1))

    def chunk(st) -> None:
        """``rounds`` draft-verify rounds; each slot advances by its own
        accepted length (1 .. gamma + 1 committed tokens a round)."""
        tokens, pos, active, sum_lp = st.tokens, st.pos, st.active, st.sum_lp
        idx = torch.arange(gamma + 1, device=tokens.device)
        for _ in range(rounds):
            # Per-slot next write position. A finished slot may sit up to
            # gamma - 1 past the horizon (its last round committed a whole
            # block); its rounds are no-ops that must stay inside the
            # token rows (JAX drops such writes), so its cursor is held at
            # max_len. An active slot's cursor is below max_len already.
            c = torch.clamp(pos + 1, max=L)
            cl = c.long()[:, None]

            # Draft: gamma proposals at per-row positions. The proposals
            # also go into a WORK buffer, so the logit rules read the
            # context target greedy would read on the accepted prefix.
            # A slot never admitted sits at pos 0: its first draft step
            # starts at 0, not -1 (its rows are inactive and replaced at
            # admission).
            work = tokens.clone()
            c2 = torch.clamp(c - 2, min=0)
            cur2 = tokens.gather(1, c2.long()[:, None] + torch.arange(2, device=c.device))
            d_logits, st.d_caches = step_d(cur2, st.d_caches, st.d_ckv, c2)
            props = []
            for j in range(gamma):
                if j:
                    d_logits, st.d_caches = step_d(props[-1][:, None], st.d_caches,
                                                   st.d_ckv, c - 1 + j)
                prop, _lp = pick(d_logits[:, -1], work, c + j)
                props.append(prop)
                work.scatter_(1, cl + j, prop[:, None])
            proposals = torch.stack(props, dim=1)  # (S, gamma)

            # Verify: ONE target step over [last, p_0 .. p_{gamma-1}].
            verify_in = torch.cat([tokens.gather(1, cl - 1), proposals], dim=1)
            t_logits, st.caches = step(verify_in, st.caches, st.ckv, c - 1)
            picks = [pick(t_logits[:, i], work, c + i) for i in range(gamma + 1)]
            greedy = torch.stack([ch for ch, _ in picks], dim=1)
            lp_rows = torch.stack([lp for _, lp in picks], dim=1)

            # Per-slot acceptance (no lockstep): m in 1 .. gamma + 1.
            agree = (greedy[:, :-1] == proposals).long()
            m = torch.cumprod(agree, dim=1).sum(dim=1) + 1  # committed this round
            g_pick = greedy.gather(1, (m - 1)[:, None])
            block = torch.where(
                idx[None, :] < (m - 1)[:, None],
                torch.nn.functional.pad(proposals, (0, 1)),  # the pad column is unused
                torch.where(idx[None, :] == (m - 1)[:, None], g_pick, eot))
            cidx = cl + idx[None, :]  # (S, gamma + 1)
            block = torch.where(active[:, None], block, tokens.gather(1, cidx))
            tokens.scatter_(1, cidx, block)

            # Committed tokens are target argmaxes, so their logprobs are
            # lp_rows (greedy's convention: up to and including the first
            # EOT, nothing past the horizon).
            in_commit = idx[None, :] < m[:, None]
            blk_eot = ((block == eot) & in_commit).long()
            prior_eot = torch.cumsum(blk_eot, dim=1) - blk_eot
            alive = in_commit & (prior_eot == 0) & active[:, None] & (cidx < L)
            sum_lp = sum_lp + torch.where(alive, lp_rows, 0.0).sum(dim=1)

            committed_eot = ((blk_eot > 0) & active[:, None]).any(dim=1)
            new_pos = torch.where(active, pos + m.to(pos.dtype), pos)
            active = active & ~committed_eot & (new_pos + 1 < L)
            pos = new_pos
        st.pos, st.active, st.sum_lp = pos, active, sum_lp

    return make_admit(spec), chunk
