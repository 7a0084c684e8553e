"""Slot-based decode engine for continuous batching (whisper family).

The JAX package's ``infer/slot_engine.py``. The batched decode programs
(``infer/decode.py``) run a batch of windows to completion: a stream that
ends after 40 tokens idles until the slowest stream of its batch ends, and
a request that arrives mid-decode waits for the whole batch. The slot
engine keeps S decode slots, every slot at its OWN position: freed slots
are refilled between chunks of K tokens, so a new request waits at most K
steps and a finished slot never idles.

Per-row ``pos`` flows through the positional-embedding gather, the cache
scatter (``KVCache.update``), the causal read of the decode kernel and the
logit rules, all at fixed shapes. JAX compiles two programs (admit,
chunk); here they are two functions over in-place device state:

* admit: the encoder and the prompt's prefill over all S slots at once
  (one call costs the same for 1 or S admissions), the results placed with
  a gather plus a select per slot (``fill_row`` / ``fill_valid``), so
  untouched slots keep their state;
* chunk: ``chunk_tokens`` greedy steps over all slots as a host loop that
  never waits for the device: ``pos``, ``active``, ``tokens`` and
  ``sum_lp`` stay on the device. :meth:`SlotEngine.reap` reads them back
  once per chunk (one host sync, counted in ``SlotEngine.stats``).

The fixed shapes also keep the step capturable by CUDA graphs. The
speculative program builders live in ``infer/continuous_spec.py`` and use
:class:`EngineSpec` only; the request-level threading lives in
``infer/continuous.py``.

Greedy parity: a window decoded through slots gives the same tokens,
length, ``sum_logprob`` and ``no_speech_prob`` as ``greedy_decode`` (same
suppression, logit rules and quality signals), held by
``tests/test_torch_continuous.py`` against both packages.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Callable, List, Optional

import numpy as np
import torch

NEG_INF = torch.finfo(torch.float32).min


@dataclass(eq=False)
class _Window:
    """One 30 s window in flight."""

    window: np.ndarray  # (n_samples,) f32
    prompt: np.ndarray  # (P,) int
    done: threading.Event = field(default_factory=threading.Event)
    tokens: Optional[np.ndarray] = None  # (max_len,) on completion
    length: int = 0
    sum_logprob: float = 0.0
    no_speech_prob: float = 0.0
    req: Any = None  # owning _Request (set by ContinuousBatcher)


@dataclass(frozen=True)
class EngineSpec:
    """Everything a slot-program builder may use: the interface between the
    engine and its program builders (greedy below, speculative in
    ``infer/continuous_spec.py``). Builders get this spec and nothing else.

    Calling conventions (the state is a :class:`SlotState`, changed in
    place; its tensors stay on the device):

    * admit(state, windows, prompts, fill_row, fill_valid)
    * chunk(state)

    ``windows`` (S, n_samples) / ``prompts`` (S, P) are admission rows
    (filler past the valid count); ``fill_row`` (S,) / ``fill_valid`` (S,)
    bool are SLOT-indexed: slot s takes admission row ``fill_row[s]`` when
    ``fill_valid[s]``, a gather plus a select per slot, so there are no
    scatter collisions and untouched slots keep their state.
    """

    slots: int
    prompt_len: int
    max_len: int          # decode horizon (committed stream width)
    ext: int              # token-row width: max_len + speculative workspace
    eot: int
    gamma: int            # speculative draft length; 0 = greedy only
    chunk_tokens: int     # admission cadence in committed tokens
    ns_id: Optional[int]  # <|nospeech|> id
    sot_pos: Optional[int]  # prompt index whose logits carry the no-speech mass
    # (next_id, logprob) under suppression, bias, repetition and timestamp
    # rules; ``pos`` an int (admission) or a per-row tensor (chunk).
    pick: Callable[..., Any]
    # Target-model surfaces: batch -> caches; (toks, caches, ckv, pos) ->
    # (logits, caches); windows (S, n_samples) -> cross-K/V.
    init_caches: Callable[..., Any]
    step: Callable[..., Any]
    encode_one: Callable[..., Any]
    # Draft-model surfaces (speculative engines only).
    init_caches_d: Optional[Callable[..., Any]] = None
    step_d: Optional[Callable[..., Any]] = None
    encode_one_d: Optional[Callable[..., Any]] = None

    @property
    def draft(self) -> bool:
        return self.step_d is not None


@dataclass(eq=False)
class SlotState:
    """The engine's device state: per-layer caches and cross-K/V (the
    draft's too in speculative engines), the token rows (S, ext), and per
    slot the position of the last decided token, whether it still decodes,
    the summed logprob and the no-speech probability."""

    caches: Any
    tokens: torch.Tensor
    pos: torch.Tensor        # (S,) int32
    active: torch.Tensor     # (S,) bool
    sum_lp: torch.Tensor     # (S,) f32
    no_speech: torch.Tensor  # (S,) f32
    ckv: Any = None          # made at the first admission
    d_caches: Any = None
    d_ckv: Any = None


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a list of caches or cross-K/V entries (dataclasses or
    tuples), in a fixed order."""
    out: List[torch.Tensor] = []
    for item in tree:
        if is_dataclass(item):
            parts = [getattr(item, f.name) for f in fields(item)]
        else:
            parts = list(item)
        out += [p for p in parts if isinstance(p, torch.Tensor)]
    return out


def _empty_like(tree):
    """A zero copy of a list of caches or cross-K/V entries."""
    out = []
    for item in tree:
        if is_dataclass(item):
            out.append(type(item)(**{
                f.name: (torch.zeros_like(v) if isinstance(v, torch.Tensor) else v)
                for f in fields(item) for v in [getattr(item, f.name)]}))
        else:
            out.append(type(item)(torch.zeros_like(v) for v in item))
    return out


def make_admit(spec: EngineSpec):
    """The admit program: encode + prefill up to S windows in ONE call.
    Shared by the greedy builder and the speculative builder, so the
    no-speech convention, the slot placement and the first-token
    bookkeeping have one implementation. With draft surfaces on the spec
    the draft model is encoded and prefilled too."""
    P, S = spec.prompt_len, spec.slots
    eot, ns_id = spec.eot, spec.ns_id

    def admit(st: SlotState, windows, prompts, fill_row, fill_valid) -> None:
        def place(big_tree, new_tree):
            for big, new in zip(_tensors(big_tree), _tensors(new_tree)):
                mask = fill_valid.reshape((S,) + (1,) * (big.dim() - 1))
                big.copy_(torch.where(mask, new[fill_row].to(big.dtype), big))

        ckv_new = spec.encode_one(windows)
        fresh = spec.init_caches(S)
        logits, fresh = spec.step(prompts, fresh, ckv_new, 0)
        if st.ckv is None:
            st.ckv = _empty_like(ckv_new)
        place(st.ckv, ckv_new)
        place(st.caches, fresh)
        if spec.draft:
            d_ckv_new = spec.encode_one_d(windows)
            d_fresh = spec.init_caches_d(S)
            _dl, d_fresh = spec.step_d(prompts, d_fresh, d_ckv_new, 0)
            if st.d_ckv is None:
                st.d_ckv = _empty_like(d_ckv_new)
            place(st.d_ckv, d_ckv_new)
            place(st.d_caches, d_fresh)

        last = logits[:, -1]
        # <|nospeech|> mass at the SOT position's output distribution
        # (OpenAI probs_at_sot), the convention of greedy and beam search.
        ns_src = last if spec.sot_pos is None else logits[:, spec.sot_pos]
        ns_prob = (torch.softmax(ns_src.float(), dim=-1)[:, ns_id] if ns_id is not None
                   else torch.zeros((S,), dtype=torch.float32, device=last.device))
        # Token rows of the engine's width: max_len for the greedy engine,
        # max_len + the stale-write workspace for the speculative one.
        rows_buf = torch.full((S, spec.ext), eot, dtype=torch.long, device=last.device)
        rows_buf[:, :P] = prompts
        first, lp0 = spec.pick(last, rows_buf, P)
        rows_buf[:, P] = first
        place([(st.tokens,)], [(rows_buf,)])
        st.pos.copy_(torch.where(fill_valid, P, st.pos))
        st.active.copy_(torch.where(fill_valid, first[fill_row] != eot, st.active))
        st.sum_lp.copy_(torch.where(fill_valid, lp0[fill_row], st.sum_lp))
        st.no_speech.copy_(torch.where(fill_valid, ns_prob[fill_row], st.no_speech))

    return admit


def build_greedy_programs(spec: EngineSpec):
    """(admit, chunk) for a draft-less slot engine."""
    L, eot = spec.max_len, spec.eot
    step, pick = spec.step, spec.pick

    def chunk(st: SlotState) -> None:
        """K greedy steps over all slots, each at its own position; no host
        sync (every value stays on the device)."""
        tokens, pos, active, sum_lp = st.tokens, st.pos, st.active, st.sum_lp
        for _ in range(spec.chunk_tokens):
            cur = tokens.gather(1, pos.long()[:, None])  # the last decided token
            logits, st.caches = step(cur, st.caches, st.ckv, pos)
            nxt, lp = pick(logits[:, -1], tokens, pos + 1)
            nxt = torch.where(active, nxt, eot)
            sum_lp = sum_lp + torch.where(active, lp, 0.0)
            new_pos = torch.where(active, pos + 1, pos)
            idx = new_pos.long()[:, None]
            tokens.scatter_(1, idx, torch.where(active[:, None], nxt[:, None],
                                                tokens.gather(1, idx)))
            active = active & (nxt != eot) & (new_pos + 1 < L)
            pos = new_pos
        st.pos, st.active, st.sum_lp = pos, active, sum_lp

    return make_admit(spec), chunk


class SlotEngine:
    """Slot engine: admit windows into free slots, decode in K-token
    chunks, reap finished slots. Driven by one owner thread
    (:class:`yoho_tpu_torch.infer.continuous.ContinuousBatcher`); not
    itself thread-safe. ``stats`` counts the chunks, the slot-chunks that
    held a window (occupancy), the :meth:`reap` calls, and ``syncs``: the
    host syncs the engine makes by design, one stream sync per reap, so
    the two counts are equal; a chunk makes none. The count restates the
    design, it measures nothing: ``chip_smoke.py`` counts the syncs PyTorch
    sees (``torch.cuda.set_sync_debug_mode``)."""

    def __init__(self, transcriber, slots: Optional[int] = None,
                 chunk_tokens: int = 16):
        t = transcriber
        family = getattr(t, "family", "whisper")
        if family != "whisper":
            from yoho_tpu_torch.infer.pipeline import _not_ported

            _not_ported(f"continuous batching of family={family!r}", 12)
        if t.beams > 1:
            raise ValueError("continuous batching is greedy-only (no beams)")
        if t.temperatures and t.temperatures[0] != 0.0:
            # Rung 0 is the slot engine's greedy decode; rungs > 0 run in
            # the batcher's assemble step (_run_fallback_ladder).
            raise ValueError("continuous batching decodes rung 0 greedily; "
                             "the temperature ladder must start at 0.0")
        if getattr(t, "condition_on_previous_text", False):
            # Slots decode windows independently; running them anyway would
            # silently drop the configured conditioning.
            raise ValueError("condition_on_previous_text is sequential by "
                             "construction: use the micro-batching engine "
                             "(drop --continuous)")
        self.t = t
        self.slots = int(slots or t.batch_size)
        self.chunk_tokens = int(chunk_tokens)
        if self.chunk_tokens < 1:
            raise ValueError("chunk_tokens must be >= 1 (0 would decode "
                             "nothing per tick and livelock the worker)")
        if self.slots < 1:
            raise ValueError("need at least one slot")
        self.prompt_len = len(t._prompt_ids())
        self.max_len = t.max_len
        self.eot = t.eot
        # Speculative slots (continuous_spec.py): each slot carries its own
        # draft-verify cursor. ``ext`` adds stale-write workspace past the
        # horizon (a verify block may write up to gamma positions past a
        # committing EOT; reap reads only [:max_len]).
        self.draft = t.draft_model is not None
        self.gamma = int(t.speculative_gamma) if self.draft else 0
        if self.draft and self.gamma < 1:
            raise ValueError(f"speculative_gamma must be >= 1, "
                             f"got {t.speculative_gamma}")
        self.ext = self.max_len + (self.gamma + 2 if self.draft else 0)
        self.device = t.device

        self._rules = None
        if t.timestamps:
            from yoho_tpu_torch.infer.whisper_rules import make_timestamp_rules

            self._rules = make_timestamp_rules(t.token_table, self.prompt_len)
        # The suppress ids as a device tensor made once: a host list copied
        # at every step would make each step wait for the device.
        self._suppress = torch.as_tensor(list(t._suppress_ids()), dtype=torch.long,
                                         device=self.device)
        # The same logit bias and repetition rules as the batched decode
        # programs, in their order: bias -> repetition -> timestamp rules.
        self._bias = t._bias_logits_fn()
        self._rep = t._repetition_rules_fn(self.prompt_len)

        # The cache horizon of speculative slots holds the workspace past
        # max_len (stale multi-token writes; infer/speculative.py).
        horizon = self.ext if self.draft else None

        def make_surfaces(model):
            def init_caches(batch):
                return model.init_caches(batch, t.cache_dtype, horizon, t.quantized_cache)

            def step(toks, caches, ckv, pos):
                return model.decode_step(toks, caches, ckv, pos)

            def encode_one(windows):
                return model.cross_kvs(model.encode_audio(t._features(windows)),
                                       t.quantized_cross_kv)

            return init_caches, step, encode_one

        init_caches, step, encode_one = make_surfaces(t.model)
        draft_surfaces = {}
        d_caches = None
        if self.draft:
            init_d, step_d, encode_d = make_surfaces(t.draft_model)
            draft_surfaces = dict(init_caches_d=init_d, step_d=step_d, encode_one_d=encode_d)
            d_caches = init_d(self.slots)
        dev = self.device
        S = self.slots
        self.state = SlotState(
            caches=init_caches(S),
            tokens=torch.full((S, self.ext), self.eot, dtype=torch.long, device=dev),
            pos=torch.zeros((S,), dtype=torch.int32, device=dev),
            active=torch.zeros((S,), dtype=torch.bool, device=dev),
            sum_lp=torch.zeros((S,), dtype=torch.float32, device=dev),
            no_speech=torch.zeros((S,), dtype=torch.float32, device=dev),
            d_caches=d_caches)
        self._occupied: List[Optional[_Window]] = [None] * S
        self.stats = {"chunks": 0, "occupied_slot_chunks": 0, "reaps": 0, "syncs": 0}

        self.spec = EngineSpec(
            slots=S, prompt_len=self.prompt_len, max_len=self.max_len, ext=self.ext,
            eot=self.eot, gamma=self.gamma, chunk_tokens=self.chunk_tokens,
            ns_id=t.token_table.no_speech, sot_pos=t._sot_index(self.prompt_len),
            pick=self._pick, init_caches=init_caches, step=step,
            encode_one=encode_one, **draft_surfaces)
        if self.draft:
            from yoho_tpu_torch.infer.continuous_spec import build_spec_programs

            self._admit, self._chunk = build_spec_programs(self.spec)
        else:
            self._admit, self._chunk = build_greedy_programs(self.spec)

    # ------------------------------------------------------------------
    def _pick(self, logits, tokens, pos):
        """Greedy next token under suppression + logit rules; returns
        (next_id, logprob). ``pos`` an int (admission) or a per-row tensor
        (chunk)."""
        logits = logits.float()
        if self._suppress.numel():
            logits = logits.index_fill(1, self._suppress, NEG_INF)
        if self._bias is not None:
            logits = self._bias(logits)
        if self._rep is not None:
            logits = self._rep(logits, tokens, pos)
        if self._rules is not None:
            logits = self._rules(logits, tokens, pos)
        nxt = torch.argmax(logits, dim=-1)
        lp = torch.log_softmax(logits, dim=-1).gather(1, nxt[:, None])[:, 0]
        return nxt, lp

    # ------------------------------------------------------------------
    def admit(self, win: _Window) -> bool:
        """Place one window into a free slot; False when all slots are busy."""
        return self.admit_many([win]) == 1

    @torch.no_grad()
    def admit_many(self, wins: List[_Window]) -> int:
        """Admit up to ``free_slots`` windows in ONE call; returns how many
        were taken (the rest stay with the caller)."""
        free = [s for s, w in enumerate(self._occupied) if w is None]
        take = wins[: len(free)]
        if not take:
            return 0
        S = self.slots
        windows = np.zeros((S, self.t.chunk_samples), np.float32)
        prompts = np.zeros((S, self.prompt_len), np.int64)
        prompts[:] = take[0].prompt[None, :]  # valid ids in the filler rows
        fill_row = np.zeros(S, np.int64)
        fill_valid = np.zeros(S, bool)
        for i, win in enumerate(take):
            windows[i] = win.window
            prompts[i] = win.prompt
            fill_row[free[i]] = i
            fill_valid[free[i]] = True
        dev = self.device
        self._admit(self.state, windows, torch.as_tensor(prompts, device=dev),
                    torch.as_tensor(fill_row, device=dev),
                    torch.as_tensor(fill_valid, device=dev))
        for i, win in enumerate(take):
            self._occupied[free[i]] = win
        return len(take)

    @torch.no_grad()
    def step(self) -> List[_Window]:
        """One K-token chunk over every slot; returns the reaped windows."""
        self.stats["chunks"] += 1
        self.stats["occupied_slot_chunks"] += self.slots - self.free_slots
        self._chunk(self.state)
        return self.reap()

    def reap(self) -> List[_Window]:
        """Collect finished slots (occupied but no longer active). One host
        sync: the slots' state comes back in one transfer."""
        st = self.state
        host = [x.to("cpu", non_blocking=True)
                for x in (st.active, st.tokens, st.sum_lp, st.no_speech)]
        if st.active.is_cuda:
            torch.cuda.current_stream(st.active.device).synchronize()
        self.stats["reaps"] += 1
        self.stats["syncs"] += 1
        active, tokens, sum_lp, no_speech = (x.numpy() for x in host)
        done: List[_Window] = []
        P = self.prompt_len
        for s, win in enumerate(self._occupied):
            if win is None or active[s]:
                continue
            self._occupied[s] = None
            # Speculative slots keep stale-write workspace past max_len; the
            # committed stream (and greedy parity) lives in [:max_len].
            row = tokens[s][: self.max_len].copy()
            is_eot = row[P:] == self.eot
            win.tokens = row
            win.length = (P + int(np.argmax(is_eot)) + 1 if is_eot.any()
                          else self.max_len)
            win.sum_logprob = float(sum_lp[s])
            win.no_speech_prob = float(no_speech[s])
            done.append(win)
        return done

    def release(self, pred) -> int:
        """Free every occupied slot whose window matches ``pred`` without
        reaping its tokens (request cancellation): the slot goes inactive
        on the device, stops advancing in :meth:`step` and is refilled by
        the next :meth:`admit_many`; the window is discarded."""
        idx = [s for s, w in enumerate(self._occupied) if w is not None and pred(w)]
        if not idx:
            return 0
        self.state.active[torch.as_tensor(idx, device=self.device)] = False
        for s in idx:
            self._occupied[s] = None
        return len(idx)

    def reset(self) -> None:
        """Forget every slot (after a failed device call): the next
        admissions rewrite the per-slot state from scratch."""
        self._occupied = [None] * self.slots
        self.state.active.zero_()

    @property
    def busy(self) -> bool:
        return any(w is not None for w in self._occupied)

    @property
    def free_slots(self) -> int:
        return sum(w is None for w in self._occupied)


# The JAX package's historical name for the engine.
ContinuousWhisperDecoder = SlotEngine
