"""Decode-program construction and language identification for
:class:`Transcriber` (whisper family).

The JAX package's ``infer/decode_programs.py``: prompt assembly, the
suppress list, the SOT index for the no-speech probability, the logit
processors in their order (bias -> repetition rules -> timestamp rules),
one memoized decode program per (batch, temperature, prompt length):
encoder -> cross-K/V -> caches -> ``greedy_decode``; with ``beams > 1``,
``beam_search`` over B*K cache rows and the untiled cross-K/V; with a draft
model at temperature 0, ``speculative_greedy_decode`` over the draft's own
encoder output, cross-K/V and caches of both models; the
teacher-forced alignment program of word timestamps; and language
detection (one decoder step on ``<|startoftranscript|>`` over an
unquantized cross-K/V and a float cache of 128 positions).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from yoho_tpu_torch.audio.io import load_audio_f32

from yoho_tpu_torch.infer.beam import beam_search
from yoho_tpu_torch.infer.decode import greedy_decode, make_whisper_step_fn
from yoho_tpu_torch.infer.speculative import (
    make_verify_step_fn,
    speculative_greedy_decode,
)


class DecodeProgramsMixin:
    """Program construction and language ID half of the Transcriber."""

    def _prompt_ids(self, language: Optional[str] = None) -> List[int]:
        """Prompt for one stream; its length does not depend on the
        language, so every language shares one decode program."""
        sot = self.token_table.sot_sequence(
            language or self.language or "en", self.task,
            timestamps=self.timestamps)
        if self.initial_prompt:
            # <|startofprev|> + context (at most half the text context).
            tt = self.token_table
            ctx = tt.encode_text(" " + self.initial_prompt.strip())
            ctx = ctx[-(self.model.cfg.n_text_ctx // 2 - 1):]
            return [tt.sot_prev] + list(map(int, ctx)) + sot
        return sot

    def _request_prompt_ids(self, language: Optional[str],
                            prompt_text: Optional[str]) -> List[int]:
        """Prompt for one request with a per-request context string (the
        OpenAI ``prompt`` field), truncated and left-padded with
        ``<|startofprev|>`` to a fixed budget so every prompted request
        shares one program."""
        if prompt_text is None:
            return self._prompt_ids(language)
        tt = self.token_table
        if tt.text_backend is None:
            raise ValueError("per-request prompt needs a text backend to "
                             "tokenize it")
        sot = tt.sot_sequence(language or self.language or "en", self.task,
                              timestamps=self.timestamps)
        ctx_budget = max(8, self.max_len // 2 - len(sot) - 1)
        ctx = list(map(int, tt.encode_text(" " + prompt_text.strip())))
        ctx = ctx[-ctx_budget:]
        pad = [tt.sot_prev] * (ctx_budget - len(ctx))
        return [tt.sot_prev] + pad + ctx + list(sot)

    def _build_logit_bias(self, logit_bias, hotwords, hotword_boost) -> dict:
        """-> sorted {token_id: delta}: the explicit entries plus
        ``hotword_boost`` on every token of the hotword phrases (comma
        separated, or a sequence), checked against the vocabulary."""
        entries: dict = {}
        for tid, delta in dict(logit_bias or {}).items():
            entries[int(tid)] = entries.get(int(tid), 0.0) + float(delta)
        if hotwords:
            phrases = ([p.strip() for p in hotwords.split(",") if p.strip()]
                       if isinstance(hotwords, str) else
                       [str(p).strip() for p in hotwords if str(p).strip()])
            if not phrases:
                raise ValueError(f"hotwords {hotwords!r} contains no phrases")
            if self.token_table.text_backend is None:
                raise ValueError("hotwords need a text backend to tokenize "
                                 "the phrases")
            boosted = set()
            for phrase in phrases:
                # Leading space: byte-BPE merges expect space-prefixed
                # words mid-sentence.
                boosted.update(int(t) for t in self.token_table.encode_text(" " + phrase))
            for tid in boosted:
                entries[tid] = entries.get(tid, 0.0) + float(hotword_boost)
        if not entries:
            return {}
        n_vocab = self.model.cfg.n_vocab
        bad = [t for t in entries if t < 0 or t >= n_vocab]
        if bad:
            raise ValueError(
                f"logit_bias token ids out of range [0, {n_vocab}): {bad}")
        return dict(sorted(entries.items()))

    def _repetition_rules_fn(self, n_prompt: int):
        """None, or the repetition rules (``logit_rules.py``) restricted to
        plain-text ids: penalizing timestamp or special tokens would fight
        the timestamp rules."""
        if (self.repetition_penalty in (None, 1.0)
                and self.no_repeat_ngram_size <= 1):
            return None
        from yoho_tpu_torch.infer.logit_rules import make_repetition_rules

        bannable = np.zeros((self.model.cfg.n_vocab,), bool)
        bannable[: self.token_table.eot] = True
        return make_repetition_rules(self.repetition_penalty,
                                     self.no_repeat_ngram_size,
                                     n_prompt=n_prompt, bannable=bannable)

    def _bias_logits_fn(self):
        """None, or ``logits -> logits`` adding the configured per-token
        deltas (a dense bias vector, made once per device and width)."""
        if not self._logit_bias_entries:
            return None
        ids = list(self._logit_bias_entries)
        deltas = list(self._logit_bias_entries.values())
        vecs = {}

        def add_bias(logits: torch.Tensor) -> torch.Tensor:
            key = (logits.device, logits.shape[-1])
            if key not in vecs:
                vec = torch.zeros((logits.shape[-1],), dtype=logits.dtype)
                vec[ids] = torch.tensor(deltas, dtype=logits.dtype)
                vecs[key] = vec.to(logits.device)
            return logits + vecs[key]

        return add_bias

    def _logits_fn(self, prompt_len: int):
        """The decode loop's logit processors, in the JAX package's order:
        bias -> repetition rules -> timestamp rules (the timestamp rules'
        forcing wins over everything before them)."""
        from yoho_tpu_torch.infer.whisper_rules import make_timestamp_rules

        bias_fn = self._bias_logits_fn()
        rep_fn = self._repetition_rules_fn(prompt_len)
        ts_fn = (make_timestamp_rules(self.token_table, prompt_len)
                 if self.timestamps else None)
        if bias_fn is None and rep_fn is None and ts_fn is None:
            return None

        def logits_fn(logits, tokens, pos):
            if bias_fn is not None:
                logits = bias_fn(logits)
            if rep_fn is not None:
                logits = rep_fn(logits, tokens, pos)
            if ts_fn is not None:
                logits = ts_fn(logits, tokens, pos)
            return logits

        return logits_fn

    def _suppress_ids(self):
        sup = list(self.token_table.non_speech_tokens)
        if not self.timestamps:
            sup += list(range(self.token_table.timestamp_begin,
                              self.token_table.n_vocab))
        return tuple(dict.fromkeys(sup + list(self.suppress_tokens)))

    def _make_step(self, cross_kvs):
        return make_whisper_step_fn(self.model, cross_kvs)

    def _sot_index(self, prompt_len: int) -> int:
        """Position of <|startoftranscript|> in a prompt of this length
        (every prompt ends with the SOT sequence); the no-speech
        probability is read at this position's output."""
        n_sot = len(self.token_table.sot_sequence(
            self.language or "en", self.task, timestamps=self.timestamps))
        return max(prompt_len - n_sot, 0)

    def _decode_fn(self, batch: int, temperature: float = 0.0,
                   prompt_len: Optional[int] = None):
        """The decode program ``fn(mel, prompt=None, seed=0) -> (tokens,
        lengths, aux)`` as numpy arrays, memoized per (batch, beams,
        temperature, prompt length)."""
        prompt_len = prompt_len or len(self._prompt_ids())
        key = (batch, self.beams, float(temperature), prompt_len)
        if key not in self._programs:
            self._programs[key] = self._build_decode_fn(batch, float(temperature),
                                                        prompt_len)
        return self._programs[key]

    def _build_decode_fn(self, batch: int, temperature: float, prompt_len: int):
        model = self.model
        suppress = self._suppress_ids()
        logits_fn = self._logits_fn(prompt_len)
        k = self.beams if self.beams > 1 else 0
        default_prompt = np.asarray([self._prompt_ids()] * batch, np.int64)

        @torch.inference_mode()
        def fn(mel, prompt=None, seed: int = 0):
            if prompt is None:
                prompt = default_prompt
            if prompt.shape != (batch, prompt_len):
                raise ValueError(f"prompt {prompt.shape} != ({batch}, {prompt_len})")
            xa = model.encode_audio(mel)
            ckv = model.cross_kvs(xa, self.quantized_cross_kv)
            prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                                     device=self.device)
            kw = dict(suppress_ids=suppress, logits_fn=logits_fn, return_aux=True,
                      no_speech_id=self.token_table.no_speech,
                      sot_index=self._sot_index(prompt_len))
            if k:
                # The cross-K/V stay untiled: the K beams of a stream share
                # one read of them (nn.layers._beam_fold).
                caches = model.init_caches(batch * k, self.cache_dtype, None,
                                           self.quantized_cache)
                tokens, lengths, _scores, aux = beam_search(
                    self._make_step(ckv), caches, prompt, self.max_len, self.eot,
                    beams=k, length_penalty=self.length_penalty, **kw)
            elif self.draft_model is not None and temperature == 0.0:
                # The draft encodes the same mel; both cache sets hold the
                # stale-write workspace past the horizon.
                d_model = self.draft_model
                gamma = self.speculative_gamma
                d_ckv = d_model.cross_kvs(d_model.encode_audio(mel),
                                          self.quantized_cross_kv)
                horizon = self.max_len + gamma + 2
                t_caches = model.init_caches(batch, self.cache_dtype, horizon,
                                             self.quantized_cache)
                d_caches = d_model.init_caches(batch, self.cache_dtype, horizon,
                                               self.quantized_cache)
                tokens, lengths, aux = speculative_greedy_decode(
                    make_verify_step_fn(model, ckv), make_verify_step_fn(d_model, d_ckv),
                    t_caches, d_caches, prompt, self.max_len, self.eot, gamma=gamma,
                    stats=self.speculative_stats, **kw)
            else:
                caches = model.init_caches(batch, self.cache_dtype, None,
                                           self.quantized_cache)
                gen = torch.Generator(device=self.device).manual_seed(42 + seed)
                tokens, lengths, aux = greedy_decode(
                    self._make_step(ckv), caches, prompt, self.max_len, self.eot,
                    temperature=temperature, generator=gen, **kw)
            return (tokens.cpu().numpy(), lengths.cpu().numpy(),
                    {k: v.cpu().numpy() for k, v in aux.items()})

        return fn

    @torch.inference_mode()
    def _align_fn(self, mel: torch.Tensor, tokens: np.ndarray):
        """The teacher-forced alignment pass over ``tokens`` (B, max_len):
        (alignment map (B, max_len, T_audio), realized-token probabilities
        (B, max_len)) from one forward, as numpy arrays."""
        xa = self.model.encode_audio(mel)
        amap, probs = self.model.cross_attention_map(
            torch.as_tensor(tokens, dtype=torch.long, device=self.device), xa, True)
        return amap.cpu().numpy(), probs.cpu().numpy()

    @torch.inference_mode()
    def _language_logits(self, windows: np.ndarray) -> np.ndarray:
        """One decoder step after <|startoftranscript|> for a (b, samples)
        batch of first windows -> (b, vocab) f32 logits, over the
        unquantized cross-K/V and a float cache of 128 positions."""
        model = self.model
        b = len(windows)
        xa = model.encode_audio(self._features(windows))
        caches = model.init_caches(b, self.cache_dtype, 128)
        prompt = torch.full((b, 1), self.token_table.sot, dtype=torch.long,
                            device=self.device)
        logits, _ = model.decode_step(prompt, caches, model.cross_kvs(xa), 0)
        return logits[:, -1].float().cpu().numpy()

    def _detection_input(self, audio) -> np.ndarray:
        """Language detection's input as the JAX package takes it: a file
        path is decoded to f32 at the model's rate, an array is cast to f32
        as it is (integer PCM is not scaled, channels are not mixed)."""
        if isinstance(audio, (str, Path)):
            return load_audio_f32(audio, self.sample_rate)
        return np.asarray(audio, np.float32)

    def detect_language(self, audio):
        """Whisper language ID on the first window: one decoder step after
        <|startoftranscript|>, argmax over the language tokens. Returns
        (language, {language: probability})."""
        window = np.zeros((1, self.chunk_samples), np.float32)
        clip = self._detection_input(audio)[: self.chunk_samples]
        window[0, : len(clip)] = clip
        tt = self.token_table
        logits = self._language_logits(window)[0]
        lang_logits = logits[tt.language_base: tt.language_base + len(tt.languages)]
        probs = self._language_softmax(lang_logits)
        best = int(np.argmax(lang_logits))
        return tt.languages[best], {
            lang: float(p) for lang, p in zip(tt.languages, probs)}

    @staticmethod
    def _language_softmax(lang_logits: np.ndarray) -> np.ndarray:
        """Softmax over the language-token logits, shared by single and
        batched detection (the two report the same probability)."""
        e = np.exp(lang_logits - lang_logits.max())
        return e / e.sum()

    def detect_language_many(self, audios: Sequence, return_probs: bool = False):
        """Batched language ID: the requests' first windows share
        ``batch_size``-padded calls. ``return_probs``: also each detected
        language's probability (None for empty inputs, which get 'en')."""
        tt = self.token_table
        prepared = [self._detection_input(a) for a in audios]
        langs = ["en"] * len(prepared)
        probs: List[Optional[float]] = [None] * len(prepared)
        todo = [i for i, a in enumerate(prepared) if len(a)]
        lang_ids = slice(tt.language_base, tt.language_base + len(tt.languages))
        b = self.batch_size
        for g in range(0, len(todo), b):
            group = todo[g: g + b]
            windows = np.zeros((b, self.chunk_samples), np.float32)
            for j, i in enumerate(group):
                clip = prepared[i][: self.chunk_samples]
                windows[j, : len(clip)] = clip
            logits = self._language_logits(windows)
            for j, i in enumerate(group):
                row = logits[j][lang_ids]
                best = int(np.argmax(row))
                langs[i] = tt.languages[best]
                probs[i] = float(self._language_softmax(row)[best])
        return (langs, probs) if return_probs else langs
