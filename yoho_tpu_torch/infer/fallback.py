"""Whisper quality-fallback ladder for :class:`Transcriber`.

Greedy first; windows failing the quality checks (low mean logprob,
pathological compression ratio) re-decode at rising sampling temperatures,
with OpenAI's ``best_of`` candidate selection at sampling rungs and the
no-speech rule deciding silent windows. A copy of the JAX package's
``infer/fallback.py`` (which imports no JAX), calling the port's decode
programs; the ladder is parity with OpenAI whisper's
``temperature``/``best_of``/``logprob_threshold``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from yoho_tpu_torch.infer.longform import Segment


class FallbackLadderMixin:
    """Fallback-ladder + decode-quality half of the Transcriber."""

    @staticmethod
    def _compression_ratio(text: str) -> float:
        import zlib

        data = text.encode("utf-8")
        if not data:
            return 0.0
        return len(data) / max(len(zlib.compress(data)), 1)

    @staticmethod
    def _mean_logprob(lengths, aux, n_prompt) -> np.ndarray:
        """Per-window mean generated-token logprob — the ONE normalization
        shared by best_of candidate selection, the fallback ladder's
        failure test, and the no-speech rule (drift between them would
        let best_of pick a candidate the ladder immediately re-fails)."""
        return aux["sum_logprob"] / np.maximum(lengths - n_prompt, 1)

    def _decode_rung(self, b: int, temp: float, prompt_len, mel, prompt, xa=None):
        """Decode one ladder rung, returning writable host arrays.

        At sampling rungs (temp > 0) with ``best_of > 1``, decodes
        best_of independent candidates through the SAME compiled program
        (the PRNG seed is a traced argument — zero extra compiles) and
        keeps, per window, the candidate with the highest mean logprob:
        OpenAI whisper's best_of selection rule. Greedy rungs are
        deterministic, so extra candidates would be identical — skipped.
        ``xa``: ``mel``'s encoder output where the caller has it.
        """
        fn = self._decode_fn(b, temp, prompt_len)
        tokens, lengths, aux = fn(mel, prompt, xa=xa)
        tokens = np.array(tokens)
        lengths = np.array(lengths)
        aux = {k: np.array(v) for k, v in aux.items()}
        # Beam search draws no samples: extra candidates would be the same.
        if float(temp) <= 0.0 or self.best_of <= 1 or self.beams > 1:
            return tokens, lengths, aux
        n_prompt = (prompt_len if prompt_len is not None
                    else len(self._prompt_ids()))

        def avg_lp(length, a):
            return self._mean_logprob(length, a, n_prompt)

        best = avg_lp(lengths, aux)
        for seed in range(1, self.best_of):
            t2, l2, a2 = fn(mel, prompt, seed=seed, xa=xa)
            l2 = np.asarray(l2)
            a2 = {k: np.asarray(v) for k, v in a2.items()}
            better = avg_lp(l2, a2) > best
            if better.any():
                t2 = np.asarray(t2)
                tokens[better] = t2[better]
                lengths[better] = l2[better]
                for k in a2:
                    aux[k][better] = a2[k][better]
                best[better] = avg_lp(l2, a2)[better]
        return tokens, lengths, aux

    def _decode_with_fallback(self, b: int, mel, prompt=None,
                              temperatures=None, xa=None):
        """Greedy first; windows failing the whisper quality checks (low
        mean logprob, pathological compression ratio) are replaced by
        higher-temperature re-decodes (parity with OpenAI's fallback).
        ``prompt`` (B, P) overrides the default prompt (previous-text
        conditioning); ``temperatures`` overrides the configured ladder
        (per-request temperature: a single-rung ladder decodes exactly at
        that temperature); ``aux["used_temperature"]`` records the ladder
        rung each window ended on; ``xa`` is ``mel``'s encoder output
        where the caller has it (every rung reads it)."""
        ladder = tuple(temperatures) if temperatures is not None \
            else self.temperatures
        prompt_len = None if prompt is None else prompt.shape[1]
        tokens, lengths, aux = self._decode_rung(b, ladder[0], prompt_len,
                                                 mel, prompt, xa)
        aux["used_temperature"] = np.full((b,), ladder[0], np.float32)
        self._run_fallback_ladder(b, mel, prompt, tokens, lengths, aux,
                                  temperatures=ladder, xa=xa)
        return tokens, lengths, aux

    def _run_fallback_ladder(self, b: int, mel, prompt,
                             tokens: np.ndarray, lengths: np.ndarray,
                             aux, temperatures=None, xa=None) -> None:
        """Ladder rungs > 0: re-decode failed windows at rising
        temperature, mutating ``tokens``/``lengths``/``aux`` in place.
        Shared by :meth:`_decode_with_fallback` and the continuous
        batcher's assemble step (``infer/continuous.py``), so the two
        paths apply identical failure criteria and retries.

        ``mel`` may be a zero-arg callable producing the mel batch — it
        is only materialized if some window actually fails (the
        continuous path would otherwise recompute features per request
        just to discover nothing needs retrying)."""
        ladder = tuple(temperatures) if temperatures is not None \
            else self.temperatures
        # Beam search has no rungs; the YOHO family has no quality ladder.
        if len(ladder) <= 1 or self.family != "whisper" or self.beams > 1:
            return

        prompt_len = None if prompt is None else prompt.shape[1]
        n_prompt = prompt_len if prompt_len is not None else len(self._prompt_ids())
        for temp in ladder[1:]:
            avg_lp = self._mean_logprob(lengths, aux, n_prompt)
            failed = avg_lp < self.logprob_threshold
            for j in range(b):
                text = self._render([int(t) for t in tokens[j, n_prompt:lengths[j]]
                                     if t < self.token_table.eot])
                if self._compression_ratio(text) > self.compression_ratio_threshold:
                    failed[j] = True
            # Silent windows are handled by the no-speech rule, not retried.
            failed &= ~self._silent_mask(lengths, aux, n_prompt)
            if not failed.any():
                break
            if callable(mel):
                mel = mel()
            t2, l2, a2 = self._decode_rung(b, temp, prompt_len, mel, prompt, xa)
            tokens[failed] = t2[failed]
            lengths[failed] = l2[failed]
            for k in a2:
                aux[k][failed] = a2[k][failed]
            aux["used_temperature"][failed] = temp

    def _silent_mask(self, lengths: np.ndarray, aux,
                     n_prompt: Optional[int] = None) -> np.ndarray:
        """Whisper no-speech rule: high p(<|nospeech|>) + low mean logprob."""
        ns = np.asarray(aux["no_speech_prob"])[: len(lengths)]
        if n_prompt is None:
            n_prompt = len(self._prompt_ids())
        avg_lp = self._mean_logprob(
            lengths, {"sum_logprob": np.asarray(aux["sum_logprob"])
                      [: len(lengths)]}, n_prompt)
        if self.family != "whisper":  # no <|nospeech|> token
            return np.zeros(len(lengths), bool)
        return (ns > self.no_speech_threshold) & (avg_lp < self.logprob_threshold)

    def _attach_quality(self, segs: List[List[Segment]], lengths: np.ndarray,
                        aux, n_prompt: Optional[int] = None) -> None:
        """Stamp window-level decode-quality signals onto each window's
        segments (the signals OpenAI/faster-whisper expose per segment:
        avg_logprob, no_speech_prob, temperature, compression_ratio).
        Signals are per decoded window — every segment parsed from the
        same window shares them."""
        if n_prompt is None:
            n_prompt = len(self._prompt_ids())
        sum_lp = aux.get("sum_logprob")
        ns = aux.get("no_speech_prob")
        temps = aux.get("used_temperature")
        for j, window_segs in enumerate(segs):
            if not window_segs:
                continue
            gen = max(int(lengths[j]) - n_prompt, 1)
            text = " ".join(s.text for s in window_segs if s.text).strip()
            ratio = self._compression_ratio(text)
            for s in window_segs:
                if sum_lp is not None:
                    s.avg_logprob = float(sum_lp[j]) / gen
                if ns is not None:
                    s.no_speech_prob = float(ns[j])
                if temps is not None:
                    s.temperature = float(temps[j])
                s.compression_ratio = ratio
