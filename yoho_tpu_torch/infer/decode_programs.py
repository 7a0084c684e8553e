"""Decode-program construction for :class:`Transcriber` (whisper family,
greedy and temperature sampling).

The subset of the JAX package's ``infer/decode_programs.py`` this slice
serves: prompt assembly, the suppress list, the SOT index for the
no-speech probability, the step function and one memoized decode program
per (batch, temperature, prompt length): encoder -> cross-K/V ->
caches -> ``greedy_decode`` with the timestamp rules.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from yoho_tpu_torch.infer.decode import greedy_decode, make_whisper_step_fn


class DecodeProgramsMixin:
    """Program construction half of the Transcriber."""

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
        lengths, aux)`` as numpy arrays, memoized per (batch, temperature,
        prompt length)."""
        prompt_len = prompt_len or len(self._prompt_ids())
        key = (batch, float(temperature), prompt_len)
        if key not in self._programs:
            self._programs[key] = self._build_decode_fn(batch, float(temperature),
                                                        prompt_len)
        return self._programs[key]

    def _build_decode_fn(self, batch: int, temperature: float, prompt_len: int):
        model = self.model
        suppress = self._suppress_ids()
        logits_fn = None
        if self.timestamps:
            from yoho_tpu_torch.infer.whisper_rules import make_timestamp_rules

            logits_fn = make_timestamp_rules(self.token_table, prompt_len)
        default_prompt = np.asarray([self._prompt_ids()] * batch, np.int64)

        @torch.inference_mode()
        def fn(mel, prompt=None, seed: int = 0):
            if prompt is None:
                prompt = default_prompt
            if prompt.shape != (batch, prompt_len):
                raise ValueError(f"prompt {prompt.shape} != ({batch}, {prompt_len})")
            xa = model.encode_audio(mel)
            ckv = model.cross_kvs(xa, self.quantized_cross_kv)
            caches = model.init_caches(batch, self.cache_dtype, None,
                                       self.quantized_cache)
            gen = torch.Generator(device=self.device).manual_seed(42 + seed)
            tokens, lengths, aux = greedy_decode(
                self._make_step(ckv), caches,
                torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                                device=self.device),
                self.max_len, self.eot, suppress_ids=suppress,
                logits_fn=logits_fn, return_aux=True,
                no_speech_id=self.token_table.no_speech,
                sot_index=self._sot_index(prompt_len),
                temperature=temperature, generator=gen)
            return (tokens.cpu().numpy(), lengths.cpu().numpy(),
                    {k: v.cpu().numpy() for k, v in aux.items()})

        return fn
