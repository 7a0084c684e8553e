"""Decode-program construction and language identification for
:class:`Transcriber`.

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
unquantized cross-K/V and a float cache of 128 positions). The YOHO family
(``family="yoho"``) prompts with ``<|startoftranscript|>`` alone, has no
no-speech token, no SOT index and no timestamp rules, and decodes over
float cross K/V and caches.

On one card the greedy program is what ``jax.jit`` makes of JAX's: its
chunks run as a CUDA graph captured at the program's first call and
replayed (``infer/graphs.py``), over one workspace per batch size (the
caches, the cross-K/V that each call writes in place, the greedy state and
a graph pool) that every greedy program of the transcriber shares
(:meth:`DecodeProgramsMixin._workspace`); the encoder, the cross-K/V and
the prefill run eagerly before the chunks. Beam search, speculative
decoding and a mesh keep their eager loops.

Under a mesh (``Transcriber(mesh=...)``) every program works on this
rank's ``data`` rows (:meth:`DecodeProgramsMixin._to_device`,
:meth:`DecodeProgramsMixin._rows`) and gathers its results over ``data``
before the host sees them (:meth:`DecodeProgramsMixin._to_host`).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from yoho_tpu_torch.audio.io import load_audio_f32

from yoho_tpu_torch.infer.beam import beam_search
from yoho_tpu_torch.infer.decode import (
    greedy_decode,
    make_whisper_step_fn,
    make_yoho_step_fn,
)
from yoho_tpu_torch.infer.graphs import ChunkGraph
from yoho_tpu_torch.infer.speculative import speculative_greedy_decode

# The fewest rows the encoder and the cross-K/V projections take at once
# (:meth:`DecodeProgramsMixin._row_chunk`).
_ENCODE_ROWS = 16


class DecodeProgramsMixin:
    """Program construction and language ID half of the Transcriber."""

    def _rows(self, batch):
        """This rank's rows of a host batch: all of it without a mesh;
        raises ``ValueError`` when the rows do not divide over ``data``."""
        if self.mesh is None:
            return batch
        from yoho_tpu_torch.parallel.mesh import shard_batch

        return shard_batch(self.mesh, batch)

    def _to_device(self, batch: np.ndarray) -> torch.Tensor:
        """A (B, ...) host batch -> this rank's rows as f32 on the device."""
        return torch.as_tensor(self._rows(batch), dtype=torch.float32,
                               device=self.device)

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        """A program's result for this rank's rows -> the whole batch as a
        numpy array (gathered over ``data`` under a mesh)."""
        if self.mesh is not None:
            from yoho_tpu_torch.parallel.mesh import gather_batch

            t = gather_batch(self.mesh, t)
        return t.cpu().numpy()

    def _prompt_ids(self, language: Optional[str] = None) -> List[int]:
        """Prompt for one stream; its length does not depend on the
        language, so every language shares one decode program."""
        if self.family != "whisper":
            return [self.tokenizer.sot_id]
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
        if self.family != "whisper":
            raise ValueError("per-request prompt is a whisper-family "
                             "feature (<|startofprev|> conditioning)")
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
            if self.family == "whisper" and self.token_table.text_backend is None:
                raise ValueError("hotwords need a text backend to tokenize "
                                 "the phrases")
            boosted = set()
            for phrase in phrases:
                # Leading space: GPT-2 byte-BPE merges expect space-prefixed
                # words mid-sentence (the YOHO tokenizer adds its own).
                ids = (self.token_table.encode_text(" " + phrase)
                       if self.family == "whisper" else self.tokenizer.encode(phrase))
                boosted.update(int(t) for t in ids)
            for tid in boosted:
                entries[tid] = entries.get(tid, 0.0) + float(hotword_boost)
        if not entries:
            return {}
        n_vocab = self._n_vocab()
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

        bannable = np.zeros((self._n_vocab(),), bool)
        if self.family == "whisper":
            bannable[: self.token_table.eot] = True
        else:
            bannable[self.tokenizer.bpe.n_special:] = True
        return make_repetition_rules(self.repetition_penalty,
                                     self.no_repeat_ngram_size,
                                     n_prompt=n_prompt, bannable=bannable)

    def _n_vocab(self) -> int:
        return (self.model.cfg.n_vocab if self.family == "whisper"
                else self.model.vocab_size)

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
                 if self.family == "whisper" and self.timestamps else None)
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
        if self.family != "whisper":
            return tuple(dict.fromkeys(self.suppress_tokens))
        sup = list(self.token_table.non_speech_tokens)
        if not self.timestamps:
            sup += list(range(self.token_table.timestamp_begin,
                              self.token_table.n_vocab))
        return tuple(dict.fromkeys(sup + list(self.suppress_tokens)))

    def _make_step(self, cross_kvs, model=None):
        """The decode step of ``model`` (default: the transcriber's; the
        draft's for speculative decoding) over ``cross_kvs``."""
        make = make_whisper_step_fn if self.family == "whisper" else make_yoho_step_fn
        return make(model or self.model, cross_kvs)

    def _no_speech_id(self) -> Optional[int]:
        return self.token_table.no_speech if self.family == "whisper" else None

    def _sot_index(self, prompt_len: int) -> Optional[int]:
        """Position of <|startoftranscript|> in a prompt of this length
        (every whisper prompt ends with the SOT sequence); the no-speech
        probability is read at this position's output. None for the YOHO
        family."""
        if self.family != "whisper":
            return None
        n_sot = len(self.token_table.sot_sequence(
            self.language or "en", self.task, timestamps=self.timestamps))
        return max(prompt_len - n_sot, 0)

    def _decode_fn(self, batch: int, temperature: float = 0.0,
                   prompt_len: Optional[int] = None):
        """The decode program ``fn(mel, prompt=None, seed=0, xa=None) ->
        (tokens, lengths, aux)`` as numpy arrays, memoized per (batch,
        beams, temperature, prompt length); ``xa`` is ``mel``'s encoder
        output where the caller has it (:meth:`_encode`)."""
        prompt_len = prompt_len or len(self._prompt_ids())
        key = (batch, self.beams, float(temperature), prompt_len)
        if key not in self._programs:
            self._programs[key] = self._build_decode_fn(batch, float(temperature),
                                                        prompt_len)
        return self._programs[key]

    def _captures(self, temperature: float) -> bool:
        """Whether the greedy program runs its chunks as a captured CUDA
        graph (``infer/graphs.py``): on a CUDA device without a mesh, and
        above temperature 0 only where this PyTorch captures a generator.
        The device alone picks the route: there is no switch."""
        from yoho_tpu_torch.infer.graphs import sampling_capturable

        return (self.device.type == "cuda" and self.mesh is None
                and (temperature == 0.0 or sampling_capturable()))

    def _workspace(self, rows: int):
        """The captured greedy programs' buffers at ``rows`` streams: one
        set per batch size, shared by every greedy program of this
        transcriber (the fallback's temperatures, other prompt lengths).
        Settings that size them (the horizon, the lanes) make a new set,
        and the old one is released first."""
        from yoho_tpu_torch.infer.decode import GreedyState
        from yoho_tpu_torch.infer.graphs import GreedyWorkspace

        key = (rows, self.max_len, self.cache_dtype, bool(self.quantized_cache),
               self.quantized_cross_kv)
        ws = self._workspaces.get(rows)
        if ws is None or ws.key != key:
            self._workspaces.pop(rows, None)
            ws = GreedyWorkspace(key=key, state=GreedyState.empty(rows, self.max_len,
                                                                  self.device),
                                 pool=torch.cuda.graph_pool_handle())
            self._workspaces[rows] = ws
        return ws

    @staticmethod
    def _row_chunk(b: int) -> int:
        """The most rows of a batch of ``b`` that the encoder and each
        layer's cross-K/V projections take at once: an eighth, and no fewer
        than ``_ENCODE_ROWS``. A large batch's activations and quantizer
        temporaries are then a fraction of its own, which is what lets a
        repeated call run beside the captured programs' held buffers within
        the capacity model (``infer/capacity.py``)."""
        return max(_ENCODE_ROWS, -(-b // 8))

    @torch.inference_mode()
    def _encode(self, mel: torch.Tensor, model=None) -> torch.Tensor:
        """The encoder output of ``mel`` (this rank's rows) under ``model``
        (default: the transcriber's; a draft's), :meth:`_row_chunk` rows at
        a time into one output."""
        model = model or self.model
        b = mel.shape[0]
        step = self._row_chunk(b)
        if b <= step:
            return model.encode_audio(mel)
        first = model.encode_audio(mel[:step])
        xa = first.new_empty((b, *first.shape[1:]))
        xa[:step] = first
        del first
        for i in range(step, b, step):
            xa[i:i + step] = model.encode_audio(mel[i:i + step])
        return xa

    def _build_decode_fn(self, batch: int, temperature: float, prompt_len: int,
                         captured: Optional[bool] = None):
        """``captured``: the greedy branch's route, by default
        :meth:`_captures`; False runs the same chunk body eagerly (the
        reference a measurement holds the captured program to)."""
        model = self.model
        suppress = self._suppress_ids()
        logits_fn = self._logits_fn(prompt_len)
        k = self.beams if self.beams > 1 else 0
        default_prompt = np.asarray([self._prompt_ids()] * batch, np.int64)
        if captured is None:
            captured = self._captures(temperature)

        @torch.inference_mode()
        def fn(mel, prompt=None, seed: int = 0, xa=None):
            if prompt is None:
                prompt = default_prompt
            if prompt.shape != (batch, prompt_len):
                raise ValueError(f"prompt {prompt.shape} != ({batch}, {prompt_len})")
            if xa is None:
                xa = self._encode(mel)
            prompt = torch.as_tensor(self._rows(np.asarray(prompt)), dtype=torch.long,
                                     device=self.device)
            rows = prompt.shape[0]  # this rank's (the batch without a mesh)
            kw = dict(suppress_ids=suppress, logits_fn=logits_fn, return_aux=True,
                      no_speech_id=self._no_speech_id(),
                      sot_index=self._sot_index(prompt_len))
            greedy = not k and not (self.draft_model is not None and temperature == 0.0)
            if greedy and captured:
                # The program's static buffers: the cross-K/V written in
                # place (one layer's and row chunk's temporaries at a
                # time), the caches and the state reused; the chunks
                # replay one capture.
                ws = self._workspace(rows)
                ws.ckv = model.cross_kvs(xa, self.quantized_cross_kv, out=ws.ckv,
                                         rows=self._row_chunk(rows))
                del xa
                if ws.caches is None:  # after the cross-K/V's temporaries are gone
                    ws.caches = model.init_caches(rows, self.cache_dtype, None,
                                                  self.quantized_cache)
                program = ws.graphs.get((temperature, prompt_len))
                if program is None:
                    program = ws.graphs[(temperature, prompt_len)] = ChunkGraph(
                        state=ws.state, pool=ws.pool,
                        generator=(torch.Generator(device=self.device)
                                   if temperature > 0.0 else None))
                if program.generator is not None:  # the one the graph draws from
                    program.generator.manual_seed(42 + seed)
                tokens, lengths, aux = greedy_decode(
                    self._make_step(ws.ckv), ws.caches, prompt, self.max_len, self.eot,
                    temperature=temperature, generator=program.generator,
                    program=program, **kw)
                return self._results(rows, tokens, lengths, aux)
            ckv = model.cross_kvs(xa, self.quantized_cross_kv, rows=self._row_chunk(rows))
            del xa
            if k:
                # The cross-K/V stay untiled: the K beams of a stream share
                # one read of them (nn.layers._beam_fold).
                caches = model.init_caches(rows * k, self.cache_dtype, None,
                                           self.quantized_cache)
                tokens, lengths, _scores, aux = beam_search(
                    self._make_step(ckv), caches, prompt, self.max_len, self.eot,
                    beams=k, length_penalty=self.length_penalty, **kw)
            elif not greedy:
                # The draft encodes the same mel; both cache sets hold the
                # stale-write workspace past the horizon.
                d_model = self.draft_model
                gamma = self.speculative_gamma
                d_ckv = d_model.cross_kvs(self._encode(mel, d_model),
                                          self.quantized_cross_kv, rows=self._row_chunk(rows))
                horizon = self.max_len + gamma + 2
                t_caches = model.init_caches(rows, self.cache_dtype, horizon,
                                             self.quantized_cache)
                d_caches = d_model.init_caches(rows, self.cache_dtype, horizon,
                                               self.quantized_cache)
                tokens, lengths, aux = speculative_greedy_decode(
                    self._make_step(ckv), self._make_step(d_ckv, d_model),
                    t_caches, d_caches, prompt, self.max_len, self.eot, gamma=gamma,
                    stats=self.speculative_stats, **kw)
            else:
                caches = model.init_caches(rows, self.cache_dtype, None,
                                           self.quantized_cache)
                gen = torch.Generator(device=self.device).manual_seed(42 + seed)
                tokens, lengths, aux = greedy_decode(
                    self._make_step(ckv), caches, prompt, self.max_len, self.eot,
                    temperature=temperature, generator=gen, **kw)
            return self._results(rows, tokens, lengths, aux)

        return fn

    def _results(self, rows: int, tokens, lengths, aux):
        """A decode program's device results -> numpy arrays of the whole
        batch (a zero no-speech probability where the family has none)."""
        if "no_speech_prob" not in aux:
            aux["no_speech_prob"] = torch.zeros((rows,), dtype=torch.float32,
                                                device=self.device)
        return (self._to_host(tokens), self._to_host(lengths),
                {k: self._to_host(v) for k, v in aux.items()})

    @torch.inference_mode()
    def _align_fn(self, mel: torch.Tensor, tokens: np.ndarray, xa=None):
        """The teacher-forced alignment pass over ``tokens`` (B, max_len):
        (alignment map (B, max_len, T_audio), realized-token probabilities
        (B, max_len)) from one forward, as numpy arrays. ``xa``: the
        encoder output of ``mel`` where the caller has it."""
        if xa is None:
            xa = self._encode(mel)
        amap, probs = self.model.cross_attention_map(
            torch.as_tensor(self._rows(tokens), dtype=torch.long, device=self.device),
            xa, True)
        return self._to_host(amap), self._to_host(probs)

    @torch.inference_mode()
    def _language_logits(self, windows: np.ndarray) -> np.ndarray:
        """One decoder step after <|startoftranscript|> for a (b, samples)
        batch of first windows -> (b, vocab) f32 logits, over the
        unquantized cross-K/V and a float cache of 128 positions."""
        model = self.model
        xa = self._encode(self._features(windows))
        b = xa.shape[0]  # this rank's rows
        caches = model.init_caches(b, self.cache_dtype, 128)
        prompt = torch.full((b, 1), self.token_table.sot, dtype=torch.long,
                            device=self.device)
        logits, _ = model.decode_step(prompt, caches, model.cross_kvs(xa), 0)
        return self._to_host(logits[:, -1].float())

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
