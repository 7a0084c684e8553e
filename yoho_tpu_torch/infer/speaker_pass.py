"""Speaker post-passes for :class:`Transcriber`: voiceprint extraction,
diarization and enrolled-speaker naming.

The JAX package's ``infer/speaker_pass.py``. The YOHO family reads speaker
embeddings at ``<|voiceprint|>`` slots in one teacher-forced pass over the
decoded tokens, injecting one slot at each segment's end when the model
emitted none (the training layout); the whisper family diarizes segment
spans after decoding with a ``VoiceprintEncoder``. Both cluster the
voiceprints into speakers and, with enrolled voiceprints, name them.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from yoho_tpu_torch.infer.diarize import (
    cluster_voiceprints,
    diarize_segments,
    name_speakers,
)
from yoho_tpu_torch.infer.longform import Segment


class SpeakerPassMixin:
    """Voiceprint / diarization / naming half of the Transcriber."""

    def _voiceprint_rows(self, tokens: np.ndarray, per_window: List[List[Segment]],
                         lengths=None) -> np.ndarray:
        """The teacher-forced rows (B, max_len) of the voiceprint pass: each
        window's decoded tokens with one ``<|voiceprint|>`` injected at the
        end of every segment, in the walk of ``_tokens_to_segments``
        (paired closes, gap-text segments, an open tail), so the i-th slot
        belongs to the i-th segment. Rows that already hold slots keep
        them. The decoder is causal: the states at the read positions (the
        token before each slot) are those of the unmodified sequence."""
        pad = np.zeros((tokens.shape[0], self.max_len), np.int64)
        pad[:, : tokens.shape[1]] = tokens[:, : self.max_len]
        tok = self.tokenizer
        vp_id = tok.voiceprint_id
        n_prompt = len(self._prompt_ids())
        for w, segs in enumerate(per_window):
            if not segs:
                continue
            length = int(lengths[w]) if lengths is not None else self.max_len
            pad[w, length:] = 0  # past the length nothing may read as a slot
            toks = pad[w, :length].tolist()
            if vp_id in toks[n_prompt:]:
                continue  # the model emitted its own slots
            out: List[int] = []
            n_text = 0
            start_open = False
            for t in toks[n_prompt:]:
                if tok.is_timestamp(t):
                    if start_open:
                        out.append(t)
                        out.append(vp_id)  # paired close -> slot follows
                    else:
                        if n_text:  # gap or leading text closes here
                            out.append(vp_id)
                        out.append(t)
                    start_open = not start_open
                    n_text = 0
                else:
                    if t not in (tok.sot_id, tok.eot_id):
                        n_text += 1
                    out.append(t)
            if n_text and start_open:  # open tail closed by the window end
                out.append(vp_id)
            row = toks[:n_prompt] + out
            if len(row) > self.max_len:
                # Past the horizon: the final slot overwrites the last kept
                # token; earlier read positions see the original prefix.
                row = row[: self.max_len]
                if row[-1] != vp_id:
                    row[-1] = vp_id
            pad[w] = 0
            pad[w, : len(row)] = row
        return pad

    @torch.inference_mode()
    def _attach_voiceprints(self, mel: torch.Tensor, tokens: np.ndarray,
                            per_window: List[List[Segment]], lengths=None,
                            xa=None) -> None:
        """YOHO family: one teacher-forced pass gives every segment the
        voiceprint read at the position before its slot. ``xa``: ``mel``'s
        encoder output where the caller has it."""
        if self.family != "yoho":
            return
        pad = self._voiceprint_rows(tokens, per_window, lengths)
        rows = torch.as_tensor(self._rows(pad), device=self.device)
        vp = self.model.voiceprints(rows, mel, self._encode(mel) if xa is None else xa)
        vp = self._to_host(vp.float())
        vp_id = self.tokenizer.voiceprint_id
        for w, segs in enumerate(per_window):
            positions = np.nonzero(pad[w] == vp_id)[0]
            for seg, p in zip(segs, positions):
                seg.voiceprint = vp[w, max(p - 1, 0)]

    def _apply_speaker_passes(self, segments: List[Segment], original_audio) -> None:
        """Diarization and speaker naming on stitched segments (the batched,
        sequential and continuous paths share it)."""
        if self.family == "yoho":
            labels = cluster_voiceprints([s.voiceprint for s in segments],
                                         threshold=self.speaker_threshold)
            for seg, spk in zip(segments, labels):
                seg.speaker = spk
        elif self.diarize_encoder is not None:
            diarize_segments(segments, original_audio, self.sample_rate,
                             self.diarize_encoder, threshold=self.speaker_threshold)
        if self.enrolled_speakers:
            name_speakers(segments, self.enrolled_speakers,
                          threshold=self.speaker_threshold)
