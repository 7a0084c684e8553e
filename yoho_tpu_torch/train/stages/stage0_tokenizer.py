"""Stage 0: train the session tokenizer (the JAX package's
``train/stages/stage0_tokenizer.py``).

Streams standardized utterances from the noisy, clean and finetune
transcript corpora (language whitelist applied), trains byte-level BPE
with the special-token scheme (``<|startoftranscript|>``,
``<|endoftranscript|>``, ``<|voiceprint|>``, one ``<|t-i|>`` per frame of
the long-context-scaled window), writes it to ``weights.tokenizer`` and
checks a round trip. The native C++ trainer runs where it builds.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Iterator

from yoho_tpu_torch.core.config import SessionConfig
from yoho_tpu_torch.text.corpus import iter_transcripts
from yoho_tpu_torch.text.standardize import standardize_text
from yoho_tpu_torch.text.tokenizer import train_tokenizer


def load_transcripts(config: SessionConfig) -> Iterator[str]:
    dirs = [config.dataset.noisy, config.dataset.clean, config.dataset.finetune]
    for d in dirs:
        for _path, lang, subs in iter_transcripts(
                Path(d) / "transcripts", config.language_whitelist):
            for s in subs:
                out = standardize_text(s.content, lang)
                if out:
                    yield out


def main(config: SessionConfig) -> None:
    hp = config.hyperparameters.tokenizer
    n_sentences = 0

    def counted():
        nonlocal n_sentences
        for s in load_transcripts(config):
            n_sentences += 1
            yield s

    # A long-context session timestamps utterances up to factor x the base
    # window, so the <|t-i|> specials cover the scaled frame range.
    factor = max(config.hyperparameters.transcribe_pretrain.long_context_factor,
                 config.hyperparameters.transcribe_finetune.long_context_factor)
    tokenizer = train_tokenizer(counted(), vocab_size=hp.vocab_size,
                                max_token_length=hp.max_token_length,
                                max_audio_len=config.yoho.max_audio_len * factor)
    if n_sentences == 0:
        corpora = ", ".join(str(d) for d in (config.dataset.noisy,
                                             config.dataset.clean,
                                             config.dataset.finetune))
        warnings.warn(
            f"stage 0 found NO transcripts under any of: {corpora} "
            "(expected <dir>/transcripts/*.srt) — the tokenizer was "
            "trained on an empty corpus (byte fallback vocab only)",
            stacklevel=1)
    else:
        print(f"Trained on {n_sentences} standardized sentences")
    Path(config.weights.tokenizer).parent.mkdir(parents=True, exist_ok=True)
    tokenizer.save(config.weights.tokenizer)

    sample = "Hello, world!"
    encoded = tokenizer.encode(sample)
    print(f"Trained tokenizer: vocab_size={tokenizer.vocab_size}")
    print(f"Encoded: {encoded}")
    print(f"Decoded: {tokenizer.decode(encoded)}")
