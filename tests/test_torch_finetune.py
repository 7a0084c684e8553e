"""The port's whisper fine-tuner against the JAX package's, in float32 on
the TINY geometry of ``tests/test_whisper_finetune.py``:

* ``WhisperFinetuneDataloader`` batches (audio, tokens, mask) bit-identical
  for the same corpus and seed, augmentation off and on;
* from the same initial parameters (carried by ``load_jax_params``) and
  the same batch: the loss within 1e-5 relative, every parameter gradient
  within 1e-4 of its leaf's largest entry; the update losses of 3 full
  runs (2 mini-batches each) within 1e-4 relative;
* remat changes the port's gradients by at most 1e-6; freeze-encoder
  leaves the encoder bit-identical; the LoRA run's merged parameters equal
  JAX's ``merge_lora`` of its adapters within 1e-6;
* a run resumed from a port checkpoint ends bit-identical to an
  uninterrupted one; a JAX checkpoint is refused; the provenance guard;
* JAX's ``convert_hf_whisper`` of the port's export equals
  ``to_jax_params`` of the tuned model;
* the mirror of ``test_finetune_overfits_and_serves``: loss under a tenth
  of the initial after 120 updates, and the port's ``Transcriber`` on the
  tuned model reproduces the supervised words.
"""

import csv
import datetime as dt
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoho_tpu.core.config import WhisperConfig as JaxConfig
from yoho_tpu.nn.whisper import Whisper as JaxWhisper
from yoho_tpu.text.srt import Subtitle, compose_srt
from yoho_tpu.text.whisper_tokens import WhisperTokenTable as JaxTable
from yoho_tpu_torch.core.config import WhisperConfig
from yoho_tpu_torch.nn.params import jax_leaves, load_jax_params, to_jax_params
from yoho_tpu_torch.nn.whisper import Whisper
from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable
from yoho_tpu_torch.train.whisper_finetune import WhisperFinetuneDataloader, WhisperFinetuner

TINY = dict(n_mels=16, n_audio_ctx=32, n_audio_state=32, n_audio_head=4,
            n_audio_layer=1, n_text_ctx=48, n_text_state=32, n_text_head=4,
            n_text_layer=1, chunk_seconds=0.64)
WORDS = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot"]
F32 = dict(compute_dtype=torch.float32, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _WordBackend:
    def __init__(self, words):
        self.word_ids = {w: 100 + i for i, w in enumerate(words)}
        self.id_words = {v: k for k, v in self.word_ids.items()}

    def encode(self, text, add_special_tokens=False):
        return [self.word_ids[w] for w in text.split()]

    def decode(self, ids):
        return " ".join(self.id_words[int(i)] for i in ids if int(i) in self.id_words)


def _write_wav(path, data, sr=16000):
    pcm = np.clip(data * 32768, -32768, 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """``tests/test_whisper_finetune.py``'s corpus: 3 tracks x 3 short
    utterances, each a tone of its word's pitch."""
    root = tmp_path_factory.mktemp("ft_corpus")
    (root / "transcripts").mkdir()
    (root / "audio").mkdir()
    g = np.random.default_rng(0)
    for f in range(3):
        subs, t = [], 0.05
        audio = g.standard_normal(16000).astype(np.float32) * 0.003
        for u in range(3):
            w = (f + 2 * u) % len(WORDS)
            start, end = t, t + 0.15
            tone = 0.4 * np.sin(2 * np.pi * (300 + 120 * w) * np.arange(int(0.15 * 16000)) / 16000)
            audio[int(start * 16000):int(start * 16000) + len(tone)] += tone.astype(np.float32)
            subs.append(Subtitle(u + 1, dt.timedelta(seconds=start),
                                 dt.timedelta(seconds=end), WORDS[w]))
            t = end + 0.08
        (root / "transcripts" / f"t{f}.srt").write_text(compose_srt(subs))
        _write_wav(root / "audio" / f"t{f}.wav", audio)
    return root


@pytest.fixture(scope="module")
def tables():
    return (WhisperTokenTable(multilingual=True, text_backend=_WordBackend(WORDS)),
            JaxTable(multilingual=True, text_backend=_WordBackend(WORDS)))


@pytest.fixture(scope="module")
def init_params():
    """Initial parameters from the JAX package's init (host numpy)."""
    cfg = JaxConfig(**TINY)
    model = JaxWhisper(cfg, dtype=jnp.float32)
    return jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, cfg.n_frames, cfg.n_mels), jnp.float32),
        jnp.zeros((1, 4), jnp.int32))["params"])


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _kw(**over):
    kw = dict(batch_size=8, timestamps=False, augment=False, language_whitelist=["en"],
              validation_frequency=0, seed=0, learning_rate=3e-3, warmup_updates=1)
    kw.update(over)
    return kw


def _port(cfg_dict, init_params, tables, corpus, out, **kw):
    cfg = WhisperConfig(**cfg_dict)
    model = load_jax_params(Whisper(cfg, device="cpu"), init_params)
    return WhisperFinetuner(cfg, model, tables[0], corpus, out, **F32, **kw)


@pytest.mark.parametrize("augment", [False, True])
def test_dataloader_batches_equal_jax(corpus, tables, augment):
    from yoho_tpu.train.whisper_finetune import WhisperFinetuneDataloader as JaxLoader

    kw = dict(batch_size=4, timestamps=True, language_whitelist=["en"], augment=augment,
              shuffle=True, use_multiprocessing=False, warmup_queue=False,
              disable_warnings=True, seed=3, speechless_ratio=0.25)
    ours = WhisperFinetuneDataloader((0.0, 1.0), corpus, WhisperConfig(**TINY), tables[0], **kw)
    ref = JaxLoader((0.0, 1.0), corpus, JaxConfig(**TINY), tables[1], **kw)
    for _ in range(4):  # past an epoch's end (9 utterances, 2 batches an epoch)
        a, b = ours.get_prepared_batch(), ref.get_prepared_batch()
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_step_loss_and_gradients_match_jax(corpus, tables, init_params, tmp_path):
    from yoho_tpu.audio.frontend import whisper_log_mel
    from yoho_tpu.train.trainer import masked_ce_loss as jax_ce

    tuner = _port(TINY, init_params, tables, corpus, tmp_path / "p", **_kw())
    batch = tuner.train_dataloader.get_batch(0)
    jm = JaxWhisper(JaxConfig(**TINY), dtype=jnp.float32)

    def jloss(params, audio, tokens, mask):
        mel = whisper_log_mel(audio, n_mels=TINY["n_mels"])
        return jax_ce(jm.apply({"params": params}, mel, tokens), tokens, mask)

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(
        init_params, jnp.asarray(batch[0]), jnp.asarray(batch[1]), jnp.asarray(batch[2]))
    placed = tuner._place(batch)
    loss = tuner._batch_loss(*placed)
    names = list(tuner._train)
    grads = torch.autograd.grad(loss, [tuner._train[k][0] for k in names])
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    want = dict(_flat(jax.device_get(want_grads)))
    assert set(names) == set(want)
    for k, g in zip(names, grads):
        got = tuner._train[k][1](g).numpy()
        top = np.abs(want[k]).max()
        np.testing.assert_allclose(got, want[k], rtol=0, atol=1e-4 * top, err_msg=k)

    # remat recomputes each block: the same gradients.
    tuner.model.remat = True
    loss_r = tuner._batch_loss(*placed)
    grads_r = torch.autograd.grad(loss_r, [tuner._train[k][0] for k in names])
    assert float(loss_r.detach()) == float(loss.detach())
    for k, a, b in zip(names, grads, grads_r):
        assert float((a - b).abs().max()) <= 1e-6 * max(float(a.abs().max()), 1e-30), k


def _metric_losses(out):
    with open(out / "metrics.csv") as f:
        return [float(r["loss"]) for r in csv.DictReader(f)]


def test_update_losses_match_jax(corpus, tables, init_params, tmp_path):
    from yoho_tpu.train.whisper_finetune import WhisperFinetuner as JaxTuner

    kw = _kw(updates=3, accumulated_batches=2)
    tuner = _port(TINY, init_params, tables, corpus, tmp_path / "p", **kw)
    tuner.run()
    jt = JaxTuner(JaxConfig(**TINY), init_params, tables[1], corpus, tmp_path / "j",
                  compute_dtype=jnp.float32, **kw)
    jt.run()
    want = _metric_losses(tmp_path / "j")
    assert len(want) == 3 and _metric_losses(tmp_path / "p") == pytest.approx(
        tuner.update_losses, rel=1e-7)
    assert tuner.update_losses == pytest.approx(want, rel=1e-4)
    # The port's export read back by the JAX package's HF converter.
    from safetensors.numpy import load_file

    from yoho_tpu.nn.convert import convert_hf_whisper

    back = dict(_flat(convert_hf_whisper(load_file(tmp_path / "p" / "model.safetensors"),
                                         JaxConfig(**TINY))))
    ours = dict(_flat(to_jax_params(tuner.model)))
    assert back.keys() == ours.keys()
    for k in ours:
        np.testing.assert_allclose(back[k], ours[k], rtol=0, atol=1e-6, err_msg=k)


def test_freeze_encoder_and_lora(corpus, tables, init_params, tmp_path):
    """freeze-encoder: the encoder bit-identical, the decoder moved. LoRA:
    the base bit-identical, and the merged parameters equal JAX's
    ``merge_lora`` of the trained adapters; the saved adapter applies in
    the JAX package."""
    from yoho_tpu.nn import lora as jl

    tuner = _port(TINY, init_params, tables, corpus, tmp_path / "f",
                  **_kw(updates=2, freeze_encoder=True))
    tuner.run()
    now = dict(_flat(to_jax_params(tuner.model)))
    before = dict(_flat(init_params))
    assert all(np.array_equal(now[k], before[k]) for k in now if k.startswith("encoder/"))
    assert any(not np.array_equal(now[k], before[k]) for k in now if k.startswith("decoder/"))
    assert not any(k.startswith("encoder/") for k in tuner.opt_state["acc_grads"])

    tuner = _port(TINY, init_params, tables, corpus, tmp_path / "l",
                  **_kw(updates=3, lora_rank=4))
    tuner.run()
    from yoho_tpu_torch.nn import lora as tl

    adapters = {p: {k: v.detach().numpy() for k, v in ab.items()}
                for p, ab in tl.adapters_of(tuner.model).items()}
    assert adapters.keys() == set(jl.select_lora_targets(init_params))
    assert any(np.abs(ab["b"]).max() > 0 for ab in adapters.values())
    with tuner._eval_context():
        merged = dict(_flat(to_jax_params(tuner.model)))
    want = dict(_flat(jax.device_get(jl.merge_lora(init_params, adapters, tuner.lora_scale))))
    for k in want:
        np.testing.assert_allclose(merged[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    applied = dict(_flat(jax.device_get(jl.apply_adapter(init_params, tmp_path / "l"))))
    for k in want:
        np.testing.assert_allclose(applied[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    tl.detach_lora(tuner.model)
    base = dict(_flat(to_jax_params(tuner.model)))
    assert all(np.array_equal(base[k], before[k]) for k in base)


def test_resume_ends_bit_identical_and_guards(corpus, tables, init_params, tmp_path):
    from yoho_tpu.train.whisper_finetune import WhisperFinetuner as JaxTuner

    kw = _kw(updates=4, accumulated_batches=2)
    whole = _port(TINY, init_params, tables, corpus, tmp_path / "whole", **kw)
    whole.run()
    half = _port(TINY, init_params, tables, corpus, tmp_path / "half", **dict(kw, updates=2))
    half.run()
    resumed = _port(TINY, init_params, tables, corpus, tmp_path / "half", **kw)
    assert resumed.step == 4
    resumed.run()
    for k, t in jax_leaves(whole.model).items():
        assert torch.equal(t, jax_leaves(resumed.model)[k]), k
    for k, t in whole.opt_state["inner"]["mu"].items():
        assert torch.equal(t, resumed.opt_state["inner"]["mu"][k]), k
    # A run from another source refuses the checkpoint.
    with pytest.raises(ValueError, match="different"):
        WhisperFinetuner(WhisperConfig(**TINY), init_params, tables[0], corpus,
                         tmp_path / "half", src_dir="/elsewhere", **F32, **kw)
    # A checkpoint of the JAX package does not resume in the port.
    JaxTuner(JaxConfig(**TINY), init_params, tables[1], corpus, tmp_path / "jax",
             compute_dtype=jnp.float32, **dict(kw, updates=1, accumulated_batches=1)).run()
    with pytest.raises(ValueError, match="not written by the PyTorch port"):
        _port(TINY, init_params, tables, corpus, tmp_path / "jax", **kw)


def _first_window(wav_path, n_samples):
    with wave.open(str(wav_path), "rb") as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    audio = (pcm / 32768.0).astype(np.float32)
    if len(audio) < n_samples:
        audio = np.pad(audio, (0, n_samples - len(audio)))
    return audio[:n_samples]


def test_finetune_overfits_and_serves(corpus, tables, init_params, tmp_path):
    """``tests/test_whisper_finetune.py::test_finetune_overfits_and_serves``
    through the port: the loss collapses on the 9-utterance corpus and the
    port's Transcriber on the tuned model transcribes the training audio."""
    from yoho_tpu_torch.infer.pipeline import Transcriber

    out = tmp_path / "tuned"
    tuner = _port(TINY, init_params, tables, corpus, out,
                  **_kw(updates=120, warmup_updates=10, validation_frequency=60,
                        validation_samples=2))
    first = tuner._place(tuner.train_dataloader.get_batch(0))
    loss0 = float(tuner._val_loss(*first))
    tuner.run()
    lossN = float(tuner._val_loss(*first))
    assert lossN < 0.1 * loss0, (loss0, lossN)
    assert (out / "metrics.csv").exists() and (out / "validations.jsonl").read_text().strip()
    assert (out / "model.safetensors").exists()

    t = Transcriber(tuner.model, token_table=tables[0], batch_size=1, timestamps=False,
                    language="en", device="cpu")
    srt = (corpus / "transcripts" / "t0.srt").read_text()
    got = t.transcribe(_first_window(corpus / "audio" / "t0.wav",
                                     WhisperConfig(**TINY).n_samples)).text
    expected_words = [line.strip() for line in srt.splitlines() if line.strip() in WORDS]
    got_words = got.split()
    assert got_words, got
    assert all(w in expected_words for w in got_words), (got, expected_words)
    assert got_words[0] == expected_words[0]
