"""The port's ``WhisperDistiller`` against the JAX package's, in float32 on
``tests/test_distill.py``'s geometries (a 32-wide teacher, a 24-wide
student, the same corpus): from the same teacher and student parameters,
the update losses of a 3-update run (temperature KL + CE) within 1e-4
relative and the masked teacher agreement at validation within 1e-5; the
teacher stays bit-identical; the export describes the student; and the
refusals of the JAX distiller. ``distill_kl_loss`` and the agreement on
the same logits are held in ``tests/test_torch_train_ops.py``.
"""

import csv
import datetime as dt
import json
import wave

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
from yoho_tpu_torch.nn.params import load_jax_params, to_jax_params
from yoho_tpu_torch.nn.whisper import Whisper
from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable
from yoho_tpu_torch.train.distill import WhisperDistiller

TEACHER = dict(n_mels=16, n_audio_ctx=32, n_audio_state=32, n_audio_head=4,
               n_audio_layer=1, n_text_ctx=48, n_text_state=32, n_text_head=4,
               n_text_layer=1, chunk_seconds=0.64)
STUDENT = dict(TEACHER, n_audio_state=24, n_text_state=24)
WORDS = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot"]
KW = dict(alpha=0.3, tau=2.0, batch_size=8, updates=3, warmup_updates=1,
          learning_rate=3e-3, timestamps=False, augment=False, language_whitelist=["en"],
          validation_frequency=3, validation_samples=1, seed=0)


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


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("distill_corpus")
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
        pcm = np.clip(audio * 32768, -32768, 32767).astype(np.int16)
        with wave.open(str(root / "audio" / f"t{f}.wav"), "wb") as w_:
            w_.setnchannels(1)
            w_.setsampwidth(2)
            w_.setframerate(16000)
            w_.writeframes(pcm.tobytes())
    return root


def _init(cfg_dict, seed):
    cfg = JaxConfig(**cfg_dict)
    model = JaxWhisper(cfg, dtype=jnp.float32)
    return jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, cfg.n_frames, cfg.n_mels), jnp.float32),
        jnp.zeros((1, 4), jnp.int32))["params"])


@pytest.fixture(scope="module")
def params():
    return _init(TEACHER, 0), _init(STUDENT, 1)


def _table():
    return WhisperTokenTable(multilingual=True, text_backend=_WordBackend(WORDS))


def _losses(path):
    with open(path / "metrics.csv") as f:
        return [float(r["loss"]) for r in csv.DictReader(f)]


def test_distiller_matches_jax(corpus, params, tmp_path, capsys):
    from yoho_tpu.train.distill import WhisperDistiller as JaxDistiller

    t_params, s_params = params
    teacher = load_jax_params(Whisper(WhisperConfig(**TEACHER), device="cpu"), t_params)
    ours = WhisperDistiller(WhisperConfig(**TEACHER), teacher, WhisperConfig(**STUDENT),
                            s_params, _table(), corpus, tmp_path / "port",
                            compute_dtype=torch.float32, device="cpu", **KW)
    ours.run()
    ref = JaxDistiller(JaxConfig(**TEACHER), t_params, JaxConfig(**STUDENT), s_params,
                       JaxTable(multilingual=True, text_backend=_WordBackend(WORDS)),
                       corpus, tmp_path / "jax", compute_dtype=jnp.float32, **KW)
    ref.run()
    assert ours.update_losses == pytest.approx(_losses(tmp_path / "jax"), rel=1e-4)
    assert ours.last_agreement == pytest.approx(ref.last_agreement, abs=1e-5)
    assert "teacher-agreement" in capsys.readouterr().out
    # The teacher is frozen; the student's export describes the student.
    for (k, v), (_, w) in zip(sorted(_flat(to_jax_params(teacher))), sorted(_flat(t_params))):
        assert np.array_equal(v, np.asarray(w)), k
    cfg_json = json.loads((tmp_path / "port" / "config.json").read_text())
    assert cfg_json["d_model"] == 24 and cfg_json["num_mel_bins"] == 16
    from safetensors.numpy import load_file

    from yoho_tpu.nn.convert import convert_hf_whisper

    back = dict(_flat(convert_hf_whisper(load_file(tmp_path / "port" / "model.safetensors"),
                                         JaxConfig(**STUDENT))))
    for k, v in _flat(to_jax_params(ours.model)):
        np.testing.assert_allclose(back[k], v, rtol=0, atol=1e-6, err_msg=k)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


@pytest.mark.parametrize("bad,match", [
    (dict(student=dict(STUDENT, n_vocab=12345)), "vocab"),
    (dict(alpha=1.5), "alpha"),
    (dict(tau=0.0), "tau"),
    (dict(lora_rank=4), "LoRA"),
])
def test_distiller_refusals(corpus, params, tmp_path, bad, match):
    t_params, s_params = params
    student = bad.pop("student", STUDENT)
    kw = dict(KW, **bad)
    with pytest.raises(ValueError, match=match):
        WhisperDistiller(WhisperConfig(**TEACHER), t_params, WhisperConfig(**student),
                         s_params, _table(), corpus, tmp_path / "bad",
                         compute_dtype=torch.float32, device="cpu", **kw)
