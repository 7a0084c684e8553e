"""The port's YOHO session training (stages 0 and 1) against the JAX
package's, on a synthetic SRT + WAV corpus made from a seed.

One session TOML (tiny geometry: 2 + 2 blocks, dims 32, 16 mels, 64
frames) is loaded by both packages' ``load_session_config``; each package
trains in its own session directory. Checked, on the CPU:

* stage 0: the tokenizer equals JAX's on the same corpus;
* ``TranscriptionDataloader``'s YOHO batches (audio, tokens, loss mask,
  spans) are bit-equal to JAX's for two seeds and two epochs, with
  augmentation and speechless samples;
* ``ASRTrainer``'s loss and gradients of one batch equal JAX's
  ``value_and_grad`` of the same loss at 2e-4 (dense, and MoE with the
  auxiliary loss);
* two applied updates (batch 4, 2 accumulated) from the same weights give
  JAX's update losses at 1e-4 relative; ``metrics.csv``,
  ``validations.jsonl`` and the checkpoint are written, a new trainer
  resumes at the checkpointed step, and ``weights.asr`` loads in JAX's
  ``load_params`` and serves through ``load_transcriber``;
* ``create-session``, ``run-session`` 0 and 1 through the command line;
  stages 3 and 4 stop as JAX's do without their inputs
  (``tests/test_torch_yoho_stages.py`` trains stages 2-4).
"""

import contextlib
import datetime as dt
import io
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoho_tpu.core.config import load_session_config as jax_session
from yoho_tpu.text.srt import Subtitle, compose_srt
from yoho_tpu_torch.core.config import load_session_config

SENTENCES = ["hello there friend", "this is a test", "the quick brown fox",
             "we are training a model", "speech goes in text comes out",
             "one more utterance here"]
TOML = """\
language_whitelist = ['en']

[yoho]
sample_rate = 16000
n_mel_bands = 16
n_fft = 400
stft_hop = 160
max_audio_len = 64
max_text_len = 32
dims = 32
n_audio_heads = 4
n_audio_blocks = 2
n_text_heads = 4
n_text_blocks = 2
{moe}
[dataset]
noisy = '{root}/noisy'
clean = '{root}/clean'
finetune = '{root}/finetune'
ambient = '{root}/ambient'
speakers = '{root}/speakers'

[hyperparameters.tokenizer]
max_token_length = 32
vocab_size = 420

[hyperparameters.transcribe_pretrain]
learning_rate = 0.001
final_learning_rate = 0.00001
batch_size = 4
accumulated_batches = 2
updates = 50
warmup_updates = 2
validation_frequency = 1
validation_samples = 2
speechless_sample_ratio = 0.25
"""
MOE = "n_experts = 2\nmoe_every_n = 1\nmoe_in_decoder = true\n"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _wav(path, data, sr=16000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.clip(data * 32768, -32768, 32767).astype(np.int16).tobytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """3 tracks of 4 tone utterances (0.2 s, 0.3 s apart) in noise, an
    ambient noise file for the speechless samples."""
    root = tmp_path_factory.mktemp("corpus")
    g = np.random.default_rng(0)
    for d in ("noisy", "clean", "finetune", "ambient", "speakers"):
        (root / d / "transcripts").mkdir(parents=True)
        (root / d / "audio").mkdir(parents=True)
    for f in range(3):
        subs, t = [], 0.1
        audio = g.standard_normal(int(16000 * 2.5)).astype(np.float32) * 0.01
        for u in range(4):
            tone = 0.3 * np.sin(2 * np.pi * (300 + 100 * u) * np.arange(3200) / 16000)
            audio[int(t * 16000): int(t * 16000) + 3200] += tone
            subs.append(Subtitle(u + 1, dt.timedelta(seconds=t),
                                 dt.timedelta(seconds=t + 0.2),
                                 SENTENCES[(f + u) % len(SENTENCES)]))
            t += 0.5
        (root / "noisy" / "transcripts" / f"track{f}.srt").write_text(compose_srt(subs))
        _wav(root / "noisy" / "audio" / f"track{f}.wav", audio)
    _wav(root / "ambient" / "audio" / "amb.wav",
         g.standard_normal(16000).astype(np.float32) * 0.01)
    return root


def _session(root, corpus, name="s", moe=""):
    d = root / name
    (d / "weights").mkdir(parents=True, exist_ok=True)
    (d / "config.toml").write_text(TOML.format(root=corpus, moe=moe))
    return d


@pytest.fixture(scope="module")
def sessions(corpus, tmp_path_factory):
    """The same session TOML under a JAX root and a port root; stage 0
    trained in each package."""
    from yoho_tpu.train.stages.stage0_tokenizer import main as jax_stage0
    from yoho_tpu_torch.train.stages.stage0_tokenizer import main as stage0

    jroot, troot = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    _session(jroot, corpus)
    _session(troot, corpus)
    jcfg, tcfg = jax_session("s", jroot), load_session_config("s", troot)
    with contextlib.redirect_stdout(io.StringIO()):
        jax_stage0(jcfg)
        stage0(tcfg)
    return jcfg, tcfg


def test_stage0_tokenizer_equals_jax(sessions):
    from yoho_tpu.text.tokenizer import YOHOTokenizer as JaxTok
    from yoho_tpu_torch.text.tokenizer import YOHOTokenizer

    jcfg, tcfg = sessions
    assert tcfg.weights.tokenizer.read_bytes() == jcfg.weights.tokenizer.read_bytes()
    tok, jtok = YOHOTokenizer.load(tcfg.weights.tokenizer), JaxTok.load(jcfg.weights.tokenizer)
    text = "<|startoftranscript|><|t-3|>hello there friend<|t-20|><|voiceprint|>"
    assert tok.encode(text) == jtok.encode(text) and tok.decode(tok.encode(text)) == text
    assert tok.vocab_size == jtok.vocab_size  # the corpus runs out of merges below 420


@pytest.mark.parametrize("seed", [0, 5])
def test_yoho_batches_bit_equal_to_jax(sessions, seed):
    """Two seeds, two epochs, augmentation on, a quarter speechless; with
    spans (stage 4's input)."""
    from yoho_tpu.text.tokenizer import YOHOTokenizer as JaxTok
    from yoho_tpu.train.dataloader import TranscriptionDataloader as JaxDL
    from yoho_tpu_torch.text.tokenizer import YOHOTokenizer
    from yoho_tpu_torch.train.dataloader import TranscriptionDataloader

    jcfg, tcfg = sessions
    kw = dict(batch_size=4, seed=seed, speechless_ratio=0.25, return_spans=True,
              use_multiprocessing=False)
    jdl = JaxDL((0.0, 1.0), jcfg, JaxTok.load(jcfg.weights.tokenizer), **kw)
    tdl = TranscriptionDataloader((0.0, 1.0), tcfg, YOHOTokenizer.load(tcfg.weights.tokenizer),
                                  **kw)
    speechless = 0
    for epoch in (0, 1):
        for dl in (jdl, tdl):
            dl._epoch = epoch
            dl.on_epoch()
        for idx in range(jdl.get_num_batches()):
            want, got = jdl.get_batch(idx), tdl.get_batch(idx)
            assert len(got) == 5
            for w, g in zip(want, got):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)
            speechless += int((got[4].sum(axis=1) == 0).sum())
    assert speechless > 0


# --------------------------------------------------------------- train step

def _jax_loss_and_grads(jcfg, tok, params, batch):
    """The JAX trainer's loss (its ``loss_fn`` and preprocess) and its
    gradient."""
    from yoho_tpu.audio.frontend import yoho_log_mel
    from yoho_tpu.nn.moe import collect_aux_losses
    from yoho_tpu.nn.yoho import YOHOModel as JaxYOHO
    from yoho_tpu.train.trainer import masked_ce_loss

    cfg = jcfg.yoho
    model = JaxYOHO(cfg, tok.vocab_size)

    def loss_fn(p, audio, tokens, mask):
        mel = yoho_log_mel(audio, cfg)
        logits, st = model.apply({"params": p}, tokens, mel, mutable=["intermediates"])
        aux = collect_aux_losses(st.get("intermediates", {}))
        return masked_ce_loss(logits, tokens, mask) + (
            cfg.moe_aux_weight * aux if cfg.n_experts > 0 else 0.0)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, *map(jnp.asarray, batch))
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        yield from _flat(v, p) if isinstance(v, dict) else [(p, v)]


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_train_step_loss_and_gradients_match_jax(sessions, corpus, tmp_path, moe):
    from yoho_tpu.text.tokenizer import YOHOTokenizer as JaxTok
    from yoho_tpu.train.dataloader import TranscriptionDataloader as JaxDL
    from yoho_tpu_torch.nn.params import to_jax_params
    from yoho_tpu_torch.train.trainer import ASRTrainer

    jcfg, tcfg = sessions
    if moe:
        _session(tmp_path, corpus, moe=MOE)
        tcfg = load_session_config("s", tmp_path)
        jcfg = jax_session("s", tmp_path)
    tok = JaxTok.load(jcfg.weights.tokenizer if not moe else sessions[0].weights.tokenizer)
    from yoho_tpu_torch.text.tokenizer import YOHOTokenizer

    trainer = ASRTrainer(tcfg, tokenizer=YOHOTokenizer.load(sessions[1].weights.tokenizer),
                         device="cpu")
    trainer.train_dataloader.terminate()
    trainer.val_dataloader.terminate()
    params = to_jax_params(trainer.model)
    batch = JaxDL((0.0, 1.0), jcfg, tok, batch_size=4, use_multiprocessing=False).get_batch(0)
    want_loss, want_grads = _jax_loss_and_grads(jcfg, tok, params, batch)
    loss = trainer._batch_loss(*trainer._place(batch))
    grads = trainer.gradients(loss)
    assert loss.item() == pytest.approx(want_loss, abs=2e-4)
    want = dict(_flat(want_grads))
    assert set(want) == set(trainer._train)
    for (k, (_t, view)), g in zip(trainer._train.items(), grads):
        np.testing.assert_allclose(view(g).numpy(), want[k], atol=2e-4, rtol=0, err_msg=k)
    if moe:
        from yoho_tpu_torch.nn.moe import collect_aux_losses

        assert float(collect_aux_losses(trainer.model).detach()) > 0


# ---------------------------------------------------------------- short run

@pytest.fixture(scope="module")
def short_runs(sessions):
    """Two applied updates in each package from the same weights."""
    from yoho_tpu.parallel.mesh import make_mesh
    from yoho_tpu.text.tokenizer import YOHOTokenizer as JaxTok
    from yoho_tpu.train.trainer import ASRTrainer as JaxTrainer
    from yoho_tpu_torch.nn.params import to_jax_params
    from yoho_tpu_torch.train.trainer import ASRTrainer

    jcfg, tcfg = sessions
    trainer = ASRTrainer(tcfg, device="cpu")
    params = to_jax_params(trainer.model)
    jt = JaxTrainer(jcfg, tokenizer=JaxTok.load(jcfg.weights.tokenizer), stage=1,
                    mesh=make_mesh(data=1, model=1, devices=jax.devices()[:1]),
                    init_params=params)
    jt.run(max_updates=2)
    trainer.run(max_updates=2)
    return jt, trainer


def _csv_losses(path):
    return [float(line.split(",")[2]) for line in path.read_text().strip().splitlines()[1:]]


def test_two_updates_match_jax(short_runs):
    jt, trainer = short_runs
    want = _csv_losses(jt.stage_path / "metrics.csv")
    assert len(trainer.update_losses) == len(want) == 2
    np.testing.assert_allclose(trainer.update_losses, want, rtol=1e-4)
    np.testing.assert_allclose(_csv_losses(trainer.stage_path / "metrics.csv"), want, rtol=1e-4)
    rows = [line.split(",") for line in
            (trainer.stage_path / "metrics.csv").read_text().strip().splitlines()[1:]]
    jrows = [line.split(",") for line in
             (jt.stage_path / "metrics.csv").read_text().strip().splitlines()[1:]]
    # The schedule read at the applied update, and a validation loss each.
    assert [r[:2] for r in rows] == [r[:2] for r in jrows] and all(r[3] for r in rows)
    np.testing.assert_allclose([float(r[3]) for r in rows], [float(r[3]) for r in jrows],
                               rtol=1e-4)
    assert len((trainer.stage_path / "validations.jsonl").read_text().splitlines()) == 2


def test_checkpoint_resume_and_export(short_runs):
    """The checkpoint resumes at the applied step; ``weights.asr`` is a
    flax params tree JAX's ``load_params`` reads, and it serves."""
    from yoho_tpu.train.checkpoint import load_params as jax_load_params
    from yoho_tpu_torch.load import load_transcriber
    from yoho_tpu_torch.nn.params import to_jax_params
    from yoho_tpu_torch.train.trainer import ASRTrainer

    jt, trainer = short_runs
    assert trainer.step == 4 and (trainer.stage_path / "checkpoint.msgpack").exists()
    resumed = ASRTrainer(trainer.config, device="cpu")
    resumed.train_dataloader.terminate()
    resumed.val_dataloader.terminate()
    assert resumed.step == 4 and resumed.opt_state["inner"]["count"] == 2
    for (k, a), b in zip(resumed._leaves.items(), trainer._leaves.values()):
        assert torch.equal(a, b), k
    tree = jax_load_params(trainer.config.weights.asr, jax.device_get(jt.state.params))
    ours = to_jax_params(trainer.model)
    got = dict(_flat(tree))
    for k, v in _flat(ours):
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
    t = load_transcriber(session="s", root=str(trainer.config.sessions_root),
                         device="cpu", batch=2)
    clip = np.zeros(t.model.cfg.n_samples, np.float32)
    assert len(t.transcribe_many([clip, clip])) == 2


def test_run_session_command_line(corpus, tmp_path, capsys):
    """create-session, run-session 0 and 1 (one update) in the port;
    stage 3 needs a speakers corpus and stage 4 stage 3's export, and
    without them both raise ``FileNotFoundError``."""
    from yoho_tpu_torch.cli.__main__ import main

    root = tmp_path / "sessions"
    assert main(["create-session", "cli", "--root", str(root)]) == 0
    assert main(["create-session", "cli", "--root", str(root)]) == 1
    (root / "cli" / "config.toml").write_text(TOML.format(root=corpus, moe=""))
    assert main(["run-session", "cli", "0", "--root", str(root)]) == 0
    assert "Trained tokenizer: vocab_size=" in capsys.readouterr().out
    assert main(["run-session", "cli", "1", "--root", str(root), "--max-updates", "1",
                 "--device", "cpu"]) == 0
    assert (root / "cli" / "weights" / "asr.ckpt").exists()
    assert len((root / "cli" / "stages" / "1" / "metrics.csv").read_text().splitlines()) == 2
    for stage, missing in (("3", "speaker dirs"), ("4", "stage-3 voiceprint artifact")):
        with pytest.raises(FileNotFoundError, match=missing):
            main(["run-session", "cli", stage, "--root", str(root), "--device", "cpu"])


def test_trainer_refuses_a_mesh_and_long_context(sessions):
    """What is not a mesh is refused with a ``TypeError`` naming what a mesh
    is (as ``Transcriber`` refuses it); ``long_context_factor=2`` on one CPU
    rank trains on a 1 x 1 (data, seq) mesh (a group of one), its ring loss
    the plain loss of the same batch (tests/test_torch_parallel_train.py
    trains over four ranks)."""
    from dataclasses import replace

    from yoho_tpu_torch.parallel.mesh import shutdown
    from yoho_tpu_torch.train.trainer import ASRTrainer, masked_ce_loss

    _, tcfg = sessions
    with pytest.raises(TypeError, match="must be a yoho_tpu_torch.parallel.mesh.Mesh"):
        ASRTrainer(tcfg, mesh=object(), device="cpu")
    hp = replace(tcfg.hyperparameters.transcribe_pretrain, long_context_factor=2)
    try:
        trainer = ASRTrainer(tcfg, hp=hp, device="cpu")
        for dl in (trainer.train_dataloader, trainer.val_dataloader):
            dl.terminate()
        assert trainer.mesh.shape == {"data": 1, "seq": 1}
        assert trainer.data_config.yoho.max_audio_len == 2 * tcfg.yoho.max_audio_len
        audio, tokens, mask = trainer._place(trainer.train_dataloader.get_batch(0))
        assert audio.shape[1] == trainer.data_config.yoho.n_samples
        with torch.no_grad():
            ring = trainer._batch_loss(audio, tokens, mask)
            plain = masked_ce_loss(trainer.model(tokens, trainer._mel(audio)), tokens, mask)
        assert float(ring) == pytest.approx(float(plain), rel=1e-5)
    finally:
        shutdown()
