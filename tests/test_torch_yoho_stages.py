"""The port's YOHO training stages 2-4 against the JAX package's, on a
synthetic corpus made from a seed (noisy SRT tracks, a clean file, three
speakers of two tone clips each).

One session TOML (1 + 1 blocks, 4 heads, dims 32, 16 mels, 64 frames,
``latent_dim`` 8, ``embedding_dim`` 16) is loaded by both packages'
``load_session_config``; each package trains in its own session
directory. Checked, on the CPU in float32:

* ``VoiceReconstructionVAE`` with JAX's noise, and ``vae_loss``, at 2e-4;
  its params tree is JAX's ``init`` tree (keys and shapes) and a
  JAX-written VAE artifact loads and gives the same forward;
* ``AudioChunkDataloader`` and ``SpeakerDataloader`` batches are bit-equal
  to JAX's over two epochs, unsharded and as the second of two shards;
* ``_restore`` against flax's ``from_state_dict``: an extra saved key is
  ignored, a missing one raises, and (unlike flax) a leaf of another shape;
* two updates (batch 4, 2 accumulated) of each of stages 2, 3 and 4 from
  the same weights equal JAX's at 1e-4 in losses and parameters (stage 2
  with JAX's noise draws in place of the trainer's ``_noise``); stage 3's
  warm start takes the VAE artifact's encoder; stage 4's validation loss
  is JAX's ``_val_loss``; stage 4 raises without the stage-3 artifact;
* ``run-session`` 2, 3 and 4 through the command line with ``--device
  cpu``.
"""

import contextlib
import datetime as dt
import io
import shutil
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoho_tpu.core.config import load_session_config as jax_session
from yoho_tpu.parallel.mesh import make_mesh
from yoho_tpu.text.srt import Subtitle, compose_srt
from yoho_tpu_torch.core.config import load_session_config

SENTENCES = ["hello there friend", "this is a test", "the quick brown fox",
             "we are training a model", "speech goes in text comes out",
             "one more utterance here"]
COMMON = """learning_rate = 0.001
final_learning_rate = 0.00001
batch_size = 4
accumulated_batches = 2
updates = 50
warmup_updates = 1
validation_samples = 1
"""
TOML = f"""\
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
n_audio_blocks = 1
n_text_heads = 4
n_text_blocks = 1

[dataset]
noisy = '{{root}}/noisy'
clean = '{{root}}/clean'
finetune = '{{root}}/finetune'
ambient = '{{root}}/ambient'
speakers = '{{root}}/speakers'

[hyperparameters.tokenizer]
max_token_length = 32
vocab_size = 420

[hyperparameters.reconstruct_pretrain]
{COMMON}validation_frequency = 1
latent_dim = 8

[hyperparameters.voiceprint_finetune]
{COMMON}validation_frequency = 1
embedding_dim = 16

[hyperparameters.transcribe_finetune]
{COMMON}validation_frequency = {{val_freq}}
speechless_sample_ratio = 0.25
"""


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _wav(path, data, sr=16000):
    path.parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.clip(data * 32768, -32768, 32767).astype(np.int16).tobytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """3 tracks of 4 tone utterances in noise, a clean noise file, an
    ambient file, and 3 speakers (a tone each) of 2 clips of 0.75 s."""
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
            subs.append(Subtitle(u + 1, dt.timedelta(seconds=t), dt.timedelta(seconds=t + 0.2),
                                 SENTENCES[(f + u) % len(SENTENCES)]))
            t += 0.5
        (root / "noisy" / "transcripts" / f"track{f}.srt").write_text(compose_srt(subs))
        _wav(root / "noisy" / "audio" / f"track{f}.wav", audio)
    _wav(root / "clean" / "audio" / "c0.wav", g.standard_normal(32000) * 0.05)
    _wav(root / "ambient" / "audio" / "amb.wav", g.standard_normal(16000) * 0.01)
    for s, f0 in enumerate((220, 440, 880)):
        for c in range(2):
            t = np.arange(12000) / 16000
            _wav(root / "speakers" / f"spk{s}" / f"clip{c}.wav",
                 0.3 * np.sin(2 * np.pi * f0 * t) + 0.01 * g.standard_normal(12000))
    return root


def _session(root, corpus, name="s", val_freq=1000):
    d = root / name
    (d / "weights").mkdir(parents=True, exist_ok=True)
    (d / "config.toml").write_text(TOML.format(root=corpus, val_freq=val_freq))
    return d


@pytest.fixture(scope="module")
def sessions(corpus, tmp_path_factory):
    """The same session TOML under a JAX root and a port root, with one
    tokenizer (the port's stage 0) in both."""
    from yoho_tpu_torch.train.stages.stage0_tokenizer import main as stage0

    jroot, troot = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    _session(jroot, corpus)
    _session(troot, corpus)
    jcfg, tcfg = jax_session("s", jroot), load_session_config("s", troot)
    with contextlib.redirect_stdout(io.StringIO()):
        stage0(tcfg)
    shutil.copyfile(tcfg.weights.tokenizer, jcfg.weights.tokenizer)
    return jcfg, tcfg


def _flat(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        yield from _flat(v, p) if isinstance(v, dict) else [(p, v)]


def _csv_losses(path):
    return [float(line.split(",")[2]) for line in path.read_text().strip().splitlines()[1:]]


def _mesh():
    return make_mesh(data=1, model=1, devices=jax.devices()[:1])


def _assert_same_run(jt, trainer, jax_params):
    """Update losses at 1e-4 relative, parameters at 1e-4, the same
    ``metrics.csv`` columns (update, schedule value, an empty val_loss)."""
    want = _csv_losses(jt.stage_path / "metrics.csv")
    assert len(trainer.update_losses) == len(want) == 2
    np.testing.assert_allclose(trainer.update_losses, want, rtol=1e-4)
    rows = [line.split(",") for line in
            (trainer.stage_path / "metrics.csv").read_text().strip().splitlines()[1:]]
    jrows = [line.split(",") for line in
             (jt.stage_path / "metrics.csv").read_text().strip().splitlines()[1:]]
    assert [r[:2] + r[3:] for r in rows] == [r[:2] + r[3:] for r in jrows]
    from yoho_tpu_torch.nn.params import to_jax_params

    want_params = dict(_flat(jax.device_get(jax_params)))
    got = dict(_flat(to_jax_params(trainer.model)))
    assert set(got) == set(want_params)
    for k, v in got.items():
        np.testing.assert_allclose(v, np.asarray(want_params[k]), atol=1e-4, rtol=0,
                                   err_msg=k)


# ------------------------------------------------------------------ the VAE

@pytest.fixture(scope="module")
def stage2(sessions):
    """JAX's stage-2 trainer and its initial VAE params; the port's trainer
    from those params, drawing JAX's noise. Both then train two updates."""
    from yoho_tpu.train.stages.stage2_reconstruction import ReconstructionTrainer as JaxTR
    from yoho_tpu_torch.nn.params import load_jax_params
    from yoho_tpu_torch.train.stages.stage2_reconstruction import ReconstructionTrainer

    jcfg, tcfg = sessions
    jt = JaxTR(jcfg, mesh=_mesh())
    init = jax.device_get(jt.state.params)
    trainer = ReconstructionTrainer(tcfg, device="cpu")
    load_jax_params(trainer.model, init)
    rng = jax.random.PRNGKey(42)

    def jax_noise(shape):
        nonlocal rng
        rng, sub = jax.random.split(rng)
        return torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32)))

    trainer._noise = jax_noise
    jt.run(max_updates=2)
    trainer.run(max_updates=2)
    return jt, trainer, init


@pytest.fixture(scope="module")
def vae_pair(stage2, sessions):
    """JAX's VAE (the session's: one encoder block, one decoder block) with
    its initial params, and the port's with those params loaded."""
    from yoho_tpu_torch.nn.params import load_jax_params
    from yoho_tpu_torch.nn.reconstruction import VoiceReconstructionVAE

    jt, _trainer, init = stage2
    vae = VoiceReconstructionVAE(sessions[1].yoho, latent_dim=8, device="cpu")
    return jt.model, init, load_jax_params(vae, init)


def test_vae_forward_and_loss_match_jax(vae_pair):
    from yoho_tpu.nn.reconstruction import vae_loss as jax_vae_loss
    from yoho_tpu_torch.nn.reconstruction import vae_loss

    jvae, params, vae = vae_pair
    mel = np.random.default_rng(1).standard_normal((2, 64, 16)).astype(np.float32) * 2
    rng = jax.random.PRNGKey(7)
    recon_j, mu_j, logvar_j = jax.jit(jvae.apply)({"params": params}, jnp.asarray(mel), rng)
    # The noise JAX drew inside the model, handed to the port.
    eps = np.array(jax.random.normal(rng, mu_j.shape, mu_j.dtype))
    with torch.no_grad():
        recon, mu, logvar = vae(torch.from_numpy(mel), torch.from_numpy(eps))
        loss, (mse, kl) = vae_loss(recon, torch.from_numpy(mel), mu, logvar, 1e-3)
    want_loss, (want_mse, want_kl) = jax_vae_loss(recon_j, jnp.asarray(mel), mu_j, logvar_j,
                                                  1e-3)
    assert recon.shape == (2, 64, 16) and mu.shape == (2, 32, 8)
    for got, want in ((recon, recon_j), (mu, mu_j), (logvar, logvar_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)
    for got, want in ((loss, want_loss), (mse, want_mse), (kl, want_kl)):
        assert float(got) == pytest.approx(float(want), abs=2e-4)
    # The clip: logvar within [-10, 10]; without eps or a generator it raises.
    with torch.no_grad():
        big = vae.to_logvar.bias.clone()
        vae.to_logvar.bias.fill_(50.0)
        assert float(vae(torch.from_numpy(mel), generator=torch.Generator())[2].max()) == 10.0
        vae.to_logvar.bias.copy_(big)
    with pytest.raises(ValueError, match="noise"):
        vae(torch.from_numpy(mel))


def test_vae_params_tree_is_jax_init_tree_and_a_jax_artifact_loads(vae_pair, sessions,
                                                                   tmp_path):
    from dataclasses import replace

    from yoho_tpu.train.checkpoint import save_params as jax_save_params
    from yoho_tpu_torch.nn.params import init_random, load_jax_params, to_jax_params
    from yoho_tpu_torch.nn.reconstruction import VoiceReconstructionVAE
    from yoho_tpu_torch.train.checkpoint import load_params

    _jvae, params, vae = vae_pair
    cfg = sessions[1].yoho
    ours = to_jax_params(init_random(VoiceReconstructionVAE(cfg, latent_dim=8, device="cpu")))
    assert sorted(ours) == sorted(params) == sorted(
        ["encoder", "to_mu", "to_logvar", "from_latent", "dec_blocks_0", "ln", "to_mel"])
    assert {k: v.shape for k, v in _flat(ours)} == \
        {k: np.asarray(v).shape for k, v in _flat(params)}
    # A dense decoder block also in an MoE session (JAX's are always dense).
    moe = VoiceReconstructionVAE(replace(cfg, n_experts=2, moe_every_n=1), latent_dim=8,
                                 device="cpu")
    assert "experts" in str(dict(_flat(to_jax_params(moe.encoder))))
    assert "experts" not in str(dict(_flat(to_jax_params(moe.dec_blocks))))
    path = tmp_path / "voice_reconstruction.ckpt"
    jax_save_params(path, params)
    loaded = load_jax_params(VoiceReconstructionVAE(cfg, latent_dim=8, device="cpu"),
                             load_params(path, ours))
    mel = torch.randn(1, 64, 16, generator=torch.Generator().manual_seed(0))
    eps = torch.randn(1, 32, 8, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for a, b in zip(loaded(mel, eps), vae(mel, eps)):
            assert torch.equal(a, b)


# -------------------------------------------------------------- dataloaders

@pytest.mark.parametrize("shard", [(0, 1), (1, 2)], ids=["whole", "shard-1-of-2"])
def test_audio_and_speaker_batches_bit_equal_to_jax(sessions, shard):
    from yoho_tpu.train.dataloader import AudioChunkDataloader as JaxChunks
    from yoho_tpu.train.dataloader import SpeakerDataloader as JaxSpeakers
    from yoho_tpu_torch.train.dataloader import AudioChunkDataloader, SpeakerDataloader

    jcfg, tcfg = sessions
    pairs = [(JaxChunks(jcfg, 4, seed=3, augment=True, shard=shard, use_multiprocessing=False),
              AudioChunkDataloader(tcfg, 4, seed=3, augment=True, shard=shard,
                                   use_multiprocessing=False)),
             (JaxSpeakers(jcfg, 4, seed=3, shard=shard, use_multiprocessing=False),
              SpeakerDataloader(tcfg, 4, seed=3, shard=shard, use_multiprocessing=False))]
    chunks = pairs[0][1].chunks
    assert len(chunks) == (12 if shard[1] == 1 else 6)
    for jdl, tdl in pairs:
        assert tdl.get_num_batches() == jdl.get_num_batches()
        for epoch in (0, 1):
            jdl._epoch = tdl._epoch = epoch
            for idx in range(jdl.get_num_batches()):
                want, got = jdl.get_batch(idx), tdl.get_batch(idx)
                assert len(got) == len(want)
                for w, g in zip(want, got):
                    assert g.dtype == w.dtype and g.shape == w.shape
                    np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="clips_per_speaker"):
        SpeakerDataloader(tcfg, 3, use_multiprocessing=False)


def test_speaker_dataloader_needs_two_speakers(sessions, tmp_path):
    from dataclasses import replace

    from yoho_tpu_torch.train.dataloader import SpeakerDataloader

    _, tcfg = sessions
    _wav(tmp_path / "spk" / "only" / "a.wav", np.zeros(1600))
    cfg = replace(tcfg, dataset=replace(tcfg.dataset, speakers=tmp_path / "spk"))
    with pytest.raises(FileNotFoundError, match=">=2 speaker dirs"):
        SpeakerDataloader(cfg, 4, use_multiprocessing=False)


# ------------------------------------------------------------------ restore

@pytest.mark.parametrize("case", ["extra-key", "missing-key", "other-shape"])
def test_restore_follows_flax_from_state_dict(case):
    """Saved keys the template lacks are ignored and a template key the
    saved tree lacks raises, as flax's ``from_state_dict`` does; a leaf of
    another shape raises too (flax copies it)."""
    from flax import serialization

    from yoho_tpu_torch.train.checkpoint import _restore

    template = {"encoder": {"w": np.zeros((2, 3), np.float32)}, "b": np.zeros(3, np.float32)}
    saved = {"encoder": {"w": np.ones((2, 3), np.float32)}, "b": np.ones(3, np.float32)}
    if case == "extra-key":
        saved["to_mu"] = {"kernel": np.ones(4, np.float32)}
        saved["encoder"]["extra"] = np.ones(1, np.float32)
        want = serialization.from_state_dict(template, saved)
        got = _restore(template, saved)
        assert sorted(got) == sorted(want) == ["b", "encoder"]
        assert sorted(got["encoder"]) == sorted(want["encoder"]) == ["w"]
        np.testing.assert_array_equal(got["encoder"]["w"], want["encoder"]["w"])
    elif case == "missing-key":
        del saved["encoder"]["w"]
        with pytest.raises(ValueError):
            serialization.from_state_dict(template, saved)
        with pytest.raises(ValueError, match="lacks the template's keys"):
            _restore(template, saved)
    else:
        saved["b"] = np.ones(4, np.float32)
        assert serialization.from_state_dict(template, saved)["b"].shape == (4,)
        with pytest.raises(ValueError, match="saved shape"):
            _restore(template, saved)


# --------------------------------------------------------------- stages 2-4

def test_stage2_two_updates_match_jax(stage2):
    from yoho_tpu.train.checkpoint import load_params as jax_load_params

    jt, trainer, _init = stage2
    _assert_same_run(jt, trainer, jt.state.params)
    assert trainer.step == 4 and (trainer.stage_path / "checkpoint.msgpack").exists()
    # The export is a flax params tree JAX's load_params reads.
    tree = jax_load_params(trainer.config.weights.voice_reconstruction,
                           jax.device_get(jt.state.params))
    assert sorted(tree) == sorted(jt.state.params)


@pytest.fixture(scope="module")
def stage3(stage2, sessions):
    """Two updates of stage 3 in each package; each warm-starts from its own
    stage-2 export, then the port takes JAX's starting params."""
    from yoho_tpu.train.stages.stage3_voiceprint import VoiceprintTrainer as JaxVT
    from yoho_tpu_torch.nn.params import load_jax_params, to_jax_params
    from yoho_tpu_torch.train.stages.stage3_voiceprint import VoiceprintTrainer

    jcfg, tcfg = sessions
    jt = JaxVT(jcfg, mesh=_mesh())
    trainer = VoiceprintTrainer(tcfg, device="cpu")
    warm = to_jax_params(trainer.model)
    load_jax_params(trainer.model, jax.device_get(jt.state.params))
    jt.run(max_updates=2)
    trainer.run(max_updates=2)
    return jt, trainer, warm


def test_stage3_warm_starts_from_the_vae_encoder(stage3, sessions):
    from yoho_tpu_torch.train.checkpoint import load_params

    _, tcfg = sessions
    _jt, _trainer, warm = stage3
    vae = load_params(tcfg.weights.voice_reconstruction)
    got = dict(_flat(warm["encoder"]))
    want = dict(_flat(vae["encoder"]))
    assert set(got) == set(want) and set(vae) > {"encoder", "to_mu", "dec_blocks_0"}
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)


def test_stage3_two_updates_match_jax(stage3):
    jt, trainer, _warm = stage3
    _assert_same_run(jt, trainer, jt.state.params)
    assert trainer.config.weights.voiceprint.exists()


@pytest.fixture(scope="module")
def stage4(stage3, sessions):
    """Two updates of stage 4 in each package: the same stage-1 export
    (a port model at the session's voiceprint width) and JAX's stage-3
    export as the teacher in both."""
    from yoho_tpu.text.tokenizer import YOHOTokenizer as JaxTok
    from yoho_tpu.train.stages.stage4_joint_finetune import JointTrainer as JaxJT
    from yoho_tpu_torch.nn.params import init_random, to_jax_params
    from yoho_tpu_torch.nn.yoho import YOHOModel
    from yoho_tpu_torch.text.tokenizer import YOHOTokenizer
    from yoho_tpu_torch.train.checkpoint import save_params
    from yoho_tpu_torch.train.stages.stage4_joint_finetune import JointTrainer

    jcfg, tcfg = sessions
    tok = YOHOTokenizer.load(tcfg.weights.tokenizer)
    asr = to_jax_params(init_random(YOHOModel(tcfg.yoho, tok.vocab_size, 16, device="cpu"),
                                    seed=5))
    for cfg in (jcfg, tcfg):
        save_params(cfg.weights.asr, asr)
    shutil.copyfile(jcfg.weights.voiceprint, tcfg.weights.voiceprint)
    jt = JaxJT(jcfg, tokenizer=JaxTok.load(jcfg.weights.tokenizer), mesh=_mesh())
    trainer = JointTrainer(tcfg, device="cpu")
    start = to_jax_params(trainer.model)
    teacher = to_jax_params(trainer.teacher)
    jt.run(max_updates=2)
    trainer.run(max_updates=2)
    return jt, trainer, asr, start, teacher


def test_stage4_two_updates_match_jax(stage4):
    from yoho_tpu_torch.nn.params import to_jax_params
    from yoho_tpu_torch.train.checkpoint import load_params

    jt, trainer, asr, start, teacher = stage4
    # The student started from weights.asr; the teacher stayed frozen.
    for (k, a), (_, b) in zip(_flat(start), _flat(asr)):
        np.testing.assert_array_equal(a, b, err_msg=k)
    after = dict(_flat(to_jax_params(trainer.teacher)))
    for k, v in _flat(teacher):
        np.testing.assert_array_equal(after[k], v, err_msg=k)
    for k, v in _flat(load_params(trainer.config.weights.voiceprint)):
        np.testing.assert_array_equal(after[k], np.asarray(v), err_msg=k)
    _assert_same_run(jt, trainer, jt.state.params)
    assert trainer.config.weights.yoho.exists()


def test_stage4_validation_loss_is_jax_val_loss(stage4):
    """The validation loss is the masked CE of the batch (JAX's inherited
    ``_val_loss``), not the joint loss; the joint loss adds the voiceprint
    term."""
    jt, trainer, *_ = stage4
    batch = trainer.val_dataloader.get_batch(0)
    assert len(batch) == 5 and batch[4].sum() > 0
    want = float(jt._val_loss(jt.state.params, *map(jnp.asarray, batch[:3])))
    with torch.no_grad():
        placed = trainer._place(batch)
        got = float(trainer._asr_loss(*placed[:3]))
        joint = float(trainer._batch_loss(*placed))
    assert got == pytest.approx(want, rel=1e-4)
    assert joint > got


def test_stage4_raises_without_the_stage3_artifact(sessions, corpus, tmp_path):
    from yoho_tpu_torch.train.stages.stage4_joint_finetune import JointTrainer

    _, tcfg = sessions
    _session(tmp_path, corpus, "bare")
    cfg = load_session_config("bare", tmp_path)
    shutil.copyfile(tcfg.weights.tokenizer, cfg.weights.tokenizer)
    with pytest.raises(FileNotFoundError, match="run stage 3 first"):
        JointTrainer(cfg, device="cpu")


def test_run_session_stages_2_3_4_command_line(sessions, corpus, tmp_path, monkeypatch):
    """``run-session`` 2, 3 and 4 (one update each, stage 4 with a
    validation) on the CPU: each writes its metrics and its export, stage 4
    warm-starting from nothing (no stage-1 export) and teaching from stage
    3's."""
    import functools

    from yoho_tpu_torch.cli.__main__ import main
    from yoho_tpu_torch.train.stages import (
        stage2_reconstruction,
        stage3_voiceprint,
        stage4_joint_finetune,
    )

    # The batches in this process (stage 1's command-line test runs the
    # worker processes).
    for mod in (stage2_reconstruction, stage3_voiceprint, stage4_joint_finetune):
        monkeypatch.setattr(mod, "main", functools.partial(mod.main, use_multiprocessing=False))
    _, tcfg = sessions
    _session(tmp_path, corpus, "cli", val_freq=1)
    cfg = load_session_config("cli", tmp_path)
    shutil.copyfile(tcfg.weights.tokenizer, cfg.weights.tokenizer)
    for stage, slot in (("2", "voice_reconstruction"), ("3", "voiceprint"), ("4", "yoho")):
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(["run-session", "cli", stage, "--root", str(tmp_path),
                         "--max-updates", "1", "--device", "cpu"]) == 0
        assert getattr(cfg.weights, slot).exists()
        rows = (cfg.path / "stages" / stage / "metrics.csv").read_text().splitlines()
        assert len(rows) == 2 and np.isfinite(float(rows[1].split(",")[2]))
    assert rows[1].split(",")[3]  # stage 4 validated
    assert (cfg.path / "stages" / "4" / "validations.jsonl").exists()


@pytest.mark.parametrize("stage", [2, 3, 4])
def test_stage_trainers_need_device_cpu_without_cuda(sessions, monkeypatch, stage):
    """On a machine without CUDA a trainer given no device raises; it never
    falls back to the CPU."""
    from yoho_tpu_torch.train.stages.stage2_reconstruction import ReconstructionTrainer
    from yoho_tpu_torch.train.stages.stage3_voiceprint import VoiceprintTrainer
    from yoho_tpu_torch.train.stages.stage4_joint_finetune import JointTrainer

    _, tcfg = sessions
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cls = {2: ReconstructionTrainer, 3: VoiceprintTrainer, 4: JointTrainer}[stage]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cls(tcfg)
