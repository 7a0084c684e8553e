"""The port's multi-process training (``train/``, ``parallel/``) over a real
process group: four gloo ranks on the CPU, held to the JAX package's
single-device loss and gradients on the same global batch.

One group runs every scenario (``tests/_torch_parallel_train_worker.py``,
which imports torch and the port only); this file makes the corpora, the
sessions and the batches, starts the ranks once per module, computes the
JAX references while they run (each JAX function compiled once: the YOHO
loss serves the trainer's step, its two updates, the ring step and the
GPipe step) and compares. Every rank reports gradients and parameters
whole (gathered over the mesh). Bounds are the JAX tests': the trainer's
loss and gradients 2e-4 and its update losses 1e-4 relative
(``tests/test_torch_yoho_train.py``), the ring and GPipe steps' loss 1e-5
and gradients 3e-5 (``tests/test_distributed.py``,
``tests/test_pipeline_parallel.py``). The global batches give the ranks
unequal mask counts, and place positives and valid spans on other ranks
than their anchors.
"""

import contextlib
import datetime as dt
import io
import os
import pickle
import shutil
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from yoho_tpu.text.srt import Subtitle, compose_srt

from test_torch_finetune import TINY, WORDS, _write_wav
from test_torch_yoho_stages import SENTENCES

TESTS = Path(__file__).resolve().parent
WORKER = TESTS / "_torch_parallel_train_worker.py"
RANKS = 4
COMMON = """learning_rate = 0.001
final_learning_rate = 0.00001
batch_size = 4
accumulated_batches = 2
updates = 50
warmup_updates = 2
validation_samples = 1
"""
TOML = f"""\
language_whitelist = ['en']

[yoho]
sample_rate = 16000
n_mel_bands = 16
n_fft = 400
stft_hop = 160
max_audio_len = {{frames}}
max_text_len = {{text}}
dims = 32
n_audio_heads = 4
n_audio_blocks = 2
n_text_heads = 4
n_text_blocks = 2
{{moe}}
[dataset]
noisy = '{{root}}/noisy'
clean = '{{root}}/clean'
finetune = '{{root}}/finetune'
ambient = '{{root}}/ambient'
speakers = '{{root}}/speakers'

[hyperparameters.tokenizer]
max_token_length = 32
vocab_size = 420

[hyperparameters.transcribe_pretrain]
{COMMON}validation_frequency = 1
speechless_sample_ratio = 0.25
{{long}}
[hyperparameters.reconstruct_pretrain]
{COMMON}validation_frequency = 1
latent_dim = 8

[hyperparameters.voiceprint_finetune]
{COMMON}validation_frequency = 1
embedding_dim = 16

[hyperparameters.transcribe_finetune]
{COMMON}validation_frequency = 1000
speechless_sample_ratio = 0.25
"""
MOE = "n_experts = 2\nmoe_every_n = 1\nmoe_in_decoder = true\n"
# Column-parallel (q, v) and row-parallel (out) adapters.
LORA_TARGETS = r"(attn|cross_attn)/(q_proj|v_proj|out_proj)$"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flat(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        yield from _flat(v, p) if isinstance(v, dict) else [(p, np.asarray(v))]


def _nest(flat):
    tree = {}
    for path, v in flat.items():
        *mods, leaf = path.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return tree


def _yoho_corpus(root: Path) -> None:
    """tests/test_torch_yoho_stages.py's corpus: 3 SRT tracks of 4 tone
    utterances, a clean file, an ambient file, 3 speakers of 2 clips."""
    from test_torch_yoho_stages import _wav

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


def _whisper_corpus(root: Path) -> None:
    """tests/test_torch_finetune.py's corpus with a fourth word a track
    (every slice has an utterance for each of four ranks)."""
    (root / "transcripts").mkdir(parents=True)
    (root / "audio").mkdir()
    g = np.random.default_rng(0)
    for f in range(3):
        subs, t = [], 0.05
        audio = g.standard_normal(16000).astype(np.float32) * 0.003
        for u in range(4):
            w = (f + 2 * u) % len(WORDS)
            tone = 0.4 * np.sin(2 * np.pi * (300 + 120 * w) * np.arange(2400) / 16000)
            audio[int(t * 16000):int(t * 16000) + 2400] += tone.astype(np.float32)
            subs.append(Subtitle(u + 1, dt.timedelta(seconds=t),
                                 dt.timedelta(seconds=t + 0.15), WORDS[w]))
            t += 0.23
        (root / "transcripts" / f"t{f}.srt").write_text(compose_srt(subs))
        _write_wav(root / "audio" / f"t{f}.wav", audio)


def _sessions(root: Path, corpus: Path):
    """Sessions "s" (dense), "moe", "lc" (half the window, long_context_factor
    2, so its clips are s's) and "cli", one tokenizer, and a stage-3
    voiceprint artifact for stage 4's teacher."""
    from yoho_tpu_torch.core.config import load_session_config
    from yoho_tpu_torch.nn.params import init_random, to_jax_params
    from yoho_tpu_torch.nn.voiceprint import VoiceprintEncoder
    from yoho_tpu_torch.train.checkpoint import save_params
    from yoho_tpu_torch.train.stages.stage0_tokenizer import main as stage0

    kinds = {"s": dict(), "moe": dict(moe=MOE), "cli": dict(),
             "lc": dict(frames=32, text=16, long="long_context_factor = 2\n")}
    for name, kw in kinds.items():
        (root / name / "weights").mkdir(parents=True)
        (root / name / "config.toml").write_text(TOML.format(**{
            "root": corpus, "frames": 64, "text": 32, "moe": "", "long": "", **kw}))
    cfg = load_session_config("s", root)
    with contextlib.redirect_stdout(io.StringIO()):
        stage0(cfg)
    for name in kinds:
        if name != "s":
            shutil.copyfile(cfg.weights.tokenizer, root / name / "weights" / "tokenizer.model")
    teacher = init_random(VoiceprintEncoder(cfg.yoho, embedding_dim=16, device="cpu"), seed=5)
    save_params(cfg.weights.voiceprint, to_jax_params(teacher))
    return cfg


def _batches(cfg):
    """The global batches (host numpy) the scenarios take."""
    from yoho_tpu_torch.text.tokenizer import YOHOTokenizer
    from yoho_tpu_torch.train.dataloader import (
        AudioChunkDataloader,
        SpeakerDataloader,
        TranscriptionDataloader,
    )

    tok = YOHOTokenizer.load(cfg.weights.tokenizer)
    kw = dict(use_multiprocessing=False, warmup_queue=False, disable_warnings=True)
    asr = TranscriptionDataloader((0.0, 1.0), cfg, tok, batch_size=4, seed=7,
                                  speechless_ratio=0.0, **kw).get_batch(0)
    spans = TranscriptionDataloader((0.0, 1.0), cfg, tok, batch_size=4, seed=3,
                                    speechless_ratio=0.0, return_spans=True, **kw).get_batch(0)
    spans = list(spans)
    spans[4] = spans[4].copy()
    spans[4][:2] = 0  # every valid span on data rank 1
    audio = AudioChunkDataloader(cfg, 4, **kw).get_batch(0)
    speakers = [x[[0, 2, 1, 3]] for x in SpeakerDataloader(cfg, 4, augment=False,
                                                             **kw).get_batch(0)]
    return dict(asr=tuple(asr), spans=tuple(spans), audio=(audio[0],), speakers=tuple(speakers))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Inputs, the four ranks' outputs, and the JAX references (compiled
    while the ranks run)."""
    from yoho_tpu.core.config import load_session_config as jax_session

    case = tmp_path_factory.mktemp("parallel_train")
    corpus, wcorpus, root = case / "corpus", case / "wcorpus", case / "sessions"
    _yoho_corpus(corpus)
    _whisper_corpus(wcorpus)
    cfg = _sessions(root, corpus)
    batches = _batches(cfg)
    jcfg = jax_session("s", root)
    refs = Refs(jcfg, root)
    mel = np.asarray(refs.mel(batches["asr"][0]))
    eps = np.asarray(jax.random.normal(refs.key, (4, 32, 8), jnp.float32))
    hf = _whisper_hf(case / "hf")
    inputs = dict(
        asr=dict(root=str(root), batch=batches["asr"]),
        moe=dict(root=str(root), batch=batches["asr"]),
        long_context=dict(root=str(root), mel_batch=(mel, *batches["asr"][1:])),
        pipeline=dict(root=str(root), mel_batch=(mel, *batches["asr"][1:])),
        stage2=dict(root=str(root), batch=batches["audio"], eps=eps),
        stage3=dict(root=str(root), batch=batches["speakers"]),
        stage4=dict(root=str(root), batch=batches["spans"]),
        whisper=dict(tiny=TINY, words=WORDS, corpus=str(wcorpus), out=str(case / "wout"),
                     lora_targets=LORA_TARGETS),
        sharded_checkpoint=dict(root=str(root), dir=str(case / "dcp")),
        cli=dict(root=str(root), hf=str(hf), corpus=str(wcorpus), out=str(case / "cli_out")),
    )
    (case / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(RANKS), LOCAL_WORLD_SIZE=str(RANKS), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(p for p in (str(TESTS.parent),
                                                      os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(case)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(RANKS)]
    logs = []
    try:
        refs.warm(cfg, root, inputs)
        for p in procs:
            logs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log[-4000:]}"
    outs = [pickle.loads((case / f"out{r}.pkl").read_bytes()) for r in range(RANKS)]
    return dict(inputs=inputs, outs=outs, refs=refs, root=root, jcfg=jcfg)


def _whisper_hf(d: Path) -> Path:
    """The TINY whisper (the port's random init) as an HF directory with a
    word BPE of the corpus's words."""
    from test_torch_cli import write_word_bpe
    from yoho_tpu_torch.core.config import WhisperConfig
    from yoho_tpu_torch.nn.export import export_hf_whisper

    export_hf_whisper(_init_whisper(0), WhisperConfig(**TINY), d)
    write_word_bpe(d, {w: 1000 + i for i, w in enumerate(WORDS)})
    return d


def _init_whisper(seed):
    """The workers' initial whisper weights (the port's seeded init)."""
    from yoho_tpu_torch.core.config import WhisperConfig
    from yoho_tpu_torch.nn.params import init_random, to_jax_params
    from yoho_tpu_torch.nn.whisper import Whisper

    return to_jax_params(init_random(Whisper(WhisperConfig(**TINY), device="cpu"), seed=seed))


# ------------------------------------------------------------- JAX references

class Refs:
    """JAX's single-device losses (each with its gradient) and optimizer
    steps, jitted once. :meth:`warm` calls each on its inputs' shapes and
    tree structure (the port's seeded initial parameters) while the ranks
    run, so the tests find them compiled."""

    def __init__(self, jcfg, root):
        from yoho_tpu.audio.frontend import whisper_log_mel, yoho_log_mel
        from yoho_tpu.core.config import WhisperConfig, load_session_config
        from yoho_tpu.nn.lora import merge_lora
        from yoho_tpu.nn.moe import collect_aux_losses
        from yoho_tpu.nn.reconstruction import VoiceReconstructionVAE, vae_loss
        from yoho_tpu.nn.voiceprint import VoiceprintEncoder, nt_xent_loss
        from yoho_tpu.nn.whisper import Whisper
        from yoho_tpu.nn.yoho import YOHOModel
        from yoho_tpu.text.tokenizer import YOHOTokenizer
        from yoho_tpu.train.distill import distill_kl_loss
        from yoho_tpu.train.trainer import masked_ce_loss
        from yoho_tpu_torch.train.checkpoint import load_params

        cfg, hp = jcfg.yoho, jcfg.hyperparameters
        tok = YOHOTokenizer.load(jcfg.weights.tokenizer)
        self.vocab = tok.vocab_size
        self.key = jax.random.PRNGKey(7)  # stage 2's noise: this key's draw
        grad = lambda f: jax.jit(jax.value_and_grad(f))  # noqa: E731
        self.mel = jax.jit(lambda a: yoho_log_mel(a, cfg))

        def yoho_loss(model, aux_weight=None):
            def loss(p, mel, tokens, mask):
                tokens = tokens.astype(jnp.int32)
                if aux_weight is None:
                    return masked_ce_loss(model.apply({"params": p}, tokens, mel), tokens, mask)
                logits, st = model.apply({"params": p}, tokens, mel, mutable=["intermediates"])
                return (masked_ce_loss(logits, tokens, mask)
                        + aux_weight * collect_aux_losses(st["intermediates"]))
            return grad(loss)

        self.yoho = yoho_loss(YOHOModel(cfg, self.vocab))
        mcfg = load_session_config("moe", root).yoho
        self.moe = yoho_loss(YOHOModel(mcfg, self.vocab), mcfg.moe_aux_weight)

        vae = VoiceReconstructionVAE(cfg, latent_dim=8)

        def vae_fn(p, audio):
            mel = yoho_log_mel(audio, cfg)
            recon, mu, logvar = vae.apply({"params": p}, mel, self.key)
            return vae_loss(recon, mel, mu, logvar, hp.reconstruct_pretrain.kl_weight)[0]

        self.vae = grad(vae_fn)
        enc = VoiceprintEncoder(cfg, embedding_dim=16)
        self.voiceprint = grad(lambda p, audio, ids: nt_xent_loss(
            enc.apply({"params": p}, yoho_log_mel(audio, cfg)), ids,
            hp.voiceprint_finetune.temperature))

        teacher, tparams = VoiceprintEncoder(cfg, embedding_dim=16), \
            load_params(jcfg.weights.voiceprint)
        joint = YOHOModel(cfg, self.vocab, voiceprint_dim=16)

        def joint_fn(p, audio, tokens, mask, spans, valid):  # JAX's stage-4 loss_fn
            mel = yoho_log_mel(audio, cfg)
            tokens = tokens.astype(jnp.int32)
            logits, vp = joint.apply({"params": p}, tokens, mel,
                                     method=YOHOModel.forward_with_voiceprints)
            ce = masked_ce_loss(logits, tokens, mask)
            pos = jnp.arange(cfg.max_audio_len) * cfg.stft_hop
            fmask = ((pos[None, None] >= spans[:, :, 0:1])
                     & (pos[None, None] < spans[:, :, 1:2])).astype(jnp.float32)
            teach = jax.lax.stop_gradient(jax.vmap(
                lambda m: teacher.apply({"params": tparams}, mel, m), 1, 1)(fmask))
            vpm = (tokens == tok.voiceprint_id).astype(jnp.int32)
            order = jnp.cumsum(vpm, axis=1) * vpm
            losses = []
            for u in range(spans.shape[1]):
                prev = jnp.pad((order == u + 1).astype(vp.dtype)[:, 1:], ((0, 0), (0, 1)))
                pred = jnp.einsum("bt,bte->be", prev, vp)
                ok = valid[:, u] * jnp.clip(prev.sum(axis=1), 0, 1)
                losses.append((1.0 - jnp.sum(pred * teach[:, u], axis=-1)) * ok)
            return ce + jnp.sum(jnp.stack(losses, 1)) / jnp.maximum(jnp.sum(valid), 1.0)

        self.joint = grad(joint_fn)

        whisper = Whisper(WhisperConfig(**TINY), dtype=jnp.float32)

        def whisper_fn(p, base, audio, tokens, mask, lora_scale=0.0):
            mel = whisper_log_mel(audio, n_mels=TINY["n_mels"])
            tokens = tokens.astype(jnp.int32)
            params = merge_lora(base, p, lora_scale) if lora_scale else p
            logits = whisper.apply({"params": params}, mel, tokens)
            ce = masked_ce_loss(logits, tokens, mask)
            if base is None or lora_scale:
                return ce
            t_logits = whisper.apply({"params": base}, mel, tokens)  # the distiller's teacher
            return 0.5 * ce + 0.5 * distill_kl_loss(t_logits, logits, mask, 2.0)

        self.whisper = grad(whisper_fn)
        self.whisper_lora = jax.jit(jax.value_and_grad(whisper_fn), static_argnums=5)

        sched = optax.warmup_cosine_decay_schedule(
            0.0, hp.transcribe_pretrain.learning_rate, hp.transcribe_pretrain.warmup_updates,
            max(hp.transcribe_pretrain.updates, hp.transcribe_pretrain.warmup_updates + 1),
            hp.transcribe_pretrain.final_learning_rate)
        wsched = optax.warmup_cosine_decay_schedule(0.0, 3e-3, 1, 2, 1e-7)
        self.tx = {"asr": optax.MultiSteps(optax.adamw(sched), 2),
                   "lora": optax.MultiSteps(optax.adamw(wsched), 2),
                   "adafactor": optax.MultiSteps(optax.adafactor(wsched), 2),
                   "distill": optax.MultiSteps(optax.adamw(wsched), 2)}
        self.apply = {k: jax.jit(lambda g, s, p, tx=tx: _apply(tx, g, s, p))
                      for k, tx in self.tx.items()}

    def warm(self, cfg, root, inputs) -> None:
        """Each function once on the port's seeded initial trees and the
        tests' batches (or batches of their shapes)."""
        import torch

        from yoho_tpu_torch.core.config import WhisperConfig, load_session_config
        from yoho_tpu_torch.nn import lora as lora_mod
        from yoho_tpu_torch.nn.params import init_random, to_jax_params
        from yoho_tpu_torch.nn.reconstruction import VoiceReconstructionVAE
        from yoho_tpu_torch.nn.voiceprint import VoiceprintEncoder
        from yoho_tpu_torch.nn.whisper import Whisper
        from yoho_tpu_torch.nn.yoho import YOHOModel

        def init(module, seed=0):
            return to_jax_params(init_random(module, seed=seed))

        mel_batch = inputs["long_context"]["mel_batch"]
        wcfg = WhisperConfig(**TINY)
        batch = (np.zeros((4, wcfg.n_samples), np.float32), np.zeros((4, wcfg.n_text_ctx),
                                                                     np.int64),
                 np.zeros((4, wcfg.n_text_ctx), np.uint8))

        def yoho():
            tree = init(YOHOModel(cfg.yoho, self.vocab, device="cpu"))
            self.yoho(tree, *mel_batch)
            self.apply["asr"](tree, self.tx["asr"].init(tree), tree)

        def whisper():
            base = _init_whisper(0)
            lora = {p: {k: v.numpy() for k, v in ab.items()} for p, ab in lora_mod.init_lora(
                torch.Generator().manual_seed(0), Whisper(wcfg, device="cpu"), 4,
                LORA_TARGETS).items()}
            self.whisper_lora(lora, base, *batch, lora_mod.lora_scale(4))
            self.whisper(base, None, *batch)
            self.whisper(base, base, *batch)
            for name, tree in (("lora", lora), ("adafactor", base), ("distill", base)):
                self.apply[name](tree, self.tx[name].init(tree), tree)

        parts = (yoho, whisper,
                 lambda: self.moe(init(YOHOModel(load_session_config("moe", root).yoho,
                                                 self.vocab, device="cpu")), *mel_batch),
                 lambda: self.vae(init(VoiceReconstructionVAE(cfg.yoho, latent_dim=8,
                                                              device="cpu")),
                                  *inputs["stage2"]["batch"]),
                 lambda: self.voiceprint(init(VoiceprintEncoder(cfg.yoho, embedding_dim=16,
                                                                device="cpu")),
                                         *inputs["stage3"]["batch"]),
                 lambda: self.joint(init(YOHOModel(cfg.yoho, self.vocab, voiceprint_dim=16,
                                                   device="cpu")), *inputs["stage4"]["batch"]))
        # XLA compiles outside the GIL: a few at once.
        with ThreadPoolExecutor(3) as pool:
            for f in [pool.submit(part) for part in parts]:
                f.result()


def _apply(tx, grads, state, params):
    updates, state = tx.update(grads, state, params)
    return optax.apply_updates(params, updates), state


def _result(group, name, rank=0):
    out = group["outs"][rank][name]
    assert "error" not in out, out.get("error")
    return out


def _assert_grads(got, want, atol):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(v), atol=atol, rtol=0,
                                   err_msg=k)


def _value(fn, params, *args):
    loss, grads = fn(params, *args)
    return float(loss), dict(_flat(jax.device_get(grads)))


def _mel_batch(group):
    return group["inputs"]["long_context"]["mel_batch"]


# ----------------------------------------------------------------------- tests

def test_collectives_gradients_match_one_process_autograd(group):
    for r in range(RANKS):
        err = _result(group, "collectives", r)
        assert max(err.values()) < 1e-5, (r, err)


def test_loader_shards_follow_the_data_axis(group):
    """Ranks that differ only in ``model`` read the same rows; the two
    ``data`` ranks' rows are disjoint and cover the epoch's table."""
    outs = [_result(group, "asr", r) for r in range(RANKS)]
    assert [o["mesh"] for o in outs] == [{"data": 2, "model": 2}] * RANKS
    assert [o["shard"] for o in outs] == [(0, 2), (0, 2), (1, 2), (1, 2)]
    assert all(o["local"] == 2 for o in outs)
    assert outs[0]["table"] == outs[1]["table"] and outs[2]["table"] == outs[3]["table"]
    assert not set(outs[0]["table"]) & set(outs[2]["table"])
    assert [o["writer"] for o in outs] == [True, False, False, False]
    # Unequal mask counts over the data ranks (the global normaliser matters).
    mask = group["inputs"]["asr"]["batch"][2][:, 1:]
    assert mask[:2].sum() != mask[2:].sum()


def test_asr_trainer_step_over_2x2_matches_jax(group):
    out = _result(group, "asr")
    assert any("model" in s for s in out["specs"].values())  # the model is cut
    loss, grads = _value(group["refs"].yoho, out["init"], *_mel_batch(group))
    assert out["loss"] == pytest.approx(loss, abs=2e-4)
    _assert_grads(out["grads"], grads, 2e-4)


def _optax_run(apply, tx, params, seen_by_rank, loss_fn, ranks=(0, 2)):
    """JAX's single-device run from ``params`` over the ranks' global
    mini-batches (the data ranks' local batches in axis order): (update
    losses, params)."""
    state = tx.init(params)
    losses = []
    for i in range(len(seen_by_rank[0])):
        batch = [np.concatenate([seen_by_rank[r][i][j] for r in ranks]) for j in
                 range(len(seen_by_rank[0][i]))]
        loss, grads = loss_fn(params, batch)
        losses.append(float(loss))
        params, state = apply(grads, state, params)
    return [float(np.mean(losses[i:i + 2])) for i in range(0, len(losses), 2)], params


def test_asr_trainer_two_updates_and_files_over_2x2(group):
    from yoho_tpu.train.checkpoint import load_params

    outs = [_result(group, "asr", r) for r in range(RANKS)]
    out, refs = outs[0], group["refs"]
    want, params = _optax_run(refs.apply["asr"], refs.tx["asr"], out["init"],
                              [o["seen"] for o in outs],
                              lambda p, b: refs.yoho(p, refs.mel(b[0]), b[1], b[2]))
    assert all(o["update_losses"] == out["update_losses"] for o in outs)
    np.testing.assert_allclose(out["update_losses"], want, rtol=1e-4)
    final = dict(_flat(jax.device_get(params)))
    for k, v in _flat(out["final"]):
        np.testing.assert_allclose(v, final[k], atol=1e-4, rtol=0, err_msg=k)
    stage = group["root"] / "s" / "stages" / "1"
    assert len((stage / "metrics.csv").read_text().strip().splitlines()) == 3
    assert len((stage / "validations.jsonl").read_text().splitlines()) == 2
    assert (stage / "checkpoint.msgpack").exists()
    assert all(o["resumed_step"] == 4 and o["resumed_count"] == 2 and o["resumed_equal"]
               for o in outs)
    tree = load_params(group["root"] / "s" / "weights" / "asr.ckpt",
                       jax.tree_util.tree_map(jnp.zeros_like, out["final"]))
    final = dict(_flat(out["final"]))
    for k, v in _flat(jax.device_get(tree)):
        np.testing.assert_array_equal(v, final[k], err_msg=k)


def test_moe_experts_over_model_2_match_jax(group):
    out = _result(group, "moe")
    assert out["experts"] and set(out["experts"]) == {1}  # 2 experts, 1 a rank
    loss, grads = _value(group["refs"].moe, out["init"], *_mel_batch(group))
    assert out["loss"] == pytest.approx(loss, abs=2e-4)
    _assert_grads(out["grads"], grads, 2e-4)


@pytest.mark.parametrize("mesh", ["seq4", "data2_seq2"])
def test_long_context_step_matches_single_device(group, mesh):
    want_loss, want = _value(group["refs"].yoho, _result(group, "asr")["init"],
                             *_mel_batch(group))
    for r in range(RANKS):
        out = _result(group, "long_context", r)[mesh]
        assert out["loss"] == pytest.approx(want_loss, abs=1e-5)
        _assert_grads(out["grads"], want, 3e-5)


def test_long_context_trainer_builds_its_mesh_and_loss(group):
    out = _result(group, "long_context")["trainer"]
    assert out["mesh"] == {"data": 1, "seq": 4}
    assert out["frames"] == 64 and out["tokens"][1] == 32
    assert out["audio"][1] == group["jcfg"].yoho.n_samples  # s's window: 2 of lc's
    np.testing.assert_allclose(out["ring"], out["plain"], rtol=1e-5)
    assert out["errors"][0][0] == "ValueError" and "n_experts" in out["errors"][0][1]


@pytest.mark.parametrize("mesh", ["pipe2", "data2_pipe2"])
def test_gpipe_step_matches_single_device(group, mesh):
    want_loss, want = _value(group["refs"].yoho, _result(group, "asr")["init"],
                             *_mel_batch(group))
    for r in range(RANKS):
        out = _result(group, "pipeline", r)[mesh]
        assert out["loss"] == pytest.approx(want_loss, abs=1e-5)
        _assert_grads(out["grads"], want, 3e-5)


def test_gpipe_guards(group):
    errors = _result(group, "pipeline")["errors"]
    assert [e[0] for e in errors] == ["ValueError"] * 4
    assert "do not divide into 4 pipeline stages" in errors[0][1]
    assert "does not divide into 2 microbatches" in errors[1][1]
    assert "homogeneous" in errors[2][1]
    assert "model axis" in errors[3][1]


def test_stage2_vae_over_data_4_matches_jax(group):
    import torch

    outs = [_result(group, "stage2", r) for r in range(RANKS)]
    loss, grads = _value(group["refs"].vae, outs[0]["init"], *group["inputs"]["stage2"]["batch"])
    assert outs[0]["loss"] == pytest.approx(loss, abs=2e-4)
    _assert_grads(outs[0]["grads"], grads, 2e-4)
    # The trainer's own noise: the global batch's draw, this rank's rows.
    whole = torch.randn((4, 3, 2), generator=torch.Generator().manual_seed(42)).numpy()
    for r, o in enumerate(outs):
        assert o["shard"] == (r, 4)
        np.testing.assert_array_equal(o["noise"], whole[r:r + 1])


def test_stage3_nt_xent_over_data_2_matches_jax(group):
    audio, ids = group["inputs"]["stage3"]["batch"]
    # Each data rank holds one clip of each speaker: every positive is on
    # the other rank.
    assert len(set(ids[:2])) == 2 and set(ids[:2]) == set(ids[2:])
    out = _result(group, "stage3")
    loss, grads = _value(group["refs"].voiceprint, out["init"], audio, ids)
    assert out["loss"] == pytest.approx(loss, abs=2e-4)
    _assert_grads(out["grads"], grads, 2e-4)


def test_stage4_joint_over_2x2_matches_jax(group):
    batch = group["inputs"]["stage4"]["batch"]
    assert float(batch[4][:2].sum()) == 0 and float(batch[4][2:].sum()) > 0
    out = _result(group, "stage4")
    assert out["teacher_frozen"] and out["teacher_whole"]
    loss, grads = _value(group["refs"].joint, out["init"], *batch)
    assert out["loss"] == pytest.approx(loss, abs=2e-4)
    _assert_grads(out["grads"], grads, 2e-4)


@pytest.mark.parametrize("run", ["lora", "adafactor", "distill"])
def test_whisper_trainers_over_the_mesh_match_jax(group, run):
    """WhisperFinetuner at 2x2 with LoRA and with Adafactor, the distiller
    at 2x2 (data 2, its teacher frozen): two updates each against JAX's
    optimizer on the same global mini-batches."""
    refs = group["refs"]
    outs = [_result(group, "whisper", r) for r in range(RANKS)]
    out = outs[0][run]
    seen = [o[run]["seen"] for o in outs]
    if run == "lora":
        base, scale = _init_whisper(0), out["scale"]
        loss_fn = lambda p, b: refs.whisper_lora(p, base, *b, scale)  # noqa: E731
        # Every adapter sits on a cut layer (its gradient sums over model too),
        # row-parallel ones (out_proj) among them.
        assert out["sharded"] == sorted(k for p, ab in out["init"].items() for k in
                                        (f"{p}/a", f"{p}/b"))
        assert any(k.endswith("out_proj/a") for k in out["sharded"])
    else:
        base = _init_whisper(1) if run == "distill" else None
        loss_fn = lambda p, b: refs.whisper(p, base, *b)  # noqa: E731
    init = out["init"] if run == "lora" else _init_whisper(0)
    want, params = _optax_run(refs.apply[run], refs.tx[run], init, seen, loss_fn)
    final = dict(_flat(jax.device_get(params)))
    for k, v in _flat(out["final"]):
        np.testing.assert_allclose(v, final[k], atol=1e-4, rtol=0, err_msg=k)
    np.testing.assert_allclose(out["update_losses"], want, rtol=1e-4)
    if run == "distill":
        assert out["frozen"] and out["teacher_leaves"] == 0


def test_sharded_adafactor_factors_the_whole_leaves(group):
    for r in range(RANKS):
        out = _result(group, "whisper", r)["adafactor_sharded"]
        assert out["factored"] == ["p", "q"] and out["err"] < 1e-5, (r, out)


def test_sharded_checkpoint_round_trip_and_swap(group):
    for r in range(RANKS):
        out = _result(group, "sharded_checkpoint", r)
        assert out["absent"] and out["round_trip"] and out["old_fallback"], (r, out)
        assert out["resharded"] and out["new_gone"], (r, out)
    files = _result(group, "sharded_checkpoint")["files"]
    assert {f"__{r}_0.distcp" for r in range(RANKS)} <= set(files) and ".metadata" in files


def test_commands_train_over_the_group(group):
    outs = [_result(group, "cli", r) for r in range(RANKS)]
    assert [o["run_session"] for o in outs] == [0] * RANKS
    assert [o["finetune"] for o in outs] == [0] * RANKS
    assert [o["run_session_printed"] for o in outs] == [True, False, False, False]
    assert [o["finetune_printed"] for o in outs] == [True, False, False, False]
    root = group["root"] / "cli"
    assert (root / "weights" / "asr.ckpt").exists()
    assert len((root / "stages" / "1" / "metrics.csv").read_text().splitlines()) == 2
    out_dir = Path(group["inputs"]["cli"]["out"])
    assert (out_dir / "model.safetensors").exists()
    assert len((out_dir / "metrics.csv").read_text().splitlines()) == 2


def test_dryrun_multichip_on_four_ranks(group):
    losses = [_result(group, "dryrun", r) for r in range(RANKS)]
    assert set(losses[0]) == {"mesh", "long_context", "pipeline", "moe"}
    assert all(np.isfinite(list(x.values())).all() for x in losses)
    assert all(x == losses[0] for x in losses)
