"""The port's HF checkpoint loader (``yoho_tpu_torch/nn/convert.py``)
against the ``safetensors`` package and the JAX package's
``load_hf_whisper`` (which goes through ``transformers``).

The port reads the directory itself (no ``transformers`` or
``safetensors`` on the machine with the card); its parameters must be
bit-equal to the JAX package's.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoho_tpu.core.config import WhisperConfig as JaxConfig
from yoho_tpu.nn import convert as jax_convert
from yoho_tpu.nn.export import export_hf_whisper as jax_export
from yoho_tpu.nn.whisper import Whisper as JaxWhisper
from yoho_tpu.train.checkpoint import load_params
from yoho_tpu_torch.nn import convert
from yoho_tpu_torch.nn.export import export_hf_whisper

FIXTURE = Path(__file__).parent / "fixtures" / "whisper_tiny"


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _assert_trees_bit_equal(got, want):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k].view(np.uint32), want[k].view(np.uint32)), k


@pytest.fixture(scope="module")
def fixture_params():
    cfg = JaxConfig(**json.loads((FIXTURE / "config.json").read_text()))
    template = jax.eval_shape(
        JaxWhisper(cfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, cfg.n_frames, cfg.n_mels), jnp.float32),
        jnp.zeros((1, 4), jnp.int32))["params"]
    template = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), template)
    params = load_params(FIXTURE / "params.msgpack", template)
    # The fixture stores bf16; an HF directory holds it as float32.
    return cfg, jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), params)


# ----------------------------------------------------------- safetensors


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_safetensors_reader_equals_the_package(tmp_path, dtype):
    st = pytest.importorskip("safetensors.torch")
    g = torch.Generator().manual_seed(0)
    tensors = {"a.weight": torch.randn(7, 5, generator=g).to(dtype),
               "b": torch.randn(3, generator=g).to(dtype),
               "c.scalar": torch.randn((), generator=g).to(dtype),
               "ids": torch.arange(6, dtype=torch.int64).reshape(2, 3),
               "codes": torch.randint(-127, 128, (4, 4), generator=g, dtype=torch.int8)}
    path = tmp_path / "model.safetensors"
    st.save_file(tensors, str(path), metadata={"format": "pt"})
    want = st.load_file(str(path))
    got = convert.read_safetensors(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def test_safetensors_sharded_index(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    g = torch.Generator().manual_seed(1)
    shards = [{"x.weight": torch.randn(4, 3, generator=g)},
              {"y.weight": torch.randn(2, 2, generator=g).to(torch.bfloat16),
               "y.bias": torch.randn(2, generator=g)}]
    weight_map = {}
    for i, tensors in enumerate(shards):
        name = f"model-{i + 1:05d}-of-00002.safetensors"
        st.save_file(tensors, str(tmp_path / name))
        weight_map.update({k: name for k in tensors})
    (tmp_path / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {}, "weight_map": weight_map}))
    got = convert.load_hf_state_dict(tmp_path)
    assert sorted(got) == sorted(weight_map)
    for tensors in shards:
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    weight_map["z.weight"] = "model-00001-of-00002.safetensors"
    (tmp_path / "model.safetensors.index.json").write_text(
        json.dumps({"weight_map": weight_map}))
    with pytest.raises(KeyError, match="z.weight"):
        convert.load_hf_state_dict(tmp_path)


def test_safetensors_unknown_dtype_and_bad_ranges_raise(tmp_path):
    def write(header, data=b"\0" * 8):
        head = json.dumps(header).encode()
        path = tmp_path / "x.safetensors"
        path.write_bytes(len(head).to_bytes(8, "little") + head + data)
        return path

    with pytest.raises(ValueError, match="F8_E4M3"):
        convert.read_safetensors(write({"t": {"dtype": "F8_E4M3", "shape": [8],
                                              "data_offsets": [0, 8]}}))
    with pytest.raises(ValueError, match="byte range"):
        convert.read_safetensors(write({"t": {"dtype": "F32", "shape": [3],
                                              "data_offsets": [0, 8]}}))
    with pytest.raises(ValueError, match="byte range"):
        convert.read_safetensors(write({"t": {"dtype": "F32", "shape": [4],
                                              "data_offsets": [0, 16]}}))


# ------------------------------------------------------------- configs

_CONFIGS = {
    "tiny": dict(num_mel_bins=80, max_source_positions=1500, d_model=384,
                 encoder_attention_heads=6, encoder_layers=4, vocab_size=51865,
                 max_target_positions=448, decoder_attention_heads=6,
                 decoder_layers=4),
    "small": dict(num_mel_bins=80, max_source_positions=1500, d_model=768,
                  encoder_attention_heads=12, encoder_layers=12, vocab_size=51865,
                  max_target_positions=448, decoder_attention_heads=12,
                  decoder_layers=12),
    "large-v3": dict(num_mel_bins=128, max_source_positions=1500, d_model=1280,
                     encoder_attention_heads=20, encoder_layers=32, vocab_size=51866,
                     max_target_positions=448, decoder_attention_heads=20,
                     decoder_layers=32),
    "turbo": dict(num_mel_bins=128, max_source_positions=1500, d_model=1280,
                  encoder_attention_heads=20, encoder_layers=32, vocab_size=51866,
                  max_target_positions=448, decoder_attention_heads=20,
                  decoder_layers=4),
}


@pytest.mark.parametrize("name", ["tiny", "small", "large-v3", "turbo"])
def test_hf_config_to_whisper_equals_jax(name):
    d = _CONFIGS[name]
    want = jax_convert.hf_config_to_whisper(SimpleNamespace(**d)).model_dump()
    got = convert.hf_config_to_whisper(d)
    assert {k: getattr(got, k) for k in want} == want


def test_hf_config_defaults_are_transformers():
    transformers = pytest.importorskip("transformers")
    hf = transformers.WhisperConfig()
    want = jax_convert.hf_config_to_whisper(hf).model_dump()
    got = convert.hf_config_to_whisper({})
    assert {k: getattr(got, k) for k in want} == want


# ---------------------------------------------------------- checkpoints


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """A random tiny transformers Whisper saved as safetensors, as .bin and
    as bf16 safetensors."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf_cfg = transformers.WhisperConfig(
        vocab_size=51865, num_mel_bins=16, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4, d_model=32,
        encoder_ffn_dim=128, decoder_ffn_dim=128, max_source_positions=32,
        max_target_positions=48)
    model = transformers.WhisperForConditionalGeneration(hf_cfg).eval()
    root = tmp_path_factory.mktemp("hf")
    model.save_pretrained(root / "safetensors", safe_serialization=True)
    model.save_pretrained(root / "bin", safe_serialization=False)
    model.to(torch.bfloat16).save_pretrained(root / "bf16", safe_serialization=True)
    return root


@pytest.mark.parametrize("kind", ["safetensors", "bin", "bf16"])
def test_load_hf_whisper_equals_jax_on_transformers_checkpoints(hf_dirs, kind):
    d = hf_dirs / kind
    files = {p.name for p in d.iterdir()}
    assert ("model.safetensors" in files) == (kind != "bin")
    want_cfg, want = jax_convert.load_hf_whisper(str(d))
    got_cfg, got = convert.load_hf_whisper(d)
    assert {k: getattr(got_cfg, k) for k in want_cfg.model_dump()} == want_cfg.model_dump()
    _assert_trees_bit_equal(got, want)


def test_load_hf_whisper_equals_jax_on_the_exported_fixture(fixture_params, tmp_path):
    cfg, params = fixture_params
    jax_export(params, cfg, tmp_path / "hf")
    want_cfg, want = jax_convert.load_hf_whisper(str(tmp_path / "hf"))
    got_cfg, got = convert.load_hf_whisper(tmp_path / "hf")
    assert got_cfg.chunk_seconds == want_cfg.chunk_seconds == 1.28
    assert {k: getattr(got_cfg, k) for k in want_cfg.model_dump()} == want_cfg.model_dump()
    _assert_trees_bit_equal(got, want)
    # The fixture itself comes back bit for bit (the exporter's encoder
    # sinusoids are ignored).
    _assert_trees_bit_equal(got, params)


def test_the_ports_exporter_reads_back(fixture_params, tmp_path):
    cfg, params = fixture_params
    from yoho_tpu_torch.core.config import WhisperConfig

    port_cfg = WhisperConfig(**json.loads((FIXTURE / "config.json").read_text()))
    export_hf_whisper(params, port_cfg, tmp_path / "hf")
    sd = convert.load_hf_state_dict(tmp_path / "hf")
    assert "model.encoder.embed_positions.weight" in sd  # written, never read
    got_cfg, got = convert.load_hf_whisper(tmp_path / "hf")
    assert got_cfg == port_cfg
    _assert_trees_bit_equal(got, params)


def test_load_hf_whisper_takes_local_directories_only(tmp_path):
    with pytest.raises(FileNotFoundError, match="local directories only"):
        convert.load_hf_whisper("openai/whisper-small")
    (tmp_path / "config.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="pytorch_model.bin"):
        convert.load_hf_whisper(tmp_path)
