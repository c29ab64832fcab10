"""The port's safetensors reader and writer (``checkpoint/safetensors_io.py``)
against the ``safetensors`` package in both directions, for every dtype the
port takes (BF16 comes back from the port's reader upcast to fp32, exactly);
sharded checkpoints with their index; ``pytorch_model*.bin`` shards; and the
loader's rules (``models/builder.py::_load_state_dict``) against the JAX
package's ``_load_state_dict``. Comparisons are exact."""

import json
import os

import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import load_file as st_load
from safetensors.torch import save_file as st_save

from cambrian_tpu.models.builder import _load_state_dict as jax_load_state_dict
from cambrian_tpu_torch.checkpoint import safetensors_io as io
from cambrian_tpu_torch.models.builder import _load_state_dict

DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16, "I8": torch.int8,
    "U8": torch.uint8, "I32": torch.int32, "I64": torch.int64, "BOOL": torch.bool,
}


def _tensors(seed=0, dtypes=DTYPES):
    """One tensor of each dtype (and a 0-d and an empty one), with values
    spread over each dtype's range."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for code, dt in dtypes.items():
        if dt.is_floating_point:
            t = torch.randn((3, 5, 2), generator=g) * 100
        elif dt == torch.bool:
            t = torch.randint(0, 2, (7,), generator=g)
        else:
            info = torch.iinfo(dt)
            t = torch.randint(max(info.min, -2 ** 40), min(info.max, 2 ** 40) + 1, (4, 6),
                              generator=g, dtype=torch.int64)
        out[f"w.{code}"] = t.to(dt)
    out["scalar"] = torch.tensor(3.5)
    out["empty"] = torch.zeros((0, 4), dtype=torch.int32)
    return out


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    """What the port's reader gives for a tensor: BF16 upcast to fp32."""
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_port_writes_what_safetensors_reads(tmp_path):
    want = _tensors()
    path = str(tmp_path / "port.safetensors")
    n = io.save_file(want, path, metadata={"format": "pt"})
    assert n == os.path.getsize(path)
    got = st_load(path)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"format": "pt"}


def test_port_reads_what_safetensors_writes(tmp_path):
    want = _tensors(seed=1)
    path = str(tmp_path / "st.safetensors")
    st_save(want, path, metadata={"format": "pt"})
    got = io.load_file(path)
    assert set(got) == set(want)
    for k, v in want.items():
        ref = _as_numpy(v)
        assert got[k].dtype == ref.dtype and got[k].shape == ref.shape, k
        np.testing.assert_array_equal(got[k], ref, err_msg=k)


def test_numpy_round_trip_and_refusals(tmp_path):
    """numpy arrays (a transposed view included) round-trip; a dtype the
    format's reader here does not take raises instead of guessing."""
    rng = np.random.default_rng(0)
    want = {"a": rng.standard_normal((4, 3)).astype(np.float32).T,
            "b": np.arange(12, dtype=np.int64).reshape(3, 4),
            "c": rng.standard_normal(5).astype(np.float16)}
    path = str(tmp_path / "np.safetensors")
    io.save_file(want, path)
    got = io.load_file(path)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)
        assert got[k].dtype == v.dtype
    with pytest.raises(TypeError):
        io.save_file({"x": np.zeros(3, np.float64)}, str(tmp_path / "f64.safetensors"))
    st_save({"x": torch.zeros(3, dtype=torch.float64)}, str(tmp_path / "st64.safetensors"))
    with pytest.raises(TypeError, match="F64"):
        io.load_file(str(tmp_path / "st64.safetensors"))


def test_sharded_checkpoint_with_index(tmp_path):
    """save_sharded cuts at the shard size and writes the index; the loader
    reads every shard back, as the safetensors package reads each."""
    want = {f"layer{i}.weight": torch.randn((64, 32), generator=torch.Generator()
                                            .manual_seed(i)).to(torch.bfloat16)
            for i in range(5)}
    want["head"] = torch.arange(10, dtype=torch.int64)
    io.save_sharded(want, str(tmp_path), shard_size_bytes=3 * 64 * 32 * 2)
    index = json.loads((tmp_path / io.INDEX_NAME).read_text())
    files = sorted(set(index["weight_map"].values()))
    assert files == ["model-00001-of-00002.safetensors", "model-00002-of-00002.safetensors"]
    assert set(index["weight_map"]) == set(want)
    assert index["metadata"]["total_size"] == sum(v.numel() * v.element_size()
                                                  for v in want.values())
    for fname in files:
        theirs = st_load(str(tmp_path / fname))
        for k, v in theirs.items():
            assert index["weight_map"][k] == fname and torch.equal(v, want[k])
    got = _load_state_dict(str(tmp_path))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], _as_numpy(v))
    # one shard when everything fits
    single = tmp_path / "single"
    io.save_sharded(want, str(single))
    assert sorted(os.listdir(single)) == ["model.safetensors"]


def test_loader_matches_jax_loader_on_safetensors_shards(tmp_path):
    """Shards written by the safetensors package (no BF16: the JAX loader
    reads through numpy, which has none)."""
    no_bf16 = {k: v for k, v in DTYPES.items() if k != "BF16"}
    st_save(_tensors(2, no_bf16), str(tmp_path / "model-00001-of-00002.safetensors"))
    st_save({"extra": torch.ones(3)}, str(tmp_path / "model-00002-of-00002.safetensors"))
    got, want = _load_state_dict(str(tmp_path)), jax_load_state_dict(str(tmp_path))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("pattern", ["pytorch_model-0000{i}-of-00002.bin", "weights{i}.pth"])
def test_bin_shards_match_jax_loader(tmp_path, pattern):
    """``pytorch_model*.bin`` (else ``*.pth``) shards through torch.load, bf16
    upcast to fp32, as the JAX loader reads them."""
    tensors = _tensors(3)
    names = sorted(tensors)
    for i, part in enumerate((names[::2], names[1::2])):
        torch.save({k: tensors[k] for k in part}, str(tmp_path / pattern.format(i=i + 1)))
    got, want = _load_state_dict(str(tmp_path)), jax_load_state_dict(str(tmp_path))
    assert set(got) == set(want) == set(tensors)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], _as_numpy(tensors[k]), err_msg=k)


def test_safetensors_shards_win_over_bin(tmp_path):
    torch.save({"x": torch.zeros(2)}, str(tmp_path / "pytorch_model.bin"))
    io.save_file({"y": torch.ones(2)}, str(tmp_path / "model.safetensors"))
    assert list(_load_state_dict(str(tmp_path))) == ["y"]
    with pytest.raises(FileNotFoundError):
        _load_state_dict(str(tmp_path / "missing"))


def test_phi3_export_round_trips():
    """``export_cambrian`` writes Phi-3's fused qkv_proj / gate_up_proj, the
    names ``convert_cambrian`` splits, so a Phi-3 checkpoint saved by the
    port loads back."""
    from cambrian_tpu_torch.checkpoint.hf_llm import convert_cambrian, export_cambrian
    from cambrian_tpu_torch.models.config import tiny_debug

    cfg = tiny_debug(num_towers=2).replace(model_type="phi3", num_key_value_heads=4)
    rng = np.random.default_rng(0)
    names = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
    sd = {}
    for i in range(cfg.num_hidden_layers):
        lp = f"model.layers.{i}."
        h, inter = cfg.hidden_size, cfg.intermediate_size
        sd[lp + "self_attn.qkv_proj.weight"] = rng.standard_normal((3 * h, h), np.float32)
        sd[lp + "mlp.gate_up_proj.weight"] = rng.standard_normal((2 * inter, h), np.float32)
        sd[lp + "self_attn.o_proj.weight"] = rng.standard_normal((h, h), np.float32)
        sd[lp + "mlp.down_proj.weight"] = rng.standard_normal((h, inter), np.float32)
        sd[lp + "input_layernorm.weight"] = rng.standard_normal(h, np.float32)
        sd[lp + "post_attention_layernorm.weight"] = rng.standard_normal(h, np.float32)
    sd["model.embed_tokens.weight"] = rng.standard_normal((cfg.vocab_size, cfg.hidden_size),
                                                          np.float32)
    sd["model.norm.weight"] = rng.standard_normal(cfg.hidden_size, np.float32)
    cfg_lm = cfg.replace(mm_projector_type="mlp2x_gelu")
    sd["model.image_newline"] = rng.standard_normal(cfg.hidden_size, np.float32)
    tree = convert_cambrian(sd, cfg_lm)
    assert set(tree["layers_0"]["self_attn"]) >= set(names[:4])
    back = export_cambrian(tree, cfg_lm)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
