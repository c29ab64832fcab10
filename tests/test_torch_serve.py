"""The port's serving path against the JAX package's, on the CPU in fp32:
``generate_stream`` (chunked yields, a stopping callable, a cache capped by
``max_len``, EOS trimming), ``load_pretrained_model`` with ``load_8bit`` /
``load_4bit`` on a tiny checkpoint, and the REPL ``serve/cli.py`` fed two
turns on stdin."""

import io
import os
import sys
from argparse import Namespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))
from util import make_tiny_checkpoint  # noqa: E402

from cambrian_tpu.constants import IMAGE_TOKEN_INDEX  # noqa: E402
from cambrian_tpu.data.packing import prepare_multimodal_data  # noqa: E402
from cambrian_tpu.infer.engine import GenerationConfig as JGenConfig  # noqa: E402
from cambrian_tpu.infer.engine import GenerationEngine as JEngine  # noqa: E402
from cambrian_tpu.models.cambrian import CambrianLM as JCambrianLM  # noqa: E402
from cambrian_tpu.models.config import tiny_debug  # noqa: E402
from cambrian_tpu.models.encoders.base import build_vision_tower_aux_list  # noqa: E402
from cambrian_tpu_torch.checkpoint.from_jax import state_dict_from_jax  # noqa: E402
from cambrian_tpu_torch.infer.engine import GenerationConfig, GenerationEngine  # noqa: E402
from cambrian_tpu_torch.models.builder import (  # noqa: E402
    CambrianForInference,
    load_pretrained_model,
)
from cambrian_tpu_torch.models.config import CambrianConfig  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def stream_pair():
    cfg = tiny_debug(num_towers=2)
    rng = np.random.default_rng(1)
    towers = build_vision_tower_aux_list(cfg.mm_vision_tower_aux_list,
                                         cfg.mm_vision_tower_aux_token_len_list)
    ids = rng.integers(5, cfg.vocab_size, (1, 40)).astype(np.int64)
    ids[0, cfg.image_position] = IMAGE_TOKEN_INDEX
    pids, _, pmask, ppos, aux_masks = prepare_multimodal_data(
        ids, ids.copy(), np.ones_like(ids, bool), [(640, 360)], cfg.image_token_len,
        cfg.mm_vision_tower_aux_token_len_list, cfg.tokenizer_model_max_length)
    feats = [jnp.asarray(rng.standard_normal((1, t.interp_size, t.hidden_size),
                                             dtype=np.float32)) for t in towers]
    jmasks = [jnp.asarray(m) for m in aux_masks]
    model = JCambrianLM(cfg, tuple(t.hidden_size for t in towers))
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(pids), jnp.asarray(pmask),
                        jnp.asarray(ppos), feats, jmasks)
    params = {"params": jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params["params"])}
    sd = state_dict_from_jax(params, prefix="lm.")
    for i, t in enumerate(towers):
        tp = jax.tree.map(np.asarray, t.init(jax.random.PRNGKey(i + 1)))
        sd.update(state_dict_from_jax(tp, prefix=f"towers.{i}.module."))
    port = CambrianForInference.from_state_dict(CambrianConfig.from_dict(cfg.to_dict()), sd,
                                                dtype=torch.float32, cache_dtype=torch.float32)
    return dict(cfg=cfg, model=model, params=params, towers=towers, feats=feats,
                jmasks=jmasks, inputs=(pids, pmask, ppos), aux_masks=aux_masks, port=port)


def _streams(p, max_len, stopping=None, **gen):
    jeng = JEngine(p["model"], p["params"], p["towers"], max_len=max_len,
                   cache_dtype=jnp.float32)
    want = [np.asarray(a) for a in jeng.generate_stream(
        *p["inputs"], p["feats"], p["jmasks"], JGenConfig(**gen), stopping)]
    eng = GenerationEngine(p["port"].lm, p["port"].towers, max_len=max_len,
                           cache_dtype=torch.float32)
    got = list(eng.generate_stream(*p["inputs"], [_t(f) for f in p["feats"]], p["aux_masks"],
                                   GenerationConfig(**gen), stopping))
    return want, got, jeng, eng


def _assert_same_stream(want, got, jeng, eng):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(eng.last_lengths, np.asarray(jeng.last_lengths))


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_generate_stream_matches_jax(stream_pair, chunk):
    want, got, jeng, eng = _streams(stream_pair, 512, max_new_tokens=10, eos_token_id=None,
                                    stream_chunk=chunk)
    _assert_same_stream(want, got, jeng, eng)
    assert got[-1].shape == (1, 10)
    assert len(got) == -(-10 // chunk)
    # every token is decoded, the last one too, and a chunk runs all its
    # steps: ceil(10 / chunk) * chunk decode steps
    assert eng.last_timings["decode_steps"] == -(-10 // chunk) * chunk


def test_generate_stream_eos_trims_like_jax(stream_pair):
    plain, _, _, _ = _streams(stream_pair, 512, max_new_tokens=10, eos_token_id=None,
                              stream_chunk=3)
    eos = int(plain[-1][0, 4])
    want, got, jeng, eng = _streams(stream_pair, 512, max_new_tokens=10, eos_token_id=eos,
                                    stream_chunk=3)
    _assert_same_stream(want, got, jeng, eng)
    assert got[-1].shape[1] <= 5


def test_generate_stream_stopping_callable_steps_per_token(stream_pair):
    seen = []

    def stopping(cum):
        seen.append(cum.shape[1])
        return cum.shape[1] >= 4

    want, got, jeng, eng = _streams(stream_pair, 512, stopping=stopping, max_new_tokens=10,
                                    eos_token_id=None, stream_chunk=8)
    _assert_same_stream(want, got, jeng, eng)
    assert [a.shape[1] for a in got] == [1, 2, 3, 4]
    assert seen == [1, 2, 3, 4] * 2   # the JAX engine's calls, then the port's


def test_generate_stream_capped_cache_finishes_per_token(stream_pair):
    # 7 free cache slots: two chunks of 3, then the tail per token until
    # the cache is full
    s = stream_pair["inputs"][0].shape[1]
    want, got, jeng, eng = _streams(stream_pair, s + 7, max_new_tokens=10, eos_token_id=None,
                                    stream_chunk=3)
    _assert_same_stream(want, got, jeng, eng)
    assert [a.shape[1] for a in got] == [3, 6, 7, 8]


def test_cambrian_generate_stream_ends_with_generate(stream_pair):
    """The user entry point: the last yield of ``generate_stream`` is what
    ``generate`` returns, with the tower encode time recorded."""
    port = stream_pair["port"]
    rng = np.random.default_rng(2)
    cfg = stream_pair["cfg"]
    ids = rng.integers(5, cfg.vocab_size, 30)
    ids[cfg.image_position] = IMAGE_TOKEN_INDEX
    images = [rng.standard_normal((1, 3, t.image_size, t.image_size)).astype(np.float32)
              for t in port.towers]
    kw = dict(images=images, image_sizes=[(320, 240)], max_new_tokens=6, eos_token_id=None)
    want = port.generate(ids, **kw)
    outs = list(port.generate_stream(ids, stream_chunk=4, **kw))
    assert [o.shape[1] for o in outs] == [4, 6]
    np.testing.assert_array_equal(outs[-1], want)
    assert port.engine.last_timings["encode_ms"] > 0


# -- loading and the CLI ------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny_serve_ckpt"))
    make_tiny_checkpoint(path)
    return path


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_loading_matches_jax_loader(tiny_checkpoint, bits):
    from cambrian_tpu.models.builder import load_pretrained_model as j_load

    kw = dict(load_8bit=bits == 8, load_4bit=bits == 4)
    tok, jmodel, _, jctx = j_load(tiny_checkpoint, **kw)
    _, model, _, ctx = load_pretrained_model(tiny_checkpoint, device="cpu",
                                             dtype=torch.float32, **kw)
    assert ctx == jctx
    assert model.config.quantize == jmodel.config.quantize == f"int{bits}"
    want = state_dict_from_jax(jax.tree.map(np.asarray, jmodel.params))
    got = model.lm.state_dict()
    assert set(got) == set(want)
    kq = "kernel_q4" if bits == 4 else "kernel_q"
    assert got[f"layers_0.mlp.up_proj.{kq}"].dtype == torch.int8
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        torch.testing.assert_close(got[k], v, atol=0, rtol=0, msg=k)

    ids = np.asarray(tok("hello world what is in this image").input_ids, np.int64)
    np.testing.assert_array_equal(model.generate(ids, max_new_tokens=8),
                                  np.asarray(jmodel.generate(ids, max_new_tokens=8)))


def test_load_8bit_and_4bit_are_mutually_exclusive(tiny_checkpoint):
    with pytest.raises(ValueError, match="mutually exclusive"):
        load_pretrained_model(tiny_checkpoint, load_8bit=True, load_4bit=True, device="cpu")


@pytest.mark.parametrize("flags", [[], ["--load-4bit"]], ids=["fp32", "int4"])
def test_cli_answers_match_jax_cli(tiny_checkpoint, tmp_path, monkeypatch, capsys, flags):
    """Both CLIs in fp32 on the same weights: the JAX loader's random tower
    weights are carried into the port's towers (neither loads snapshots)."""
    PIL = pytest.importorskip("PIL.Image")
    from cambrian_tpu.models import builder as j_builder
    from cambrian_tpu.serve import cli as j_cli
    from cambrian_tpu_torch.checkpoint.from_jax import load_state_dict_checked
    from cambrian_tpu_torch.serve import cli

    loaded = {}

    def j_load(*args, **kwargs):
        out = j_builder.load_pretrained_model(*args, dtype=jnp.float32, **kwargs)
        loaded["jax"] = out[1]
        return out

    def port_load(*args, **kwargs):
        out = load_pretrained_model(*args, **kwargs)
        for t, tp in zip(out[1].towers, loaded["jax"].tower_params):
            load_state_dict_checked(t, state_dict_from_jax(jax.tree.map(np.asarray, tp),
                                                           prefix="module."))
        return out

    monkeypatch.setattr(j_cli, "load_pretrained_model", j_load)
    monkeypatch.setattr(cli, "load_pretrained_model", port_load)
    image = PIL.new("RGB", (64, 48), (120, 180, 60))
    path = str(tmp_path / "img.png")
    image.save(path)
    turns = "describe the picture\nwhat is in this image\n"

    monkeypatch.setattr("sys.stdin", io.StringIO(turns))
    j_cli.main(Namespace(model_path=tiny_checkpoint, model_base=None, image_file=path,
                         device=None, conv_mode=None, temperature=0.0, max_new_tokens=6,
                         load_8bit=False, load_4bit="--load-4bit" in flags, debug=False))
    want = capsys.readouterr().out
    monkeypatch.setattr("sys.stdin", io.StringIO(turns))
    cli.main(["--model-path", tiny_checkpoint, "--image-file", path, "--temperature", "0",
              "--max-new-tokens", "6", "--device", "cpu", *flags])
    got = capsys.readouterr().out
    assert got == want
    assert got.count("ASSISTANT: ") == 2 and got.rstrip().endswith("exit...")
