"""The port's sharded inference, ``GenerationEngine(mesh=...)``, on the
CPU: four gloo processes (tests/torch_parallel_workers.py) generate greedy
tokens on (1,2,2) (tensor parallelism and FSDP2, a batch split over the two
fsdp ranks, and a batch of three that does not split and runs on every
rank) and, with the 34B structure of tests/test_34b_geometry_decode.py, on
(1,1,4) with images. Each equals the unsharded port's tokens; the (1,2,2)
text batch also equals the JAX engine's on its (1,2,2) mesh, as
tests/test_continuous_batching.py holds the JAX one. One spawn runs every
case."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_workers as workers  # noqa: E402
from test_34b_geometry_decode import scaled_34b_config  # noqa: E402

from cambrian_tpu.constants import IMAGE_TOKEN_INDEX  # noqa: E402
from cambrian_tpu.data.packing import prepare_multimodal_data  # noqa: E402
from cambrian_tpu.infer.engine import GenerationConfig as JGenerationConfig  # noqa: E402
from cambrian_tpu.infer.engine import GenerationEngine as JGenerationEngine  # noqa: E402
from cambrian_tpu.models.cambrian import CambrianLM  # noqa: E402
from cambrian_tpu.models.config import tiny_debug  # noqa: E402
from cambrian_tpu.models.encoders.base import build_vision_tower_aux_list  # noqa: E402
from cambrian_tpu.parallel.mesh import MeshConfig, create_mesh  # noqa: E402
from cambrian_tpu_torch.checkpoint.from_jax import state_dict_from_jax  # noqa: E402
from cambrian_tpu_torch.infer.engine import GenerationConfig, GenerationEngine  # noqa: E402
from cambrian_tpu_torch.models.builder import CambrianForInference  # noqa: E402
from cambrian_tpu_torch.models.config import CambrianConfig  # noqa: E402
from cambrian_tpu_torch.models.builder import random_state_dict  # noqa: E402

RNG = np.random.default_rng(34)


def _text_prompt(cfg, b, seq=12):
    ids = RNG.integers(5, cfg.vocab_size, (b, seq)).astype(np.int32)
    mask = np.ones((b, seq), bool)
    mask[-1, seq - 3:] = False                   # the last row is shorter
    pos = np.tile(np.arange(seq), (b, 1))
    return ids, mask, pos, None, None


def _image_prompt(cfg, towers, b=1, seq=24):
    ids = RNG.integers(5, cfg.vocab_size, (b, seq)).astype(np.int64)
    ids[:, cfg.image_position] = IMAGE_TOKEN_INDEX
    pids, _, pmask, ppos, aux = prepare_multimodal_data(
        ids, ids.copy(), np.ones((b, seq), bool), [(640, 360)] * b, cfg.image_token_len,
        cfg.mm_vision_tower_aux_token_len_list, cfg.tokenizer_model_max_length)
    pixels = [RNG.standard_normal((b, 3, t.image_size, t.image_size), dtype=np.float32)
              for t in towers]
    return np.asarray(pids), np.asarray(pmask), np.asarray(ppos), pixels, list(aux)


def _plain_tokens(case):
    """The unsharded port engine's greedy tokens of a case."""
    m = CambrianForInference.from_state_dict(
        CambrianConfig.from_dict(case["cfg"]), {k: v.clone() for k, v in case["sd"].items()},
        torch.float32)
    engine = GenerationEngine(m.lm, m.towers, max_len=128, cache_dtype=torch.float32)
    ids, mask, pos, pixels, aux_masks = case["prompt"]
    feats = None if pixels is None else engine.encode_images(pixels)
    return engine.generate(ids, mask, pos, feats, aux_masks,
                           GenerationConfig(max_new_tokens=case["new_tokens"], temperature=0.0))


@pytest.fixture(scope="module")
def sharded_infer(tmp_path_factory):
    """Every case's payload, and one spawn of four ranks running them while
    this process computes the JAX engine's tokens."""
    # the tiny Cambrian of make_tiny_checkpoint, from JAX weights
    jcfg = tiny_debug(num_towers=2)
    towers = build_vision_tower_aux_list(jcfg.mm_vision_tower_aux_list,
                                         jcfg.mm_vision_tower_aux_token_len_list)
    jmodel = CambrianLM(jcfg, tuple(t.hidden_size for t in towers))
    text2 = _text_prompt(jcfg, 2)
    b0 = _image_prompt(jcfg, towers)
    feats = [jnp.zeros((1, t.interp_size, t.hidden_size)) for t in towers]
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(b0[0]),
                                  jnp.asarray(b0[1]), jnp.asarray(b0[2]), feats,
                                  [jnp.asarray(m) for m in b0[4]])
    sd = state_dict_from_jax(params, prefix="lm.")
    for i, t in enumerate(towers):
        sd.update(state_dict_from_jax(jax.jit(t.init)(jax.random.PRNGKey(i + 1)),
                                      prefix=f"towers.{i}.module."))
    tiny = dict(cfg=jcfg.to_dict(), sd=sd, new_tokens=5)
    # Yi-34B's structure at test width: 8 heads, 4 kv heads over model = 4
    cfg34 = CambrianConfig.from_dict(scaled_34b_config().to_dict())
    sd34 = random_state_dict(cfg34, torch.Generator().manual_seed(34), 0.05,
                             dtype=torch.float32, device="cpu")
    m34 = CambrianForInference.from_state_dict(cfg34, sd34, torch.float32)
    cases = {
        "tiny_text_b2": dict(tiny, mesh=(1, 2, 2), prompt=text2),
        "tiny_text_b3": dict(tiny, mesh=(1, 2, 2), prompt=_text_prompt(jcfg, 3)),
        "yi34b_structure": dict(cfg=cfg34.to_dict(), sd=sd34, new_tokens=8, mesh=(1, 1, 4),
                                prompt=_image_prompt(cfg34, m34.towers)),
    }
    tmp = tmp_path_factory.mktemp("parallel_infer")
    started = workers.start_ranks(workers.infer_rank, 4, tmp, dict(cases=cases))

    jax_mesh = create_mesh(MeshConfig(data=1, fsdp=2, model=2), devices=jax.devices()[:4])
    jengine = JGenerationEngine(jmodel, params, max_len=128, cache_dtype=jnp.float32,
                                mesh=jax_mesh)
    with jax.set_mesh(jax_mesh):
        jax_tokens = np.asarray(jengine.generate(
            *text2[:3], None, None, JGenerationConfig(max_new_tokens=5, temperature=0.0)))
    plain = {name: _plain_tokens(case) for name, case in cases.items()}
    ranks = workers.join_ranks(started, timeout=90)
    return dict(cases=cases, ranks=ranks, plain=plain, jax=jax_tokens)


@pytest.mark.parametrize("name", ["tiny_text_b2", "tiny_text_b3", "yi34b_structure"])
def test_sharded_engine_matches_unsharded(sharded_infer, name):
    """Greedy tokens identical on every rank and equal to the unsharded
    engine's; the KV cache holds each rank's share of the kv heads."""
    case = sharded_infer["cases"][name]
    want = sharded_infer["plain"][name]
    assert want.shape[1] == case["new_tokens"]
    for rank in sharded_infer["ranks"]:
        got = rank[name]
        np.testing.assert_array_equal(got["tokens"], want, err_msg=name)
    cfg = CambrianConfig.from_dict(case["cfg"])
    tp = case["mesh"][2]
    assert sharded_infer["ranks"][0][name]["kv_heads"] == cfg.num_key_value_heads // tp
    split = [r[name]["rows"] for r in sharded_infer["ranks"]]
    if name == "tiny_text_b2":      # one row on each fsdp rank, in mesh order
        assert split == [slice(0, 1), slice(0, 1), slice(1, 2), slice(1, 2)]
    else:                           # three rows do not split over two; one dp rank
        assert split == [None] * 4


def test_sharded_engine_matches_jax_sharded_engine(sharded_infer):
    """The (1,2,2) text batch's tokens equal the JAX engine's on its own
    (1,2,2) mesh."""
    want = sharded_infer["jax"]
    np.testing.assert_array_equal(sharded_infer["plain"]["tiny_text_b2"], want)
    for rank in sharded_infer["ranks"]:
        np.testing.assert_array_equal(rank["tiny_text_b2"]["tokens"], want)
