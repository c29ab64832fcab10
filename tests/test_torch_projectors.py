"""The LLaVA-style projectors of the port (``models/projectors.py``) and the
non-SVA ``CambrianLM`` against the JAX package on the CPU in fp32.

- Each type (``linear``, ``mlp2x_gelu``, ``mlp3x_gelu``, ``identity``,
  ``se_mlp``, ``CAbstractor`` on an even and an odd token grid) against its
  flax module, parameters perturbed and carried across by ``from_jax``: 1e-5.
- ``build_projector_module``'s dispatch, and its ``ValueError`` for an
  unknown type in both packages.
- A tiny non-SVA Cambrian of each type, built from the JAX tree of a
  text-only ``init`` (which holds no ``mm_projector``: flax creates a
  module's parameters when it is called): text-only logits to 1e-4 and 8
  greedy tokens of ``generate`` identical to JAX's; an image request raises
  ``AttributeError`` naming ``mm_projector_aux`` in both packages.
- An HF checkpoint's ``model.mm_projector.{0,2}`` (``mlp2x_gelu``) and
  ``model.mm_projector`` (``linear``) load through ``checkpoint/hf_llm.py``
  and ``load_pretrained_model`` into the flax names, and project as flax does.
"""

import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cambrian_tpu.checkpoint.save import save_pretrained as jsave_pretrained
from cambrian_tpu.constants import IMAGE_TOKEN_INDEX
from cambrian_tpu.models import builder as jbuilder
from cambrian_tpu.models import projectors as jproj
from cambrian_tpu.models.cambrian import CambrianLM as JCambrianLM
from cambrian_tpu.models.config import tiny_debug
from cambrian_tpu.models.encoders.base import build_vision_tower_aux_list
from cambrian_tpu_torch.checkpoint.from_jax import load_jax_params, state_dict_from_jax
from cambrian_tpu_torch.checkpoint.safetensors_io import save_file
from cambrian_tpu_torch.models import projectors as tproj
from cambrian_tpu_torch.models.builder import (
    CambrianForInference,
    load_pretrained_model,
)
from cambrian_tpu_torch.models.config import CambrianConfig

TOL = 1e-5
LOGIT_TOL = 1e-4
TYPES = ["linear", "mlp2x_gelu", "identity", "se_mlp", "CAbstractor"]
IN_DIM = 24


def _perturb(tree, rng, scale=0.05):
    return jax.tree.map(
        lambda x: np.asarray(x) + scale * rng.standard_normal(x.shape).astype(np.float32), tree)


def _cfg(ptype, hidden=32):
    return tiny_debug(num_towers=2).replace(mm_projector_type=ptype, hidden_size=hidden)


@pytest.mark.parametrize("ptype,tokens", [("linear", 16), ("mlp2x_gelu", 16),
                                          ("mlp3x_gelu", 16), ("identity", 16),
                                          ("se_mlp", 16), ("CAbstractor", 16),
                                          ("CAbstractor", 25)])
def test_projector_matches_flax(ptype, tokens):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, tokens, IN_DIM)).astype(np.float32)
    cfg = _cfg(ptype)
    jmod = jproj.build_projector_module(cfg)
    params = _perturb(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    port = tproj.build_projector_module(CambrianConfig.from_dict(cfg.to_dict()), IN_DIM)
    load_jax_params(port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_build_projector_module_dispatch():
    cfg = CambrianConfig.from_dict(_cfg("linear").to_dict())
    kinds = {"linear": tproj.LinearProjector, "mlp2x_gelu": tproj.MlpGeluProjector,
             "mlp4x_gelu": tproj.MlpGeluProjector, "identity": tproj.IdentityProjector,
             "se_mlp": tproj.SEMlpProjector, "CAbstractor": tproj.CAbstractor}
    for ptype, cls in kinds.items():
        mod = tproj.build_projector_module(cfg.replace(mm_projector_type=ptype), IN_DIM)
        assert type(mod) is cls
        assert type(jproj.build_projector_module(_cfg(ptype))).__name__ == cls.__name__
    assert [n for n, _ in tproj.build_projector_module(
        cfg.replace(mm_projector_type="mlp4x_gelu"), IN_DIM).named_children()] == [
            "fc0", "fc1", "fc2", "fc3"]
    for bad in ("mlp_gelu", "sva2", "Linear"):
        with pytest.raises(ValueError, match="Unknown projector type"):
            tproj.build_projector_module(cfg.replace(mm_projector_type=bad), IN_DIM)
        with pytest.raises(ValueError, match="Unknown projector type"):
            jproj.build_projector_module(_cfg(bad))


@pytest.fixture(scope="module")
def text_params():
    """One text-only JAX init (the tree is the same for every non-SVA type)."""
    cfg = tiny_debug(num_towers=2).replace(mm_projector_type="linear")
    towers = build_vision_tower_aux_list(cfg.mm_vision_tower_aux_list,
                                         cfg.mm_vision_tower_aux_token_len_list)
    ids = jnp.ones((1, 16), jnp.int32)
    params = jax.jit(JCambrianLM(cfg, tuple(t.hidden_size for t in towers)).init)(
        jax.random.PRNGKey(0), ids, jnp.ones(ids.shape, bool), jnp.arange(16)[None])
    rng = np.random.default_rng(1)
    return {"params": _perturb(params["params"], rng, 0.02)}, towers


@pytest.fixture(scope="module", params=TYPES)
def text_pair(request, text_params):
    params, towers = text_params
    assert "mm_projector" not in params["params"]
    cfg = tiny_debug(num_towers=2).replace(mm_projector_type=request.param)
    jlm = JCambrianLM(cfg, tuple(t.hidden_size for t in towers))
    tower_params = [t.init(jax.random.PRNGKey(i + 1)) for i, t in enumerate(towers)]
    jmodel = jbuilder.CambrianForInference(config=cfg, lm=jlm, params=params, towers=towers,
                                           tower_params=tower_params)
    sd = state_dict_from_jax(params, prefix="lm.")
    for i, tp in enumerate(tower_params):
        sd.update(state_dict_from_jax(jax.tree.map(np.asarray, tp), prefix=f"towers.{i}.module."))
    port = CambrianForInference.from_state_dict(CambrianConfig.from_dict(cfg.to_dict()), sd,
                                                dtype=torch.float32, cache_dtype=torch.float32)
    rng = np.random.default_rng(2)
    ids = rng.integers(5, cfg.vocab_size, 40).astype(np.int64)
    return dict(cfg=cfg, jlm=jlm, params=params, jmodel=jmodel, port=port, ids=ids, rng=rng)


def test_text_logits_match_jax(text_pair):
    p = text_pair
    lm = p["port"].lm
    kinds = {n.split(".")[0] for n, _ in lm.named_parameters()}
    assert "mm_projector_aux_0" not in kinds and "vision_query" not in kinds
    assert type(lm.mm_projector).__name__ == type(
        jproj.build_projector_module(p["cfg"])).__name__
    ids = p["ids"][None]
    pos = np.arange(ids.shape[1])[None]
    want = p["jlm"].apply(p["params"], jnp.asarray(ids), jnp.ones(ids.shape, bool),
                          jnp.asarray(pos))
    with torch.no_grad():
        got = lm(torch.from_numpy(ids), torch.ones(ids.shape, dtype=torch.bool),
                 torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_greedy_generate_matches_jax(text_pair):
    p = text_pair
    kw = dict(max_new_tokens=8, eos_token_id=None)
    want = np.asarray(p["jmodel"].generate(p["ids"], **kw))
    got = p["port"].generate(p["ids"], **kw)
    assert got.shape == (1, 8)
    np.testing.assert_array_equal(got, want)


def test_image_request_raises_as_jax(text_pair):
    p = text_pair
    ids = p["ids"].copy()
    ids[5] = IMAGE_TOKEN_INDEX
    images = [p["rng"].standard_normal((1, 3, t.image_size, t.image_size)).astype(np.float32)
              for t in p["port"].towers]
    kw = dict(images=images, image_sizes=[(40, 30)], max_new_tokens=2, eos_token_id=None)
    with pytest.raises(AttributeError, match="mm_projector_aux"):
        p["jmodel"].generate(ids, images=[jnp.asarray(x) for x in images],
                             **{k: v for k, v in kw.items() if k != "images"})
    with pytest.raises(AttributeError, match="mm_projector_aux"):
        p["port"].generate(ids, **kw)


@pytest.mark.parametrize("ptype,hf_keys", [("mlp2x_gelu", ["model.mm_projector.0",
                                                           "model.mm_projector.2"]),
                                           ("linear", ["model.mm_projector"])])
def test_hf_projector_weights_load(ptype, hf_keys, text_params, tmp_path):
    """A JAX-written checkpoint (no projector) plus a shard of HF-named
    projector weights, read by both loaders: the port's ``mm_projector``
    holds the JAX loader's tree and projects as flax does."""
    params, towers = text_params
    cfg = _cfg(ptype, hidden=128).replace(mm_hidden_size=IN_DIM)
    path = str(tmp_path / "ckpt")
    jsave_pretrained(params, cfg, path)
    rng = np.random.default_rng(3)
    extra = {}
    for i, key in enumerate(hf_keys):
        extra[f"{key}.weight"] = rng.standard_normal(
            (cfg.hidden_size, IN_DIM if i == 0 else cfg.hidden_size)).astype(np.float32)
        extra[f"{key}.bias"] = rng.standard_normal(cfg.hidden_size).astype(np.float32)
    save_file(extra, os.path.join(path, "projector.safetensors"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, jmodel, _, _ = jbuilder.load_pretrained_model(path, dtype=jnp.float32)
        _, model, _, _ = load_pretrained_model(path, device="cpu", dtype=torch.float32)
    jtree = jmodel.params["params"]["mm_projector"]
    assert sorted(jtree) == sorted(n for n, _ in model.lm.mm_projector.named_children())
    x = rng.standard_normal((1, 16, IN_DIM)).astype(np.float32)
    want = jproj.build_projector_module(cfg).apply({"params": jtree}, jnp.asarray(x))
    with torch.no_grad():
        got = model.lm.mm_projector(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_tree_without_projector_gets_random_weights(text_params):
    """``from_state_dict`` fills a non-SVA projector the tree lacks, and
    keeps the tree's when it has one."""
    params, towers = text_params
    cfg = CambrianConfig.from_dict(tiny_debug(num_towers=2).replace(
        mm_projector_type="mlp2x_gelu").to_dict())
    sd = state_dict_from_jax(params, prefix="lm.")
    for i, t in enumerate(towers):
        sd.update(state_dict_from_jax(jax.tree.map(np.asarray, t.init(jax.random.PRNGKey(i))),
                                      prefix=f"towers.{i}.module."))
    filled = CambrianForInference.from_state_dict(cfg, sd, dtype=torch.float32)
    w = filled.lm.mm_projector.fc0.weight
    in_dim = sum(t.hidden_size for t in towers)
    assert w.shape == (cfg.hidden_size, in_dim) and 0.01 < float(w.detach().std()) < 0.03
    assert float(filled.lm.mm_projector.fc1.bias.detach().abs().max()) == 0.0
    mine = {f"lm.mm_projector.{k}": torch.full_like(v, 0.5)
            for k, v in filled.lm.mm_projector.state_dict().items()}
    kept = CambrianForInference.from_state_dict(cfg, {**sd, **mine}, dtype=torch.float32)
    assert all(bool((v == 0.5).all()) for v in kept.lm.mm_projector.state_dict().values())
