"""Tower parity: the port's ViT and ConvNeXt towers against the JAX
package's, on the same JAX ``init`` parameters (through
``checkpoint/from_jax.py``) and the same pixels, on the CPU in fp32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cambrian_tpu.models.encoders import base as jbase
from cambrian_tpu.models.encoders import convnext as jconvnext
from cambrian_tpu.models.encoders import vit as jvit
from cambrian_tpu_torch.checkpoint.from_jax import load_jax_params, state_dict_from_jax
from cambrian_tpu_torch.models.encoders import base as tbase
from cambrian_tpu_torch.models.encoders import convnext as tconvnext
from cambrian_tpu_torch.models.encoders import vit as tvit

TOL = 1e-5  # fp32, same math; summation order differs

VIT_VARIANTS = {
    # CLIP-like: class token, pre-LN, quick_gelu, tapped at layer -2
    "clip_like": dict(class_token=True, pre_layernorm=True, final_layernorm=False,
                      act="quick_gelu", patch_bias=False, select_layer=-2,
                      num_layers=3),
    # SigLIP-like: no class token, tanh GELU, final LN, head_dim 12
    "siglip_like": dict(class_token=False, act="gelu_tanh", hidden_size=48,
                        ln_eps=1e-6),
    # DINOv2-like: class token + registers, SwiGLU, LayerScale, exact GELU
    "dinov2_like": dict(class_token=True, swiglu=True, layer_scale=True,
                        num_register_tokens=2, ln_eps=1e-6),
}


def _pixels(size, seed=0, batch=2):
    return np.random.default_rng(seed).standard_normal(
        (batch, 3, size, size), dtype=np.float32)


def _perturb(params, seed):
    """Random values for every leaf (flax init leaves LN/LayerScale/pos at
    constants that would hide a wrong mapping)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.1 * rng.standard_normal(x.shape).astype(np.float32),
        params)


@pytest.mark.parametrize("name", sorted(VIT_VARIANTS))
def test_vit_matches_jax(name):
    cfg_j = jvit.tiny_vit(image_size=32, **VIT_VARIANTS[name])
    cfg_t = tvit.tiny_vit(image_size=32, **VIT_VARIANTS[name])
    px = _pixels(32)
    mod = jvit.VisionTransformer(cfg_j)
    params = _perturb(mod.init(jax.random.PRNGKey(0), jnp.asarray(px))["params"], 1)
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(px)))
    port = load_jax_params(tvit.VisionTransformer(cfg_t), params)
    with torch.no_grad():
        got = port(torch.from_numpy(px)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_convnext_multistage_matches_jax():
    cfg_j, cfg_t = jconvnext.tiny_convnext(64), tconvnext.tiny_convnext(64)
    px = _pixels(64, seed=2)
    mod = jconvnext.ConvNeXtTokens(cfg_j, interp_side=4)
    params = _perturb(mod.init(jax.random.PRNGKey(0), jnp.asarray(px))["params"], 3)
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(px)))
    port = load_jax_params(tconvnext.ConvNeXtTokens(cfg_t, interp_side=4), params)
    with torch.no_grad():
        got = port(torch.from_numpy(px)).numpy()
    assert got.shape == (2, 16, sum(cfg_t.dims))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_tower_registry_and_interp_match_jax():
    # a debug tower resampled 16 -> 9 tokens through interpolate_tokens
    name = "debug-tower-0-interp9"
    jt = jbase.build_vision_tower(name)
    tt = tbase.build_vision_tower(name)
    assert (tt.hidden_size, tt.image_size, tt.interp_size) == (
        jt.hidden_size, jt.image_size, jt.interp_size)
    px = _pixels(jt.image_size, seed=4)
    params = _perturb(jt.init(jax.random.PRNGKey(1)), 5)
    want = np.asarray(jt.apply(params, jnp.asarray(px)))
    load_jax_params(tt, params, prefix="module.")
    with torch.no_grad():
        got = tt(torch.from_numpy(px)).numpy()
    assert got.shape == (2, 9, jt.hidden_size)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_production_tower_geometry():
    """The registry builds the 8B towers with the JAX package's geometry
    (on the meta device: no weights are allocated)."""
    from cambrian_tpu.models.config import cambrian_8b

    cfg = cambrian_8b()
    with torch.device("meta"):
        towers = tbase.build_vision_tower_aux_list(
            cfg.mm_vision_tower_aux_list, cfg.mm_vision_tower_aux_token_len_list,
            dtype=torch.bfloat16)
    jtowers = jbase.build_vision_tower_aux_list(
        cfg.mm_vision_tower_aux_list, cfg.mm_vision_tower_aux_token_len_list)
    for t, j in zip(towers, jtowers):
        assert (t.hidden_size, t.image_size, t.interp_size) == (
            j.hidden_size, j.image_size, j.interp_size)
        assert t.config.__dict__ == j.config.__dict__
    blocks = [t.config.num_blocks_to_run for t in towers[:3]]
    assert blocks == [27, 23, 40]   # SigLIP, CLIP at layer -2, DINOv2


def test_from_jax_rejects_unused_keys():
    cfg = tvit.tiny_vit(class_token=False)
    mod = jvit.VisionTransformer(jvit.tiny_vit(class_token=False))
    params = dict(mod.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32)))["params"])
    params["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="stray"):
        load_jax_params(tvit.VisionTransformer(cfg), params)
    sd = state_dict_from_jax({"patch_embed": {"kernel": np.zeros((8, 8, 3, 32))}})
    assert tuple(sd["patch_embed.weight"].shape) == (32, 3, 8, 8)
