"""The port's encoder-study towers (``models/encoders/{extra,sam}.py``, the
rotary, relative-position and sub-LN branches of ``vit.py``) against the
JAX package's, on the CPU in fp32, at tiny sizes.

- Each family's tower output vs JAX to 1e-5, on JAX ``init`` parameters
  moved by noise (so that no mapping hides behind an init constant) and
  crossed by ``checkpoint/from_jax.py``: plain ViT with and without a class
  token, DFN, EVA-02 (rope rescaled to another pretrain grid, sub-LN SwiGLU,
  no key bias), DPT, BEiT (relative-position bias), SAM (windowed and global
  blocks, decomposed rel-pos, neck; at its checkpoint's size and at ``res``
  overrides), and the hybrid tower; SAM's ``_get_rel_pos`` where it resizes
  a table (the weights of ``jax.image.resize(..., "linear")``, bit for bit).
- The registry: every name the JAX package's tests resolve, plus the
  full-size zoo, to the same module, config, hidden size, image size,
  ``interp_size`` and upstream repo (built on the meta device).
- ``convert_dpt_vit``, ``convert_eva02`` (timm and BAAI naming) and
  ``convert_sam_vision`` vs JAX's, leaf for leaf, on HF-layout dicts;
  ``load_tower_params`` on MiDaS (DPT, BEiT) and EVA-02 snapshots under
  ``CAMBRIAN_TOWER_CACHE``.
- A tiny Cambrian whose towers are an EVA-02-style ViT and ``tiny_sd``:
  prefill and decode logits to 1e-4 and greedy tokens identical to JAX's.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))

from cambrian_tpu.checkpoint import hf_vision as jhf  # noqa: E402
from cambrian_tpu.mm_utils import ImageProcessor as JImageProcessor  # noqa: E402
from cambrian_tpu.models import builder as jbuilder  # noqa: E402
from cambrian_tpu.models.encoders import base as jbase  # noqa: E402
from cambrian_tpu.models.encoders import extra as jextra  # noqa: E402
from cambrian_tpu.models.encoders import sam as jsam  # noqa: E402
from cambrian_tpu.models.encoders import vit as jvit  # noqa: E402
from cambrian_tpu_torch.checkpoint import hf_vision as thf  # noqa: E402
from cambrian_tpu_torch.checkpoint import safetensors_io  # noqa: E402
from cambrian_tpu_torch.checkpoint.from_jax import load_jax_params, state_dict_from_jax  # noqa: E402
from cambrian_tpu_torch.mm_utils import IMAGENET_MEAN, IMAGENET_STD, ImageProcessor  # noqa: E402
from cambrian_tpu_torch.models import builder as tbuilder  # noqa: E402
from cambrian_tpu_torch.models.encoders import base as tbase  # noqa: E402
from cambrian_tpu_torch.models.encoders import extra as textra  # noqa: E402
from cambrian_tpu_torch.models.encoders import sam as tsam  # noqa: E402
from cambrian_tpu_torch.models.encoders import vit as tvit  # noqa: E402
from cambrian_tpu_torch.ops.resize import linear_resize_matrix  # noqa: E402
from test_torch_diffusion_tower import _jax_apply, _random_params  # noqa: E402

transformers = pytest.importorskip("transformers")

TOL = 1e-5          # tower outputs, fp32: same math, sums in another order
LOGIT_TOL = 1e-4    # logits after the whole decoder

TINY = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64, patch_size=8,
            image_size=32)
# the builders' settings of extra.py at tiny widths
FAMILIES = {
    # MAE / supervised / MAWS / MoCo: class token, final LayerNorm
    "plain_cls": dict(TINY, class_token=True, final_layernorm=True, act="gelu",
                      select_layer=0, ln_eps=1e-6),
    # I-JEPA: no class token
    "plain_nocls": dict(TINY, class_token=False, final_layernorm=True, act="gelu",
                        select_layer=0, ln_eps=1e-6),
    # DFN-CLIP: pre-LN, quick_gelu, no patch bias, tapped at layer -2
    "dfn": dict(TINY, num_layers=3, class_token=True, pre_layernorm=True,
                final_layernorm=False, act="quick_gelu", patch_bias=False,
                select_layer=-2, ln_eps=1e-5),
    # EVA-02: rope with positions rescaled from the 4 x 4 grid to a 2 x 2
    # pretrain grid, sub-LN SwiGLU (an odd hidden width, as 2730), no k bias
    "eva02": dict(TINY, num_layers=3, intermediate_size=43, class_token=True,
                  final_layernorm=False, act="gelu", select_layer=-2, ln_eps=1e-6,
                  k_bias=False, rope=True, rope_ref_side=2, swiglu_ln=True),
    # DPT-L: hidden_states[-1], no final LayerNorm
    "dpt": dict(TINY, class_token=True, final_layernorm=False, act="gelu",
                select_layer=-1, ln_eps=1e-12),
    # BEiT-L: relative-position bias, LayerScale, no absolute pos embed
    "beit": dict(TINY, class_token=True, final_layernorm=False, act="gelu",
                 select_layer=-1, ln_eps=1e-12, k_bias=False, abs_pos_embed=False,
                 rel_pos_bias=True, layer_scale=True),
}


def _pixels(size, seed=0, batch=2):
    return np.random.default_rng(seed).standard_normal((batch, 3, size, size),
                                                       dtype=np.float32)


def _perturb(params, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + scale * rng.standard_normal(x.shape).astype(np.float32),
        params)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_vit_family_matches_jax(family):
    """Through each package's ``_vit_tower``, resampled 16 -> 9 tokens."""
    kw = FAMILIES[family]
    jt = jextra._vit_tower(family, jvit.ViTConfig(**kw), None, 9, jnp.float32,
                           IMAGENET_MEAN, IMAGENET_STD)
    tt = textra._vit_tower(family, tvit.ViTConfig(**kw), None, 9, torch.float32, None,
                           IMAGENET_MEAN, IMAGENET_STD)
    px = _pixels(32, seed=1)
    params = _perturb(jt.init(jax.random.PRNGKey(0)), 2)
    want = np.asarray(jt.apply(params, jnp.asarray(px)))
    load_jax_params(tt, params, prefix="module.")
    with torch.no_grad():
        got = tt(torch.from_numpy(px)).numpy()
    assert got.shape == want.shape == (2, 9, 32)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_rope_tables_and_rotation_match_jax():
    """The tables at a rescaled grid, the interleaved-pair rotation (not
    LLaMA's halves) and the unrotated class token, exactly as JAX's."""
    for side, head_dim, ref in ((4, 16, 4), (24, 64, 16), (6, 88, 16)):
        jsin, jcos = jvit._rope_tables(side, head_dim, ref)
        tsin, tcos = tvit._rope_tables(side, head_dim, ref)
        np.testing.assert_array_equal(tsin.numpy(), np.asarray(jsin))
        np.testing.assert_array_equal(tcos.numpy(), np.asarray(jcos))
    x = np.random.default_rng(3).standard_normal((2, 37, 3, 16), dtype=np.float32)
    sin, cos = jvit._rope_tables(6, 16, 4)
    want = np.asarray(jvit._apply_rope(jnp.asarray(x), sin, cos, n_prefix=1))
    got = tvit._apply_rope(torch.from_numpy(x), *tvit._rope_tables(6, 16, 4), 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[:, 0], x[:, 0])


@pytest.mark.parametrize("side", [2, 5, 32])
def test_beit_relative_position_index_matches_jax(side):
    np.testing.assert_array_equal(tvit.beit_relative_position_index(side),
                                  jvit.beit_relative_position_index(side))


# -- SAM ----------------------------------------------------------------------

SAM = dict(hidden_size=32, num_layers=3, num_heads=4, mlp_ratio=2.0, patch_size=8,
           image_size=64, window_size=3, global_attn_indexes=(1,), output_channels=16)


def _hf_sam(seed=0):
    """An HF SamVisionEncoder at SAM's tiny geometry (8 x 8 grid, windows of
    3: padded to 9), its dict moved by noise; the rel-pos tables are zeros
    at init, so the noise matters."""
    from transformers import SamVisionConfig
    from transformers.models.sam.modeling_sam import SamVisionEncoder

    hf = SamVisionEncoder(SamVisionConfig(
        hidden_size=32, num_hidden_layers=3, num_attention_heads=4, image_size=64,
        patch_size=8, window_size=3, global_attn_indexes=[1], output_channels=16,
        use_rel_pos=True, mlp_ratio=2.0, layer_norm_eps=1e-6))
    rng = np.random.default_rng(seed)
    return {k: v.detach().numpy() + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
            for k, v in hf.state_dict().items()}


def test_sam_from_hf_matches_jax():
    """SAM converted from an HF dict: the converter's tree leaf for leaf,
    then the tower's output (windowed blocks padded 8 -> 9, a global block)."""
    sd = _hf_sam()
    jcfg, tcfg = jsam.SamViTConfig(**SAM), tsam.SamViTConfig(**SAM)
    want_tree = jsam.convert_sam_vision(sd, jcfg)
    got_tree = tsam.convert_sam_vision(sd, tcfg)
    jl, gl = _leaves(want_tree), _leaves(got_tree)
    assert set(gl) == set(jl)
    for k in jl:
        np.testing.assert_array_equal(gl[k], jl[k], err_msg=k)
    px = _pixels(64, seed=5)
    want = np.asarray(jsam.SamViT(jcfg).apply({"params": jax.tree.map(jnp.asarray, want_tree)},
                                              jnp.asarray(px)))
    port = load_jax_params(tsam.SamViT(tcfg), got_tree)
    with torch.no_grad():
        got = port(torch.from_numpy(px)).numpy()
    assert got.shape == want.shape == (2, 64, 16)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("res", [48, 80])
def test_sam_res_override_matches_jax(res):
    """``_build_sam`` at a ``res`` override (6 x 6 grid: no padding; 10 x 10:
    padded to 12), on perturbed JAX init parameters (tables of 11 and 19
    rows in the global block)."""
    jt = jbase.build_vision_tower(f"sam_vit_b-res{res}")
    tt = tbase.build_vision_tower(f"sam_vit_b-res{res}")
    assert tt.config.__dict__ == jt.config.__dict__ and tt.image_size == res
    jcfg = jsam.SamViTConfig(**{**SAM, "image_size": res})
    tcfg = tsam.SamViTConfig(**{**SAM, "image_size": res})
    px = _pixels(res, seed=6)
    jmod = jsam.SamViT(jcfg)
    params = _perturb(jmod.init(jax.random.PRNGKey(0), jnp.asarray(px))["params"], 7)
    assert params["blocks_1"]["attn"]["rel_pos_h"].shape == (2 * (res // 8) - 1, 8)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(px)))
    port = load_jax_params(tsam.SamViT(tcfg), params)
    with torch.no_grad():
        got = port(torch.from_numpy(px)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("sizes", [(6, 6, 15), (6, 6, 9), (4, 4, 27), (3, 6, 11), (6, 3, 11)])
def test_sam_get_rel_pos_matches_jax(sizes):
    """The table gathered at the relative coordinates, resized first where
    its rows are not 2 max(q, k) - 1 (down: 15 -> 11, 27 -> 7; up: 9 -> 11;
    unequal q and k)."""
    q, k, rows = sizes
    table = np.random.default_rng(rows).standard_normal((rows, 8), dtype=np.float32)
    want = np.asarray(jsam._get_rel_pos(q, k, jnp.asarray(table)))
    got = tsam._get_rel_pos(q, k, torch.from_numpy(table)).numpy()
    assert got.shape == want.shape == (q, k, 8)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("size", [(15, 11), (15, 19), (127, 63), (27, 27), (5, 2)])
def test_linear_resize_matrix_is_jax_resizes(size):
    """SAM's table resize: the weights of ``jax.image.resize(..., "linear")``
    (antialiased), bit for bit."""
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

    old, new = size
    want = np.asarray(compute_weight_mat(old, new, new / old, 0.0, _fill_triangle_kernel,
                                         True)).T
    np.testing.assert_array_equal(linear_resize_matrix(old, new), want)
    table = np.random.default_rng(old).standard_normal((old, 8), dtype=np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(table), (new, 8), "linear"))
    np.testing.assert_allclose(linear_resize_matrix(old, new) @ table, ref, atol=1e-6, rtol=0)


def test_sam_window_partition_round_trip():
    """64 x 64 pads to 70 x 70 for windows of 14 (25 windows an image) and
    comes back unchanged, as in JAX."""
    x = np.random.default_rng(6).standard_normal((2, 64, 64, 8), dtype=np.float32)
    win, pad = tsam.window_partition(torch.from_numpy(x), 14)
    jwin, jpad = jsam.window_partition(jnp.asarray(x), 14)
    assert pad == jpad == (70, 70) and tuple(win.shape) == (50, 14, 14, 8)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jwin))
    back = tsam.window_unpartition(win, 14, pad, (64, 64))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("size", [(100, 50), (50, 100), (64, 64)])
def test_sam_image_processor_matches_jax(size):
    """Longest side resized to the tower's size, bottom/right zero padding,
    0-255-scale normalization: the JAX processor's array exactly."""
    Image = pytest.importorskip("PIL.Image")

    rgb = np.random.default_rng(size[0]).integers(0, 256, (size[1], size[0], 3), np.uint8)
    img = Image.fromarray(rgb)
    got = tsam.SamImageProcessor(size=64).preprocess(img)["pixel_values"]
    want = jsam.SamImageProcessor(size=64).preprocess(img)["pixel_values"]
    assert got.shape == want.shape == (1, 3, 64, 64)
    np.testing.assert_array_equal(got, want)
    if size[0] > size[1]:
        assert not got[0, :, 32:].any()          # the bottom half is padding


# -- hybrid -----------------------------------------------------------------------

def test_hybrid_tower_matches_jax():
    """Two debug towers on the same pixels, the first resampled 16 -> 4
    tokens by its own name, then by the hybrid 4 -> 9, the second 16 -> 9,
    concatenated; the JAX list of sub-trees loads as ``module.{i}.*``."""
    name = "hybridmodel-debug-tower-res32-interp4-&&&-debug-tower-res32-interp9"
    jt = jbase.build_vision_tower(name)
    tt = tbase.build_vision_tower(name)
    assert (tt.hidden_size, tt.image_size, tt.interp_size) == (
        jt.hidden_size, jt.image_size, jt.interp_size) == (64, 32, 9)
    assert [t.interp_size for t in tt.towers] == [t.interp_size for t in jt.towers] == [4, 9]
    params = _perturb(jt.init(jax.random.PRNGKey(0)), 7)
    assert isinstance(params, list) and len(params) == 2
    sd = state_dict_from_jax(params, prefix="module.")
    assert set(sd) == set(tt.state_dict())
    load_jax_params(tt, params, prefix="module.")
    px = _pixels(32, seed=8)
    want = np.asarray(jt.apply(params, jnp.asarray(px)))
    with torch.no_grad():
        got = tt(torch.from_numpy(px)).numpy()
    assert got.shape == want.shape == (2, 9, 64)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


# -- the registry -------------------------------------------------------------------

REGISTRY_NAMES = [
    # the JAX package's own registry tests (tests/test_extra_towers.py)
    "mae-vit-l-16-interp576",
    "ijepa-vit-h-14-interp576",
    "moco-vit-b-16-interp144",
    "supervised-vit-l-16-interp576",
    "dfn-clip-vit-h-14-res224-interp256",
    "eva/CLIP-ViT-L-336-interp576",
    "timm/eva02_large_patch14_clip_224.merged2b_s4b_b131k-interp256",
    "large-midas-interp576",
    "large-beit-midas-512-interp576",
    # the rest of the zoo at full size
    "sam_vit_h",
    "sam_vit_l-res1024-interp576",
    "sam_vit_b-res512",
    "diffusion",
    "diffusion-sd21-interp9216",
    "pixart-alpha",
    "maws-vit-2b-14",
    "maws-vit-h-14-interp256",
    "ijepa-vit-g-16",
    "mae-vit-h-14",
    "supervised-vit-h-14",
    "eva02_large_patch14_clip_336-interp576",
    "hybridmodel-mae-vit-l-16-&&&-dfn-clip-vit-h-14-interp256",
]


@pytest.mark.parametrize("name", REGISTRY_NAMES)
def test_registry_resolves_like_jax(name):
    jt = jbase.build_vision_tower(name)
    with torch.device("meta"):
        tt = tbase.build_vision_tower(name, dtype=torch.bfloat16)
    assert (tt.hidden_size, tt.image_size, tt.interp_size, tt.hf_repo) == (
        jt.hidden_size, jt.image_size, jt.interp_size, jt.hf_repo)
    assert tt.num_patches == jt.num_patches
    assert type(tt.config).__name__ == type(jt.config).__name__
    assert tt.config.__dict__ == jt.config.__dict__
    if isinstance(tt, textra._HybridTower):
        assert [type(t.module).__name__ for t in tt.towers] == [
            type(t.module).__name__ for t in jt.towers]
    else:
        assert type(tt.module).__name__ == type(jt.module).__name__
    ip, jp = tt.image_processor, jt.image_processor
    assert (ip.size, tuple(ip.image_mean), tuple(ip.image_std)) == (
        jp.size, tuple(jp.image_mean), tuple(jp.image_std))


def test_dfn_beats_clip_vit_and_hybrid_midas_raises():
    """A prefix beats a substring: ``dfn-clip-vit-h`` is DFN's builder (32
    layers at 1280), not CLIP-L's; ``hybrid-midas`` raises as in JAX."""
    with torch.device("meta"):
        t = tbase.build_vision_tower("dfn-clip-vit-h-14")
    assert t.hidden_size == 1280 and t.config.num_layers == 32
    assert t.hf_repo == "apple/DFN5B-CLIP-ViT-H-14"
    for build in (jbase.build_vision_tower, tbase.build_vision_tower):
        with pytest.raises(NotImplementedError, match="hybrid-midas"):
            build("hybrid-midas")


def test_aux_list_appends_interp():
    names = ["eva/CLIP-ViT-L-336", "large-midas", "ijepa-vit-g-16"]
    with torch.device("meta"):
        towers = tbase.build_vision_tower_aux_list(names, [576, 576, 196])
    jtowers = jbase.build_vision_tower_aux_list(names, [576, 576, 196])
    assert [t.name for t in towers] == [t.name for t in jtowers]
    assert [t.num_patches for t in towers] == [576, 576, 196]


# -- converters and snapshots -------------------------------------------------------

def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _perturbed(model, seed):
    rng = np.random.default_rng(seed)
    return {k: v.detach().numpy() + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
            for k, v in model.state_dict().items()}


def _hf_dpt(seed=0):
    return _perturbed(transformers.DPTForDepthEstimation(transformers.DPTConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        image_size=32, patch_size=8, neck_hidden_sizes=[16, 16, 16, 16],
        fusion_hidden_size=16)), seed)


def _hf_dpt_native48(seed=0):
    """DPT at 48 px (a 6 x 6 position grid), run at 32: resampled."""
    return _perturbed(transformers.DPTForDepthEstimation(transformers.DPTConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        image_size=48, patch_size=8, neck_hidden_sizes=[16, 16, 16, 16],
        fusion_hidden_size=16)), seed)


def _hf_beit(seed=0):
    return _perturbed(transformers.BeitModel(transformers.BeitConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        image_size=32, patch_size=8, use_relative_position_bias=True,
        layer_scale_init_value=0.1, use_absolute_position_embeddings=False,
        use_mean_pooling=False), add_pooling_layer=False), seed)


def _eva_dict(seed=0, baai=False, native_side=4):
    """An EVA-02 trunk in timm naming (``visual.trunk.``, fc1_g/fc1_x/norm/
    fc2) or BAAI naming (``visual.``, w1/w2/ffn_ln/w3)."""
    rng = np.random.default_rng(seed)
    d, m, p = 32, 43, 8
    n = native_side * native_side

    def r(*shape):      # a checkpoint's scale: activations stay near unit size
        return 0.1 * rng.standard_normal(shape).astype(np.float32)

    pre = "visual." if baai else "visual.trunk."
    sd = {"pos_embed": r(1, n + 1, d), "cls_token": r(1, 1, d),
          "patch_embed.proj.weight": r(d, 3, p, p), "patch_embed.proj.bias": r(d)}
    mlp = ("mlp.w1", "mlp.w2", "mlp.ffn_ln", "mlp.w3") if baai else (
        "mlp.fc1_g", "mlp.fc1_x", "mlp.norm", "mlp.fc2")
    for i in range(3):
        lp = f"blocks.{i}."
        for nm, shape in (("attn.q_proj", (d, d)), ("attn.v_proj", (d, d)),
                          ("attn.proj", (d, d)), (mlp[0], (m, d)), (mlp[1], (m, d)),
                          (mlp[3], (d, m))):
            sd[lp + nm + ".weight"], sd[lp + nm + ".bias"] = r(*shape), r(shape[0])
        sd[lp + "attn.k_proj.weight"] = r(d, d)
        for nm, width in (("norm1", d), ("norm2", d), (mlp[2], m)):
            sd[lp + nm + ".weight"], sd[lp + nm + ".bias"] = 1 + r(width), r(width)
    sd["norm.weight"], sd["norm.bias"] = r(d), r(d)        # unused at layer -2
    return {pre + k: v for k, v in sd.items()}


# name: (dict, converter, tower kwargs)
CONVERTERS = {
    "dpt": (_hf_dpt, "convert_dpt_vit", FAMILIES["dpt"]),
    "dpt_resampled": (_hf_dpt_native48, "convert_dpt_vit", FAMILIES["dpt"]),
    "beit": (_hf_beit, "convert_dpt_vit", FAMILIES["beit"]),
    "eva02_timm": (_eva_dict, "convert_eva02", FAMILIES["eva02"]),
    "eva02_baai": (lambda seed: _eva_dict(seed, baai=True), "convert_eva02",
                   FAMILIES["eva02"]),
    "eva02_resampled": (lambda seed: _eva_dict(seed, native_side=6), "convert_eva02",
                        FAMILIES["eva02"]),
}


@pytest.mark.parametrize("name", sorted(CONVERTERS))
def test_converter_matches_jax(name):
    make, conv, kw = CONVERTERS[name]
    sd = make(seed=3)
    jcfg, tcfg = jvit.ViTConfig(**kw), tvit.ViTConfig(**kw)
    want = getattr(jhf, conv)(sd, jcfg)
    got = getattr(thf, conv)(sd, tcfg)
    wl, gl = _leaves(want), _leaves(got)
    assert set(gl) == set(wl)
    for k in wl:
        assert gl[k].shape == wl[k].shape, k
        if name.endswith("resampled") and k == "pos_embed":
            np.testing.assert_allclose(gl[k], wl[k], atol=TOL, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(gl[k], wl[k], err_msg=k)
    px = _pixels(32, seed=4)
    ref = np.asarray(jvit.VisionTransformer(jcfg).apply(
        {"params": jax.tree.map(jnp.asarray, want)}, jnp.asarray(px)))
    port = load_jax_params(tvit.VisionTransformer(tcfg), got)
    with torch.no_grad():
        out = port(torch.from_numpy(px)).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind", ["large-midas", "large-beit-midas-512", "eva02-l-336"])
def test_load_tower_params_from_snapshot_matches_jax(kind, tmp_path, monkeypatch):
    """A snapshot under ``CAMBRIAN_TOWER_CACHE``: the name picks the
    converter (``midas`` -> DPT, ``eva`` -> EVA-02, never CLIP's), and the
    port's tower equals the JAX loader's, tensor for tensor."""
    make, kw = {"large-midas": (_hf_dpt, FAMILIES["dpt"]),
                "large-beit-midas-512": (_hf_beit, FAMILIES["beit"]),
                "eva02-l-336": (_eva_dict, FAMILIES["eva02"])}[kind]
    repo = f"fake-org/tiny-{kind}"
    snap = tmp_path / repo.replace("/", "--")
    snap.mkdir(parents=True)
    safetensors_io.save_file(make(seed=9), str(snap / "model.safetensors"))
    monkeypatch.setenv("CAMBRIAN_TOWER_CACHE", str(tmp_path))
    jcfg, tcfg = jvit.ViTConfig(**kw), tvit.ViTConfig(**kw)
    name = f"{kind}-interp4"
    jt = jbase.VisionTower(name=name, module=jvit.VisionTransformer(jcfg), config=jcfg,
                           hidden_size=32, image_size=32, interp_size=4,
                           image_processor=JImageProcessor(size=32), hf_repo=repo)
    tt = tbase.VisionTower(name=name, module=tvit.VisionTransformer(tcfg), config=tcfg,
                           hidden_size=32, image_size=32, interp_size=4,
                           image_processor=ImageProcessor(size=32), hf_repo=repo)
    jparams = jbuilder.load_tower_params(jt)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jparams), prefix="module.")
    got = tbuilder.load_tower_params(tt)
    assert set(got) == set(want) == set(tt.state_dict())
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0, msg=k)
    tt.load_state_dict(got)
    px = _pixels(32, seed=10, batch=1)
    with torch.no_grad():
        out = tt(torch.from_numpy(px)).numpy()
    np.testing.assert_allclose(out, np.asarray(jt.apply(jparams, jnp.asarray(px))),
                               atol=TOL, rtol=TOL)


# -- a tiny Cambrian with an EVA-02-style tower and tiny_sd ------------------------------

EVA_TOWER = "tinyeva-tower"


def _jax_eva_builder(name, res, interp, dtype):
    return jextra._vit_tower(name, jvit.ViTConfig(**FAMILIES["eva02"]), res, interp, dtype,
                             IMAGENET_MEAN, IMAGENET_STD)


def _port_eva_builder(name, res, interp, dtype, device):
    return textra._vit_tower(name, tvit.ViTConfig(**FAMILIES["eva02"]), res, interp, dtype,
                             device, IMAGENET_MEAN, IMAGENET_STD)


@pytest.fixture(scope="module")
def eva_sd_cambrian():
    """JAX and port Cambrian with towers (tiny EVA-02 ViT, tiny_sd at 64 px
    resampled 16 -> 64 tokens), the same perturbed weights, the same pixels;
    the SD tower takes JAX's default noise in both."""
    from cambrian_tpu.constants import IMAGE_TOKEN_INDEX
    from cambrian_tpu.data.packing import prepare_multimodal_data
    from cambrian_tpu.models.cambrian import CambrianLM as JCambrianLM
    from cambrian_tpu.models.config import tiny_debug
    from cambrian_tpu_torch.models.builder import CambrianForInference
    from cambrian_tpu_torch.models.config import CambrianConfig

    mp = pytest.MonkeyPatch()
    mp.setitem(jbase._REGISTRY, EVA_TOWER, _jax_eva_builder)
    mp.setitem(tbase._REGISTRY, EVA_TOWER, _port_eva_builder)
    try:
        cfg = tiny_debug(num_towers=2).replace(
            mm_vision_tower_aux_list=(EVA_TOWER, "diffusion-tiny"))
        towers = jbase.build_vision_tower_aux_list(cfg.mm_vision_tower_aux_list,
                                                   cfg.mm_vision_tower_aux_token_len_list)
        rng = np.random.default_rng(0)
        ids = rng.integers(5, cfg.vocab_size, (1, 40)).astype(np.int64)
        ids[0, cfg.image_position] = IMAGE_TOKEN_INDEX
        pids, _, pmask, ppos, aux_masks = prepare_multimodal_data(
            ids, ids.copy(), np.ones_like(ids, bool), [(640, 360)], cfg.image_token_len,
            cfg.mm_vision_tower_aux_token_len_list, cfg.tokenizer_model_max_length)
        images = [rng.standard_normal((1, 3, t.image_size, t.image_size), dtype=np.float32)
                  for t in towers]
        # the SD tower's parameters drawn at its init's shapes and its
        # features jitted (flax's eager init and apply take ~80 s here)
        tower_params = [_perturb(towers[0].init(jax.random.PRNGKey(1)), 11, 0.05),
                        _random_params(towers[1].module, towers[1].image_size, 12)]
        sd_feats = _jax_apply(towers[1].config)({"params": tower_params[1]},
                                                jnp.asarray(images[1]))
        feats = [towers[0].apply(tower_params[0], jnp.asarray(images[0])),
                 jbase.interpolate_tokens(sd_feats, towers[1].interp_size)]
        model = JCambrianLM(cfg, tuple(t.hidden_size for t in towers))
        jmasks = [jnp.asarray(m) for m in aux_masks]
        params = model.init(jax.random.PRNGKey(0), jnp.asarray(pids), jnp.asarray(pmask),
                            jnp.asarray(ppos), feats, jmasks)
        params = {"params": _perturb(params["params"], 13, 0.02)}
        sd = state_dict_from_jax(params, prefix="lm.")
        for i, tp in enumerate(tower_params):
            sd.update(state_dict_from_jax(tp, prefix=f"towers.{i}.module."))
        port = CambrianForInference.from_state_dict(
            CambrianConfig.from_dict(cfg.to_dict()), sd, dtype=torch.float32,
            cache_dtype=torch.float32)
    finally:
        mp.undo()
    sd_cfg = towers[1].config
    side = sd_cfg.image_size // 8
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(sd_cfg.noise_seed),
                                         (1, side, side, sd_cfg.latent_channels), jnp.float32))
    return dict(cfg=cfg, towers=towers, model=model, params=params, images=images,
                feats=feats, jmasks=jmasks, pids=pids, pmask=pmask, ppos=ppos,
                aux_masks=aux_masks, port=port,
                noise=torch.from_numpy(noise.transpose(0, 3, 1, 2).copy()))


def _port_feats(p):
    with torch.no_grad():
        return [p["port"].towers[0](torch.from_numpy(p["images"][0])),
                p["port"].towers[1](torch.from_numpy(p["images"][1]), noise=p["noise"])]


def test_eva_sd_cambrian_features_and_logits_match_jax(eva_sd_cambrian):
    from cambrian_tpu.models.cambrian import CambrianLM as JCambrianLM
    from cambrian_tpu.models.language.llama import init_kv_cache as j_init_cache
    from cambrian_tpu_torch.models.language.llama import init_kv_cache

    p = eva_sd_cambrian
    feats = _port_feats(p)
    assert [tuple(f.shape) for f in feats] == [(1, 16, 32), (1, 64, 56)]
    for got, want in zip(feats, p["feats"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    s = p["pids"].shape[1]
    jcache = j_init_cache(p["cfg"], 1, s + 4, jnp.float32)
    jlogits, _ = p["model"].apply(
        p["params"], jnp.asarray(p["pids"]), jnp.asarray(p["pmask"]), jnp.asarray(p["ppos"]),
        jcache, p["feats"], p["jmasks"], method=JCambrianLM.prefill)
    cache = init_kv_cache(p["port"].config, 1, s + 4, torch.float32)
    with torch.no_grad():
        logits, _ = p["port"].lm.prefill(
            torch.from_numpy(p["pids"]), torch.from_numpy(p["pmask"]),
            torch.from_numpy(p["ppos"]), cache, feats,
            [torch.from_numpy(m) for m in p["aux_masks"]])
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_eva_sd_cambrian_greedy_tokens_identical(eva_sd_cambrian):
    from cambrian_tpu.infer.engine import GenerationConfig as JGenConfig
    from cambrian_tpu.infer.engine import GenerationEngine as JEngine
    from cambrian_tpu_torch.infer.engine import GenerationConfig

    p = eva_sd_cambrian
    cfg = p["cfg"]
    jeng = JEngine(p["model"], p["params"], p["towers"],
                   max_len=cfg.tokenizer_model_max_length + 64, cache_dtype=jnp.float32)
    want = jeng.generate(p["pids"], p["pmask"], p["ppos"], p["feats"], p["jmasks"],
                         JGenConfig(max_new_tokens=8, eos_token_id=None))
    got = p["port"].engine.generate(p["pids"], p["pmask"], p["ppos"], _port_feats(p),
                                    p["aux_masks"],
                                    GenerationConfig(max_new_tokens=8, eos_token_id=None))
    assert got.shape == (1, 8)
    np.testing.assert_array_equal(got, np.asarray(want))
