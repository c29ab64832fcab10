"""Tower snapshot loading of the port (``checkpoint/hf_vision.py``,
``models/builder.py``) against the JAX package's, on the CPU in fp32.

- Each converter on the same HF-layout dict (tiny towers made with
  ``transformers``, every tensor perturbed so that no mapping hides behind
  an init constant) gives the JAX converter's tree, leaf for leaf exactly,
  except a resampled DINOv2 position embedding (1e-5: the same weights, sums
  in another order); through ``checkpoint/from_jax.py`` the port's tower
  then gives the JAX tower's output to 1e-5 (fp32, same math).
- ``interpolate_patch_pos_embed`` (bicubic, antialiased) against
  ``jax.image.resize`` for 37 -> 27 (DINOv2-giant at 378) and 16 -> 24, to
  1e-5.
- ``load_pretrained_model`` on a tiny checkpoint whose towers resolve to
  snapshots under ``CAMBRIAN_TOWER_CACHE`` (the fixture pattern of
  ``tests/test_tower_snapshot_loading.py``) against the JAX loader: the
  same tower parameters (exactly), the same greedy tokens, and no "RANDOM
  weights" warning; the warning where a snapshot is missing.
"""

import os
import sys
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))
from util import make_tiny_tokenizer  # noqa: E402

from cambrian_tpu.checkpoint import hf_vision as jhf  # noqa: E402
from cambrian_tpu.constants import IMAGE_TOKEN_INDEX  # noqa: E402
from cambrian_tpu.mm_utils import ImageProcessor as JImageProcessor  # noqa: E402
from cambrian_tpu.models import builder as jbuilder  # noqa: E402
from cambrian_tpu.models.encoders import base as jbase  # noqa: E402
from cambrian_tpu.models.encoders import convnext as jconvnext  # noqa: E402
from cambrian_tpu.models.encoders import vit as jvit  # noqa: E402
from cambrian_tpu_torch.checkpoint import hf_vision as thf  # noqa: E402
from cambrian_tpu_torch.checkpoint import safetensors_io  # noqa: E402
from cambrian_tpu_torch.checkpoint.from_jax import load_jax_params, state_dict_from_jax  # noqa: E402
from cambrian_tpu_torch.mm_utils import ImageProcessor  # noqa: E402
from cambrian_tpu_torch.models import builder as tbuilder  # noqa: E402
from cambrian_tpu_torch.models.encoders import base as tbase  # noqa: E402
from cambrian_tpu_torch.models.encoders import convnext as tconvnext  # noqa: E402
from cambrian_tpu_torch.models.encoders import vit as tvit  # noqa: E402

transformers = pytest.importorskip("transformers")

TOL = 1e-5

VIT = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64, patch_size=14)
CLIP = dict(VIT, image_size=28, class_token=True, pre_layernorm=True, final_layernorm=False,
            act="quick_gelu", patch_bias=False, select_layer=-2)
SIGLIP = dict(VIT, image_size=28, class_token=False, final_layernorm=True, act="gelu_tanh",
              select_layer=0, ln_eps=1e-6)
DINOV2 = dict(VIT, intermediate_size=88, class_token=True, final_layernorm=True, act="gelu",
              swiglu=True, layer_scale=True, select_layer=0, ln_eps=1e-6)


def _perturbed(model, seed):
    """An HF model's state dict as numpy, every tensor moved by noise."""
    rng = np.random.default_rng(seed)
    return {k: v.detach().numpy() + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
            for k, v in model.state_dict().items()}


def _hf_clip(seed=0, layers=2):
    return _perturbed(transformers.CLIPVisionModel(transformers.CLIPVisionConfig(
        hidden_size=32, num_hidden_layers=layers, num_attention_heads=4, intermediate_size=64,
        image_size=28, patch_size=14, hidden_act="quick_gelu")), seed)


def _hf_siglip(seed=0):
    return _perturbed(transformers.SiglipVisionModel(transformers.SiglipVisionConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        image_size=28, patch_size=14)), seed)


def _timm_siglip(seed=0):
    """The SigLIP dict in open_clip's timm naming (fused qkv, a batched
    pos_embed), as ViT-SO400M-14-SigLIP-384 stores it."""
    hf = _hf_siglip(seed)
    p, out = "vision_model.", {}
    out["visual.trunk.patch_embed.proj.weight"] = hf[p + "embeddings.patch_embedding.weight"]
    out["visual.trunk.patch_embed.proj.bias"] = hf[p + "embeddings.patch_embedding.bias"]
    out["visual.trunk.pos_embed"] = hf[p + "embeddings.position_embedding.weight"][None]
    for i in range(2):
        lp, tp = f"{p}encoder.layers.{i}.", f"visual.trunk.blocks.{i}."
        for leaf in ("weight", "bias"):
            out[tp + f"attn.qkv.{leaf}"] = np.concatenate(
                [hf[lp + f"self_attn.{n}_proj.{leaf}"] for n in "qkv"])
            out[tp + f"attn.proj.{leaf}"] = hf[lp + f"self_attn.out_proj.{leaf}"]
            out[tp + f"norm1.{leaf}"] = hf[lp + f"layer_norm1.{leaf}"]
            out[tp + f"norm2.{leaf}"] = hf[lp + f"layer_norm2.{leaf}"]
            out[tp + f"mlp.fc1.{leaf}"] = hf[lp + f"mlp.fc1.{leaf}"]
            out[tp + f"mlp.fc2.{leaf}"] = hf[lp + f"mlp.fc2.{leaf}"]
            out[f"visual.trunk.norm.{leaf}"] = hf[p + f"post_layernorm.{leaf}"]
    out["visual.trunk.attn_pool.latent"] = np.zeros((1, 1, 32), np.float32)  # ignored
    return out


def _hf_dinov2(seed=0, native=42):
    return _perturbed(transformers.Dinov2Model(transformers.Dinov2Config(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, mlp_ratio=4,
        image_size=native, patch_size=14, use_swiglu_ffn=True)), seed)


def _hf_convnext(seed=0):
    return _perturbed(transformers.ConvNextModel(transformers.ConvNextConfig(
        depths=[1, 1, 2, 1], hidden_sizes=[16, 32, 64, 128])), seed)


def _timm_convnext(seed=0):
    """The ConvNeXt dict in open_clip's timm naming under ``visual.trunk.``."""
    renames = [("embeddings.patch_embeddings.", "stem.0."), ("embeddings.layernorm.", "stem.1."),
               ("encoder.stages.", "stages."), ("downsampling_layer.", "downsample."),
               (".layers.", ".blocks."), ("dwconv.", "conv_dw."), ("layernorm.", "norm."),
               ("pwconv1.", "mlp.fc1."), ("pwconv2.", "mlp.fc2."),
               ("layer_scale_parameter", "gamma")]
    out = {}
    for k, v in _hf_convnext(seed).items():
        for a, b in renames:
            k = k.replace(a, b)
        out["visual.trunk." + k] = v
    return out


# name: (HF dict, converter, tower kwargs or ConvNeXt, image size)
CASES = {
    "clip": (_hf_clip, "convert_clip_vision", CLIP, 28),
    "clip_full_depth": (_hf_clip, "convert_clip_vision",
                        dict(CLIP, select_layer=0, final_layernorm=True), 28),
    "siglip": (_hf_siglip, "convert_siglip_vision", SIGLIP, 28),
    "siglip_timm": (_timm_siglip, "convert_siglip_timm", SIGLIP, 28),
    "dinov2_native": (_hf_dinov2, "convert_dinov2", dict(DINOV2, image_size=42), 42),
    "dinov2_down": (_hf_dinov2, "convert_dinov2", dict(DINOV2, image_size=28), 28),
    "dinov2_up": (_hf_dinov2, "convert_dinov2", dict(DINOV2, image_size=56), 56),
    "convnext_hf": (_hf_convnext, "convert_convnext", None, 64),
    "convnext_timm": (_timm_convnext, "convert_convnext", None, 64),
}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_converter_matches_jax(name):
    make_sd, conv, kw, size = CASES[name]
    sd = make_sd()
    if kw is None:
        jcfg, tcfg = jconvnext.tiny_convnext(size), tconvnext.tiny_convnext(size)
        jmod = jconvnext.ConvNeXtTokens(jcfg, interp_side=4)
        tmod = tconvnext.ConvNeXtTokens(tcfg, interp_side=4)
    else:
        jcfg, tcfg = jvit.ViTConfig(**kw), tvit.ViTConfig(**kw)
        jmod, tmod = jvit.VisionTransformer(jcfg), tvit.VisionTransformer(tcfg)
    want = getattr(jhf, conv)(sd, jcfg)
    got = getattr(thf, conv)(sd, tcfg)
    wl, gl = _leaves(want), _leaves(got)
    assert set(gl) == set(wl)
    resampled = name in ("dinov2_down", "dinov2_up")
    for k in wl:
        assert gl[k].shape == wl[k].shape, k
        if resampled and k == "pos_embed":
            np.testing.assert_allclose(gl[k], wl[k], atol=TOL, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(gl[k], wl[k], err_msg=k)

    px = np.random.default_rng(7).standard_normal((2, 3, size, size), dtype=np.float32)
    ref = np.asarray(jmod.apply({"params": jax.tree.map(jnp.asarray, want)}, jnp.asarray(px)))
    load_jax_params(tmod, got)
    with torch.no_grad():
        out = tmod(torch.from_numpy(px)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("old,new", [(37, 27), (16, 24)])
def test_interpolate_patch_pos_embed_matches_jax(old, new):
    """DINOv2-giant's 37 x 37 grid (518 px) resampled to 27 x 27 (378 px),
    and an upsample; the weight matrices are jax.image.resize's own."""
    from jax._src.image.scale import _fill_keys_cubic_kernel, compute_weight_mat

    pos = np.random.default_rng(old).standard_normal((old * old, 48), dtype=np.float32)
    want = jhf.interpolate_patch_pos_embed(pos, old, new)
    got = thf.interpolate_patch_pos_embed(pos, old, new)
    assert got.shape == want.shape == (new * new, 48) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    ref_w = np.asarray(compute_weight_mat(old, new, new / old, 0.0, _fill_keys_cubic_kernel,
                                          True)).T
    np.testing.assert_array_equal(thf.bicubic_resize_matrix(old, new), ref_w)


# -- load_pretrained_model on a tower cache -------------------------------------

TOWERS = {"tinysnap-clip": ("fake-org/tiny-clip", CLIP, _hf_clip),
          "tinysnap-dinov2": ("fake-org/tiny-dinov2", dict(DINOV2, image_size=28), _hf_dinov2)}


def _jax_builder(key):
    repo, kw, _ = TOWERS[key]

    def build(name, res, interp, dtype):
        cfg = jvit.ViTConfig(**kw)
        return jbase.VisionTower(name=name, module=jvit.VisionTransformer(cfg), config=cfg,
                                 hidden_size=cfg.hidden_size, image_size=cfg.image_size,
                                 interp_size=interp,
                                 image_processor=JImageProcessor(size=cfg.image_size),
                                 hf_repo=repo)
    return build


def _port_builder(key):
    repo, kw, _ = TOWERS[key]

    def build(name, res, interp, dtype, device):
        cfg = tvit.ViTConfig(**kw)
        return tbase.VisionTower(name=name, module=tvit.VisionTransformer(cfg, dtype, device),
                                 config=cfg, hidden_size=cfg.hidden_size,
                                 image_size=cfg.image_size, interp_size=interp,
                                 image_processor=ImageProcessor(size=cfg.image_size),
                                 hf_repo=repo)
    return build


@pytest.fixture()
def tower_cache(tmp_path, monkeypatch):
    """Snapshots of the two tiny towers under CAMBRIAN_TOWER_CACHE (CLIP as
    ``org--name``, DINOv2 at its 3 x 3 native grid as ``org/name``), both
    towers registered in both packages, and a tiny checkpoint naming them."""
    from cambrian_tpu.checkpoint.save import save_pretrained
    from cambrian_tpu.models.cambrian import CambrianLM
    from cambrian_tpu.models.config import tiny_debug

    cache = tmp_path / "towers"
    for i, (key, (repo, _, make)) in enumerate(TOWERS.items()):
        snap = cache / (repo.replace("/", "--") if i == 0 else repo)
        snap.mkdir(parents=True)
        safetensors_io.save_file(make(seed=i + 3), str(snap / "model.safetensors"))
        monkeypatch.setitem(jbase._REGISTRY, key, _jax_builder(key))
        monkeypatch.setitem(tbase._REGISTRY, key, _port_builder(key))
    monkeypatch.setenv("CAMBRIAN_TOWER_CACHE", str(cache))

    cfg = tiny_debug(num_towers=2).replace(mm_vision_tower_aux_list=tuple(TOWERS))
    towers = jbase.build_vision_tower_aux_list(cfg.mm_vision_tower_aux_list,
                                               cfg.mm_vision_tower_aux_token_len_list)
    model = CambrianLM(cfg, tuple(t.hidden_size for t in towers))
    rng = np.random.default_rng(0)
    ids = np.zeros((1, cfg.tokenizer_model_max_length), np.int32)
    feats = [jnp.asarray(rng.standard_normal((1, t.interp_size, t.hidden_size), np.float32))
             for t in towers]
    masks = [jnp.ones((1, cfg.image_token_len, w * w), bool) for w in cfg.cross_att_window_sizes()]
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.ones(ids.shape, bool),
                        jnp.arange(ids.shape[1])[None], feats, masks)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)
    path = str(tmp_path / "ckpt")
    save_pretrained(params, cfg, path)
    make_tiny_tokenizer(path)
    return path, cfg


def test_load_pretrained_model_reads_tower_snapshots(tower_cache):
    path, cfg = tower_cache
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tok, jmodel, _, _ = jbuilder.load_pretrained_model(path, dtype=jnp.float32)
        _, model, procs, ctx = tbuilder.load_pretrained_model(path, device="cpu",
                                                              dtype=torch.float32)
    assert not [w for w in caught if "RANDOM" in str(w.message)]
    assert ctx == cfg.tokenizer_model_max_length and len(procs) == 2
    for t, tp in zip(model.towers, jmodel.tower_params):
        want = state_dict_from_jax(jax.tree.map(np.asarray, tp), prefix="module.")
        got = t.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            if k == "module.pos_embed" and "dinov2" in t.name:   # resampled 3 x 3 -> 2 x 2
                torch.testing.assert_close(got[k], v, atol=TOL, rtol=0, msg=k)
            else:
                torch.testing.assert_close(got[k], v, atol=0, rtol=0, msg=k)

    rng = np.random.default_rng(1)
    ids = rng.integers(5, cfg.vocab_size, 30).astype(np.int64)
    ids[5] = IMAGE_TOKEN_INDEX
    images = [rng.standard_normal((1, 3, t.image_size, t.image_size), np.float32)
              for t in model.towers]
    kw = dict(image_sizes=[(40, 30)], max_new_tokens=6, eos_token_id=None)
    want = np.asarray(jmodel.generate(ids, images=[jnp.asarray(x) for x in images], **kw))
    got = model.generate(ids, images=images, **kw)
    np.testing.assert_array_equal(got, want)


def test_snapshot_resolution_matches_jax(tower_cache, tmp_path, monkeypatch):
    """CAMBRIAN_TOWER_CACHE in both namings, then the newest HF hub snapshot."""
    for key in TOWERS:
        jt, tt = jbase.build_vision_tower(key), tbase.build_vision_tower(key)
        assert tbuilder._tower_snapshot_dir(tt) == jbuilder._tower_snapshot_dir(jt) is not None
    monkeypatch.delenv("CAMBRIAN_TOWER_CACHE")
    hub = tmp_path / "hf" / "hub" / "models--fake-org--tiny-clip" / "snapshots"
    for rev in ("aaa", "bbb"):
        (hub / rev).mkdir(parents=True)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    jt, tt = jbase.build_vision_tower("tinysnap-clip"), tbase.build_vision_tower("tinysnap-clip")
    assert tbuilder._tower_snapshot_dir(tt) == jbuilder._tower_snapshot_dir(jt) == str(hub / "bbb")


def test_siglip_timm_snapshot_dispatch(tmp_path, monkeypatch):
    """A SigLIP snapshot with fused ``.attn.qkv.`` keys goes to the timm
    converter, as in the JAX loader."""
    repo = "fake-org/tiny-siglip"
    snap = tmp_path / repo.replace("/", "--")
    snap.mkdir(parents=True)
    safetensors_io.save_file(_timm_siglip(seed=5), str(snap / "model.safetensors"))
    monkeypatch.setenv("CAMBRIAN_TOWER_CACHE", str(tmp_path))
    jcfg, tcfg = jvit.ViTConfig(**SIGLIP), tvit.ViTConfig(**SIGLIP)
    jt = jbase.VisionTower(name="tiny-siglip", module=jvit.VisionTransformer(jcfg), config=jcfg,
                           hidden_size=32, image_size=28, interp_size=None,
                           image_processor=JImageProcessor(size=28), hf_repo=repo)
    tt = tbase.VisionTower(name="tiny-siglip", module=tvit.VisionTransformer(tcfg), config=tcfg,
                           hidden_size=32, image_size=28, interp_size=None,
                           image_processor=ImageProcessor(size=28), hf_repo=repo)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jbuilder.load_tower_params(jt)),
                               prefix="module.")
    got = tbuilder.load_tower_params(tt)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0, msg=k)


def test_missing_snapshot_warns_and_uses_random_weights(tower_cache, monkeypatch, tmp_path):
    path, cfg = tower_cache
    monkeypatch.setenv("CAMBRIAN_TOWER_CACHE", str(tmp_path / "empty"))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "no-hf"))
    tt = tbase.build_vision_tower("tinysnap-clip")
    with pytest.warns(UserWarning, match="RANDOM weights"):
        sd = tbuilder.load_tower_params(tt, torch.Generator().manual_seed(0))
    assert set(sd) == set(tt.state_dict())
    with pytest.warns(UserWarning, match="No local snapshot for tower tinysnap-dinov2"):
        _, model, _, _ = tbuilder.load_pretrained_model(path, device="cpu", dtype=torch.float32)
    # seeded per tower: two loads give the same towers
    with pytest.warns(UserWarning, match="RANDOM weights"):
        _, again, _, _ = tbuilder.load_pretrained_model(path, device="cpu", dtype=torch.float32)
    for a, b in zip(model.towers, again.towers):
        for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(v, w), k
