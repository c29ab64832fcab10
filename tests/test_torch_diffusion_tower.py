"""The port's SD-2.1 one-step-denoise tower (``models/encoders/diffusion.py``)
against the JAX package's, on the CPU in fp32.

- Geometry, the DDIM schedule, ``add_noise`` and the timestep embedding as
  JAX's.
- ``tiny_sd`` at 64 px (every self-attention under 128 queries: plain) and
  at 128 px (the first down and last up blocks' self-attention over 256
  queries: the flash-attention branch) vs JAX to 1e-5, given JAX's own noise
  (``jax.random.normal(PRNGKey(noise_seed))``) as ``noise=``; without it the
  port draws from a ``torch.Generator`` seeded the same way, a draw of its
  own.
- ``convert_sd_tower`` on diffusers-named dicts (``vae.encoder.*`` +
  ``unet.*``, and the bare per-component naming) vs JAX's, leaf for leaf,
  and ``load_tower_params`` on an SD-2.1 snapshot under
  ``CAMBRIAN_TOWER_CACHE`` vs the JAX loader's.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cambrian_tpu.checkpoint import hf_vision as jhf
from cambrian_tpu.models import builder as jbuilder
from cambrian_tpu.models.encoders import base as jbase
from cambrian_tpu.models.encoders import diffusion as jdiff
from cambrian_tpu_torch.checkpoint import hf_vision as thf
from cambrian_tpu_torch.checkpoint import safetensors_io
from cambrian_tpu_torch.checkpoint.from_jax import load_jax_params, state_dict_from_jax
from cambrian_tpu_torch.models import builder as tbuilder
from cambrian_tpu_torch.models.encoders import base as tbase
from cambrian_tpu_torch.models.encoders import diffusion as tdiff

TOL = 1e-5   # fp32, same math; convolutions and sums in another order


def _pixels(size, seed=0, batch=2):
    return np.random.default_rng(seed).standard_normal((batch, 3, size, size),
                                                       dtype=np.float32)


def _random_params(module, size, seed):
    """Parameters for the JAX ``module`` at its init's shapes (traced by
    ``jax.eval_shape``: flax's eager init of the UNet takes a minute on the
    CPU), drawn so that the ~40 layers keep the features near unit size:
    kernels N(0, 0.25/fan_in), norm scales 1 + N(0, 0.02^2), everything else
    N(0, 0.02^2). (With kernels N(0, 1/fan_in) the features reach ~10, where
    JAX's jitted and eager results already differ by 1.2e-5.)"""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 3, size, size)))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, x):
        leaf = path[-1].key
        z = rng.standard_normal(x.shape).astype(np.float32)
        if leaf == "kernel":
            return 0.5 * z / np.sqrt(np.prod(x.shape[:-1]))
        return 1 + 0.02 * z if leaf == "scale" else 0.02 * z
    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def _jax_apply(cfg):
    """JAX's tower, jitted once a config (eager flax dispatch compiles op by
    op, ~30 s a run here)."""
    return jax.jit(jdiff.SDFeatureTower(cfg).apply)


def _jax_noise(cfg, batch, seed=None):
    """JAX's default draw, as NCHW numpy (the port's latent layout)."""
    side = cfg.image_size // 8
    key = jax.random.PRNGKey(cfg.noise_seed if seed is None else seed)
    noise = jax.random.normal(key, (batch, side, side, cfg.latent_channels), jnp.float32)
    return np.ascontiguousarray(np.asarray(noise).transpose(0, 3, 1, 2))


def test_sd21_geometry_matches_jax():
    cfg, jcfg = tdiff.SDConfig(), jdiff.SDConfig()
    assert cfg.__dict__ == jcfg.__dict__
    assert (cfg.hidden_size, cfg.grid_side, cfg.num_patches) == (3520, 32, 1024)
    assert tdiff.tiny_sd(128).__dict__ == jdiff.tiny_sd(128).__dict__
    with torch.device("meta"):
        tower = tdiff.SDFeatureTower(cfg, dtype=torch.bfloat16)
    n_params = sum(p.numel() for p in tower.parameters())
    jshapes = jax.eval_shape(lambda: jdiff.SDFeatureTower(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64))))["params"]
    assert n_params == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jshapes))
    assert set(state_dict_from_jax(jax.tree.map(lambda x: np.zeros((1,) * len(x.shape)),
                                                jshapes))) == set(tower.state_dict())


def test_schedule_noise_and_timestep_embedding_match_jax():
    cfg = tdiff.SDConfig()
    np.testing.assert_array_equal(tdiff.ddim_alphas_cumprod(cfg),
                                  jdiff.ddim_alphas_cumprod(jdiff.SDConfig()))
    rng = np.random.default_rng(1)
    x, n = (rng.standard_normal((2, 4, 8, 8), dtype=np.float32) for _ in range(2))
    np.testing.assert_array_equal(tdiff.add_noise(cfg, x, n, 250),
                                  jdiff.add_noise(jdiff.SDConfig(), x, n, 250))
    t = np.array([0, 250, 999])
    want = np.asarray(jdiff.timestep_embedding(jnp.asarray(t), 320))
    got = tdiff.timestep_embedding(torch.from_numpy(t), 320).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


@pytest.mark.parametrize("size", [64, 128])
def test_tiny_sd_matches_jax_given_its_noise(size):
    cfg = jdiff.tiny_sd(size)
    px = _pixels(size, seed=2)
    jmod = jdiff.SDFeatureTower(cfg)
    params = _random_params(jmod, size, seed=3)
    apply = _jax_apply(cfg)
    want = np.asarray(apply({"params": params}, jnp.asarray(px)))
    port = load_jax_params(tdiff.SDFeatureTower(tdiff.tiny_sd(size)), params)
    with torch.no_grad():
        got = port(torch.from_numpy(px), noise=torch.from_numpy(_jax_noise(cfg, 2))).numpy()
    assert got.shape == want.shape == (2, (size // 16) ** 2, cfg.hidden_size)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    # a noise key of JAX's other than the default: the features follow it
    want = np.asarray(apply({"params": params}, jnp.asarray(px),
                            noise_rng=jax.random.PRNGKey(5)))
    with torch.no_grad():
        got = port(torch.from_numpy(px),
                   noise=torch.from_numpy(_jax_noise(cfg, 2, seed=5))).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_tiny_sd_flash_branch_counts(monkeypatch):
    """At 128 px the self-attention of the 16 x 16 blocks (down 0's one
    layer, up 3's two) takes the flash-attention branch; at 64 px none
    does."""
    from cambrian_tpu_torch.models.encoders import diffusion

    calls = []
    real = diffusion.flash_attention

    def spy(q, k, v):
        calls.append(tuple(q.shape))
        return real(q, k, v)

    monkeypatch.setattr(diffusion, "flash_attention", spy)
    for size, want in ((64, []), (128, [(1, 256, 1, 8)] * 3)):
        calls.clear()
        with torch.no_grad():
            tdiff.SDFeatureTower(tdiff.tiny_sd(size))(torch.zeros(1, 3, size, size))
        assert calls == want, size


def test_default_noise_is_a_seeded_torch_draw():
    cfg = tdiff.tiny_sd(64)
    torch.manual_seed(0)
    tower = tdiff.SDFeatureTower(cfg)
    px = torch.from_numpy(_pixels(64, seed=4))
    noise = torch.randn((2, 4, 8, 8), generator=torch.Generator().manual_seed(cfg.noise_seed))
    with torch.no_grad():
        a, b = tower(px), tower(px)
        c = tower(px, noise=noise)
        d = tower(px, noise=torch.from_numpy(_jax_noise(cfg, 2)))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    torch.testing.assert_close(a, c, atol=0, rtol=0)
    assert not torch.allclose(a, d)
    with pytest.raises(ValueError, match="noise must be"):
        tower(px, noise=noise[:1])


# -- the converter and the snapshot ------------------------------------------------

def _diffusers_dict(cfg, seed, bare=False, empty=True):
    """An SD-2.1 state dict in diffusers naming at ``cfg``'s widths: the VAE
    encoder and quant_conv, the UNet, and ``empty_prompt_embeds``; ``bare``
    drops the ``vae.`` / ``unet.`` component prefixes."""
    rng = np.random.default_rng(seed)
    sd = {}

    def r(*shape):      # a checkpoint's scale: activations stay near unit size
        return 0.1 * rng.standard_normal(shape).astype(np.float32)

    def dense(key, dout, din, bias=True):
        sd[key + ".weight"] = r(dout, din)
        if bias:
            sd[key + ".bias"] = r(dout)

    def conv(key, cout, cin, k=3):
        sd[key + ".weight"], sd[key + ".bias"] = r(cout, cin, k, k), r(cout)

    def norm(key, c):
        sd[key + ".weight"], sd[key + ".bias"] = 1 + r(c), r(c)

    def resnet(p, cin, cout, temb=None):
        norm(p + ".norm1", cin)
        conv(p + ".conv1", cout, cin)
        if temb:
            dense(p + ".time_emb_proj", cout, temb)
        norm(p + ".norm2", cout)
        conv(p + ".conv2", cout, cout)
        if cin != cout:
            conv(p + ".conv_shortcut", cout, cin, k=1)

    def transformer(p, c, ctx):
        norm(p + ".norm", c)
        dense(p + ".proj_in", c, c)
        tp = p + ".transformer_blocks.0."
        for nm in ("norm1", "norm2", "norm3"):
            norm(tp + nm, c)
        for a, kdim in (("attn1", c), ("attn2", ctx)):
            dense(f"{tp}{a}.to_q", c, c, bias=False)
            dense(f"{tp}{a}.to_k", c, kdim, bias=False)
            dense(f"{tp}{a}.to_v", c, kdim, bias=False)
            dense(f"{tp}{a}.to_out.0", c, c)
        dense(tp + "ff.net.0.proj", 8 * c, c)
        dense(tp + "ff.net.2", c, 4 * c)
        dense(p + ".proj_out", c, c)

    enc, vae, unet = ("encoder", "", "") if bare else ("vae.encoder", "vae.", "unet.")
    vc = cfg.vae_channels
    conv(f"{enc}.conv_in", vc[0], 3)
    prev = vc[0]
    for i, ch in enumerate(vc):
        for j in range(cfg.vae_layers_per_block):
            resnet(f"{enc}.down_blocks.{i}.resnets.{j}", prev if j == 0 else ch, ch)
        if i != len(vc) - 1:
            conv(f"{enc}.down_blocks.{i}.downsamplers.0.conv", ch, ch)
        prev = ch
    for j in range(2):
        resnet(f"{enc}.mid_block.resnets.{j}", vc[-1], vc[-1])
    ap = f"{enc}.mid_block.attentions.0"
    norm(ap + ".group_norm", vc[-1])
    for nm in ("to_q", "to_k", "to_v", "to_out.0"):
        dense(f"{ap}.{nm}", vc[-1], vc[-1])
    norm(f"{enc}.conv_norm_out", vc[-1])
    conv(f"{enc}.conv_out", 2 * cfg.latent_channels, vc[-1])
    conv(f"{vae}quant_conv", 2 * cfg.latent_channels, 2 * cfg.latent_channels, k=1)

    bc, ted, ctx = cfg.block_out_channels, cfg.time_embed_dim, cfg.cross_attention_dim
    n = len(bc)
    conv(f"{unet}conv_in", bc[0], cfg.latent_channels)
    dense(f"{unet}time_embedding.linear_1", ted, bc[0])
    dense(f"{unet}time_embedding.linear_2", ted, ted)
    skip_ch, prev = [bc[0]], bc[0]
    for i, ch in enumerate(bc):
        for j in range(cfg.layers_per_block):
            resnet(f"{unet}down_blocks.{i}.resnets.{j}", prev if j == 0 else ch, ch, ted)
            if i < n - 1:
                transformer(f"{unet}down_blocks.{i}.attentions.{j}", ch, ctx)
            skip_ch.append(ch)
        if i != n - 1:
            conv(f"{unet}down_blocks.{i}.downsamplers.0.conv", ch, ch)
            skip_ch.append(ch)
        prev = ch
    resnet(f"{unet}mid_block.resnets.0", bc[-1], bc[-1], ted)
    transformer(f"{unet}mid_block.attentions.0", bc[-1], ctx)
    resnet(f"{unet}mid_block.resnets.1", bc[-1], bc[-1], ted)
    prev = bc[-1]
    for i, ch in enumerate(reversed(bc)):
        for j in range(cfg.layers_per_block + 1):
            resnet(f"{unet}up_blocks.{i}.resnets.{j}", prev + skip_ch.pop(), ch, ted)
            prev = ch
            if i > 0:
                transformer(f"{unet}up_blocks.{i}.attentions.{j}", ch, ctx)
        if i != n - 1:
            conv(f"{unet}up_blocks.{i}.upsamplers.0.conv", ch, ch)
    if empty:
        sd["empty_prompt_embeds"] = r(77, ctx)
    return sd


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("naming", ["diffusers", "bare", "no_empty_prompt"])
def test_convert_sd_tower_matches_jax(naming):
    cfg = jdiff.tiny_sd(64)
    sd = _diffusers_dict(cfg, seed=6, bare=naming == "bare", empty=naming != "no_empty_prompt")
    want = jhf.convert_sd_tower(sd, cfg)
    got = thf.convert_sd_tower(sd, tdiff.tiny_sd(64))
    wl, gl = _leaves(want), _leaves(got)
    assert set(gl) == set(wl)
    for k in wl:
        np.testing.assert_array_equal(gl[k], wl[k], err_msg=k)
    port = load_jax_params(tdiff.SDFeatureTower(tdiff.tiny_sd(64)), got)
    px = _pixels(64, seed=7)
    ref = np.asarray(_jax_apply(cfg)(
        {"params": jax.tree.map(jnp.asarray, want)}, jnp.asarray(px)))
    with torch.no_grad():
        out = port(torch.from_numpy(px), noise=torch.from_numpy(_jax_noise(cfg, 2))).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


def test_load_diffusion_snapshot_matches_jax(tmp_path, monkeypatch):
    """``diffusion-tiny`` resolves to SD-2.1's repo; its snapshot under
    ``CAMBRIAN_TOWER_CACHE`` goes to ``convert_sd_tower`` (not CLIP's
    converter) in both loaders, tensor for tensor."""
    name = "diffusion-tiny-interp4"
    jt, tt = jbase.build_vision_tower(name), tbase.build_vision_tower(name)
    assert tt.hf_repo == jt.hf_repo == "stabilityai/stable-diffusion-2-1"
    snap = tmp_path / tt.hf_repo.replace("/", "--")
    snap.mkdir(parents=True)
    safetensors_io.save_file(_diffusers_dict(jt.config, seed=8), str(snap / "model.safetensors"))
    monkeypatch.setenv("CAMBRIAN_TOWER_CACHE", str(tmp_path))
    jparams = jbuilder.load_tower_params(jt)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jparams), prefix="module.")
    got = tbuilder.load_tower_params(tt)
    assert set(got) == set(want) == set(tt.state_dict())
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0, msg=k)
    tt.load_state_dict(got)
    px = _pixels(64, seed=9, batch=1)
    with torch.no_grad():
        out = tt(torch.from_numpy(px), noise=torch.from_numpy(_jax_noise(jt.config, 1)))
    want = _jax_apply(jt.config)({"params": jparams}, jnp.asarray(px))
    np.testing.assert_allclose(out.numpy(), np.asarray(jbase.interpolate_tokens(want, 4)),
                               atol=TOL, rtol=TOL)
    assert out.shape == (1, 4, jt.hidden_size)
