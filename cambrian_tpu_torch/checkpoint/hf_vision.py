"""HF/torch -> flax-named weight converters for the production vision towers
(cambrian_tpu/checkpoint/hf_vision.py).

Input is a flat ``{name: numpy array}`` state dict (``checkpoint/
safetensors_io.py`` or a ``.bin`` shard); output is the JAX package's
parameter tree of the tower, which ``checkpoint/from_jax.py`` maps onto the
port's ``state_dict``. Covered checkpoints (the production 4-tower ensemble):

- openai/clip-vit-large-patch14-336 (CLIPVisionModel)
- google/siglip-so400m-patch14-384 (SiglipVisionModel, or the open_clip /
  timm ViT-SO400M-14-SigLIP-384 trunk with its fused qkv)
- facebook/dinov2-giant (Dinov2Model), with the patch position embeddings
  resampled for a ``-res`` override
- ConvNeXt trunks in HF (ConvNextModel) or timm/open_clip naming

and the encoder-study towers: the MiDaS DPT backbones (Intel/dpt-large,
Intel/dpt-beit-large-512), the EVA-02-CLIP trunk (timm or BAAI naming) and
the SD-2.1 UNet + VAE encoder (diffusers naming). SAM's converter lives with
its tower (``models/encoders/sam.py``).
"""

from typing import Dict, Optional

import numpy as np

from ..models.encoders.convnext import ConvNeXtConfig
from ..models.encoders.vit import ViTConfig
from ..ops.resize import scale_and_translate_matrix


def _conv_kernel(w: np.ndarray) -> np.ndarray:
    """torch conv [out, in, kh, kw] -> flax [kh, kw, in, out]."""
    return np.transpose(w, (2, 3, 1, 0))


def _dense(sd, prefix):
    out = {"kernel": sd[f"{prefix}.weight"].T}
    if f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"]
    return out


def _ln(sd, prefix):
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5 at distances x >= 0, in
    fp32 (``jax.image.resize``'s "bicubic")."""
    f32 = np.float32
    out = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    out = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), out)
    return np.where(x >= 2.0, f32(0.0), out).astype(f32)


def bicubic_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] fp32 matrix of the antialiased bicubic resize along one axis,
    ``jax.image.resize(..., "bicubic", antialias=True)``'s weights.
    ``F.interpolate(mode="bicubic")`` differs (a = -0.75, no antialiasing,
    clamped edge taps)."""
    return scale_and_translate_matrix(in_size, out_size, _keys_cubic)


def interpolate_patch_pos_embed(pos: np.ndarray, old_side: int, new_side: int) -> np.ndarray:
    """Bicubic (antialiased) resample of a square patch position-embedding
    grid [old_side^2, C] -> [new_side^2, C] in fp32, the JAX package's
    ``jax.image.resize`` as two products with per-axis weight matrices (the
    DINOv2 tower at a resolution other than its checkpoint's)."""
    c = pos.shape[-1]
    grid = np.asarray(pos, np.float32).reshape(old_side, old_side, c)
    m = bicubic_resize_matrix(old_side, new_side)
    out = np.einsum("hH,Hwc->hwc", m, grid)
    out = np.einsum("wW,hWc->hwc", m, out)
    return np.ascontiguousarray(out.reshape(new_side * new_side, c), dtype=np.float32)


def convert_clip_vision(sd: Dict[str, np.ndarray], cfg: ViTConfig) -> dict:
    """CLIPVisionModel -> VisionTransformer params (pre_layernorm variant)."""
    p = "vision_model."
    if not any(k.startswith(p) for k in sd):
        p = ""
    params = {
        "patch_embed": {"kernel": _conv_kernel(sd[f"{p}embeddings.patch_embedding.weight"])},
        "cls_token": sd[f"{p}embeddings.class_embedding"].reshape(1, 1, -1),
        "pos_embed": sd[f"{p}embeddings.position_embedding.weight"],
        "pre_layernorm": _ln(sd, f"{p}pre_layrnorm"),
    }
    if f"{p}embeddings.patch_embedding.bias" in sd:
        params["patch_embed"]["bias"] = sd[f"{p}embeddings.patch_embedding.bias"]
    for i in range(cfg.num_blocks_to_run):
        lp = f"{p}encoder.layers.{i}."
        params[f"blocks_{i}"] = {
            "norm1": _ln(sd, lp + "layer_norm1"),
            "attn": {
                "q_proj": _dense(sd, lp + "self_attn.q_proj"),
                "k_proj": _dense(sd, lp + "self_attn.k_proj"),
                "v_proj": _dense(sd, lp + "self_attn.v_proj"),
                "out_proj": _dense(sd, lp + "self_attn.out_proj"),
            },
            "norm2": _ln(sd, lp + "layer_norm2"),
            "mlp": {"fc1": _dense(sd, lp + "mlp.fc1"), "fc2": _dense(sd, lp + "mlp.fc2")},
        }
    if cfg.num_blocks_to_run == cfg.num_layers and cfg.final_layernorm:
        params["final_layernorm"] = _ln(sd, f"{p}post_layernorm")
    return params


def convert_siglip_vision(sd: Dict[str, np.ndarray], cfg: ViTConfig) -> dict:
    """SiglipVisionModel -> VisionTransformer params (no class token)."""
    p = "vision_model."
    if not any(k.startswith(p) for k in sd):
        p = ""
    params = {
        "patch_embed": {
            "kernel": _conv_kernel(sd[f"{p}embeddings.patch_embedding.weight"]),
            "bias": sd[f"{p}embeddings.patch_embedding.bias"],
        },
        "pos_embed": sd[f"{p}embeddings.position_embedding.weight"],
    }
    for i in range(cfg.num_blocks_to_run):
        lp = f"{p}encoder.layers.{i}."
        params[f"blocks_{i}"] = {
            "norm1": _ln(sd, lp + "layer_norm1"),
            "attn": {
                "q_proj": _dense(sd, lp + "self_attn.q_proj"),
                "k_proj": _dense(sd, lp + "self_attn.k_proj"),
                "v_proj": _dense(sd, lp + "self_attn.v_proj"),
                "out_proj": _dense(sd, lp + "self_attn.out_proj"),
            },
            "norm2": _ln(sd, lp + "layer_norm2"),
            "mlp": {"fc1": _dense(sd, lp + "mlp.fc1"), "fc2": _dense(sd, lp + "mlp.fc2")},
        }
    if cfg.num_blocks_to_run == cfg.num_layers and cfg.final_layernorm:
        params["final_layernorm"] = _ln(sd, f"{p}post_layernorm")
    return params


def convert_siglip_timm(sd: Dict[str, np.ndarray], cfg: ViTConfig) -> dict:
    """timm/open_clip SigLIP trunk -> VisionTransformer params.

    The reference loads ViT-SO400M-14-SigLIP-384 through open_clip
    (siglip_encoder.py:52-64); checkpoint keys are timm-style with fused qkv
    ('visual.trunk.blocks.N.attn.qkv.weight'). The attn-pool head is ignored
    (the tower taps trunk tokens)."""
    for prefix in ("visual.trunk.", "trunk.", ""):
        if any(k.startswith(prefix + "patch_embed.") for k in sd):
            break
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    pos = sd["pos_embed"]
    if pos.ndim == 3:
        pos = pos[0]
    params = {
        "patch_embed": {
            "kernel": _conv_kernel(sd["patch_embed.proj.weight"]),
            "bias": sd["patch_embed.proj.bias"],
        },
        "pos_embed": pos,
    }
    c = cfg.hidden_size
    for i in range(cfg.num_blocks_to_run):
        lp = f"blocks.{i}."
        qkv_w = sd[lp + "attn.qkv.weight"]      # [3C, C]
        qkv_b = sd[lp + "attn.qkv.bias"]
        q_w, k_w, v_w = np.split(qkv_w, 3, axis=0)
        q_b, k_b, v_b = np.split(qkv_b, 3, axis=0)
        params[f"blocks_{i}"] = {
            "norm1": _ln(sd, lp + "norm1"),
            "attn": {
                "q_proj": {"kernel": q_w.T, "bias": q_b},
                "k_proj": {"kernel": k_w.T, "bias": k_b},
                "v_proj": {"kernel": v_w.T, "bias": v_b},
                "out_proj": _dense(sd, lp + "attn.proj"),
            },
            "norm2": _ln(sd, lp + "norm2"),
            "mlp": {"fc1": _dense(sd, lp + "mlp.fc1"),
                    "fc2": _dense(sd, lp + "mlp.fc2")},
        }
    if cfg.num_blocks_to_run == cfg.num_layers and cfg.final_layernorm:
        params["final_layernorm"] = _ln(sd, "norm")
    return params


def convert_dinov2(sd: Dict[str, np.ndarray], cfg: ViTConfig,
                   native_image_size: Optional[int] = None) -> dict:
    """Dinov2Model -> VisionTransformer params (LayerScale + optional SwiGLU).

    When cfg.image_size differs from the checkpoint's native resolution, patch
    position embeddings are bicubically resampled (the reference relies on
    HF's runtime interpolation; we bake it in at load time for static shapes).
    """
    pos = sd["embeddings.position_embeddings"][0]  # [1+N, C]
    cls_pos, patch_pos = pos[:1], pos[1:]
    old_side = int(patch_pos.shape[0] ** 0.5)
    new_side = cfg.grid_side
    if old_side != new_side:
        patch_pos = interpolate_patch_pos_embed(patch_pos, old_side, new_side)
    params = {
        "patch_embed": {
            "kernel": _conv_kernel(sd["embeddings.patch_embeddings.projection.weight"]),
            "bias": sd["embeddings.patch_embeddings.projection.bias"],
        },
        "cls_token": sd["embeddings.cls_token"],
        "pos_embed": np.concatenate([cls_pos, patch_pos], axis=0),
    }
    if cfg.num_register_tokens:
        params["register_tokens"] = sd["embeddings.register_tokens"]
    for i in range(cfg.num_blocks_to_run):
        lp = f"encoder.layer.{i}."
        if cfg.swiglu:
            mlp = {
                "weights_in": _dense(sd, lp + "mlp.weights_in"),
                "weights_out": _dense(sd, lp + "mlp.weights_out"),
            }
        else:
            mlp = {"fc1": _dense(sd, lp + "mlp.fc1"), "fc2": _dense(sd, lp + "mlp.fc2")}
        params[f"blocks_{i}"] = {
            "norm1": _ln(sd, lp + "norm1"),
            "attn": {
                "q_proj": _dense(sd, lp + "attention.attention.query"),
                "k_proj": _dense(sd, lp + "attention.attention.key"),
                "v_proj": _dense(sd, lp + "attention.attention.value"),
                "out_proj": _dense(sd, lp + "attention.output.dense"),
            },
            "ls1_gamma": sd[lp + "layer_scale1.lambda1"],
            "norm2": _ln(sd, lp + "norm2"),
            "mlp": mlp,
            "ls2_gamma": sd[lp + "layer_scale2.lambda1"],
        }
    if cfg.num_blocks_to_run == cfg.num_layers and cfg.final_layernorm:
        params["final_layernorm"] = _ln(sd, "layernorm")
    return params


def convert_dpt_vit(sd: Dict[str, np.ndarray], cfg: ViTConfig) -> dict:
    """MiDaS DPT backbones -> VisionTransformer params
    (reference midas_encoder.py:69-83 loads DPTForDepthEstimation and taps
    hidden_states[-1]; the depth head/neck is ignored).

    Accepts Intel/dpt-large naming (``dpt.encoder.layer...``, plain ViT) and
    Intel/dpt-beit-large-512 / BeitModel naming (``backbone.``/``beit.``/bare
    prefix, BEiT layout with per-layer relative position bias, lambda
    LayerScale, fused key without bias)."""
    for prefix in ("dpt.", "backbone.", "beit.", ""):
        if any(k.startswith(prefix + "encoder.layer.") for k in sd):
            break
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    beit = any(".lambda_1" in k for k in sd)

    params = {
        "patch_embed": {
            "kernel": _conv_kernel(sd["embeddings.patch_embeddings.projection.weight"]),
            "bias": sd["embeddings.patch_embeddings.projection.bias"],
        },
        "cls_token": sd["embeddings.cls_token"],
    }
    if cfg.abs_pos_embed:
        pos = sd["embeddings.position_embeddings"]
        if pos.ndim == 3:
            pos = pos[0]
        cls_pos, patch_pos = pos[:1], pos[1:]
        old_side = int(patch_pos.shape[0] ** 0.5)
        if old_side != cfg.grid_side:
            patch_pos = interpolate_patch_pos_embed(patch_pos, old_side,
                                                    cfg.grid_side)
        params["pos_embed"] = np.concatenate([cls_pos, patch_pos], axis=0)
    for i in range(cfg.num_blocks_to_run):
        lp = f"encoder.layer.{i}."
        attn = {
            "q_proj": _dense(sd, lp + "attention.attention.query"),
            "k_proj": _dense(sd, lp + "attention.attention.key"),
            "v_proj": _dense(sd, lp + "attention.attention.value"),
            "out_proj": _dense(sd, lp + "attention.output.dense"),
        }
        if beit:
            attn["rel_pos_table"] = sd[
                lp + "attention.attention.relative_position_bias."
                     "relative_position_bias_table"]
        block = {
            "norm1": _ln(sd, lp + "layernorm_before"),
            "attn": attn,
            "norm2": _ln(sd, lp + "layernorm_after"),
            "mlp": {"fc1": _dense(sd, lp + "intermediate.dense"),
                    "fc2": _dense(sd, lp + "output.dense")},
        }
        if beit:
            block["ls1_gamma"] = sd[lp + "lambda_1"]
            block["ls2_gamma"] = sd[lp + "lambda_2"]
        params[f"blocks_{i}"] = block
    if cfg.num_blocks_to_run == cfg.num_layers and cfg.final_layernorm:
        params["final_layernorm"] = _ln(sd, "layernorm")
    return params


def convert_eva02(sd: Dict[str, np.ndarray], cfg: ViTConfig) -> dict:
    """EVA-02-CLIP trunk -> VisionTransformer params.

    The reference loads timm/eva02_large_patch14_clip_* through open_clip
    (eva_clip_encoder.py:24-38) and taps trunk.forward_features. Accepts
    timm Eva naming (``visual.trunk.blocks.N.attn.{q,k,v}_proj``, SwiGLU as
    ``mlp.fc1_g/fc1_x/mlp.norm/fc2``) and BAAI EVA-02 naming
    (``visual.blocks.N.mlp.w1/w2/ffn_ln/w3``). Rope tables are computed, not
    stored, so they need no conversion."""
    for prefix in ("visual.trunk.", "trunk.", "visual.", ""):
        if any(k.startswith(prefix + "blocks.") for k in sd):
            break
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    pos = sd["pos_embed"]
    if pos.ndim == 3:
        pos = pos[0]
    cls_pos, patch_pos = pos[:1], pos[1:]
    old_side = int(patch_pos.shape[0] ** 0.5)
    if old_side != cfg.grid_side:
        patch_pos = interpolate_patch_pos_embed(patch_pos, old_side,
                                                cfg.grid_side)
    params = {
        "patch_embed": {
            "kernel": _conv_kernel(sd["patch_embed.proj.weight"]),
            "bias": sd["patch_embed.proj.bias"],
        },
        "cls_token": sd["cls_token"].reshape(1, 1, -1),
        "pos_embed": np.concatenate([cls_pos, patch_pos], axis=0),
    }
    for i in range(cfg.num_blocks_to_run):
        lp = f"blocks.{i}."
        if lp + "mlp.w1.weight" in sd:   # BAAI naming
            mlp = {"w1": _dense(sd, lp + "mlp.w1"),
                   "w2": _dense(sd, lp + "mlp.w2"),
                   "ffn_ln": _ln(sd, lp + "mlp.ffn_ln"),
                   "w3": _dense(sd, lp + "mlp.w3")}
        else:                            # timm naming
            mlp = {"w1": _dense(sd, lp + "mlp.fc1_g"),
                   "w2": _dense(sd, lp + "mlp.fc1_x"),
                   "ffn_ln": _ln(sd, lp + "mlp.norm"),
                   "w3": _dense(sd, lp + "mlp.fc2")}
        params[f"blocks_{i}"] = {
            "norm1": _ln(sd, lp + "norm1"),
            "attn": {
                "q_proj": _dense(sd, lp + "attn.q_proj"),
                "k_proj": {"kernel": sd[lp + "attn.k_proj.weight"].T},
                "v_proj": _dense(sd, lp + "attn.v_proj"),
                "out_proj": _dense(sd, lp + "attn.proj"),
            },
            "norm2": _ln(sd, lp + "norm2"),
            "mlp": mlp,
        }
    if cfg.num_blocks_to_run == cfg.num_layers and cfg.final_layernorm:
        params["final_layernorm"] = _ln(sd, "norm")
    return params


def _gn(sd, prefix):
    return {"gn": {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}}


def _conv(sd, prefix):
    out = {"kernel": _conv_kernel(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"]
    return out


def _sd_resnet(sd, prefix, has_temb=True):
    block = {
        "norm1": _gn(sd, prefix + ".norm1"),
        "conv1": _conv(sd, prefix + ".conv1"),
        "norm2": _gn(sd, prefix + ".norm2"),
        "conv2": _conv(sd, prefix + ".conv2"),
    }
    if has_temb and prefix + ".time_emb_proj.weight" in sd:
        block["time_emb_proj"] = _dense(sd, prefix + ".time_emb_proj")
    if prefix + ".conv_shortcut.weight" in sd:
        block["conv_shortcut"] = _conv(sd, prefix + ".conv_shortcut")
    return block


def _sd_transformer(sd, prefix):
    tp = prefix + ".transformer_blocks.0."
    block = {
        "norm1": _ln(sd, tp + "norm1"),
        "norm2": _ln(sd, tp + "norm2"),
        "norm3": _ln(sd, tp + "norm3"),
        "ff_geglu": _dense(sd, tp + "ff.net.0.proj"),
        "ff_out": _dense(sd, tp + "ff.net.2"),
    }
    for a in ("attn1", "attn2"):
        for proj in ("to_q", "to_k", "to_v"):
            block[f"{a}_{proj}"] = _dense(sd, f"{tp}{a}.{proj}")
        block[f"{a}_to_out"] = _dense(sd, f"{tp}{a}.to_out.0")
    return {
        "norm": _gn(sd, prefix + ".norm"),
        "proj_in": _dense(sd, prefix + ".proj_in"),
        "block_0": block,
        "proj_out": _dense(sd, prefix + ".proj_out"),
    }


def convert_sd_tower(sd: Dict[str, np.ndarray], cfg) -> dict:
    """stabilityai/stable-diffusion-2-1 (diffusers naming: ``unet.*`` +
    ``vae.*``, or bare per-component dicts) -> SDFeatureTower params
    (reference diffusion_encoder.py:166-216 loads the UNet + VAE + DDIM
    scheduler; the VAE decoder, text encoder and safety checker are unused).

    ``empty_prompt_embeds`` ([77, cross_attention_dim], the cached empty-
    string encoding, diffusion_encoder.py:237-243) may be supplied as a key
    of the same name; it defaults to zeros otherwise.
    """
    n_blocks = len(cfg.block_out_channels)

    vae = {k[len("vae.encoder."):]: v for k, v in sd.items()
           if k.startswith("vae.encoder.")}
    if not vae:
        vae = {k[len("encoder."):]: v for k, v in sd.items()
               if k.startswith("encoder.")}
    quant_key = "vae.quant_conv" if "vae.quant_conv.weight" in sd else "quant_conv"
    vp = {
        "conv_in": _conv(vae, "conv_in"),
        "conv_norm_out": _gn(vae, "conv_norm_out"),
        "conv_out": _conv(vae, "conv_out"),
        "quant_conv": _conv(sd, quant_key),
        "mid_resnet_0": _sd_resnet(vae, "mid_block.resnets.0", False),
        "mid_resnet_1": _sd_resnet(vae, "mid_block.resnets.1", False),
        "mid_attn": {
            "group_norm": _gn(vae, "mid_block.attentions.0.group_norm"),
            "to_q": _dense(vae, "mid_block.attentions.0.to_q"),
            "to_k": _dense(vae, "mid_block.attentions.0.to_k"),
            "to_v": _dense(vae, "mid_block.attentions.0.to_v"),
            "to_out": _dense(vae, "mid_block.attentions.0.to_out.0"),
        },
    }
    for i in range(len(cfg.vae_channels)):
        for j in range(cfg.vae_layers_per_block):
            vp[f"down_{i}_resnet_{j}"] = _sd_resnet(
                vae, f"down_blocks.{i}.resnets.{j}", False)
        if i != len(cfg.vae_channels) - 1:
            vp[f"down_{i}_downsample"] = _conv(
                vae, f"down_blocks.{i}.downsamplers.0.conv")

    unet = {k[len("unet."):]: v for k, v in sd.items() if k.startswith("unet.")}
    if not unet:
        unet = sd
    up = {
        "conv_in": _conv(unet, "conv_in"),
        "time_linear_1": _dense(unet, "time_embedding.linear_1"),
        "time_linear_2": _dense(unet, "time_embedding.linear_2"),
        "mid_resnet_0": _sd_resnet(unet, "mid_block.resnets.0"),
        "mid_resnet_1": _sd_resnet(unet, "mid_block.resnets.1"),
        "mid_attn": _sd_transformer(unet, "mid_block.attentions.0"),
    }
    for i in range(n_blocks):
        for j in range(cfg.layers_per_block):
            up[f"down_{i}_resnet_{j}"] = _sd_resnet(
                unet, f"down_blocks.{i}.resnets.{j}")
            if i < n_blocks - 1:
                up[f"down_{i}_attn_{j}"] = _sd_transformer(
                    unet, f"down_blocks.{i}.attentions.{j}")
        if i != n_blocks - 1:
            up[f"down_{i}_downsample"] = _conv(
                unet, f"down_blocks.{i}.downsamplers.0.conv")
    for i in range(n_blocks):
        for j in range(cfg.layers_per_block + 1):
            up[f"up_{i}_resnet_{j}"] = _sd_resnet(
                unet, f"up_blocks.{i}.resnets.{j}")
            if i > 0:
                up[f"up_{i}_attn_{j}"] = _sd_transformer(
                    unet, f"up_blocks.{i}.attentions.{j}")
        if i != n_blocks - 1:
            up[f"up_{i}_upsample"] = _conv(
                unet, f"up_blocks.{i}.upsamplers.0.conv")

    empty = sd.get("empty_prompt_embeds")
    if empty is None:
        empty = np.zeros((77, cfg.cross_attention_dim), np.float32)
    return {"vae": vp, "unet": up, "empty_prompt_embeds": empty}


def convert_convnext(sd: Dict[str, np.ndarray], cfg: ConvNeXtConfig) -> dict:
    """ConvNext trunk -> ConvNeXtTokens params ('trunk' subtree).

    Accepts HF ConvNextModel naming (embeddings/encoder.stages...) or
    timm/open_clip naming (stem/stages...).
    """
    for prefix in ("visual.trunk.", "trunk.", "convnext."):
        if any(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items()
                  if k.startswith(prefix)}
            break
    hf = any(k.startswith("embeddings.") for k in sd)

    trunk = {}
    if hf:
        trunk["stem_conv"] = {
            "kernel": _conv_kernel(sd["embeddings.patch_embeddings.weight"]),
            "bias": sd["embeddings.patch_embeddings.bias"],
        }
        trunk["stem_norm"] = _ln(sd, "embeddings.layernorm")
        for s, (depth, dim) in enumerate(zip(cfg.depths, cfg.dims)):
            sp = f"encoder.stages.{s}."
            if s > 0:
                trunk[f"downsample_norm_{s}"] = _ln(sd, sp + "downsampling_layer.0")
                trunk[f"downsample_conv_{s}"] = {
                    "kernel": _conv_kernel(sd[sp + "downsampling_layer.1.weight"]),
                    "bias": sd[sp + "downsampling_layer.1.bias"],
                }
            for b in range(depth):
                bp = sp + f"layers.{b}."
                trunk[f"stage_{s}_block_{b}"] = {
                    "dwconv": {
                        "kernel": _conv_kernel(sd[bp + "dwconv.weight"]),
                        "bias": sd[bp + "dwconv.bias"],
                    },
                    "norm": _ln(sd, bp + "layernorm"),
                    "pwconv1": _dense(sd, bp + "pwconv1"),
                    "pwconv2": _dense(sd, bp + "pwconv2"),
                    "gamma": sd[bp + "layer_scale_parameter"],
                }
    else:  # timm naming (open_clip trunk)
        trunk["stem_conv"] = {
            "kernel": _conv_kernel(sd["stem.0.weight"]),
            "bias": sd["stem.0.bias"],
        }
        trunk["stem_norm"] = _ln(sd, "stem.1")
        for s, (depth, dim) in enumerate(zip(cfg.depths, cfg.dims)):
            sp = f"stages.{s}."
            if s > 0:
                trunk[f"downsample_norm_{s}"] = _ln(sd, sp + "downsample.0")
                trunk[f"downsample_conv_{s}"] = {
                    "kernel": _conv_kernel(sd[sp + "downsample.1.weight"]),
                    "bias": sd[sp + "downsample.1.bias"],
                }
            for b in range(depth):
                bp = sp + f"blocks.{b}."
                trunk[f"stage_{s}_block_{b}"] = {
                    "dwconv": {
                        "kernel": _conv_kernel(sd[bp + "conv_dw.weight"]),
                        "bias": sd[bp + "conv_dw.bias"],
                    },
                    "norm": _ln(sd, bp + "norm"),
                    "pwconv1": _dense(sd, bp + "mlp.fc1"),
                    "pwconv2": _dense(sd, bp + "mlp.fc2"),
                    "gamma": sd[bp + "gamma"],
                }
    return {"trunk": trunk}
