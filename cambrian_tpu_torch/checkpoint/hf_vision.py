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

The DPT/MiDaS, EVA-02 and Stable Diffusion converters of the JAX module come
with their towers.
"""

from typing import Dict, Optional

import numpy as np

from ..models.encoders.convnext import ConvNeXtConfig
from ..models.encoders.vit import ViTConfig


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
    computed step by step as ``jax.image.resize(..., "bicubic",
    antialias=True)`` computes it (``scale_and_translate``): half-pixel
    sample centres; on a downsample the kernel is widened by in/out; each
    output's weights are divided by their sum, with no clamping at the edges.
    ``F.interpolate(mode="bicubic")`` differs (a = -0.75, no antialiasing,
    clamped edge taps)."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)            # a Python float, as in JAX
    kernel_scale = f32(max(inv_scale, 1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.5)
    dist = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = _keys_cubic(dist)                                          # [in, out]
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).T.astype(f32)


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
