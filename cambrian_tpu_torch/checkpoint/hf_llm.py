"""HF/torch -> Flax converters for the decoder and the Cambrian connector.

Covers the published checkpoint layout (parameter names fixed by
cambrian_arch.py:183-200 and train_fsdp.py:251): ``model.layers.*`` LLaMA
weights, ``model.mm_projector*`` / ``model.vision_sampler_*`` /
``model.vision_sampler_layers`` / ``model.vision_query`` /
``model.image_newline`` connector weights, ``lm_head.weight``.

All converters take a flat {name: numpy array} state dict (from safetensors
or ``.numpy()``-ed torch tensors) and emit the CambrianLM params pytree.
The reverse direction (export_cambrian) writes HF-layout numpy dicts for
save_pretrained-style interchange.
"""

from typing import Dict, Optional

import numpy as np

from ..models.config import CambrianConfig


def _dense(sd, prefix):
    out = {"kernel": sd[f"{prefix}.weight"].T}
    if f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"]
    return out


def _ln(sd, prefix):
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _seq_ln_dense(sd, prefix):
    """torch Sequential(LayerNorm, Linear) -> (ln, dense) flax params."""
    return (
        {"scale": sd[f"{prefix}.0.weight"], "bias": sd[f"{prefix}.0.bias"]},
        {"kernel": sd[f"{prefix}.1.weight"].T},
    )


def convert_llama_decoder(sd: Dict[str, np.ndarray], cfg: CambrianConfig,
                          prefix: str = "model.") -> dict:
    """HF LlamaModel weights -> our decoder params (embed + layers + norm)."""
    params = {
        "embed_tokens": {"embedding": sd[f"{prefix}embed_tokens.weight"]},
        "norm": {"weight": sd[f"{prefix}norm.weight"]},
    }
    for i in range(cfg.num_hidden_layers):
        lp = f"{prefix}layers.{i}."
        params[f"layers_{i}"] = {
            "input_layernorm": {"weight": sd[lp + "input_layernorm.weight"]},
            "self_attn": {
                "q_proj": _dense(sd, lp + "self_attn.q_proj"),
                "k_proj": _dense(sd, lp + "self_attn.k_proj"),
                "v_proj": _dense(sd, lp + "self_attn.v_proj"),
                "o_proj": _dense(sd, lp + "self_attn.o_proj"),
            },
            "post_attention_layernorm": {
                "weight": sd[lp + "post_attention_layernorm.weight"]
            },
            "mlp": {
                "gate_proj": _dense(sd, lp + "mlp.gate_proj"),
                "up_proj": _dense(sd, lp + "mlp.up_proj"),
                "down_proj": _dense(sd, lp + "mlp.down_proj"),
            },
        }
    return params


def convert_phi3_decoder(sd: Dict[str, np.ndarray], cfg: CambrianConfig,
                         prefix: str = "model.") -> dict:
    """HF Phi3Model -> decoder params: split the fused qkv_proj / gate_up_proj
    (the vendored phi3 the reference carries, phi3/modeling_phi3.py)."""
    params = {
        "embed_tokens": {"embedding": sd[f"{prefix}embed_tokens.weight"]},
        "norm": {"weight": sd[f"{prefix}norm.weight"]},
    }
    h, kvh, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    for i in range(cfg.num_hidden_layers):
        lp = f"{prefix}layers.{i}."
        qkv = sd[lp + "self_attn.qkv_proj.weight"]          # [(h+2kvh)*d, H]
        q_w, k_w, v_w = np.split(qkv, [h * d, h * d + kvh * d], axis=0)
        gate_up = sd[lp + "mlp.gate_up_proj.weight"]        # [2I, H]
        gate_w, up_w = np.split(gate_up, 2, axis=0)
        params[f"layers_{i}"] = {
            "input_layernorm": {"weight": sd[lp + "input_layernorm.weight"]},
            "self_attn": {
                "q_proj": {"kernel": q_w.T},
                "k_proj": {"kernel": k_w.T},
                "v_proj": {"kernel": v_w.T},
                "o_proj": _dense(sd, lp + "self_attn.o_proj"),
            },
            "post_attention_layernorm": {
                "weight": sd[lp + "post_attention_layernorm.weight"]
            },
            "mlp": {
                "gate_proj": {"kernel": gate_w.T},
                "up_proj": {"kernel": up_w.T},
                "down_proj": _dense(sd, lp + "mlp.down_proj"),
            },
        }
    return params


def convert_cohere_decoder(sd: Dict[str, np.ndarray], cfg: CambrianConfig,
                           prefix: str = "model.") -> dict:
    """HF CohereModel -> decoder params (parallel-residual layers with a
    single bias-less LayerNorm per layer; tied embeddings)."""
    params = {
        "embed_tokens": {"embedding": sd[f"{prefix}embed_tokens.weight"]},
        "norm": {"weight": sd[f"{prefix}norm.weight"]},
    }
    for i in range(cfg.num_hidden_layers):
        lp = f"{prefix}layers.{i}."
        layer = {
            "input_layernorm": {"weight": sd[lp + "input_layernorm.weight"]},
            "self_attn": {
                "q_proj": _dense(sd, lp + "self_attn.q_proj"),
                "k_proj": _dense(sd, lp + "self_attn.k_proj"),
                "v_proj": _dense(sd, lp + "self_attn.v_proj"),
                "o_proj": _dense(sd, lp + "self_attn.o_proj"),
            },
            "mlp": {
                "gate_proj": _dense(sd, lp + "mlp.gate_proj"),
                "up_proj": _dense(sd, lp + "mlp.up_proj"),
                "down_proj": _dense(sd, lp + "mlp.down_proj"),
            },
        }
        if lp + "self_attn.q_norm.weight" in sd:
            layer["self_attn"]["q_norm"] = {"weight": sd[lp + "self_attn.q_norm.weight"]}
            layer["self_attn"]["k_norm"] = {"weight": sd[lp + "self_attn.k_norm.weight"]}
        params[f"layers_{i}"] = layer
    return params


# mistral and gemma share llama's weight naming; only runtime behavior differs
convert_mistral_decoder = convert_llama_decoder
convert_gemma_decoder = convert_llama_decoder


def convert_decoder(sd: Dict[str, np.ndarray], cfg: CambrianConfig,
                    prefix: str = "model.") -> dict:
    if cfg.model_type == "phi3":
        return convert_phi3_decoder(sd, cfg, prefix)
    if cfg.model_type == "cohere":
        return convert_cohere_decoder(sd, cfg, prefix)
    return convert_llama_decoder(sd, cfg, prefix)


def _convert_sva_layer(sd: Dict[str, np.ndarray], prefix: str, num_towers: int) -> dict:
    """One torch VisionCrossAttentionLayer -> flax params
    (naming map mirrors vision_sampler.py:248-327)."""
    q_ln, q_proj = _seq_ln_dense(sd, prefix + "cross_attn.q_proj")
    cross = {"q_ln": q_ln, "q_proj": q_proj,
             "o_proj": {"kernel": sd[prefix + "cross_attn.o_proj.weight"].T}}
    for i in range(num_towers):
        k_ln, k_proj = _seq_ln_dense(sd, prefix + f"cross_attn.k_proj_{i}")
        v_ln, v_proj = _seq_ln_dense(sd, prefix + f"cross_attn.v_proj_{i}")
        cross[f"k_ln_{i}"] = k_ln
        cross[f"k_proj_{i}"] = k_proj
        cross[f"v_ln_{i}"] = v_ln
        cross[f"v_proj_{i}"] = v_proj
    layer = {
        "proj_context": {"kernel": sd[prefix + "proj_context.weight"].T},
        "proj_in": {"kernel": sd[prefix + "proj_in.weight"].T},
        "proj_out": {
            "linear_1": {"kernel": sd[prefix + "proj_out.linear_1.weight"].T},
            "linear_2": {"kernel": sd[prefix + "proj_out.linear_2.weight"].T},
        },
        "norm": _ln(sd, prefix + "norm"),
        "cross_attn": cross,
    }
    for i in range(num_towers):
        key = prefix + f"pos_embed_{i}"
        if key in sd:
            layer[f"pos_embed_{i}"] = sd[key]
    return layer


def _convert_sampler(sd, prefix: str, depth: int, num_towers: int) -> dict:
    return {
        f"layers_{d}": _convert_sva_layer(sd, f"{prefix}layers.{d}.", num_towers)
        for d in range(depth)
    }


def convert_cambrian(sd: Dict[str, np.ndarray], cfg: CambrianConfig,
                     num_towers: Optional[int] = None) -> dict:
    """Full Cambrian HF checkpoint -> CambrianLM params pytree."""
    num_towers = num_towers or len(cfg.mm_vision_tower_aux_list)
    params = convert_decoder(sd, cfg, prefix="model.")
    if not cfg.tie_word_embeddings and "lm_head.weight" in sd:
        params["lm_head"] = {"kernel": sd["lm_head.weight"].T}

    if cfg.mm_projector_type == "sva":
        params["mm_projector"] = {
            "fc1": _dense(sd, "model.mm_projector.0"),
            "fc2": _dense(sd, "model.mm_projector.2"),
        }
        for i in range(num_towers):
            p = f"model.mm_projector_aux_{i}."
            params[f"mm_projector_aux_{i}"] = {
                "fc1": _dense(sd, p + "0"),
                "fc2": _dense(sd, p + "2"),
                "ln": _ln(sd, p + "3"),
            }
        for g in range(cfg.num_query_group):
            params[f"vision_sampler_{g}"] = _convert_sampler(
                sd, f"model.vision_sampler_{g}.", cfg.connector_depth, num_towers
            )
        if not cfg.connector_only:
            for k in range(cfg.num_of_vision_sampler_layers):
                params[f"vision_sampler_layers_{k}"] = _convert_sampler(
                    sd, f"model.vision_sampler_layers.{k}.", 1, num_towers
                )
        params["vision_query"] = sd["model.vision_query"]
    else:
        # mlp{N}x_gelu-style projector: Sequential indices 0,2,4,...
        proj = {}
        idx = 0
        n = 0
        while f"model.mm_projector.{idx}.weight" in sd:
            proj[f"fc{n}"] = _dense(sd, f"model.mm_projector.{idx}")
            idx += 2
            n += 1
        if not proj and "model.mm_projector.weight" in sd:
            proj = {"proj": _dense(sd, "model.mm_projector")}
        params["mm_projector"] = proj
    params["image_newline"] = sd["model.image_newline"]
    return params


# ---------------------------------------------------------------------------
# export (our params -> HF layout), for save_pretrained-style interchange
# ---------------------------------------------------------------------------

def _export_dense(out, prefix, p):
    out[f"{prefix}.weight"] = np.asarray(p["kernel"]).T
    if "bias" in p:
        out[f"{prefix}.bias"] = np.asarray(p["bias"])


def _export_ln(out, prefix, p):
    out[f"{prefix}.weight"] = np.asarray(p["scale"])
    out[f"{prefix}.bias"] = np.asarray(p["bias"])


def _export_seq_ln_dense(out, prefix, ln, dense):
    out[f"{prefix}.0.weight"] = np.asarray(ln["scale"])
    out[f"{prefix}.0.bias"] = np.asarray(ln["bias"])
    out[f"{prefix}.1.weight"] = np.asarray(dense["kernel"]).T


def _export_sva_layer(out, prefix, layer, num_towers):
    out[f"{prefix}proj_context.weight"] = np.asarray(layer["proj_context"]["kernel"]).T
    out[f"{prefix}proj_in.weight"] = np.asarray(layer["proj_in"]["kernel"]).T
    out[f"{prefix}proj_out.linear_1.weight"] = np.asarray(
        layer["proj_out"]["linear_1"]["kernel"]).T
    out[f"{prefix}proj_out.linear_2.weight"] = np.asarray(
        layer["proj_out"]["linear_2"]["kernel"]).T
    _export_ln(out, f"{prefix}norm", layer["norm"])
    cross = layer["cross_attn"]
    _export_seq_ln_dense(out, f"{prefix}cross_attn.q_proj", cross["q_ln"], cross["q_proj"])
    for i in range(num_towers):
        if f"k_ln_{i}" not in cross:
            break
        _export_seq_ln_dense(out, f"{prefix}cross_attn.k_proj_{i}",
                             cross[f"k_ln_{i}"], cross[f"k_proj_{i}"])
        _export_seq_ln_dense(out, f"{prefix}cross_attn.v_proj_{i}",
                             cross[f"v_ln_{i}"], cross[f"v_proj_{i}"])
    out[f"{prefix}cross_attn.o_proj.weight"] = np.asarray(cross["o_proj"]["kernel"]).T
    for i in range(num_towers):
        if f"pos_embed_{i}" in layer:
            out[f"{prefix}pos_embed_{i}"] = np.asarray(layer[f"pos_embed_{i}"])


def export_cambrian(params: dict, cfg: CambrianConfig) -> Dict[str, np.ndarray]:
    """CambrianLM params -> HF-layout flat state dict (inverse of
    convert_cambrian; round-trip tested)."""
    num_towers = len(cfg.mm_vision_tower_aux_list)
    out: Dict[str, np.ndarray] = {}
    out["model.embed_tokens.weight"] = np.asarray(params["embed_tokens"]["embedding"])
    out["model.norm.weight"] = np.asarray(params["norm"]["weight"])
    for i in range(cfg.num_hidden_layers):
        lp = f"model.layers.{i}."
        layer = params[f"layers_{i}"]
        out[lp + "input_layernorm.weight"] = np.asarray(
            layer["input_layernorm"]["weight"])
        attn, mlp = layer["self_attn"], layer["mlp"]
        if cfg.model_type == "cohere":
            # one shared norm a layer; the qk norms where the config has them,
            # as convert_cohere_decoder reads them
            for name in ("q_norm", "k_norm"):
                if name in attn:
                    out[lp + f"self_attn.{name}.weight"] = np.asarray(attn[name]["weight"])
        else:
            out[lp + "post_attention_layernorm.weight"] = np.asarray(
                layer["post_attention_layernorm"]["weight"])
        if cfg.model_type == "phi3":
            # Phi-3's fused projections, as convert_phi3_decoder splits them
            out[lp + "self_attn.qkv_proj.weight"] = np.concatenate(
                [np.asarray(attn[n]["kernel"]).T for n in ("q_proj", "k_proj", "v_proj")])
            out[lp + "mlp.gate_up_proj.weight"] = np.concatenate(
                [np.asarray(mlp[n]["kernel"]).T for n in ("gate_proj", "up_proj")])
            _export_dense(out, lp + "self_attn.o_proj", attn["o_proj"])
            _export_dense(out, lp + "mlp.down_proj", mlp["down_proj"])
            continue
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _export_dense(out, lp + f"self_attn.{name}", attn[name])
        for name in ("gate_proj", "up_proj", "down_proj"):
            _export_dense(out, lp + f"mlp.{name}", mlp[name])
    if "lm_head" in params:
        out["lm_head.weight"] = np.asarray(params["lm_head"]["kernel"]).T
    if cfg.mm_projector_type == "sva":
        _export_dense(out, "model.mm_projector.0", params["mm_projector"]["fc1"])
        _export_dense(out, "model.mm_projector.2", params["mm_projector"]["fc2"])
        for i in range(num_towers):
            p = params[f"mm_projector_aux_{i}"]
            _export_dense(out, f"model.mm_projector_aux_{i}.0", p["fc1"])
            _export_dense(out, f"model.mm_projector_aux_{i}.2", p["fc2"])
            _export_ln(out, f"model.mm_projector_aux_{i}.3", p["ln"])
        for g in range(cfg.num_query_group):
            sampler = params[f"vision_sampler_{g}"]
            for d in range(cfg.connector_depth):
                _export_sva_layer(out, f"model.vision_sampler_{g}.layers.{d}.",
                                  sampler[f"layers_{d}"], num_towers)
        if not cfg.connector_only:
            for k in range(cfg.num_of_vision_sampler_layers):
                sampler = params[f"vision_sampler_layers_{k}"]
                _export_sva_layer(out, f"model.vision_sampler_layers.{k}.layers.0.",
                                  sampler["layers_0"], num_towers)
        out["model.vision_query"] = np.asarray(params["vision_query"])
    out["model.image_newline"] = np.asarray(params["image_newline"])
    return out
