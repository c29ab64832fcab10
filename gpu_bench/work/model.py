"""Model FLOPs of Cambrian-1's work, counted from shapes: the products the
work needs, 2 per multiply-add, with no recomputation. Training counts the
backward only where a gradient is needed: the trainable connector's weights
and inputs (x3 its forward), the frozen decoder's inputs alone (x2), the
frozen towers not at all (x1)."""

from typing import Sequence


def _vit(t: dict, images: int) -> float:
    n = (t["image_size"] // t["patch"]) ** 2 + (1 if t["class_token"] else 0)
    c, f = t["hidden"], t["mlp"]
    mlp = 6 * n * c * f if t["swiglu"] else 4 * n * c * f
    block = 8 * n * c * c + 4 * n * n * c + mlp
    patch = 2 * (n - (1 if t["class_token"] else 0)) * c * 3 * t["patch"] ** 2
    return images * (patch + t["blocks_run"] * block)


def _convnext(t: dict, images: int) -> float:
    r = t["image_size"] // 4
    dims = t["dims"]
    total = 2 * r * r * dims[0] * 3 * 16
    for s, (depth, c) in enumerate(zip(t["depths"], dims)):
        if s > 0:
            r //= 2
            total += 2 * r * r * c * dims[s - 1] * 4
        total += depth * 2 * r * r * c * (49 + 8 * c)
    return images * total


def towers(cfg: dict, images: int = 1) -> float:
    """The four towers' forward over ``images`` images."""
    return sum(_convnext(t, images) if t["kind"] == "convnext" else _vit(t, images)
               for t in cfg["towers"])


def _windows(cfg: dict) -> Sequence[int]:
    q_side = int(round(cfg["model"]["image_token_len"] ** 0.5))
    return [(int(round(t["tokens"] ** 0.5)) // q_side) ** 2 for t in cfg["towers"]]


def sva_layer(q_dim: int, ctx_dim: int, hid: int, queries: int, windows: Sequence[int]) -> float:
    w = sum(windows)
    return 2 * queries * (ctx_dim * hid + (q_dim + hid) * hid + 2 * hid * hid
                          + hid * q_dim + hid * hid) \
        + 4 * queries * w * hid * hid + 4 * queries * w * hid


def connector(cfg: dict) -> float:
    """Per-tower projections, the connector's samplers and the image
    projector, for one image."""
    m = cfg["model"]
    vh, h, q = m["vision_hidden_size"], m["hidden_size"], m["image_token_len"]
    proj = sum(2 * t["tokens"] * (t["out_dim"] * vh + vh * vh) for t in cfg["towers"])
    samplers = m["connector_depth"] * sva_layer(vh, vh, vh, q, _windows(cfg))
    return proj + samplers + 2 * q * (vh * h + h * h)


def in_llm_samplers(cfg: dict) -> float:
    """The in-decoder SVA steps of one image's block."""
    m = cfg["model"]
    if m.get("connector_only"):
        return 0.0
    return m["num_of_vision_sampler_layers"] * sva_layer(
        m["hidden_size"], m["vision_hidden_size"], m["vision_hidden_size"],
        m["image_token_len"], _windows(cfg))


def _head_dim(m: dict) -> int:
    return m.get("head_dim") or m["hidden_size"] // m["num_attention_heads"]


def decoder_token(cfg: dict) -> float:
    """The decoder's weight products for one token, every layer."""
    m = cfg["model"]
    h, f, d = m["hidden_size"], m["intermediate_size"], _head_dim(m)
    qo = 2 * h * m["num_attention_heads"] * d
    kv = 2 * h * m["num_key_value_heads"] * d
    return 2 * m["num_hidden_layers"] * (qo + kv + 3 * h * f)


def attention_pairs(cfg: dict, pairs: int) -> float:
    """QK^T and PV over ``pairs`` (query, key) pairs, every layer."""
    m = cfg["model"]
    return 4 * m["num_hidden_layers"] * m["num_attention_heads"] * _head_dim(m) * pairs


def head_token(cfg: dict) -> float:
    m = cfg["model"]
    return 2 * m["hidden_size"] * m["vocab_size"]


def prefill(cfg: dict, slots: int) -> float:
    """A prompt of ``slots`` slots (its image block included) into the
    cache, and the logits of its last slot; the encode is apart."""
    return (connector(cfg) + in_llm_samplers(cfg) + slots * decoder_token(cfg)
            + attention_pairs(cfg, slots * (slots + 1) // 2) + head_token(cfg))


def decode_token(cfg: dict, context: int) -> float:
    """One decode step of one sequence whose cache holds ``context`` rows
    before it."""
    return decoder_token(cfg) + attention_pairs(cfg, context + 1) + head_token(cfg)


def train_batch(cfg: dict, lengths: Sequence[int], labelled: int) -> float:
    """One stage-1 batch of samples of these valid slots and ``labelled``
    labelled next tokens in all: towers forward; connector and in-decoder
    samplers forward and backward (x3); decoder and head forward and input
    gradient (x2); attention forward and backward over the causal pairs
    (x3)."""
    per_image = towers(cfg, 1) + 3 * (connector(cfg) + in_llm_samplers(cfg))
    return sum(per_image + 2 * n * decoder_token(cfg)
               + 3 * attention_pairs(cfg, n * (n + 1) // 2) for n in lengths) \
        + 2 * labelled * head_token(cfg)
