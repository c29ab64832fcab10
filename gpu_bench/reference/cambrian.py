"""Plain float32 Cambrian-1: the four vision towers, the SVA connector with
its in-decoder re-injection, a LLaMA-family decoder and the LM head, written
from the published architectures (Cambrian-1, arXiv:2406.16860; CLIP ViT-L/14,
SigLIP SO400M, DINOv2-g with SwiGLU and LayerScale, OpenCLIP ConvNeXt-XXL;
LLaMA / Yi / Phi-3). No kernel, cache or batching: one sequence at a time,
every product a float32 matmul with TF32 off.

Weights come from a ``source``: ``source(group)`` gives the float32 tensors of
one group (``towers.0``, ``lm.rest``, ``lm.layers_7``, ``lm.embed_tokens``,
``lm.lm_head``) under the state-dict names the benchmark hands to the program
too, so that a 34B decoder is read one layer at a time. ``quant`` names what
is done to a decoder projection before use: None, "int8" (symmetric, one
scale per output channel, as a weight-only int8 checkpoint stores it) or
"fp8" (e4m3 with one scale per output channel). ``rounding="fp8"`` rounds
every matrix of every group to e4m3 the same way (the lower-precision
control of a bf16 configuration).

Departures from the published models, each as the benchmark's inputs make
them moot: images are square, so every image slot and every window token is
valid and no mask is applied; a tower's grid is resampled to the SVA's with
a plain bilinear map (half-pixel centres, no antialiasing).
"""

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

Source = Callable[[str], Dict[str, torch.Tensor]]
PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


# -- weight rounding ------------------------------------------------------------

def int8_weight(w: torch.Tensor) -> torch.Tensor:
    """[N, K] -> the int8 grid value of each entry times its row's scale."""
    absmax = w.abs().amax(1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    return torch.clamp(torch.round(w / scale), -127, 127) * scale


def fp8_weight(w: torch.Tensor) -> torch.Tensor:
    """e4m3 with one scale per output channel (the first axis)."""
    flat = w.reshape(w.shape[0], -1)
    absmax = flat.abs().amax(1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 448.0, torch.ones_like(absmax))
    q = (flat / scale).to(torch.float8_e4m3fn).float() * scale
    return q.reshape(w.shape)


def round_group(tensors: Dict[str, torch.Tensor], rounding: Optional[str]) -> Dict[str, torch.Tensor]:
    """Every matrix and kernel of a group rounded by ``rounding`` ("fp8");
    vectors (norms, biases) as they are."""
    if rounding is None:
        return tensors
    if rounding != "fp8":
        raise ValueError(f"unknown rounding {rounding!r}")
    return {k: fp8_weight(v) if v.dim() >= 2 else v for k, v in tensors.items()}


# -- small ops -------------------------------------------------------------------

def layer_norm(x, w, b, eps):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def rms_norm(x, w, eps):
    return x / torch.sqrt(x.square().mean(-1, keepdim=True) + eps) * w


def linear(x, w, b=None):
    y = x @ w.T
    return y if b is None else y + b


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


ACTS = {"gelu": gelu, "gelu_tanh": gelu_tanh, "quick_gelu": quick_gelu}


def attention(q, k, v, causal: bool):
    """q [Q, H, D], k/v [K, H, D] -> [Q, H, D], softmax in float32."""
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        n_q, n_k = q.shape[0], k.shape[0]
        keep = torch.ones(n_q, n_k, dtype=torch.bool, device=q.device).tril(n_k - n_q)
        scores = scores.masked_fill(~keep, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1), v)


def resize_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] bilinear weights: half-pixel centres, a triangle of
    width one input pixel, each row normalised over the taps inside."""
    src = (torch.arange(n_out, dtype=torch.float64) + 0.5) * (n_in / n_out) - 0.5
    dist = (src[:, None] - torch.arange(n_in, dtype=torch.float64)[None, :]).abs()
    w = (1.0 - dist).clamp_min(0.0)
    return (w / w.sum(1, keepdim=True)).float().to(device)


def resize_grid(x: torch.Tensor, side: int) -> torch.Tensor:
    """[B, h, w, C] -> [B, side, side, C]."""
    mh = resize_matrix(x.shape[1], side, x.device)
    mw = resize_matrix(x.shape[2], side, x.device)
    x = torch.einsum("oh,bhwc->bowc", mh, x)
    return torch.einsum("ow,bhwc->bhoc", mw, x)


# -- towers ----------------------------------------------------------------------

def vit_tokens(w: Dict[str, torch.Tensor], p: str, t: dict, pixels: torch.Tensor) -> torch.Tensor:
    """A ViT tower's patch tokens at its tap depth, [B, N, C]."""
    c, heads = t["hidden"], t["heads"]
    x = F.conv2d(pixels, w[p + "patch_embed.weight"], w.get(p + "patch_embed.bias"),
                 stride=t["patch"])
    x = x.flatten(2).transpose(1, 2)
    b = x.shape[0]
    pos = w[p + "pos_embed"]
    if t["class_token"]:
        cls = w[p + "cls_token"].reshape(1, 1, c).expand(b, 1, c)
        x = torch.cat([cls, x], 1) + pos[None]
    else:
        x = x + pos[None]
    eps = t["ln_eps"]
    if t["pre_ln"]:
        x = layer_norm(x, w[p + "pre_layernorm.weight"], w[p + "pre_layernorm.bias"], eps)
    act = ACTS[t["act"]]
    for i in range(t["blocks_run"]):
        q = f"{p}blocks_{i}."
        h = layer_norm(x, w[q + "norm1.weight"], w[q + "norm1.bias"], eps)
        out = []
        for s in range(b):
            hs = h[s]
            qq, kk, vv = (linear(hs, w[f"{q}attn.{n}.weight"], w[f"{q}attn.{n}.bias"])
                          .reshape(hs.shape[0], heads, -1) for n in ("q_proj", "k_proj", "v_proj"))
            out.append(attention(qq, kk, vv, causal=False).reshape(hs.shape[0], c))
        h = linear(torch.stack(out), w[q + "attn.out_proj.weight"], w[q + "attn.out_proj.bias"])
        if t["layer_scale"]:
            h = h * w[q + "ls1_gamma"]
        x = x + h
        h = layer_norm(x, w[q + "norm2.weight"], w[q + "norm2.bias"], eps)
        if t["swiglu"]:
            a, g = linear(h, w[q + "mlp.weights_in.weight"], w[q + "mlp.weights_in.bias"]).chunk(2, -1)
            h = linear(F.silu(a) * g, w[q + "mlp.weights_out.weight"], w[q + "mlp.weights_out.bias"])
        else:
            h = linear(act(linear(h, w[q + "mlp.fc1.weight"], w[q + "mlp.fc1.bias"])),
                       w[q + "mlp.fc2.weight"], w[q + "mlp.fc2.bias"])
        if t["layer_scale"]:
            h = h * w[q + "ls2_gamma"]
        x = x + h
    if t["final_ln"]:
        x = layer_norm(x, w[p + "final_layernorm.weight"], w[p + "final_layernorm.bias"], eps)
    if t["class_token"]:
        x = x[:, 1:]
    side = int(round(x.shape[1] ** 0.5))
    out_side = int(round(t["tokens"] ** 0.5))
    if side != out_side:
        x = resize_grid(x.reshape(b, side, side, c), out_side).reshape(b, out_side ** 2, c)
    return x


def convnext_tokens(w: Dict[str, torch.Tensor], p: str, t: dict, pixels: torch.Tensor) -> torch.Tensor:
    """ConvNeXt's four stage maps, each resized to the token grid, channels
    concatenated: [B, side^2, sum(dims)]."""
    eps = t["ln_eps"]
    p = p + "trunk."

    def chan_norm(x, name):
        return layer_norm(x.permute(0, 2, 3, 1), w[name + ".weight"], w[name + ".bias"],
                          eps).permute(0, 3, 1, 2)

    x = chan_norm(F.conv2d(pixels, w[p + "stem_conv.weight"], w[p + "stem_conv.bias"], stride=4),
                  p + "stem_norm")
    maps = []
    for s, depth in enumerate(t["depths"]):
        if s > 0:
            x = chan_norm(x, f"{p}downsample_norm_{s}")
            x = F.conv2d(x, w[f"{p}downsample_conv_{s}.weight"], w[f"{p}downsample_conv_{s}.bias"],
                         stride=2)
        for i in range(depth):
            q = f"{p}stage_{s}_block_{i}."
            h = F.conv2d(x, w[q + "dwconv.weight"], w[q + "dwconv.bias"], padding=3,
                         groups=x.shape[1]).permute(0, 2, 3, 1)
            h = layer_norm(h, w[q + "norm.weight"], w[q + "norm.bias"], eps)
            h = linear(gelu(linear(h, w[q + "pwconv1.weight"], w[q + "pwconv1.bias"])),
                       w[q + "pwconv2.weight"], w[q + "pwconv2.bias"])
            x = x + (h * w[q + "gamma"]).permute(0, 3, 1, 2)
        maps.append(x)
    side = int(round(t["tokens"] ** 0.5))
    grid = torch.cat([resize_grid(m.permute(0, 2, 3, 1), side) for m in maps], -1)
    return grid.reshape(grid.shape[0], side * side, -1)


def encode(source: Source, towers: Sequence[dict], pixels: Sequence[torch.Tensor],
           rounding: Optional[str] = None) -> List[torch.Tensor]:
    """Each tower's tokens for its pixel batch [B, 3, R, R]."""
    feats = []
    for i, (t, px) in enumerate(zip(towers, pixels)):
        w = round_group(source(f"towers.{i}"), rounding)
        fn = convnext_tokens if t["kind"] == "convnext" else vit_tokens
        feats.append(fn(w, f"towers.{i}.module.", t, px.float()))
        del w
    return feats


# -- the SVA connector -------------------------------------------------------------

def windows(x: torch.Tensor, q_side: int) -> torch.Tensor:
    """[B, S*S, C] -> [B, q_side^2, r^2, C]: each query cell's window."""
    b, n, c = x.shape
    s = int(round(n ** 0.5))
    r = s // q_side
    x = x.reshape(b, q_side, r, q_side, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, q_side * q_side, r * r, c)


def sva_layer(w: Dict[str, torch.Tensor], p: str, queries, context, kvs, heads: int = 16):
    """One joint SVA layer: queries [B, Q, q_dim], context [B, Q, vh], kvs
    per tower [B, Q, W_i, vh] -> [B, Q, q_dim]."""
    eps = 1e-5
    ctx = linear(context, w[p + "proj_context.weight"])
    x = linear(torch.cat([queries, ctx], -1), w[p + "proj_in.weight"])
    a = p + "cross_attn."
    b, nq, hid = x.shape
    d = hid // heads
    q = linear(layer_norm(x, w[a + "q_ln.weight"], w[a + "q_ln.bias"], eps),
               w[a + "q_proj.weight"]).reshape(b, nq, heads, d)
    ks, vs = [], []
    for i, kv in enumerate(kvs):
        pos = w.get(f"{p}pos_embed_{i}")
        kv = kv if pos is None else kv + pos
        n_w = kv.shape[2]
        k = linear(layer_norm(kv, w[f"{a}k_ln_{i}.weight"], w[f"{a}k_ln_{i}.bias"], eps),
                   w[f"{a}k_proj_{i}.weight"])
        v = linear(layer_norm(kv, w[f"{a}v_ln_{i}.weight"], w[f"{a}v_ln_{i}.bias"], eps),
                   w[f"{a}v_proj_{i}.weight"])
        ks.append(k.reshape(b, nq, n_w, heads, d))
        vs.append(v.reshape(b, nq, n_w, heads, d))
    k, v = torch.cat(ks, 2), torch.cat(vs, 2)
    scores = torch.einsum("bqhd,bqwhd->bqhw", q, k) / math.sqrt(d)
    out = torch.einsum("bqhw,bqwhd->bqhd", torch.softmax(scores, -1), v)
    x = x + linear(out.reshape(b, nq, hid), w[a + "o_proj.weight"])
    x = layer_norm(x, w[p + "norm.weight"], w[p + "norm.bias"], eps)
    x = linear(gelu(linear(x, w[p + "proj_out.linear_1.weight"])), w[p + "proj_out.linear_2.weight"])
    return x + queries


def connector(w: Dict[str, torch.Tensor], m: dict, feats: Sequence[torch.Tensor]):
    """(image block [B, block, H], windows per tower, global context
    [B, Q, vh]) from the towers' tokens."""
    side = int(round(m["image_token_len"] ** 0.5))
    projected = []
    for i, f in enumerate(feats):
        p = f"lm.mm_projector_aux_{i}."
        h = linear(gelu(linear(f, w[p + "fc1.weight"], w[p + "fc1.bias"])),
                   w[p + "fc2.weight"], w[p + "fc2.bias"])
        projected.append(layer_norm(h, w[p + "ln.weight"], w[p + "ln.bias"], 1e-5))
    b = projected[0].shape[0]
    vh = projected[0].shape[-1]
    n_q = side * side
    glob = projected[0].mean(1, keepdim=True).expand(b, n_q, vh)
    kvs = [windows(x, side) for x in projected]
    queries = w["lm.vision_query"][0].reshape(1, 1, vh).expand(b, n_q, vh)
    for j in range(m["connector_depth"]):
        queries = sva_layer(w, f"lm.vision_sampler_0.layers_{j}.", queries, glob, kvs)
    img = linear(gelu(linear(queries, w["lm.mm_projector.fc1.weight"], w["lm.mm_projector.fc1.bias"])),
                 w["lm.mm_projector.fc2.weight"], w["lm.mm_projector.fc2.bias"])
    hidden = img.shape[-1]
    grid = img.reshape(b, side, side, hidden)
    newline = w["lm.image_newline"].reshape(1, 1, 1, hidden).expand(b, side, 1, hidden)
    block = torch.cat([grid, newline], 2).reshape(b, side * (side + 1), hidden)
    return block, kvs, glob


def sampler_layers(m: dict) -> List[int]:
    """Decoder layers followed by an in-LLM SVA step."""
    if m.get("connector_only"):
        return []
    return [m["start_of_vision_sampler_layers"] + k * m["stride_of_vision_sampler_layers"]
            for k in range(m["num_of_vision_sampler_layers"])]


# -- the decoder -------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, H, D] rotated by position, the two halves of D paired."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d))
    ang = positions.double()[:, None] * inv[None]
    cos, sin = torch.cat([ang, ang], -1).cos().float(), torch.cat([ang, ang], -1).sin().float()
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    rot = torch.cat([-x2, x1], -1)
    return x * cos[:, None] + rot * sin[:, None]


def decoder_layer(w: Dict[str, torch.Tensor], p: str, m: dict, x: torch.Tensor,
                  positions: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """One pre-norm LLaMA block over one sequence x [S, H]."""
    def proj(name, h):
        wt = w[f"{p}{name}.weight"]
        if quant == "int8":
            wt = int8_weight(wt)
        elif quant == "fp8":
            wt = fp8_weight(wt)
        return h @ wt.T

    eps = m["rms_norm_eps"]
    heads, kv_heads = m["num_attention_heads"], m["num_key_value_heads"]
    d = m["head_dim"] or m["hidden_size"] // heads
    s = x.shape[0]
    h = rms_norm(x, w[p + "input_layernorm.weight"], eps)
    q = rope(proj("self_attn.q_proj", h).reshape(s, heads, d), positions, m["rope_theta"])
    k = rope(proj("self_attn.k_proj", h).reshape(s, kv_heads, d), positions, m["rope_theta"])
    v = proj("self_attn.v_proj", h).reshape(s, kv_heads, d)
    rep = heads // kv_heads
    k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    x = x + proj("self_attn.o_proj", attention(q, k, v, causal=True).reshape(s, heads * d))
    h = rms_norm(x, w[p + "post_attention_layernorm.weight"], eps)
    return x + proj("mlp.down_proj", F.silu(proj("mlp.gate_proj", h)) * proj("mlp.up_proj", h))


def image_start(ids: torch.Tensor, marker: int) -> int:
    where = (ids == marker).nonzero()
    if where.numel() != 1:
        raise ValueError(f"a sequence needs exactly one image marker, found {where.numel()}")
    return int(where[0, 0])


def hidden_states(source: Source, cfg: dict, seqs: Sequence[torch.Tensor],
                  feats: Sequence[torch.Tensor], quant: Optional[str] = None,
                  rounding: Optional[str] = None, layer_fn=None) -> List[torch.Tensor]:
    """The final-norm hidden states [S, H] of each sequence of ids (one image
    marker each, which the image block of ``image_token_len + side`` slots
    takes the place of; S counts the block), with ``feats[i]`` the towers'
    tokens of sequence i ([1, N, C] per tower). Layer by layer over all the
    sequences, so each decoder layer's weights are read once.
    ``layer_fn(fn, *args)`` runs each decoder layer (the training reference
    passes a checkpointing wrapper)."""
    m = cfg["model"]
    marker = cfg["image_marker"]
    rest = round_group(source("lm.rest"), rounding)
    embed = round_group(source("lm.embed_tokens"), rounding)["lm.embed_tokens.weight"]
    block_len = None
    xs, starts, vis = [], [], []
    for ids, f in zip(seqs, feats):
        block, kvs, glob = connector(rest, m, f)
        block_len = block.shape[1]
        start = image_start(ids, marker)
        x = embed[ids.clamp_min(0)]
        x = torch.cat([x[:start], block[0], x[start + 1:]], 0)
        xs.append(x)
        starts.append(start)
        vis.append((kvs, glob))
    del embed
    inject = {i: k for k, i in enumerate(sampler_layers(m))}
    run = layer_fn or (lambda fn, *args: fn(*args))
    side = int(round(m["image_token_len"] ** 0.5))
    for i in range(m["num_hidden_layers"]):
        w = round_group(source(f"lm.layers_{i}"), rounding)
        p = f"lm.layers_{i}."
        for j, x in enumerate(xs):
            pos = torch.arange(x.shape[0], device=x.device)
            x = run(decoder_layer, w, p, m, x, pos, quant)
            if i in inject:
                kvs, glob = vis[j]
                st = starts[j]
                blk = x[st:st + block_len].reshape(side, side + 1, -1)
                lat = blk[:, :side].reshape(1, side * side, -1)
                lat = sva_layer(rest, f"lm.vision_sampler_layers_{inject[i]}.layers_0.", lat,
                                glob, kvs)
                blk = torch.cat([lat.reshape(side, side, -1), blk[:, side:]], 1)
                x = torch.cat([x[:st], blk.reshape(block_len, -1), x[st + block_len:]], 0)
            xs[j] = x
        del w
    eps = m["rms_norm_eps"]
    return [rms_norm(x, rest["lm.norm.weight"], eps) for x in xs]


def head_weight(source: Source, cfg: dict, rounding: Optional[str] = None) -> torch.Tensor:
    if cfg["model"].get("tie_word_embeddings"):
        return round_group(source("lm.embed_tokens"), rounding)["lm.embed_tokens.weight"]
    return round_group(source("lm.lm_head"), rounding)["lm.lm_head.weight"]
