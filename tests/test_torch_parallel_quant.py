"""The port's quantized serving on the (data, fsdp, model) mesh, on the CPU:
the sharding rules on a quantized parameter tree against the JAX package's,
the int4 row-parallel rule, and four gloo processes
(tests/torch_parallel_workers.py) serving int8, int4 and int4 with the scale
on the weights (``CAMBRIAN_INT4_V2=1``) through ``GenerationEngine(mesh=...)``
on (1,2,2) and (1,1,4). Greedy tokens equal the unsharded port's and the JAX
``GenerationEngine(mesh=...)``'s on its (1,2,2) mesh; first-step logits are
within 1e-4 of both. The decoder is a 2-layer tiny Cambrian at widths whose
int4 scale groups split over two ranks in attention and over four in the
MLP (o_proj's K = 256 is two groups of 128, down_proj's K = 512 four), so
that (1,1,4) keeps int4 attention replicated by the rule. One spawn runs
every serving case."""

import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_workers as workers  # noqa: E402

from cambrian_tpu.constants import IMAGE_TOKEN_INDEX  # noqa: E402
from cambrian_tpu.data.packing import prepare_multimodal_data  # noqa: E402
from cambrian_tpu.infer.engine import GenerationConfig as JGenerationConfig  # noqa: E402
from cambrian_tpu.infer.engine import GenerationEngine as JGenerationEngine  # noqa: E402
from cambrian_tpu.models.cambrian import CambrianLM  # noqa: E402
from cambrian_tpu.models.config import tiny_debug  # noqa: E402
from cambrian_tpu.models.encoders.base import build_vision_tower_aux_list  # noqa: E402
from cambrian_tpu.ops.quant import quantize_dense_tree  # noqa: E402
from cambrian_tpu.parallel import mesh as jmesh  # noqa: E402
from cambrian_tpu.parallel import sharding as jsharding  # noqa: E402
from cambrian_tpu_torch.checkpoint.from_jax import state_dict_from_jax  # noqa: E402
from cambrian_tpu_torch.checkpoint.save import save_pretrained  # noqa: E402
from cambrian_tpu_torch.infer.engine import GenerationConfig, GenerationEngine  # noqa: E402
from cambrian_tpu_torch.models.builder import (  # noqa: E402
    CambrianForInference,
    build_modules,
    load_pretrained_model,
)
from cambrian_tpu_torch.models.config import CambrianConfig  # noqa: E402
from cambrian_tpu_torch.ops import quant  # noqa: E402
from cambrian_tpu_torch.parallel import mesh, sharding  # noqa: E402

CFG = tiny_debug(num_towers=2).replace(hidden_size=256, intermediate_size=512,
                                       num_attention_heads=8, num_key_value_heads=4,
                                       num_hidden_layers=2, num_of_vision_sampler_layers=1)
MODES = ["int8", "int4", "int4_scale_on_weights"]
MESHES = [(1, 2, 2), (1, 1, 4)]
NEW_TOKENS = 5
LOGIT_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _plain_params(seed=0):
    """The tiny Cambrian's (CFG's) flax tree, perturbed off its init, and
    its towers."""
    cfg = CFG
    rng = np.random.default_rng(seed)
    towers = build_vision_tower_aux_list(cfg.mm_vision_tower_aux_list,
                                         cfg.mm_vision_tower_aux_token_len_list)
    b, s = 1, 24
    ids = np.full((b, s), 7, np.int64)
    ids[:, cfg.image_position] = IMAGE_TOKEN_INDEX
    pids, _, pmask, ppos, aux = prepare_multimodal_data(
        ids, ids.copy(), np.ones((b, s), bool), [(640, 360)], cfg.image_token_len,
        cfg.mm_vision_tower_aux_token_len_list, cfg.tokenizer_model_max_length)
    feats = [jnp.zeros((b, t.interp_size, t.hidden_size)) for t in towers]
    plain = CambrianLM(cfg, tuple(t.hidden_size for t in towers))
    params = jax.jit(plain.init)(jax.random.PRNGKey(seed), jnp.asarray(pids), jnp.asarray(pmask),
                                 jnp.asarray(ppos), feats, [jnp.asarray(m) for m in aux])
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape).astype(np.float32),
        params["params"])
    return {"params": params}, towers


@functools.lru_cache(maxsize=None)
def _jax_params(mode):
    """The quantized JAX model, its tree (the decoder's projections through
    ``quantize_dense_tree``) and the towers."""
    params, towers = _plain_params()
    params = {k: quantize_dense_tree(v, mode=mode) if k.startswith("layers_") else v
              for k, v in params["params"].items()}
    qcfg = CFG.replace(quantize=mode)
    return CambrianLM(qcfg, tuple(t.hidden_size for t in towers)), {"params": params}, towers


def _port_case(cfg, params, towers, mode):
    sd = state_dict_from_jax(params, prefix="lm.")
    for i, t in enumerate(towers):
        sd.update(state_dict_from_jax(jax.jit(t.init)(jax.random.PRNGKey(i + 1)),
                                      prefix=f"towers.{i}.module."))
    return dict(cfg=cfg.replace(quantize=mode).to_dict(), sd=sd, new_tokens=NEW_TOKENS)


def _text_prompt(cfg, b=2, seq=12):
    rng = np.random.default_rng(35)
    ids = rng.integers(5, cfg.vocab_size, (b, seq)).astype(np.int32)
    mask = np.ones((b, seq), bool)
    mask[-1, seq - 3:] = False                   # the last row is shorter
    return ids, mask, np.tile(np.arange(seq), (b, 1))


def _plain(case, scale_on_weights):
    """The unsharded port engine's tokens and first-step logits."""
    m = CambrianForInference.from_state_dict(
        CambrianConfig.from_dict(case["cfg"]), {k: v.clone() for k, v in case["sd"].items()},
        torch.float32)
    engine = GenerationEngine(m.lm, m.towers, max_len=64, cache_dtype=torch.float32)
    if scale_on_weights:
        os.environ["CAMBRIAN_INT4_V2"] = "1"
    try:
        tokens = engine.generate(*case["prompt"], None, None,
                                 GenerationConfig(max_new_tokens=NEW_TOKENS))
    finally:
        os.environ.pop("CAMBRIAN_INT4_V2", None)
    return tokens, engine.last_next_logits


@pytest.fixture(scope="module")
def sharded_quant(tmp_path_factory):
    """One spawn of four ranks serving every (mode, mesh) case, while this
    process runs the JAX mesh engine, its prefill logits and the unsharded
    port engine."""
    prompt = _text_prompt(CFG)
    bundles = {m: _jax_params(m) for m in ("int8", "int4")}
    cases = {}
    for mode in MODES:
        jmodel, params, towers = bundles[mode.split("_")[0]]
        base = _port_case(CFG, params, towers, mode.split("_")[0])
        for dims in MESHES:
            cases[(mode, dims)] = dict(base, mesh=dims, prompt=prompt,
                                       scale_on_weights=mode == "int4_scale_on_weights")
    tmp = tmp_path_factory.mktemp("parallel_quant")
    # load_pretrained_model(load_4bit=True) of a checkpoint, handed to the
    # mesh engine as it comes
    checkpoint = str(tmp / "checkpoint")
    save_pretrained(_plain_params()[0], CambrianConfig.from_dict(CFG.to_dict()), checkpoint)
    cases["loaded_int4"] = dict(checkpoint=checkpoint, mesh=(1, 2, 2), prompt=prompt,
                                new_tokens=NEW_TOKENS)
    started = workers.start_ranks(workers.quant_rank, 4, tmp, dict(cases=cases))

    jax_mesh = jmesh.create_mesh(jmesh.MeshConfig(data=1, fsdp=2, model=2),
                                 devices=jax.devices()[:4])
    jax_tokens, jax_logits = {}, {}
    ids, mask, pos = prompt
    # the logits that pick the first token: each row's last valid slot
    last = mask.shape[1] - 1 - np.argmax(mask[:, ::-1], axis=1)
    for key, (jmodel, params, towers) in bundles.items():
        engine = JGenerationEngine(jmodel, params, max_len=64, cache_dtype=jnp.float32,
                                   mesh=jax_mesh)
        with jax.set_mesh(jax_mesh):
            jax_tokens[key] = np.asarray(engine.generate(
                *prompt, None, None, JGenerationConfig(max_new_tokens=NEW_TOKENS,
                                                       temperature=0.0)))
        logits = jax.jit(jmodel.apply)(params, jnp.asarray(ids), jnp.asarray(mask),
                                       jnp.asarray(pos))
        jax_logits[key] = np.asarray(logits)[np.arange(len(last)), last]
    plain = {mode: _plain(cases[(mode, MESHES[0])], mode == "int4_scale_on_weights")
             for mode in MODES}
    _, loaded, _, _ = load_pretrained_model(checkpoint, load_4bit=True, device="cpu",
                                            dtype=torch.float32)
    plain["loaded_int4"] = loaded.engine.generate(*prompt, None, None,
                                                  GenerationConfig(max_new_tokens=NEW_TOKENS))
    ranks = workers.join_ranks(started, timeout=120)
    return dict(cases=cases, ranks=ranks, plain=plain, jax_tokens=jax_tokens,
                jax_logits=jax_logits)


@pytest.mark.parametrize("dims", [(1, 2, 2), (2, 2, 1)])
def test_quantized_tree_shardings_match_jax(dims):
    """Every tensor of the quantized port model (``kernel_q`` / ``kernel_q4``
    [K(/2), N], ``scale`` [N] or [K/group, N], the fp32 biases, and the
    unquantized rest) gets the spec JAX gives the flax leaf the bridge maps
    onto it."""
    for mode in ("int8", "int4"):
        jmodel, params, _ = _jax_params(mode)
        jax_mesh = jmesh.create_mesh(jmesh.MeshConfig(*dims), devices=jax.devices()[:4])
        jspecs = jsharding.infer_param_shardings(params, jax_mesh)
        flat = jax.tree_util.tree_leaves_with_path(params)
        flat_specs = jax.tree.leaves(jspecs, is_leaf=lambda x: hasattr(x, "spec"))
        names = list(state_dict_from_jax(params))
        with torch.device("meta"):
            lm, _ = build_modules(CambrianConfig.from_dict(CFG.replace(quantize=mode).to_dict()),
                                  torch.float32)
        port = {k: v.shape for k, v in lm.state_dict().items()}
        assert set(port) == set(names)
        got = sharding.infer_param_shardings(port, dict(zip(mesh.AXES, dims)))
        quantized = set()
        for name, (path, leaf), spec in zip(names, flat, flat_specs):
            want = tuple(spec.spec) + (None,) * (len(leaf.shape) - len(spec.spec))
            if path[-1].key == "kernel":
                want = want[::-1]                        # Dense kernel -> weight
            assert got[name] == want, (name, got[name], want)
            if path[-1].key in ("kernel_q", "kernel_q4") or (
                    path[-1].key == "scale" and "_proj" in path[-2].key):
                quantized.add((path[-1].key, want))
        leaf = "kernel_q4" if mode == "int4" else "kernel_q"
        if dims[2] > 1:
            # column- and row-parallel weights, and their scales
            assert {(leaf, ("fsdp", "model")), (leaf, ("model", "fsdp"))} <= quantized
            if mode == "int4":
                assert {("scale", ("fsdp", "model")), ("scale", ("model", "fsdp"))} <= quantized


def test_int4_row_parallel_takes_whole_groups():
    """A row-parallel int4 projection (and its column-parallel partners)
    takes the model axis only where every rank's K is whole scale groups:
    o_proj's K = 256 (two groups) splits over 2 ranks but not over 4, where
    attention stays replicated though its heads divide; down_proj's K = 512
    splits over 4. int8 splits wherever the heads and widths divide."""
    def plan(mode, tp):
        with torch.device("meta"):
            lm, _ = build_modules(CambrianConfig.from_dict(CFG.replace(quantize=mode).to_dict()),
                                  torch.float32)
        assert lm.layers_0.self_attn.o_proj.scale.shape[0] == (2 if mode == "int4" else 256)
        return sharding._tp_plan(lm, {"data": 1, "fsdp": 1, "model": tp})

    assert sharding.attention_tp(CFG.num_attention_heads, CFG.num_key_value_heads, 4)
    for tp in (2, 4):
        int8 = plan("int8", tp)
        assert int8["layers_0.self_attn.o_proj"] == "row"
        assert int8["layers_0.self_attn.q_proj"] == "column"
        assert int8["layers_1.mlp.down_proj"] == "row"
    int4 = plan("int4", 2)
    assert int4["layers_0.self_attn.o_proj"] == "row" and int4["layers_0.mlp.down_proj"] == "row"
    int4 = plan("int4", 4)
    assert not any(n.startswith("layers_0.self_attn.") for n in int4)
    assert int4["layers_0.mlp.down_proj"] == "row" and int4["layers_0.mlp.gate_proj"] == "column"


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dims", MESHES)
def test_sharded_quantized_engine_matches(sharded_quant, mode, dims):
    """Greedy tokens on every rank equal the unsharded port's and the JAX
    mesh engine's; the first step's logits (each rank's rows) are within
    1e-4 of both."""
    want, plain_logits = sharded_quant["plain"][mode]
    jax_key = mode.split("_")[0]
    np.testing.assert_array_equal(want, sharded_quant["jax_tokens"][jax_key])
    np.testing.assert_allclose(plain_logits.numpy(), sharded_quant["jax_logits"][jax_key],
                               atol=LOGIT_TOL, rtol=0)
    for r, rank in enumerate(sharded_quant["ranks"]):
        got = rank[(mode, dims)]
        np.testing.assert_array_equal(got["tokens"], want, err_msg=f"rank {r}")
        rows = got["rows"] or slice(None)
        np.testing.assert_allclose(got["logits"].numpy(), plain_logits[rows].numpy(),
                                   atol=LOGIT_TOL, rtol=0, err_msg=f"rank {r}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dims", MESHES)
def test_sharded_quantized_layout(sharded_quant, mode, dims):
    """Each rank holds its slice of the split projections (N of q/up, K of
    o/down, whole scale groups for int4) and its share of the kv heads; the
    int4 attention of (1,1,4) stays whole; the int8 tensors stay buffers,
    whole on every fsdp rank (FSDP2 shards the floating parameters)."""
    got = sharded_quant["ranks"][0][(mode, dims)]
    tp = dims[2]
    int4 = mode != "int8"
    attn_tp = not (int4 and tp == 4)
    assert got["kv_heads"] == CFG.num_key_value_heads // (tp if attn_tp else 1)
    k, hidden, inter = 256, CFG.hidden_size, CFG.intermediate_size
    rows = (lambda n: n // 2) if int4 else (lambda n: n)
    a = tp if attn_tp else 1
    weight = "kernel_q4" if int4 else "kernel_q"
    assert got["local"][f"q_proj.{weight}"] == (rows(hidden), k // a)
    assert got["local"][f"o_proj.{weight}"] == (rows(k // a), hidden)
    assert got["local"][f"up_proj.{weight}"] == (rows(hidden), inter // tp)
    assert got["local"][f"down_proj.{weight}"] == (rows(inter // tp), hidden)
    if int4:
        assert got["local"]["down_proj.scale"] == (inter // tp // quant.INT4_GROUP, hidden)
        assert got["local"]["up_proj.scale"] == (hidden // quant.INT4_GROUP, inter // tp)
    else:
        assert got["local"]["down_proj.scale"] == (hidden,)
    assert got["plan"]["layers_0.mlp.down_proj"] == "row"
    # plain tensors, not FSDP2's DTensors: replicated over (data, fsdp)
    assert all(spec == () for spec in got["fsdp"].values()), got["fsdp"]
    assert got["norm"] == ("fsdp",)        # a layer's FSDP2 parameter, for contrast


def test_loaded_quantized_model_serves_on_the_mesh(sharded_quant):
    """``load_pretrained_model(load_4bit=True)``'s model, handed to
    ``GenerationEngine(mesh=...)`` as it comes, gives on every rank of
    (1,2,2) the unsharded loaded model's greedy tokens; its int4 MLP is
    split over model."""
    want = sharded_quant["plain"]["loaded_int4"]
    assert want.shape == (2, NEW_TOKENS)
    for rank in sharded_quant["ranks"]:
        got = rank["loaded_int4"]
        np.testing.assert_array_equal(got["tokens"], want)
        assert got["plan"]["layers_1.mlp.down_proj"] == "row"
        assert got["local"]["down_proj.kernel_q4"] == (CFG.intermediate_size // 2 // 2,
                                                        CFG.hidden_size)
