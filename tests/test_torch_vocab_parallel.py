"""The port's vocab-parallel embedding, LM head and chunked cross-entropy
against the JAX package's, on the CPU: four gloo processes
(tests/torch_parallel_workers.py, one spawn for the file) and the JAX
references on its 8-device mesh meanwhile.

- Layout: on (1,2,2), (2,2,1) and (1,1,4) the embedding and the head are in
  no FSDP2 unit and hold ``infer_param_shardings``' spec: V/n rows a rank,
  n = model x fsdp, model-major; V = 515 (``initialize_vision_tokenizer``'s
  three tokens on the tiny 512) does not divide and is whole on every rank.
- The loss alone: value, ``dhidden`` and each rank's slab of ``dhead``
  against JAX ``chunked_cross_entropy`` given ``head_spec`` (tied and
  untied, Cohere's logit scale, the final softcap, the bf16 head, no chunks,
  V = 515), rows of unequal valid counts.
- One stage-2 step of the tiny model (V = 520) on (1,2,2) under a dispatch
  mode: no op makes a tensor of V x H elements or a last dimension of V
  (the port's tests/test_ce_grad_sharding.py); its loss and the embedding
  and head it leaves equal the unsharded port's step (so do V = 515's and
  a tied head's).
- DCP: the (1,2,2) checkpoint restores exactly under (2,2,1), the V = 515
  one (whole on each rank) under (4,1,1).
- Serving: greedy tokens of ``GenerationEngine(mesh=...)`` equal the
  unsharded engine's, and a tie planted between two slabs goes to the lower
  index."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_workers as workers  # noqa: E402
from test_torch_parallel_train import GRAD_NORM_TOL, _batches  # noqa: E402
from test_torch_train import LOSS_TOL, TRAIN_KW  # noqa: E402

from cambrian_tpu.constants import IGNORE_INDEX  # noqa: E402
from cambrian_tpu.models import cambrian as jcambrian  # noqa: E402
from cambrian_tpu.models.config import tiny_debug  # noqa: E402
from cambrian_tpu.models.encoders.base import build_vision_tower_aux_list  # noqa: E402
from cambrian_tpu.parallel import sharding as jsharding  # noqa: E402
from cambrian_tpu.parallel.mesh import MeshConfig, create_mesh  # noqa: E402
from cambrian_tpu_torch.infer.engine import GenerationConfig, GenerationEngine  # noqa: E402
from cambrian_tpu_torch.models.builder import (  # noqa: E402
    CambrianForInference,
    initialize_vision_tokenizer,
    random_state_dict,
)
from cambrian_tpu_torch.models.config import CambrianConfig  # noqa: E402
from cambrian_tpu_torch.train.optimizer import TrainConfig  # noqa: E402
from cambrian_tpu_torch.train.train_step import init_train_state, make_train_step  # noqa: E402

# the tiny Cambrian at half its decoder depth, as the other sharded tests
CFG = tiny_debug(num_towers=2).replace(tokenizer_model_max_length=192, num_hidden_layers=2,
                                       num_of_vision_sampler_layers=1)
# the dispatch mode's model: a vocab that no other width of the model, its
# towers, its sequences or FSDP2's buffers has (512 is the size of a rank's
# share of a 1,024-element unit on (1,2,2)), and loss chunks whose slab
# logits [rows, V/4] do not hold V x H elements (at 128 tokens a chunk, its
# 4 x 128 gathered rows are 4 H)
WATCH_VOCAB, WATCH_CHUNK = 520, 64
LAYOUT_MESHES = [(1, 2, 2), (2, 2, 1), (1, 1, 4)]
# the first step takes the peak rate, so that it moves the weights
STEP_KW = dict(TRAIN_KW, warmup_ratio=0.0)
LOSS_B, LOSS_S, LOSS_CHUNK = 4, 48, 16
LOSS_ENDS = [48, 35, 20, 41]            # each row's valid length: unequal counts per rank
LOSS_CASES = {                          # name: (config fields, port mesh, chunk)
    "untied": ({}, (1, 2, 2), LOSS_CHUNK),
    "untied_over_data": ({}, (2, 2, 1), LOSS_CHUNK),
    "tied": ({"tie_word_embeddings": True}, (1, 2, 2), LOSS_CHUNK),
    "logit_scale": ({"logit_scale": 0.25}, (1, 2, 2), LOSS_CHUNK),
    "final_softcap": ({"final_logit_softcapping": 1.5}, (1, 2, 2), LOSS_CHUNK),
    "bf16_head": ({"lm_head_dtype": "bf16"}, (1, 2, 2), LOSS_CHUNK),
    "unchunked": ({}, (1, 1, 4), None),
    "replicated_515": ({"vocab_size": 515}, (1, 2, 2), LOSS_CHUNK),
}
TIE = (7, 2 * (CFG.vocab_size // 4) + 7)     # one offset in slabs 0 and 2 of (1,2,2)


class _Tokenizer:
    def __init__(self):
        self.vocab = []

    def add_tokens(self, tokens, special_tokens=False):
        self.vocab.extend(tokens)
        return len(tokens)


def _loss_inputs(rng, vocab):
    hidden = rng.standard_normal((LOSS_B, LOSS_S, CFG.hidden_size)).astype(np.float32)
    labels = rng.integers(0, vocab, (LOSS_B, LOSS_S)).astype(np.int64)
    labels[:, :5] = IGNORE_INDEX
    for r, end in enumerate(LOSS_ENDS):
        labels[r, end:] = IGNORE_INDEX
    head = (0.2 * rng.standard_normal((vocab, CFG.hidden_size))).astype(np.float32)
    return hidden, labels, head


def _jax_loss(jcfg, hidden, labels, head, chunk):
    """JAX value and gradients (hidden, head [V, H]) on its (2,2,2) mesh, the
    head laid out by its rule and ``chunked_cross_entropy`` given the spec."""
    mesh = create_mesh(MeshConfig(2, 2, 2), devices=jax.devices()[:8])
    tied = jcfg.tie_word_embeddings
    weight = head if tied else head.T
    spec = (("model", "fsdp"), None) if tied else (None, ("model", "fsdp"))
    lab = jnp.asarray(labels.astype(np.int32))

    def logits_fn(hd, hc):
        return jcambrian.head_logits(jcfg, hd, hc)

    def loss(h, w):
        if chunk:
            return jcambrian.chunked_cross_entropy(h, lab, logits_fn, chunk, w, spec)
        return jcambrian.cross_entropy_loss(logits_fn(w, h), lab)

    with jax.set_mesh(mesh):
        h = jax.device_put(hidden, NamedSharding(mesh, P(("data", "fsdp"), None, None)))
        w = jax.device_put(weight, NamedSharding(
            mesh, jsharding._fit_spec(P(*spec), weight.shape, mesh)))
        value, (dh, dw) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(h, w)
    dw = np.asarray(dw)
    return float(value), np.asarray(dh), dw if tied else dw.T


def _jax_specs(vocab, dims):
    """JAX's specs of the embedding and the head (the port's dims)."""
    mesh = create_mesh(MeshConfig(*dims), devices=jax.devices()[:4])
    h = CFG.hidden_size
    shapes = {"params": {"embed_tokens": {"embedding": jax.ShapeDtypeStruct((vocab, h), jnp.float32)},
                         "lm_head": {"kernel": jax.ShapeDtypeStruct((h, vocab), jnp.float32)}}}
    specs = jsharding.infer_param_shardings(shapes, mesh)["params"]

    def pad(spec):
        spec = tuple(spec)
        return spec + (None,) * (2 - len(spec))

    return {"embed_tokens.weight": pad(specs["embed_tokens"]["embedding"].spec),
            "lm_head.weight": pad(specs["lm_head"]["kernel"].spec)[::-1]}


def _model(case):
    m = CambrianForInference.from_state_dict(
        CambrianConfig.from_dict(case["cfg"]), {k: v.clone() for k, v in case["sd"].items()},
        torch.float32)
    return m.lm, m.towers


def _plain_step(case):
    """The unsharded port's stage-2 step on the whole first batch: loss,
    grad norm and the gradients it hands the optimizer of the embedding and
    head."""
    lm, towers = _model(case)
    tc = TrainConfig(**STEP_KW)
    state = init_train_state(lm, towers, tc)
    batch = {k: [torch.from_numpy(np.asarray(x)) for x in v] if isinstance(v, list)
             else torch.from_numpy(np.asarray(v)) for k, v in case["batches"][0].items()}
    grads = {}
    optimizer_step = state.optimizer.step

    def capture(g):
        grads.update({n: t.clone() for n, t in g.items()
                      if n.split(".")[0] in ("embed_tokens", "lm_head")})
        return optimizer_step(g)

    state.optimizer.step = capture
    _, metrics = make_train_step(lm, towers, freeze=tc)(state, batch)
    return dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]), grads=grads)


def _plain_serve(case, model):
    lm, towers = _model(model)
    engine = GenerationEngine(lm, towers, max_len=64, cache_dtype=torch.float32)
    ids, mask, pos = case["prompt"]
    gcfg = GenerationConfig(max_new_tokens=case["new_tokens"], temperature=0.0)
    return engine.generate(ids, mask, pos, None, None, gcfg)


def _tie_weights(model, prompt):
    """``model``'s weights with head rows ``TIE`` both set to a vector whose
    logit for row 0's last prompt token is about 40: the two slabs tie
    exactly there, far above every other logit."""
    lm, _ = _model(model)
    ids, mask, pos = prompt
    with torch.no_grad():
        hidden = lm.hidden_states(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                                  torch.from_numpy(pos).long())
    h = hidden[0, int(mask[0].sum()) - 1]
    sd = {k: v.clone() for k, v in model["sd"].items()}
    for row in TIE:
        sd["lm.lm_head.weight"][row] = 40.0 * h / h.dot(h)
    return dict(model, sd=sd)


@pytest.fixture(scope="module")
def vocab_run(tmp_path_factory):
    rng = np.random.default_rng(23)
    jtowers = build_vision_tower_aux_list(CFG.mm_vision_tower_aux_list,
                                          CFG.mm_vision_tower_aux_token_len_list)
    cfg = CambrianConfig.from_dict(CFG.to_dict())
    sd = random_state_dict(cfg, torch.Generator().manual_seed(23), 0.05,
                           dtype=torch.float32, device="cpu")
    sd515, cfg515 = initialize_vision_tokenizer(sd, _Tokenizer(), cfg, True, True)
    tied = cfg.replace(tie_word_embeddings=True)
    sd_tied = random_state_dict(tied, torch.Generator().manual_seed(24), 0.05,
                                dtype=torch.float32, device="cpu")
    watch = cfg.replace(vocab_size=WATCH_VOCAB, loss_chunk=WATCH_CHUNK)
    sd_watch = random_state_dict(watch, torch.Generator().manual_seed(25), 0.05,
                                 dtype=torch.float32, device="cpu")
    models = {
        "v512": dict(cfg=cfg.to_dict(), sd=sd),
        "v520": dict(cfg=watch.to_dict(), sd=sd_watch,
                     batches=_batches(CFG.replace(vocab_size=WATCH_VOCAB), jtowers, rng, 1)),
        "v515": dict(cfg=cfg515.to_dict(), sd=sd515,
                     batches=_batches(CFG.replace(vocab_size=515), jtowers, rng, 1)),
        "vtied": dict(cfg=tied.to_dict(), sd=sd_tied, batches=_batches(CFG, jtowers, rng, 1)),
    }
    loss = {}
    for name, (fields, dims, chunk) in LOSS_CASES.items():
        jcfg = CFG.replace(**fields)
        hidden, labels, head = _loss_inputs(rng, jcfg.vocab_size)
        loss[name] = dict(cfg=jcfg.to_dict(), mesh=dims, chunk=chunk, hidden=hidden,
                          labels=labels, head=head,
                          count=int((labels[:, 1:] != IGNORE_INDEX).sum()))
    ids = rng.integers(5, 512, (4, 12)).astype(np.int64)
    mask = np.ones(ids.shape, bool)
    mask[-1, 9:] = False                        # the last row is shorter
    prompt = (ids, mask, np.tile(np.arange(12), (4, 1)))
    models["vtie"] = _tie_weights(models["v512"], prompt)
    serve = {name: dict(model=model, mesh=dims, prompt=prompt, new_tokens=6)
             for name, model, dims in (("split", "v512", (1, 2, 2)),
                                       ("over_data", "v512", (2, 2, 1)),
                                       ("tied", "vtied", (1, 2, 2)),
                                       ("replicated_515", "v515", (1, 2, 2)),
                                       ("tie", "vtie", (1, 2, 2)))}
    tmp = tmp_path_factory.mktemp("vocab_parallel")
    payload = dict(models, layout_meshes=LAYOUT_MESHES, loss=loss, serve=serve,
                   train_kw=STEP_KW, out_dir=str(tmp / "out"))
    started = workers.start_ranks(workers.vocab_rank, 4, tmp, payload)
    want = dict(
        specs={(key, dims): _jax_specs(models[key]["cfg"]["vocab_size"], dims)
               for key in ("v512", "v515") for dims in LAYOUT_MESHES},
        loss={name: _jax_loss(CFG.replace(**LOSS_CASES[name][0]), c["hidden"], c["labels"],
                              c["head"], c["chunk"]) for name, c in loss.items()},
        steps={key: _plain_step(models[key]) for key in ("v520", "v515", "vtied")},
        serve={name: _plain_serve(c, models[c["model"]]) for name, c in serve.items()})
    ranks = workers.join_ranks(started, timeout=120)
    return dict(ranks=ranks, want=want, models=models, loss=loss, serve=serve)


@pytest.mark.parametrize("key", ["v512", "v515"])
@pytest.mark.parametrize("dims", LAYOUT_MESHES)
def test_layout_matches_jax(vocab_run, key, dims):
    """Spec, local shape and slab of the embedding and the head on every
    rank; neither is in an FSDP2 unit (which do manage the rest)."""
    vocab = vocab_run["models"][key]["cfg"]["vocab_size"]
    n = dims[1] * dims[2]
    split = vocab % n == 0
    want = vocab_run["want"]["specs"][(key, dims)]
    assert (want["embed_tokens.weight"] == (("model", "fsdp"), None)) == split
    sd = vocab_run["models"][key]["sd"]
    starts = set()
    for rank in vocab_run["ranks"]:
        got = rank["layout"][(key, dims)]
        assert got["n_managed"] > 0 and got["split"] == split
        for name in ("embed_tokens.weight", "lm_head.weight"):
            rec = got[name]
            assert rec["spec"] == want[name], (name, rec["spec"], want[name])
            assert rec["shape"] == (vocab, CFG.hidden_size) and not rec["in_unit"]
            rows = vocab // n if split else vocab
            assert rec["local"] == (rows, CFG.hidden_size)
            assert torch.equal(rec["slab"], sd[f"lm.{name}"][got["start"]:got["start"] + rows])
        starts.add(got["start"])
    # model-major: the (fsdp, model) rank (f, m) holds slab m * fsdp + f
    assert len(starts) == (n if split else 1)
    if split:
        coords = [(r // dims[2] % dims[1], r % dims[2]) for r in range(4)]
        for (f, m), rank in zip(coords, vocab_run["ranks"]):
            assert rank["layout"][(key, dims)]["start"] == (m * dims[1] + f) * (vocab // n)


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_loss_matches_jax(vocab_run, name):
    """The summed shares, ``dhidden`` of each rank's rows and the head's
    gradient on each rank's slab against JAX: the loss at LOSS_TOL, the
    gradients at LOSS_TOL and LOSS_TOL of their largest magnitude; under the
    bf16 head at one bf16 rounding, as both packages round the gradient of
    each bf16 operand (the port a slab's part of ``dhidden``)."""
    value, dh, dw = vocab_run["want"]["loss"][name]
    case = vocab_run["loss"][name]
    rtol = 2 ** -8 if name == "bf16_head" else LOSS_TOL
    got_dh = np.full(dh.shape, np.nan, np.float32)
    for rank in vocab_run["ranks"]:
        got = rank["loss"][name]
        np.testing.assert_allclose(got["loss"], value, rtol=LOSS_TOL)
        lo, hi = got["rows"]
        got_dh[lo:hi] = got["dhidden"].numpy()
        slab = got["dhead"].numpy()
        np.testing.assert_allclose(slab, dw[got["start"]:got["start"] + len(slab)],
                                   rtol=rtol, atol=rtol * np.abs(dw).max())
    np.testing.assert_allclose(got_dh, dh, rtol=rtol, atol=rtol * np.abs(dh).max())
    assert np.abs(dw).max() > 0 and case["count"] > 0


def test_no_whole_vocab_tensor_in_a_stage2_step(vocab_run):
    """A stage-2 step on (1,2,2), forward, backward and the optimizer: no
    op's output holds V x H elements or a last dimension of V on any rank."""
    for rank in vocab_run["ranks"]:
        watch = rank["watch"]
        assert watch["ops"] > 1000 and np.isfinite(rank["step_520"]["loss"])
        assert watch["seen"] == [], watch["seen"][:10]


@pytest.mark.parametrize("key", ["v520", "v515", "vtied"])
def test_step_matches_unsharded(vocab_run, key):
    """The sharded stage-2 step's loss and grad norm, and the gradients of
    the embedding and head it hands the optimizer (summed over data, and
    over fsdp where V = 515 is whole on each rank), as the unsharded port's
    (V = 520 split, 515 whole, a tied head): the loss at LOSS_TOL, the grad
    norm at tests/test_torch_parallel_train.py's GRAD_NORM_TOL, the
    gradients at LOSS_TOL of their largest magnitude."""
    want = vocab_run["want"]["steps"][key]
    assert set(want["grads"]) == ({"embed_tokens.weight"} if key == "vtied" else
                                  {"embed_tokens.weight", "lm_head.weight"})
    for rank in vocab_run["ranks"]:
        got = rank[f"step_{key[1:]}"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_TOL)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=GRAD_NORM_TOL)
        assert set(got["grads"]) == set(want["grads"])
        for name, g in want["grads"].items():
            g = g.numpy()
            assert np.abs(g).max() > 0, name
            np.testing.assert_allclose(got["grads"][name].numpy(), g, rtol=LOSS_TOL,
                                       atol=LOSS_TOL * np.abs(g).max(), err_msg=name)


@pytest.mark.parametrize("key, dims", [("520", (2, 2, 1)), ("515", (4, 1, 1))])
def test_checkpoint_restores_under_another_mesh(vocab_run, key, dims):
    """Saved under (1,2,2) after the step, restored under ``dims`` into a
    model of other weights: every parameter and optimizer leaf exactly, the
    embedding laid out as ``dims`` gives it."""
    for rank in vocab_run["ranks"]:
        got = rank[f"restored_{key}"]
        assert got["step"] == 1
        assert got["params"] == [] and got["optimizer"] == []
        assert got["n_params"] > 100 and got["n_optimizer"] > 100
        layout = got["layout"]
        assert layout["split"] and not layout["embed_tokens.weight"]["in_unit"]
        n = dims[1] * dims[2]
        assert layout["embed_tokens.weight"]["local"][0] == int(key) // n


@pytest.mark.parametrize("name", ["split", "over_data", "tied", "replicated_515", "tie"])
def test_sharded_greedy_tokens(vocab_run, name):
    """``generate`` and ``generate_stream`` on the mesh give the unsharded
    engine's greedy tokens on every rank; with rows split, each rank's first
    logits are its own rows over the whole vocab."""
    want = vocab_run["want"]["serve"][name]
    for rank in vocab_run["ranks"]:
        got = rank["serve"][name]
        np.testing.assert_array_equal(got["tokens"], want)
        np.testing.assert_array_equal(got["stream"], want)
        rows = got["rows"]
        n = 4 if rows is None else rows.stop - rows.start
        model = vocab_run["models"][vocab_run["serve"][name]["model"]]
        assert got["first_logits"].shape == (n, model["cfg"]["vocab_size"])


def test_planted_tie_goes_to_the_lower_index(vocab_run):
    """Head rows ``TIE`` (slabs 0 and 2) hold one vector: row 0's first
    logits tie exactly there, above every other, and greedy picks the lower
    index, as ``argmax`` over the whole row does."""
    lo, hi = TIE
    for rank in vocab_run["ranks"][:2]:          # the (1,2,2) ranks holding row 0
        got = rank["serve"]["tie"]
        assert got["rows"] == slice(0, 2)
        first = got["first_logits"][0]
        assert first[lo] == first[hi] and first[lo] == first.max()
        assert (first == first.max()).sum() == 2
        assert got["tokens"][0, 0] == lo
