"""The port's training path against the JAX package's, on the CPU in fp32:
the chunked cross-entropy, the optimizer (groups, freeze, decay mask,
clipping, schedules, bf16 first moment, gradient accumulation), the train
step over three steps of stage 1 and stage 2 with remat (and of stage 1 on
a tiny Cambrian-Gemma at head_dim 256), the data collator
and sampler, and ``train()`` end to end with checkpoint, resume and the HF
export. Inputs are made with numpy from a seed; weights are carried from the
JAX package through ``checkpoint/from_jax.py``. The tiny train step on the
card against the CPU is in tests/test_torch_flash_backward.py, which
collects without JAX."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, os.path.dirname(__file__))
from util import make_tiny_checkpoint  # noqa: E402

from cambrian_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX  # noqa: E402
from cambrian_tpu.data.packing import prepare_multimodal_data  # noqa: E402
from cambrian_tpu.models import cambrian as jcambrian  # noqa: E402
from cambrian_tpu.models.config import tiny_debug  # noqa: E402
from cambrian_tpu.models.encoders.base import build_vision_tower_aux_list  # noqa: E402
from cambrian_tpu.train import optimizer as joptim  # noqa: E402
from cambrian_tpu_torch.checkpoint.from_jax import state_dict_from_jax  # noqa: E402
from cambrian_tpu_torch.models import cambrian as tcambrian  # noqa: E402
from cambrian_tpu_torch.models.builder import CambrianForInference  # noqa: E402
from cambrian_tpu_torch.models.config import CambrianConfig  # noqa: E402
from cambrian_tpu_torch.train import optimizer as toptim  # noqa: E402
from cambrian_tpu_torch.train.train_step import init_train_state, make_train_step  # noqa: E402

TOL = 1e-5          # ops and the CE, fp32
LOSS_TOL = 1e-5     # per-step loss of the 3-step trajectories (relative)
PARAM_TOL = 2e-5    # parameters after 3 Adam steps at lr <= 1e-3 (absolute)


def _port_cfg(jcfg):
    return CambrianConfig.from_dict(jcfg.to_dict())


# -- chunked cross-entropy -----------------------------------------------------

@pytest.mark.parametrize("head_trains", [True, False])
@pytest.mark.parametrize("tied", [False, True])
def test_chunked_cross_entropy_matches_jax(tied, head_trains):
    jcfg = tiny_debug(1).replace(vocab_size=50, hidden_size=16, tie_word_embeddings=tied)
    cfg = _port_cfg(jcfg)
    rng = np.random.default_rng(3)
    b, s, h, v = 2, 37, 16, 50
    hidden = rng.standard_normal((b, s, h), dtype=np.float32)
    head = rng.standard_normal((v, h), dtype=np.float32) * 0.3     # the port's [V, H]
    labels = rng.integers(0, v, (b, s))
    labels[0, :5] = IGNORE_INDEX
    labels[1, -7:] = IGNORE_INDEX
    jhead = head if tied else head.T                                # JAX: kernel [H, V]

    def j_loss(hd, hid):
        return jcambrian.chunked_cross_entropy(
            hid, jnp.asarray(labels), lambda a, c: jcambrian.head_logits(jcfg, a, c), 8, hd)

    want, (want_dhead, want_dhid) = jax.value_and_grad(j_loss, argnums=(0, 1))(
        jnp.asarray(jhead), jnp.asarray(hidden))
    th = torch.from_numpy(hidden).requires_grad_(True)
    thead = torch.from_numpy(head).requires_grad_(head_trains)
    tlab = torch.from_numpy(labels)
    loss = tcambrian.chunked_cross_entropy(
        th, tlab, lambda a, c: tcambrian.head_logits(cfg, a, c), 8, thead)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want), rtol=TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(want_dhid), atol=TOL, rtol=TOL)
    if head_trains:
        dhead = np.asarray(want_dhead) if tied else np.asarray(want_dhead).T
        np.testing.assert_allclose(thead.grad.numpy(), dhead, atol=TOL, rtol=TOL)
    else:
        assert thead.grad is None
    # the same math as the whole-logits loss
    whole = tcambrian.cross_entropy_loss(tcambrian.head_logits(cfg, thead, th), tlab)
    np.testing.assert_allclose(float(whole), float(loss), rtol=TOL)


# -- optimizer -----------------------------------------------------------------

PARAM_SHAPES = {
    "mm_projector.fc1.weight": (6, 5),
    "mm_projector.fc1.bias": (6,),
    "mm_projector_aux_0.ln.weight": (5,),
    "vision_query": (1, 5),
    "image_newline": (5,),
    "vision_sampler_0.layers_0.proj_in.weight": (4, 5),
    "vision_sampler_0.layers_0.pos_embed_1": (4, 4),
    "vision_sampler_layers_1.layers_0.norm.bias": (4,),
    "layers_0.mlp.up_proj.weight": (7, 5),
    "layers_0.input_layernorm.weight": (5,),
    "lm_head.weight": (9, 5),
    "vision_towers.0.module.blocks_0.mlp.fc1.weight": (3, 4),
    "vision_towers.0.module.blocks_0.mlp.fc1.bias": (3,),
}

OPT_CONFIGS = {
    # every trainable group, clipping, warmup then cosine, bf16 first moment
    "four_groups": dict(unfreeze_mm_vision_tower=True, weight_decay=0.1, max_grad_norm=0.5,
                        warmup_ratio=0.34, total_steps=3, lr_scheduler_type="cosine",
                        adam_mu_dtype="bfloat16", learning_rate=1e-2, mm_projector_lr=2e-2,
                        mm_vision_sampler_lr=5e-3, mm_vision_tower_lr=3e-3),
    # stage 1: decoder and towers frozen; linear schedule, no clipping
    "stage1_frozen": dict(tune_mm_mlp_adapter=True, weight_decay=0.05, max_grad_norm=100.0,
                          warmup_ratio=0.0, total_steps=3, lr_scheduler_type="linear",
                          learning_rate=1e-2),
    "freeze_backbone": dict(freeze_backbone=True, weight_decay=0.0, max_grad_norm=1.0,
                            warmup_ratio=0.5, total_steps=3, lr_scheduler_type="constant",
                            learning_rate=1e-2),
}


def _nest(flat):
    tree = {}
    for name, value in flat.items():
        node = tree
        *head, leaf = name.split(".")
        for part in head:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("name", sorted(OPT_CONFIGS))
def test_optimizer_matches_optax(name):
    rng = np.random.default_rng(len(name))
    init = {k: rng.standard_normal(s, dtype=np.float32) for k, s in PARAM_SHAPES.items()}
    grads = [{k: rng.standard_normal(s, dtype=np.float32) * (0.3 + i)
              for k, s in PARAM_SHAPES.items()} for i in range(3)]
    jcfg = joptim.TrainConfig(**OPT_CONFIGS[name])
    cfg = toptim.TrainConfig(**OPT_CONFIGS[name])

    jparams = _nest({k: jnp.asarray(v) for k, v in init.items()})
    tx, jlabels = joptim.build_optimizer(jparams, jcfg)
    jstate = tx.init(jparams)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt, labels = toptim.build_optimizer(params, cfg)
    assert labels == _flat(jlabels)
    assert {k for k, p in params.items() if p.requires_grad} == set(opt.params)
    for g in grads:
        # frozen gradients are zero, as JAX make_train_step's stop_gradient
        # makes them, so that both clip the trainable gradients' norm
        jg = {k: jnp.asarray(v if labels[k] != "frozen" else np.zeros_like(v))
              for k, v in g.items()}
        updates, jstate = tx.update(_nest(jg), jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        assert opt.step({k: torch.from_numpy(g[k]) for k in opt.params})
    want = _flat(jparams)
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k], atol=1e-6, rtol=1e-6, err_msg=k)
        if labels[k] == "frozen":
            np.testing.assert_array_equal(p.detach().numpy(), init[k])


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("warmup_ratio", [0.0, 0.25])
def test_schedule_matches_optax(kind, warmup_ratio):
    kw = dict(lr_scheduler_type=kind, warmup_ratio=warmup_ratio, total_steps=8)
    jsched = joptim._schedule(3e-3, joptim.TrainConfig(**kw))
    tsched = toptim._schedule(3e-3, toptim.TrainConfig(**kw))
    # optax evaluates in fp32 and the port in double: 1 + cos near the end
    # of the cosine cancels, so fp32 keeps about 1e-6 of the value there
    for count in range(11):
        np.testing.assert_allclose(tsched(count), float(jsched(count)), rtol=1e-5, atol=1e-12)
    if warmup_ratio == 0.0:
        assert tsched(0) == pytest.approx(3e-3)     # no warmup: lr(0) = peak


def test_gradient_accumulation_matches_multisteps():
    """k micro-batches give one optimizer step on their running mean
    (optax.MultiSteps), and the schedule counts optimizer steps: after
    total_steps * k micro-batches the count is total_steps and the cosine
    has reached its end."""
    k, opt_steps = 4, 3
    kw = dict(learning_rate=1e-2, lr_scheduler_type="cosine", warmup_ratio=0.34,
              total_steps=opt_steps, weight_decay=0.01)
    rng = np.random.default_rng(11)
    shapes = {"layers_0.mlp.up_proj.weight": (4, 4), "layers_0.mlp.up_proj.bias": (4,)}
    init = {n: rng.standard_normal(s, dtype=np.float32) for n, s in shapes.items()}
    jparams = _nest({n: jnp.asarray(v) for n, v in init.items()})
    tx, _ = joptim.build_optimizer(jparams, joptim.TrainConfig(**kw))
    mtx = optax.MultiSteps(tx, k)
    jstate = mtx.init(jparams)
    params = {n: torch.nn.Parameter(torch.from_numpy(v.copy())) for n, v in init.items()}
    opt, _ = toptim.build_optimizer(params, toptim.TrainConfig(**kw), accumulate=k)
    for i in range(opt_steps * k):
        g = {n: rng.standard_normal(s, dtype=np.float32) * 0.2 for n, s in shapes.items()}
        updates, jstate = mtx.update(_nest({n: jnp.asarray(v) for n, v in g.items()}), jstate,
                                     jparams)
        jparams = optax.apply_updates(jparams, updates)
        assert opt.step({n: torch.from_numpy(v) for n, v in g.items()}) == ((i + 1) % k == 0)
        want = _flat(jparams)
        for n, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), want[n], atol=1e-6, rtol=1e-6)
    assert opt.count == opt_steps and opt.mini_step == 0
    assert toptim._schedule(kw["learning_rate"], toptim.TrainConfig(**kw))(opt_steps) <= 1e-9


def test_cast_frozen_params_keeps_norms_and_trainables_fp32():
    cfg = toptim.TrainConfig(tune_mm_mlp_adapter=True)
    params = {k: torch.nn.Parameter(torch.zeros(s)) for k, s in PARAM_SHAPES.items()}
    toptim.cast_frozen_params(params, cfg)
    labels = toptim.label_params(params, cfg)
    for k, p in params.items():
        frozen_matrix = labels[k] == "frozen" and not toptim.is_norm_param(k)
        assert p.dtype == (torch.bfloat16 if frozen_matrix else torch.float32), k
    assert params["lm_head.weight"].dtype == torch.bfloat16
    assert params["layers_0.input_layernorm.weight"].dtype == torch.float32


# -- train step ------------------------------------------------------------------

def _perturb(tree, rng, scale):
    return jax.tree.map(
        lambda x: np.asarray(x) + scale * rng.standard_normal(x.shape).astype(np.float32), tree)


def _tiny_batches(cfg, towers, rng, n, b=2):
    """n packed batches of b samples: an image marker, a masked prompt,
    right padding in the second sample."""
    out = []
    for _ in range(n):
        seq = 150
        ids = rng.integers(5, cfg.vocab_size, (b, seq)).astype(np.int64)
        ids[:, cfg.image_position] = IMAGE_TOKEN_INDEX
        labels = ids.copy()
        labels[:, :30] = IGNORE_INDEX
        mask = np.ones((b, seq), bool)
        mask[1, 110:] = False
        ids[1, 110:] = 0
        labels[1, 110:] = IGNORE_INDEX
        pids, plab, pmask, ppos, aux = prepare_multimodal_data(
            ids, labels, mask, [(640, 360), (300, 500)][:b], cfg.image_token_len,
            cfg.mm_vision_tower_aux_token_len_list, cfg.tokenizer_model_max_length)
        images = [rng.standard_normal((b, 3, t.image_size, t.image_size), dtype=np.float32)
                  for t in towers]
        out.append(dict(input_ids=pids, labels=plab, attention_mask=pmask, position_ids=ppos,
                        aux_masks=list(aux), images=images))
    return out


def _to_torch(batch, device="cpu"):
    return {k: [torch.from_numpy(np.asarray(x)).to(device) for x in v] if isinstance(v, list)
            else torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


def _tiny_training(jcfg, seed=0):
    """JAX CambrianLM, towers, perturbed weights and three batches of 192
    slots (the decoder takes the flash branch) for ``jcfg``."""
    towers = build_vision_tower_aux_list(jcfg.mm_vision_tower_aux_list,
                                         jcfg.mm_vision_tower_aux_token_len_list)
    rng = np.random.default_rng(seed)
    batches = _tiny_batches(jcfg, towers, rng, 3)
    model = jcambrian.CambrianLM(jcfg, tuple(t.hidden_size for t in towers))
    b0 = batches[0]
    feats = [t.apply(t.init(jax.random.PRNGKey(i + 1)), jnp.asarray(px))
             for i, (t, px) in enumerate(zip(towers, b0["images"]))]
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(b0["input_ids"]),
                        jnp.asarray(b0["attention_mask"]), jnp.asarray(b0["position_ids"]),
                        feats, [jnp.asarray(m) for m in b0["aux_masks"]])
    params = {"params": _perturb(params["params"], rng, 0.02)}
    tower_params = [_perturb(t.init(jax.random.PRNGKey(i + 1)), rng, 0.05)
                    for i, t in enumerate(towers)]
    return dict(jcfg=jcfg, towers=towers, model=model, params=params,
                tower_params=tower_params, batches=batches)


@pytest.fixture(scope="module")
def tiny_training():
    """The tiny LLaMA Cambrian's training setup (``_tiny_training``)."""
    return _tiny_training(tiny_debug(num_towers=2).replace(tokenizer_model_max_length=192))


def _port_model(t, device="cpu"):
    sd = state_dict_from_jax(t["params"], prefix="lm.")
    for i, tp in enumerate(t["tower_params"]):
        sd.update(state_dict_from_jax(tp, prefix=f"towers.{i}.module."))
    m = CambrianForInference.from_state_dict(
        _port_cfg(t["jcfg"]), {k: v.to(device) for k, v in sd.items()}, torch.float32)
    return m.lm, m.towers


TRAIN_KW = dict(learning_rate=1e-3, mm_vision_sampler_lr=5e-4, warmup_ratio=0.34,
                total_steps=3, lr_scheduler_type="cosine", max_grad_norm=1.0)


def _trajectory_matches_jax(t, stage):
    """Three steps of the port's ``make_train_step`` against JAX
    ``make_train_step`` on ``t``'s model, weights and batches: losses, grad
    norms and the parameters after the steps; frozen ones unchanged."""
    from cambrian_tpu.train.train_step import init_train_state as j_init_state
    from cambrian_tpu.train.train_step import make_train_step as j_make_step

    kw = dict(TRAIN_KW, tune_mm_mlp_adapter=stage == 1)
    jtc = joptim.TrainConfig(**kw)
    jstate = j_init_state(t["params"], jtc)
    jstep = jax.jit(j_make_step(t["model"], t["towers"], freeze=jtc))

    lm, towers = _port_model(t)
    assert lm.cfg.remat
    before = {k: v.detach().clone() for k, v in lm.state_dict().items()}
    tc = toptim.TrainConfig(**kw)
    state = init_train_state(lm, towers, tc)
    step = make_train_step(lm, towers, freeze=tc)
    for i, batch in enumerate(t["batches"]):
        jbatch = {k: [jnp.asarray(x) for x in v] if isinstance(v, list) else jnp.asarray(v)
                  for k, v in batch.items()}
        jstate, jm = jstep(jstate, t["tower_params"], jbatch)
        state, m = step(state, _to_torch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_TOL,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4,
                                   err_msg=f"step {i}")
        assert m["step"] == int(jm["step"]) == i + 1
    want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    labels = toptim.label_params(dict(lm.named_parameters()), tc)
    n_frozen = 0
    for k, p in lm.named_parameters():
        assert p.grad is None, k
        if labels[k] == "frozen":
            n_frozen += 1
            assert not p.requires_grad
            torch.testing.assert_close(p.detach(), before[k], atol=0, rtol=0, msg=k)
        else:
            assert not torch.equal(p.detach(), before[k]), f"{k} did not train"
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), atol=PARAM_TOL,
                                   rtol=0, err_msg=k)
    assert (n_frozen > 0) == (stage == 1)
    for tw in towers:
        assert not any(p.requires_grad for p in tw.parameters())
    return lm


@pytest.mark.parametrize("stage", [1, 2])
def test_train_step_matches_jax(tiny_training, stage):
    _trajectory_matches_jax(tiny_training, stage)


def test_gemma_stage1_train_step_matches_jax():
    """A tiny Cambrian-Gemma (head_dim 256, K2's widest; tied embeddings,
    tanh GELU, Gemma's norm and normaliser; 2 layers) through three stage-1
    steps against JAX ``make_train_step``, as the LLaMA one above."""
    jcfg = tiny_debug(num_towers=2).replace(
        tokenizer_model_max_length=192, model_type="gemma", hidden_act="gelu_pytorch_tanh",
        head_dim=256, tie_word_embeddings=True, rms_norm_eps=1e-6, num_hidden_layers=2,
        num_of_vision_sampler_layers=1)
    lm = _trajectory_matches_jax(_tiny_training(jcfg, seed=1), stage=1)
    assert lm.layers_0.self_attn.q_proj.weight.shape[0] == 4 * 256 and "lm_head" not in dict(
        lm.named_parameters())


# -- data ------------------------------------------------------------------------

class _Tok:
    model_max_length = 64
    pad_token_id = 0
    padding_side = "right"


def _instances(rng):
    out = []
    for i, n in enumerate([30, 80, 20, 45]):
        ids = rng.integers(5, 400, n)
        labels = ids.copy()
        labels[: n // 3] = IGNORE_INDEX
        if i % 2 == 0:
            ids[3] = IMAGE_TOKEN_INDEX
            labels[3] = IGNORE_INDEX
        images = [rng.standard_normal((3, s, s), dtype=np.float32) for s in (32, 32)]
        out.append(dict(input_ids=ids, labels=labels, image_aux_list=images,
                        image_size=(50 + 10 * i, 40 + 7 * i)))
    return out


def test_collator_and_sampler_match_jax():
    from cambrian_tpu.data import dataset as jdata
    from cambrian_tpu_torch.data import dataset as tdata

    instances = _instances(np.random.default_rng(5))
    kw = dict(tokenizer=_Tok(), image_token_len=16, image_aux_token_len_list=[16, 64],
              image_position=5)
    want = jdata.DataCollatorForSupervisedDataset(**kw)(instances)
    got = tdata.DataCollatorForSupervisedDataset(**kw)(instances)
    assert sorted(got) == sorted(want)
    for k in want:
        for g, w in zip(got[k] if isinstance(got[k], list) else [got[k]],
                        want[k] if isinstance(want[k], list) else [want[k]]):
            np.testing.assert_array_equal(g, w, err_msg=k)
    lengths = [5, -7, 9, 3, -2, -11, 8, 4, -6, 12, 1, -3, 7]
    for by_modality in (False, True):
        j = jdata.LengthGroupedSampler(2, 2, lengths, generator=np.random.default_rng(9),
                                       group_by_modality=by_modality)
        t = tdata.LengthGroupedSampler(2, 2, lengths, generator=np.random.default_rng(9),
                                       group_by_modality=by_modality)
        assert list(iter(t)) == list(iter(j))


# -- train() end to end ------------------------------------------------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("torch_trainrun")
    ckpt = d / "base_ckpt"
    make_tiny_checkpoint(str(ckpt))
    img_dir = d / "images"
    img_dir.mkdir()
    Image.new("RGB", (64, 40), (200, 30, 40)).save(img_dir / "img0.jpg")
    records = [
        {"id": str(i), "image": "img0.jpg", "conversations": [
            {"from": "human", "value": "<image>\nWhat is in this image?"},
            {"from": "gpt", "value": "A cat sitting on a mat."},
        ]} if i % 2 == 0 else
        {"id": str(i), "conversations": [
            {"from": "human", "value": "What is a cat?"},
            {"from": "gpt", "value": "A cat is a small animal."},
        ]}
        for i in range(16)
    ]
    data_path = d / "train.jsonl"
    with open(data_path, "w") as f:
        for r in records[:8]:
            f.write(json.dumps(r) + "\n")
    data16 = d / "train16.jsonl"
    with open(data16, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    return d, str(ckpt), str(data_path), str(data16), str(img_dir)


def _train_args(ckpt, data_path, img_dir, out, **training):
    from cambrian_tpu_torch.train.train import DataArguments, ModelArguments
    from cambrian_tpu_torch.train.trainer import TrainingArguments

    model_args = ModelArguments(
        model_name_or_path=ckpt, version="llama_3",
        vision_tower_aux_list=json.dumps(["debug-tower-0", "debug-tower-1"]),
        vision_tower_aux_token_len_list=json.dumps([16, 64]), image_token_len=16,
        query_num_list=json.dumps([16]), connector_depth=2, num_of_vision_sampler_layers=2,
        stride_of_vision_sampler_layers=2, vision_hidden_size=64)
    data_args = DataArguments(data_path=data_path, image_folder=img_dir, image_position=5,
                              model_max_length=96)
    kw = dict(output_dir=out, num_train_epochs=2, per_device_train_batch_size=2,
              logging_steps=1, save_steps=3, learning_rate=1e-3, warmup_ratio=0.0,
              lr_scheduler_type="constant", bf16=False, dataloader_num_workers=2,
              device="cpu")
    kw.update(training)
    return model_args, data_args, TrainingArguments(**kw)


def test_dataset_items_match_jax(workdir):
    """The port's LazySupervisedDataset gives the JAX copy's items (ids,
    labels, per-tower pixels from the native image path) on a JSONL with an
    image and text-only records."""
    from transformers import AutoTokenizer

    from cambrian_tpu import conversation as jconv
    from cambrian_tpu.data import dataset as jdata
    from cambrian_tpu.models.encoders.base import build_vision_tower_aux_list as jtowers
    from cambrian_tpu_torch import conversation as tconv
    from cambrian_tpu_torch.data import dataset as tdata
    from cambrian_tpu_torch.models.encoders.base import build_vision_tower_aux_list as ttowers

    d, ckpt, data_path, _, img_dir = workdir
    names, lens = ["debug-tower-0", "debug-tower-1"], [16, 64]
    tok = AutoTokenizer.from_pretrained(ckpt)
    tok.model_max_length = 96
    tok.pad_token = tok.pad_token or tok.eos_token

    class Args:
        is_multimodal = True
        image_folder = img_dir

    jargs, targs = Args(), Args()
    jargs.image_processor_aux_list = [t.image_processor for t in jtowers(names, lens)]
    targs.image_processor_aux_list = [t.image_processor for t in ttowers(names, lens)]
    jconv.default_conversation = jconv.conv_templates["llama_3"]
    tconv.default_conversation = tconv.conv_templates["llama_3"]
    jds = jdata.LazySupervisedDataset(data_path, tok, jargs)
    tds = tdata.LazySupervisedDataset(data_path, tok, targs)
    assert len(tds) == len(jds) and tds.modality_lengths == jds.modality_lengths
    for i in range(len(jds)):
        want, got = jds[i], tds[i]
        assert sorted(got) == sorted(want) and got["image_size"] == want["image_size"]
        np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
        np.testing.assert_array_equal(got["labels"], want["labels"])
        for g, w in zip(got["image_aux_list"], want["image_aux_list"]):
            np.testing.assert_array_equal(g, w)


def test_train_entry_resume_and_export(workdir):
    from cambrian_tpu_torch.models.builder import load_pretrained_model
    from cambrian_tpu_torch.train.train import train

    d, ckpt, data_path, _, img_dir = workdir
    out = str(d / "out")
    history = train(*_train_args(ckpt, data_path, img_dir, out))
    # 8 records at batch 2: 4 optimizer steps an epoch, 2 epochs
    assert [h["step"] for h in history] == list(range(1, 9))
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in history)
    ckpts = sorted(os.listdir(os.path.join(out, "checkpoints")))
    assert ckpts == ["step_000000006.pt", "step_000000008.pt"]      # save_total_limit 2
    assert os.path.exists(os.path.join(out, "config.json"))

    # the HF export loads through the port's loader and holds the trained weights
    _, model, _, ctx = load_pretrained_model(out, device="cpu", dtype=torch.float32)
    assert ctx == 96 and model.config.image_token_len == 16
    final = torch.load(os.path.join(out, "checkpoints", ckpts[-1]), weights_only=True)
    assert final["step"] == 8
    exported = model.lm.state_dict()
    for name, st in final["optimizer"]["state"].items():
        torch.testing.assert_close(exported[name], st["master"], atol=0, rtol=0, msg=name)

    # resume continues the step count from the newest checkpoint
    history = train(*_train_args(ckpt, data_path, img_dir, out, num_train_epochs=3,
                                 train_continue=True))
    assert [h["step"] for h in history] == [9, 10, 11, 12]
    assert all(np.isfinite(h["loss"]) for h in history)


def test_trainer_sizes_schedule_in_optimizer_steps(workdir, tmp_path):
    """With gradient_accumulation_steps=2 the trainer sizes total_steps, and
    the logged learning rate, in optimizer steps."""
    from cambrian_tpu_torch.train.train import train

    _, ckpt, _, data16, img_dir = workdir
    # 16 records at batch 8: 2 micro-batches an epoch; accumulation 2 gives
    # one optimizer step an epoch, two over two epochs
    model_args, data_args, args = _train_args(
        ckpt, data16, img_dir, str(tmp_path / "out_accum"), per_device_train_batch_size=8,
        gradient_accumulation_steps=2, lr_scheduler_type="cosine", save_steps=100)
    history = train(model_args, data_args, args)
    assert args.total_steps == 2
    assert [h["step"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert history[0]["lr"] == pytest.approx(args.learning_rate, rel=1e-6)
    assert history[1]["lr"] == pytest.approx(args.learning_rate / 2, rel=1e-6)


def test_pretrain_mm_mlp_adapter_loads_a_stage1_dump(tmp_path):
    """``--pretrain_mm_mlp_adapter``: a connector-only ``torch.save`` dump of
    HF-named tensors sets the connector and nothing else; a full checkpoint
    directory (the HF export) sets every tensor, as the JAX loader does."""
    from safetensors.numpy import load_file

    from cambrian_tpu_torch import tiny_debug as t_tiny
    from cambrian_tpu_torch.checkpoint.from_jax import load_state_dict_checked
    from cambrian_tpu_torch.checkpoint.save import save_pretrained
    from cambrian_tpu_torch.models.builder import build_modules
    from cambrian_tpu_torch.train.train import _init_params, load_pretrain_mm_mlp_adapter

    cfg = t_tiny(2)

    def model(seed):
        with torch.device("meta"):
            lm, towers = build_modules(cfg, torch.float32)
        load_state_dict_checked(lm, _init_params(lm, seed), assign=True)
        return lm, len(towers)

    src, n_towers = model(0)
    save_pretrained(src, cfg, str(tmp_path / "full"))
    hf = load_file(str(tmp_path / "full" / "model.safetensors"))
    keys = ("mm_projector", "vision_sampler", "vision_query", "image_newline")
    torch.save({k: torch.from_numpy(v) for k, v in hf.items() if any(s in k for s in keys)},
               tmp_path / "mm_projector.bin")
    want = src.state_dict()

    dst, _ = model(1)
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    loaded = load_pretrain_mm_mlp_adapter(dst, str(tmp_path / "mm_projector.bin"), n_towers)
    assert {"vision_query", "image_newline", "vision_sampler_0",
            "mm_projector_aux_0"} <= set(loaded)
    assert not any(k.startswith(("layers_", "embed", "lm_head")) for k in loaded)
    for k, v in dst.state_dict().items():
        ref = want[k] if k.split(".")[0] in loaded else before[k]
        torch.testing.assert_close(v, ref, atol=0, rtol=0, msg=k)

    full, _ = model(2)
    load_pretrain_mm_mlp_adapter(full, str(tmp_path / "full"), n_towers)
    for k, v in full.state_dict().items():
        torch.testing.assert_close(v, want[k], atol=0, rtol=0, msg=k)


def test_many_devices_are_refused(workdir):
    """More than one device raises until multi-GPU training is ported (LoRA
    trains: tests/test_torch_lora.py); and the launch script's flags parse."""
    from cambrian_tpu_torch.train.train import parse_args, train

    d, ckpt, data_path, _, img_dir = workdir
    with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
        train(*_train_args(ckpt, data_path, img_dir, str(d / "out_mesh"), mesh_fsdp=2))
    # the launch script's spelling of booleans and lists
    model_args, data_args, args = parse_args([
        "--model_name_or_path", ckpt, "--tune_mm_mlp_adapter", "True", "--bf16", "False",
        "--query_num_list", "[16]", "--per_device_train_batch_size", "8",
        "--learning_rate", "1e-3", "--group_by_modality_length", "--warmup_ratio", "0.06"])
    assert args.tune_mm_mlp_adapter is True and args.bf16 is False
    assert args.group_by_modality_length is True and args.per_device_train_batch_size == 8
    assert args.learning_rate == 1e-3 and model_args.query_num_list == "[16]"
    assert args.device == "cuda" and data_args.model_max_length == 2048

