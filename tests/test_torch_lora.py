"""The port's LoRA (cambrian_tpu_torch/train/lora.py and the LoRA train step)
against the JAX package's (cambrian_tpu/train/lora.py, make_lora_train_step),
on the CPU in fp32: the targeted projections, the identity of a zero b, the
merged weights and logits given the same adapters, the adapter file across
the two packages, the optimizer's labels of an adapter tree, a 3-step
trajectory, and ``train()`` with ``--lora_enable`` end to end. Adapters are
made with numpy (or by the JAX package) and handed to both; the weights
cross through ``checkpoint/from_jax.py``."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_train import (  # noqa: F401  (tiny_training, workdir: fixtures)
    TRAIN_KW,
    _port_model,
    _to_torch,
    _train_args,
    tiny_training,
    workdir,
)

from cambrian_tpu.train import lora as jlora  # noqa: E402
from cambrian_tpu.train import optimizer as joptim  # noqa: E402
from cambrian_tpu_torch.checkpoint import safetensors_io  # noqa: E402
from cambrian_tpu_torch.checkpoint.from_jax import state_dict_from_jax  # noqa: E402
from cambrian_tpu_torch.train import lora as tlora  # noqa: E402
from cambrian_tpu_torch.train import optimizer as toptim  # noqa: E402
from cambrian_tpu_torch.train.train_step import (  # noqa: E402
    init_lora_train_state,
    make_lora_train_step,
)

RANK, ALPHA = 4, 8
WEIGHT_TOL = 1e-6   # merged weights: the same fp32 product and sum
LOGIT_TOL = 1e-4    # logits after the whole decoder, fp32
LOSS_TOL = 1e-5     # per-step loss of the 3-step trajectories (relative)
NORM_TOL = 1e-4     # per-step gradient norm (relative)
ADAPTER_TOL = 2e-5  # adapters after 3 Adam steps at lr <= 1e-3 (absolute)


def _numpy_adapters(jadapters, seed, scale=0.01):
    """The JAX adapter tree as numpy, b nudged off zero so that a and b both
    get gradients and the merge is not the identity."""
    rng = np.random.default_rng(seed)
    return {k: {p: np.asarray(x) + scale * rng.standard_normal(x.shape).astype(np.float32)
                for p, x in ad.items()} for k, ad in jadapters.items()}


def _port_adapters(nadapters):
    return {k: {p: torch.from_numpy(np.array(x)) for p, x in ad.items()}
            for k, ad in nadapters.items()}


def _forward_args(t, batch):
    tb = _to_torch(batch)
    return tb, (tb["input_ids"], tb["attention_mask"], tb["position_ids"])


def test_targets_match_jax(tiny_training):
    """The port targets the projections whose kernels the JAX package
    targets: the decoder's seven and the SVA samplers' (substring match),
    with [in, r] / [r, out] factors, b zero."""
    t = tiny_training
    jad = jlora.init_lora_params(t["params"], RANK, jax.random.PRNGKey(1))
    lm, _ = _port_model(t)
    ad = tlora.init_lora_params(lm, RANK, torch.Generator().manual_seed(1))
    assert sorted(ad) == sorted(jad)
    assert any("vision_sampler" in k for k in ad) and any("layers_0/mlp" in k for k in ad)
    for k, a in ad.items():
        assert tuple(a["a"].shape) == jad[k]["a"].shape
        assert tuple(a["b"].shape) == jad[k]["b"].shape and not a["b"].any()
        assert a["a"].dtype == a["b"].dtype == torch.float32
        assert tlora.weight_name(k) in dict(lm.named_parameters())
    assert tlora.DEFAULT_TARGETS == jlora.DEFAULT_TARGETS


def test_zero_b_is_identity(tiny_training):
    """b = 0: the merged weights are the base's bit for bit, and so are the
    logits of the merged forward."""
    t = tiny_training
    lm, towers = _port_model(t)
    ad = tlora.init_lora_params(lm, RANK, torch.Generator().manual_seed(2))
    sd = lm.state_dict()
    merged = tlora.apply_lora(sd, ad, ALPHA, RANK)
    for k, v in sd.items():
        torch.testing.assert_close(merged[k], v, atol=0, rtol=0, msg=k)
    tb, args = _forward_args(t, t["batches"][0])
    with torch.no_grad():
        feats = [tw(px) for tw, px in zip(towers, tb["images"])]
        want = lm(*args, feats, tb["aux_masks"])
        with tlora.lora_merged(lm, ad, ALPHA, RANK):
            got = lm(*args, feats, tb["aux_masks"])
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_merged_weights_and_logits_match_jax(tiny_training):
    """Given the same numpy adapters, ``apply_lora`` gives JAX
    ``apply_lora``'s weights, ``merge_lora`` folds the same into the model,
    and the merged forward (in the loss, and after the fold) gives JAX's
    logits on the merged tree."""
    t = tiny_training
    nad = _numpy_adapters(jlora.init_lora_params(t["params"], RANK, jax.random.PRNGKey(3)), 4)
    jmerged = jlora.apply_lora(t["params"], jax.tree.map(jnp.asarray, nad), ALPHA, RANK)
    want_sd = state_dict_from_jax(jax.tree.map(np.asarray, jmerged))
    lm, towers = _port_model(t)
    ad = _port_adapters(nad)
    got_sd = tlora.apply_lora(lm.state_dict(), ad, ALPHA, RANK)
    changed = 0
    for k, v in want_sd.items():
        np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(), atol=WEIGHT_TOL, rtol=0,
                                   err_msg=k)
        changed += not torch.equal(got_sd[k], lm.state_dict()[k])
    assert changed == len(ad)

    batch = t["batches"][0]
    feats = [tw.apply(tp, jnp.asarray(px))
             for tw, tp, px in zip(t["towers"], t["tower_params"], batch["images"])]
    want = np.asarray(t["model"].apply(
        jmerged, jnp.asarray(batch["input_ids"]), jnp.asarray(batch["attention_mask"]),
        jnp.asarray(batch["position_ids"]), feats, [jnp.asarray(m) for m in batch["aux_masks"]]))
    tb, args = _forward_args(t, batch)
    with torch.no_grad():
        tfeats = [tw(px) for tw, px in zip(towers, tb["images"])]
        with tlora.lora_merged(lm, ad, ALPHA, RANK):
            got = lm(*args, tfeats, tb["aux_masks"])
        tlora.merge_lora(lm, ad, ALPHA, RANK)
        folded = lm(*args, tfeats, tb["aux_masks"])
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(folded.numpy(), want, atol=LOGIT_TOL, rtol=0)
    for k, v in lm.state_dict().items():
        torch.testing.assert_close(v, got_sd[k], atol=0, rtol=0, msg=k)


def test_adapter_file_round_trips_across_packages(tiny_training, tmp_path):
    """A file the port writes (its own safetensors writer) loads in the JAX
    package (``safetensors.numpy`` and ``lora_from_state_dict``), and one
    the JAX package writes loads in the port, to the same factors and the
    same merged weights, under JAX's key names."""
    from safetensors.numpy import load_file, save_file

    t = tiny_training
    nad = _numpy_adapters(jlora.init_lora_params(t["params"], RANK, jax.random.PRNGKey(5)), 6)
    ad = _port_adapters(nad)
    port_file = str(tmp_path / "port.safetensors")
    safetensors_io.save_file(tlora.lora_state_dict(ad), port_file)
    raw = load_file(port_file)
    assert set(raw) == set(jlora.lora_state_dict(nad))
    assert sorted(raw) == sorted(f"{k}.lora_{p}" for k in nad for p in "ab")
    back = jlora.lora_from_state_dict(raw)
    jax_file = str(tmp_path / "jax.safetensors")
    save_file(jlora.lora_state_dict(back), jax_file)
    again = tlora.lora_from_state_dict(safetensors_io.load_file(jax_file))
    assert sorted(back) == sorted(again) == sorted(nad)
    for k in nad:
        for p in "ab":
            np.testing.assert_array_equal(np.asarray(back[k][p]), nad[k][p])
            np.testing.assert_array_equal(again[k][p].numpy(), nad[k][p])
    lm, _ = _port_model(t)
    sd = lm.state_dict()
    want = state_dict_from_jax(jax.tree.map(np.asarray, jlora.merge_lora(
        t["params"], back, ALPHA, RANK)))
    got = tlora.apply_lora(sd, again, ALPHA, RANK)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=WEIGHT_TOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("policy", ["default", "tune_mm_mlp_adapter", "freeze_backbone"])
def test_adapter_labels_match_jax(tiny_training, policy):
    """The optimizer's labels of the adapter tree equal JAX ``label_params``
    on its adapter tree: under ``tune_mm_mlp_adapter`` (and
    ``freeze_backbone``) the decoder's adapters are frozen, the samplers'
    train in their group."""
    t = tiny_training
    kw = {} if policy == "default" else {policy: True}
    jad = jlora.init_lora_params(t["params"], RANK, jax.random.PRNGKey(1))
    jlabels = joptim.label_params(jad, joptim.TrainConfig(**kw))
    want = {f"{k}/{p}": jlabels[k][p] for k in jad for p in ("a", "b")}
    lm, _ = _port_model(t)
    ad = tlora.init_lora_params(lm, RANK, torch.Generator().manual_seed(1))
    got = toptim.label_params(tlora.flat_adapters(ad), toptim.TrainConfig(**kw))
    assert got == want
    groups = set(got.values())
    assert groups == ({"base", "vision_sampler"} if policy == "default"
                      else {"frozen", "vision_sampler"})


@pytest.mark.parametrize("policy", ["default", "tune_mm_mlp_adapter"])
def test_lora_train_step_matches_jax(tiny_training, policy):
    """Three steps of ``make_lora_train_step`` against JAX
    ``make_lora_train_step`` from the same adapters and batches: loss, the
    norm over every adapter's gradient (the clip's, frozen adapters
    included), and the adapters after the steps; the frozen adapters and
    the base model do not move."""
    from cambrian_tpu.train.train_step import init_train_state as j_init_state
    from cambrian_tpu.train.train_step import make_lora_train_step as j_make_step

    t = tiny_training
    kw = dict(TRAIN_KW, tune_mm_mlp_adapter=policy == "tune_mm_mlp_adapter")
    nad = _numpy_adapters(jlora.init_lora_params(t["params"], RANK, jax.random.PRNGKey(7)), 8)
    jstate = j_init_state(jax.tree.map(jnp.asarray, nad), joptim.TrainConfig(**kw))
    jstep = jax.jit(j_make_step(t["model"], t["towers"], t["params"], ALPHA, RANK))

    lm, towers = _port_model(t)
    base = {k: v.detach().clone() for k, v in lm.state_dict().items()}
    ad = _port_adapters(nad)
    tc = toptim.TrainConfig(**kw)
    state = init_lora_train_state(ad, tc)
    step = make_lora_train_step(lm, towers, ad, ALPHA, RANK)
    for i, batch in enumerate(t["batches"]):
        jbatch = {k: [jnp.asarray(x) for x in v] if isinstance(v, list) else jnp.asarray(v)
                  for k, v in batch.items()}
        jstate, jm = jstep(jstate, t["tower_params"], jbatch)
        state, m = step(state, _to_torch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_TOL,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=NORM_TOL,
                                   err_msg=f"step {i}")
        assert m["step"] == int(jm["step"]) == i + 1
    labels = toptim.label_params(tlora.flat_adapters(ad), tc)
    for k in nad:
        for p in "ab":
            got, want = ad[k][p].detach(), np.asarray(jstate.params[k][p])
            np.testing.assert_allclose(got.numpy(), want, atol=ADAPTER_TOL, rtol=0,
                                       err_msg=f"{k}/{p}")
            moved = not np.array_equal(got.numpy(), nad[k][p])
            assert moved == (labels[f"{k}/{p}"] != "frozen"), f"{k}/{p}"
    for k, v in lm.state_dict().items():
        torch.testing.assert_close(v, base[k], atol=0, rtol=0, msg=k)
    assert all(p.grad is None and not p.requires_grad for p in lm.parameters())
    assert not any(p.requires_grad for tw in towers for p in tw.parameters())


def test_train_entry_lora_writes_adapters_and_merged_export(workdir):
    """``train()`` with ``--lora_enable``: the adapters file under JAX's key
    names, the HF export equal to ``merge_lora(base, adapters)``, resume
    from the newest checkpoint, and ``lora_weight_path`` loading a file."""
    from cambrian_tpu_torch.models.builder import load_pretrained_model
    from cambrian_tpu_torch.train.train import train

    d, ckpt, data_path, _, img_dir = workdir
    out = str(d / "out_lora")
    kw = dict(lora_enable=True, lora_r=RANK, lora_alpha=ALPHA, learning_rate=1e-2)

    def run(out, **training):
        # room for the llama_3 prompts, so that every batch has supervision
        model_args, data_args, args = _train_args(ckpt, data_path, img_dir, out, **training)
        data_args.model_max_length = 512
        return train(model_args, data_args, args)

    history = run(out, num_train_epochs=1, **kw)
    assert [h["step"] for h in history] == [1, 2, 3, 4]
    assert all(np.isfinite(h["loss"]) and h["loss"] > 0 and h["grad_norm"] > 0
               for h in history)
    path = os.path.join(out, "lora_adapters.safetensors")
    ad = tlora.lora_from_state_dict(safetensors_io.load_file(path))
    _, base, _, _ = load_pretrained_model(ckpt, device="cpu", dtype=torch.float32)
    assert sorted(ad) == sorted(tlora.lora_targets(base.lm))
    assert any(p["b"].any() for p in ad.values())
    want = tlora.apply_lora(base.lm.state_dict(), ad, ALPHA, RANK)
    _, exported, _, _ = load_pretrained_model(out, device="cpu", dtype=torch.float32)
    changed = 0
    for k, v in exported.lm.state_dict().items():
        torch.testing.assert_close(v, want[k], atol=0, rtol=0, msg=k)
        changed += not torch.equal(v, base.lm.state_dict()[k])
    assert changed > 0

    # resume: the adapters and their optimizer state come back from the
    # checkpoint, and the step count goes on
    history = run(out, num_train_epochs=2, train_continue=True, **kw)
    assert [h["step"] for h in history] == [5, 6, 7, 8]
    resumed = tlora.lora_from_state_dict(safetensors_io.load_file(path))
    assert any(not torch.equal(resumed[k]["b"], p["b"]) for k, p in ad.items())

    # lora_weight_path: the adapters start from the file (and, every group's
    # learning rate 0, end there)
    out2 = str(d / "out_lora_from_file")
    run(out2, num_train_epochs=1, max_steps=1, lora_weight_path=path,
        **dict(kw, learning_rate=0.0, mm_vision_sampler_lr=0.0))
    again = tlora.lora_from_state_dict(
        safetensors_io.load_file(os.path.join(out2, "lora_adapters.safetensors")))
    for k, p in resumed.items():
        for part in "ab":
            torch.testing.assert_close(again[k][part], p[part], atol=0, rtol=0)
