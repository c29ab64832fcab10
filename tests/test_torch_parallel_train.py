"""The port's sharded training against the JAX package's, on the CPU: four
gloo processes (tests/torch_parallel_workers.py) train a tiny Cambrian for
three steps of stage 1 and of stage 2 on meshes (1,2,2) (tensor parallelism
and FSDP2) and (2,2,1) (HSDP), from the weights and global batches the JAX
``make_train_step`` steps on its (2,2,2) mesh, and are held to it at
tests/test_torch_train.py's tolerances. The batch's rows hold unequal
numbers of valid tokens, so every rank's share of the global normaliser
differs. Then a DCP checkpoint saved under (1,2,2) restores exactly under
(4,1,1) and (2,1,2), and ``consolidate`` writes an HF checkpoint that both
packages' ``load_pretrained_model`` read. One spawn runs every check."""

import concurrent.futures
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_workers as workers  # noqa: E402
from test_torch_train import LOSS_TOL, PARAM_TOL, TRAIN_KW, _perturb  # noqa: E402

from cambrian_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX  # noqa: E402
from cambrian_tpu.data.packing import prepare_multimodal_data  # noqa: E402
from cambrian_tpu.models import cambrian as jcambrian  # noqa: E402
from cambrian_tpu.models.config import tiny_debug  # noqa: E402
from cambrian_tpu.models.encoders.base import build_vision_tower_aux_list  # noqa: E402
from cambrian_tpu.parallel.mesh import MeshConfig, create_mesh  # noqa: E402
from cambrian_tpu.parallel.sharding import infer_param_shardings  # noqa: E402
from cambrian_tpu.train import optimizer as joptim  # noqa: E402
from cambrian_tpu.train import train_step as jtrain  # noqa: E402
from cambrian_tpu_torch.checkpoint.from_jax import state_dict_from_jax  # noqa: E402
from cambrian_tpu_torch.train import optimizer as toptim  # noqa: E402

# the tiny Cambrian at half its decoder depth (2 layers, one in-LLM SVA
# sampler): the JAX sharded compiles dominate this file's time
CFG = tiny_debug(num_towers=2).replace(tokenizer_model_max_length=192, num_hidden_layers=2,
                                       num_of_vision_sampler_layers=1)
MESHES = [(1, 2, 2), (2, 2, 1)]
RESTORE_MESHES = [(4, 1, 1), (2, 1, 2)]
ROW_ENDS = [150, 110, 70, 130]      # each row's valid length: unequal counts per rank
GRAD_NORM_TOL = 1e-4                # as tests/test_torch_train.py holds the grad norms


def _batches(cfg, towers, rng, n):
    b = len(ROW_ENDS)
    out = []
    for _ in range(n):
        ids = rng.integers(5, cfg.vocab_size, (b, 150)).astype(np.int64)
        ids[:, cfg.image_position] = IMAGE_TOKEN_INDEX
        labels = ids.copy()
        labels[:, :30] = IGNORE_INDEX
        mask = np.ones(ids.shape, bool)
        for r, end in enumerate(ROW_ENDS):
            mask[r, end:] = False
            ids[r, end:] = 0
            labels[r, end:] = IGNORE_INDEX
        pids, plab, pmask, ppos, aux = prepare_multimodal_data(
            ids, labels, mask, [(640, 360), (300, 500)] * (b // 2), cfg.image_token_len,
            cfg.mm_vision_tower_aux_token_len_list, cfg.tokenizer_model_max_length)
        images = [rng.standard_normal((b, 3, t.image_size, t.image_size), dtype=np.float32)
                  for t in towers]
        out.append(dict(input_ids=pids, labels=plab, attention_mask=pmask, position_ids=ppos,
                        aux_masks=list(aux), images=images))
    return out


def _jax_trajectories(model, towers, params, tower_params, batches):
    """JAX make_train_step on its (2,2,2) mesh: {stage: (losses, grad
    norms, final params)}."""
    mesh = create_mesh(MeshConfig(data=2, fsdp=2, model=2), devices=jax.devices()[:8])
    out = {}
    for stage in (1, 2):
        jtc = joptim.TrainConfig(**dict(TRAIN_KW, tune_mm_mlp_adapter=stage == 1))
        state = jtrain.init_train_state(params, jtc)
        state_sh = jtrain.state_shardings(state, mesh)
        tower_sh = [infer_param_shardings(tp, mesh) for tp in tower_params]
        batch_sh = jtrain.batch_shardings(mesh, num_towers=len(towers))
        losses, norms = [], []
        with jax.set_mesh(mesh):
            step = jax.jit(jtrain.make_train_step(model, towers, freeze=jtc),
                           in_shardings=(state_sh, tower_sh, batch_sh),
                           out_shardings=(state_sh, None))
            state = jax.device_put(state, state_sh)
            tps = [jax.device_put(tp, sh) for tp, sh in zip(tower_params, tower_sh)]
            for batch in batches:
                jb = {k: [jnp.asarray(x) for x in v] if isinstance(v, list) else jnp.asarray(v)
                      for k, v in batch.items()}
                state, m = step(state, tps, jax.device_put(jb, batch_sh))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        out[stage] = (losses, norms, state_dict_from_jax(jax.device_get(state.params)))
    return out


@pytest.fixture(scope="module")
def sharded_run(tmp_path_factory):
    """The JAX references, and one spawn of four ranks doing every port
    side of this file."""
    jcfg = CFG
    towers = build_vision_tower_aux_list(jcfg.mm_vision_tower_aux_list,
                                         jcfg.mm_vision_tower_aux_token_len_list)
    rng = np.random.default_rng(21)
    batches = _batches(jcfg, towers, rng, 3)
    model = jcambrian.CambrianLM(jcfg, tuple(t.hidden_size for t in towers))
    b0 = batches[0]
    # the tower features' shapes are all the decoder's init needs
    feats = [jnp.zeros((len(ROW_ENDS), t.interp_size, t.hidden_size)) for t in towers]
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(b0["input_ids"]),
                                 jnp.asarray(b0["attention_mask"]),
                                 jnp.asarray(b0["position_ids"]), feats,
                                 [jnp.asarray(m) for m in b0["aux_masks"]])
    params = {"params": _perturb(params["params"], rng, 0.02)}
    tower_params = [_perturb(jax.jit(t.init)(jax.random.PRNGKey(i + 1)), rng, 0.05)
                    for i, t in enumerate(towers)]

    sd = state_dict_from_jax(params, prefix="lm.")
    for i, tp in enumerate(tower_params):
        sd.update(state_dict_from_jax(tp, prefix=f"towers.{i}.module."))
    tmp = tmp_path_factory.mktemp("parallel_train")
    payload = dict(cfg=jcfg.to_dict(), sd=sd, batches=batches, train_kw=TRAIN_KW,
                   meshes=MESHES, save_mesh=(1, 2, 2), restore_meshes=RESTORE_MESHES,
                   rng_seed=17, out_dir=str(tmp / "out"))
    # the ranks run while this process computes the JAX references and, in a
    # thread, consolidates the (1,2,2) checkpoint as soon as the ranks write it
    started = workers.start_ranks(workers.train_rank, 4, tmp, payload)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        loading = pool.submit(_consolidate_and_load, jcfg,
                              os.path.join(str(tmp), "out", "stage1_1x2x2"), str(tmp / "hf"))
        want = _jax_trajectories(model, towers, params, tower_params, batches)
        loaded = loading.result()
    ranks = workers.join_ranks(started, timeout=90)
    start = {k[len("lm."):]: v for k, v in sd.items() if k.startswith("lm.")}
    return dict(jcfg=jcfg, want=want, ranks=ranks, tmp=tmp, start=start, loaded=loaded)


def _consolidate_and_load(jcfg, out, hf_dir, timeout=90.0):
    """``consolidate`` of the run's newest checkpoint under ``out`` (waiting
    for the ranks to write it), then both packages' ``load_pretrained_model``
    of the export: (JAX params, the port's state dict, the error of a step
    that is not there)."""
    from cambrian_tpu.models.builder import load_pretrained_model as jload
    from cambrian_tpu_torch.checkpoint.consolidate import checkpoint_dirs, consolidate
    from cambrian_tpu_torch.checkpoint.save import save_config
    from cambrian_tpu_torch.models.builder import load_pretrained_model as tload
    from cambrian_tpu_torch.models.config import CambrianConfig

    deadline = time.monotonic() + timeout
    while not checkpoint_dirs(os.path.join(out, "checkpoints")):
        assert time.monotonic() < deadline, "the ranks wrote no checkpoint"
        time.sleep(0.2)
    save_config(CambrianConfig.from_dict(jcfg.to_dict()), out)
    missing = None
    try:
        consolidate(out, hf_dir + "_none", step=99)
    except FileNotFoundError as e:
        missing = e
    consolidate(out, hf_dir)
    with open(os.path.join(hf_dir, "config.json")) as f:
        model_type = json.load(f)["model_type"]
    _, jmodel, _, _ = jload(hf_dir)
    _, tmodel, _, _ = tload(hf_dir, device="cpu", dtype=torch.float32)
    return dict(jax=jax.device_get(jmodel.params["params"]), port=tmodel.lm.state_dict(),
                missing=missing, model_type=model_type)


@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize("dims", MESHES)
def test_sharded_trajectory_matches_jax(sharded_run, stage, dims):
    """Losses, grad norms and the parameters after three steps against JAX
    on its (2,2,2) mesh; frozen parameters bitwise unchanged; every rank
    logged the same loss and norm, with its own count of valid tokens."""
    losses, norms, want_params = sharded_run["want"][stage]
    runs = [r["runs"][(stage, dims)] for r in sharded_run["ranks"]]
    run = runs[0]
    for other in runs[1:]:
        assert other["loss"] == run["loss"] and other["grad_norm"] == run["grad_norm"]
    # rows of unequal lengths: the (data, fsdp) ranks hold different counts
    counts = {tuple(r["valid_tokens"]) for r in runs}
    assert len(counts) == (2 if dims == (1, 2, 2) else 4), counts
    for i in range(len(losses)):
        np.testing.assert_allclose(run["loss"][i], losses[i], rtol=LOSS_TOL, err_msg=f"step {i}")
        np.testing.assert_allclose(run["grad_norm"][i], norms[i], rtol=GRAD_NORM_TOL,
                                   err_msg=f"step {i}")
    tc = toptim.TrainConfig(**dict(TRAIN_KW, tune_mm_mlp_adapter=stage == 1))
    labels = toptim.label_params(run["params"], tc)
    n_frozen = 0
    for k, p in run["params"].items():
        np.testing.assert_allclose(p.numpy(), want_params[k].numpy(), atol=PARAM_TOL, rtol=0,
                                   err_msg=k)
        if labels[k] == "frozen":
            n_frozen += 1
            assert not run["requires_grad"][k], k
    assert (n_frozen > 0) == (stage == 1)
    assert not run["grads_left"]
    assert run["trainable"] == sorted(k for k, lab in labels.items() if lab != "frozen")


def test_frozen_weights_bitwise_unchanged(sharded_run):
    """Stage 1 leaves every frozen weight as it was, bit for bit, on both
    meshes."""
    tc = toptim.TrainConfig(**dict(TRAIN_KW, tune_mm_mlp_adapter=True))
    start = sharded_run["start"]
    for dims in MESHES:
        params = sharded_run["ranks"][0]["runs"][(1, dims)]["params"]
        labels = toptim.label_params(params, tc)
        frozen = [k for k, lab in labels.items() if lab == "frozen"]
        assert "embed_tokens.weight" in frozen and "layers_0.mlp.up_proj.weight" in frozen
        for k in frozen:
            assert torch.equal(params[k], start[k]), k


@pytest.mark.parametrize("dims", RESTORE_MESHES)
def test_checkpoint_restores_under_another_mesh(sharded_run, dims):
    """Saved under (1,2,2) through the trainer, restored under ``dims`` into
    a model of other weights: every parameter and optimizer leaf, the step,
    the optimizer's count and the RNG identical."""
    for rank in sharded_run["ranks"]:
        got = rank["restored"][dims]
        assert got["step"] == 3 and got["micro_step"] and got["count"] == 3
        assert got["rng"]
        assert got["params"] == [] and got["optimizer"] == []
        assert got["n_params"] > 100 and got["n_optimizer"] > 100
        assert got["optimizer_nonzero"] > 0, "optimizer state trivially zero: test vacuous"


def test_consolidate_reads_in_both_packages(sharded_run):
    """The (1,2,2) checkpoint -> consolidate -> HF safetensors, read by the
    JAX and the port's ``load_pretrained_model``: ``vision_query`` exact,
    ``q_proj`` within the bf16 export's rounding, as
    tests/test_topology_checkpoint.py holds the JAX consolidate; a step that
    was never saved raises."""
    loaded, saved = sharded_run["loaded"], sharded_run["ranks"][0]["saved_params"]
    assert isinstance(loaded["missing"], FileNotFoundError)
    assert loaded["model_type"] == "cambrian_llama"
    jp = loaded["jax"]
    np.testing.assert_allclose(np.asarray(jp["vision_query"]), saved["vision_query"].numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jp["layers_0"]["self_attn"]["q_proj"]["kernel"]).T,
                               saved["layers_0.self_attn.q_proj.weight"].numpy(),
                               rtol=2e-3, atol=2e-3)      # bf16 export
    got = loaded["port"]
    torch.testing.assert_close(got["vision_query"], saved["vision_query"], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got["layers_0.self_attn.q_proj.weight"],
                               saved["layers_0.self_attn.q_proj.weight"], rtol=2e-3, atol=2e-3)


def test_trainer_train_on_a_mesh(sharded_run):
    """``CambrianTrainer.train()`` on (1,2,2): a global batch of 2 x 2 rows,
    two optimizer steps whose losses every rank logs alike, the final DCP
    checkpoint, and ``save_model``'s export gathered from the shards, which
    holds the final parameters."""
    from cambrian_tpu_torch.checkpoint.consolidate import read_checkpoint
    from cambrian_tpu_torch.models.builder import load_pretrained_model

    runs = [r["train"] for r in sharded_run["ranks"]]
    run = runs[0]
    assert run["global_batch"] == 4
    assert [h["step"] for h in run["history"]] == [1, 2]
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in run["history"])
    keys = ("step", "loss", "grad_norm", "lr")
    assert all([{k: h[k] for k in keys} for h in r["history"]]
               == [{k: h[k] for k in keys} for h in run["history"]] for r in runs)
    assert [os.path.basename(p) for p in run["checkpoints"]] == ["step_000000002"]
    final = read_checkpoint(run["checkpoints"][-1])["model"]
    _, model, _, _ = load_pretrained_model(run["out_dir"], device="cpu", dtype=torch.float32)
    exported = model.lm.state_dict()
    assert set(final) == set(exported)
    for name, t in final.items():
        torch.testing.assert_close(exported[name], t, atol=0, rtol=0, msg=name)


def test_bf16_model_shards_and_trains(sharded_run):
    """A model built in bf16, its trainable Linears bf16 beside fp32 norms,
    position tables and queries: the FSDP2 units keep one trainable dtype
    each, and two stage-1 steps on (1,2,2) move every trainable tensor."""
    for rank in sharded_run["ranks"]:
        got = rank["bf16"]
        assert got["dtypes"] == ["torch.bfloat16", "torch.float32"]
        assert np.isfinite(got["loss"]) and got["grad_norm"] > 0
        assert got["moved"] == got["trainable"] > 0
