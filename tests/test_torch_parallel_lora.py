"""The port's LoRA on the (data, fsdp, model) mesh against the JAX package's,
on the CPU: the sharding rules on an adapter tree, then four gloo processes
(tests/torch_parallel_workers.py) train a tiny Cambrian's adapters through
``CambrianTrainer`` (``lora_enable``, the adapters read through
``lora_weight_path``) for three steps on (1,4,1) (FSDP2) and (1,2,2)
(tensor parallelism and FSDP2), from the weights, adapters and global
batches JAX ``make_lora_train_step`` steps on its (1,2,2) mesh under
``jax.set_mesh``, held to tests/test_torch_lora.py's tolerances. The batch's
rows hold unequal numbers of valid tokens. The (1,4,1) run's DCP checkpoint
restores under (2,2,1); its adapters' file and its merged export read
back in both packages, and ``consolidate`` of its checkpoint onto the base
gives the same weights. One spawn runs every rank-side check."""

import concurrent.futures
import functools
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
from test_torch_lora import ADAPTER_TOL, ALPHA, LOSS_TOL, NORM_TOL, RANK  # noqa: E402
from test_torch_parallel_train import CFG, _batches  # noqa: E402
from test_torch_train import TRAIN_KW, _perturb  # noqa: E402

from cambrian_tpu.models import cambrian as jcambrian  # noqa: E402
from cambrian_tpu.models.encoders.base import build_vision_tower_aux_list  # noqa: E402
from cambrian_tpu.parallel import mesh as jmesh  # noqa: E402
from cambrian_tpu.parallel import sharding as jsharding  # noqa: E402
from cambrian_tpu.train import lora as jlora  # noqa: E402
from cambrian_tpu.train import optimizer as joptim  # noqa: E402
from cambrian_tpu.train import train_step as jtrain  # noqa: E402
from cambrian_tpu_torch.checkpoint import safetensors_io  # noqa: E402
from cambrian_tpu_torch.checkpoint.from_jax import state_dict_from_jax  # noqa: E402
from cambrian_tpu_torch.parallel import mesh, sharding  # noqa: E402
from cambrian_tpu_torch.train import lora as tlora  # noqa: E402

MESHES = [(1, 4, 1), (1, 2, 2)]
SAVE_MESH, RESTORE_MESH = (1, 4, 1), (2, 2, 1)
EXPORT_TOL = 2e-3       # the HF export is bf16


@functools.lru_cache(maxsize=None)
def _setup():
    """The JAX model, towers, perturbed weights, numpy adapters (b nudged
    off zero) and three global batches of unequal valid lengths."""
    towers = build_vision_tower_aux_list(CFG.mm_vision_tower_aux_list,
                                         CFG.mm_vision_tower_aux_token_len_list)
    rng = np.random.default_rng(22)
    batches = _batches(CFG, towers, rng, 3)
    model = jcambrian.CambrianLM(CFG, tuple(t.hidden_size for t in towers))
    b0 = batches[0]
    feats = [jnp.zeros((len(b0["input_ids"]), t.interp_size, t.hidden_size)) for t in towers]
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(b0["input_ids"]),
                                 jnp.asarray(b0["attention_mask"]),
                                 jnp.asarray(b0["position_ids"]), feats,
                                 [jnp.asarray(m) for m in b0["aux_masks"]])
    params = {"params": _perturb(params["params"], rng, 0.02)}
    tower_params = [_perturb(jax.jit(t.init)(jax.random.PRNGKey(i + 1)), rng, 0.05)
                    for i, t in enumerate(towers)]
    jad = jlora.init_lora_params(params, RANK, jax.random.PRNGKey(3))
    adapters = {k: {p: np.asarray(x) + 0.01 * rng.standard_normal(x.shape).astype(np.float32)
                    for p, x in ad.items()} for k, ad in jad.items()}
    return model, towers, params, tower_params, adapters, batches


def _jax_lora_trajectory(model, towers, params, tower_params, adapters, batches):
    """JAX make_lora_train_step on its (1,2,2) mesh: losses, grad norms and
    the adapters after the steps."""
    jmesh_ = jmesh.create_mesh(jmesh.MeshConfig(data=1, fsdp=2, model=2),
                               devices=jax.devices()[:4])
    state = jtrain.init_train_state(jax.tree.map(jnp.asarray, adapters),
                                    joptim.TrainConfig(**TRAIN_KW))
    state_sh = jtrain.state_shardings(state, jmesh_)
    tower_sh = [jsharding.infer_param_shardings(tp, jmesh_) for tp in tower_params]
    batch_sh = jtrain.batch_shardings(jmesh_, num_towers=len(towers))
    losses, norms = [], []
    with jax.set_mesh(jmesh_):
        step = jax.jit(jtrain.make_lora_train_step(model, towers, params, ALPHA, RANK),
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
    return losses, norms, jax.tree.map(np.asarray, jax.device_get(state.params))


def _read_back(out, export_dir, base_dir, timeout=120.0):
    """Once the ranks have written them: the adapters' file through both
    packages' readers, the trainer's merged export and ``consolidate`` of
    the LoRA checkpoint onto the base, each through both packages'
    ``load_pretrained_model``."""
    from safetensors.numpy import load_file

    from cambrian_tpu.models.builder import load_pretrained_model as jload
    from cambrian_tpu_torch.checkpoint.consolidate import consolidate
    from cambrian_tpu_torch.checkpoint.save import save_config
    from cambrian_tpu_torch.models.builder import load_pretrained_model as tload
    from cambrian_tpu_torch.models.config import CambrianConfig

    deadline = time.monotonic() + timeout
    while not os.path.exists(export_dir + ".done"):
        assert time.monotonic() < deadline, "the ranks wrote no export"
        time.sleep(0.2)
    save_config(CambrianConfig.from_dict(CFG.to_dict()), out)
    consolidated = os.path.join(out, "consolidated")
    consolidate(out, consolidated, base_model=base_dir)
    path = os.path.join(out, "lora_adapters.safetensors")
    files = dict(jax=jlora.lora_from_state_dict(load_file(path)),
                 port=tlora.lora_from_state_dict(safetensors_io.load_file(path)))
    loaded = {}
    for name, d in (("export", export_dir), ("consolidated", consolidated)):
        _, tmodel, _, _ = tload(d, device="cpu", dtype=torch.float32)
        loaded[name] = dict(port=tmodel.lm.state_dict())
    _, jmodel, _, _ = jload(export_dir)
    loaded["export"]["jax"] = jax.device_get(jmodel.params["params"])
    return files, loaded


@pytest.fixture(scope="module")
def sharded_lora(tmp_path_factory):
    """The JAX trajectory, and one spawn of four ranks doing every port
    side of this file; the read-back of what the ranks wrote runs in a
    thread meanwhile."""
    from cambrian_tpu_torch.checkpoint.save import save_pretrained
    from cambrian_tpu_torch.models.config import CambrianConfig

    model, towers, params, tower_params, adapters, batches = _setup()
    sd = state_dict_from_jax(params, prefix="lm.")
    for i, tp in enumerate(tower_params):
        sd.update(state_dict_from_jax(tp, prefix=f"towers.{i}.module."))
    tmp = tmp_path_factory.mktemp("parallel_lora")
    adapters_file = str(tmp / "adapters.safetensors")
    safetensors_io.save_file({k: torch.from_numpy(v) for k, v in
                              jlora.lora_state_dict(adapters).items()}, adapters_file)
    out_dir = str(tmp / "out")
    payload = dict(cfg=CFG.to_dict(), sd=sd, batches=batches, train_kw=TRAIN_KW,
                   meshes=MESHES, save_mesh=SAVE_MESH, restore_mesh=RESTORE_MESH,
                   out_dir=out_dir, adapters_file=adapters_file, rank=RANK, alpha=ALPHA)
    started = workers.start_ranks(workers.lora_rank, 4, tmp, payload)
    # the base checkpoint the run "started from", for consolidate
    base_dir = str(tmp / "base")
    save_pretrained(params, CambrianConfig.from_dict(CFG.to_dict()), base_dir)
    save_dir = os.path.join(out_dir, "x".join(map(str, SAVE_MESH)))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        reading = pool.submit(_read_back, save_dir, os.path.join(save_dir, "hf"), base_dir)
        want = _jax_lora_trajectory(model, towers, params, tower_params, adapters, batches)
        files, loaded = reading.result()
    ranks = workers.join_ranks(started, timeout=120)
    start = {k[len("lm."):]: v for k, v in sd.items() if k.startswith("lm.")}
    return dict(want=want, ranks=ranks, adapters=adapters, params=params, files=files,
                loaded=loaded, start=start)


@pytest.mark.parametrize("dims", [(1, 2, 2), (2, 2, 1)])
def test_adapter_tree_shardings_match_jax(dims):
    """The rules give each adapter leaf (``<kernel path>/a`` [in, r],
    ``/b`` [r, out]) the spec JAX's ``infer_param_shardings`` gives it on
    its adapter tree."""
    adapters = _setup()[4]
    jax_mesh = jmesh.create_mesh(jmesh.MeshConfig(*dims), devices=jax.devices()[:4])
    jspecs = jsharding.infer_param_shardings(adapters, jax_mesh)
    flat = tlora.flat_adapters({k: {p: torch.from_numpy(x) for p, x in ad.items()}
                                for k, ad in adapters.items()})
    got = sharding.infer_param_shardings(flat, dict(zip(mesh.AXES, dims)))
    kinds = set()
    for key, ad in adapters.items():
        for part, x in ad.items():
            spec = jspecs[key][part].spec
            want = tuple(spec) + (None,) * (x.ndim - len(spec))
            assert got[f"{key}/{part}"] == want, (key, part, got[f"{key}/{part}"], want)
            kinds.add(want)
    assert len(kinds) > 1 and any(a is not None for k in kinds for a in k)


@pytest.mark.parametrize("dims", MESHES)
def test_sharded_lora_trajectory_matches_jax(sharded_lora, dims):
    """Losses, grad norms and the adapters after three steps against JAX on
    its (1,2,2) mesh, every rank alike; the base bitwise unchanged, no
    gradient left on it."""
    losses, norms, want = sharded_lora["want"]
    runs = [r["runs"][dims] for r in sharded_lora["ranks"]]
    run = runs[0]
    for other in runs[1:]:
        assert other["loss"] == run["loss"] and other["grad_norm"] == run["grad_norm"]
    for i in range(len(losses)):
        np.testing.assert_allclose(run["loss"][i], losses[i], rtol=LOSS_TOL, err_msg=f"step {i}")
        np.testing.assert_allclose(run["grad_norm"][i], norms[i], rtol=NORM_TOL,
                                   err_msg=f"step {i}")
    moved = 0
    for key, ad in want.items():
        for part, x in ad.items():
            got = run["adapters"][f"{key}/{part}"].numpy()
            np.testing.assert_allclose(got, x, atol=ADAPTER_TOL, rtol=0, err_msg=f"{key}/{part}")
            moved += not np.array_equal(got, sharded_lora["adapters"][key][part])
    assert moved == 2 * len(want)
    for r in runs:
        assert r["base_moved"] == [] and r["grads_left"] == []


def test_adapters_laid_out_like_their_linears(sharded_lora):
    """On (1,2,2): B's N columns over model for a column-parallel linear
    (q_proj, up_proj), A's K rows for a row-parallel one (o_proj,
    down_proj), every factor whole over data and fsdp; on (1,4,1) all
    whole."""
    layout = sharded_lora["ranks"][0]["runs"][(1, 2, 2)]["layout"]
    for site, split in (("self_attn/q_proj", ("b", (None, "model"))),
                        ("mlp/up_proj", ("b", (None, "model"))),
                        ("self_attn/o_proj", ("a", ("model", None))),
                        ("mlp/down_proj", ("a", ("model", None)))):
        key = f"params/layers_0/{site}/kernel"
        part, spec = split
        other = "a" if part == "b" else "b"
        assert layout[f"{key}/{part}"] == spec, site
        assert layout[f"{key}/{other}"] == (None, None), site
    flat = sharded_lora["ranks"][0]["runs"][(1, 4, 1)]["layout"]
    assert set(flat.values()) == {(None, None)}


def test_lora_checkpoint_restores_under_another_mesh(sharded_lora):
    """The (1,4,1) checkpoint, restored under (2,2,1) into a trainer that
    drew other adapters: every adapter and optimizer leaf identical, the
    step and the micro-step too."""
    for rank in sharded_lora["ranks"]:
        got = rank["restored"]
        assert got["step"] == 3 and got["micro_step"]
        assert got["adapters"] == [] and got["optimizer"] == []
        assert got["n_adapters"] == 2 * len(sharded_lora["adapters"])
        assert got["n_optimizer"] >= 3 * got["n_adapters"]


def test_adapters_file_and_merged_export_read_in_both_packages(sharded_lora):
    """The adapters' file (written once, from whole tensors) reads in both
    packages as the run's adapters; the trainer's merged export (read by
    both packages) and ``consolidate`` of the LoRA checkpoint onto the base
    (read by the port) hold the JAX ``merge_lora`` of the base and those
    adapters, within the bf16 export's rounding."""
    run = sharded_lora["ranks"][0]["runs"][SAVE_MESH]
    files = sharded_lora["files"]
    for key, ad in files["jax"].items():
        for part in "ab":
            want = run["adapters"][f"{key}/{part}"].numpy()
            np.testing.assert_array_equal(np.asarray(ad[part]), want)
            np.testing.assert_array_equal(files["port"][key][part].numpy(), want)
    assert sorted(files["port"]) == sorted(sharded_lora["adapters"])
    merged = jlora.merge_lora(sharded_lora["params"], files["jax"], ALPHA, RANK)
    want = state_dict_from_jax(jax.tree.map(np.asarray, merged))
    start = sharded_lora["start"]
    for name in ("export", "consolidated"):
        loaded = sharded_lora["loaded"][name]
        for site in ("layers_0.self_attn.q_proj", "layers_1.mlp.down_proj"):
            w = want[f"{site}.weight"]
            assert not torch.equal(w, start[f"{site}.weight"])
            torch.testing.assert_close(loaded["port"][f"{site}.weight"], w, atol=EXPORT_TOL,
                                       rtol=EXPORT_TOL, msg=f"{name} {site}")
            if "jax" in loaded:
                tree = loaded["jax"]
                for part in site.split("."):
                    tree = tree[part]
                np.testing.assert_allclose(np.asarray(tree["kernel"]).T, w.numpy(),
                                           atol=EXPORT_TOL, rtol=EXPORT_TOL,
                                           err_msg=f"{name} {site}")
        torch.testing.assert_close(loaded["port"]["vision_query"], start["vision_query"],
                                   atol=EXPORT_TOL, rtol=EXPORT_TOL)


def test_trainer_lora_train_on_a_mesh(sharded_lora):
    """``CambrianTrainer.train()`` with ``lora_enable`` on (1,2,2), the
    adapters drawn from the seed (the same on every rank): two optimizer
    steps every rank logs alike, the final checkpoint, the adapters' file
    written once, and ``save_model``'s export holding the base merged with
    that file's adapters."""
    from cambrian_tpu_torch.models.builder import load_pretrained_model

    runs = [r["train"] for r in sharded_lora["ranks"]]
    run = runs[0]
    assert run["global_batch"] == 4
    assert [h["step"] for h in run["history"]] == [1, 2]
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in run["history"])
    keys = ("step", "loss", "grad_norm", "lr")
    assert all([{k: h[k] for k in keys} for h in r["history"]]
               == [{k: h[k] for k in keys} for h in run["history"]] for r in runs)
    assert [os.path.basename(p) for p in run["checkpoints"]] == ["step_000000002"]
    adapters = tlora.lora_from_state_dict(safetensors_io.load_file(
        os.path.join(run["out_dir"], "lora_adapters.safetensors")))
    assert sorted(adapters) == sorted(sharded_lora["adapters"])
    assert all(ad["b"].any() for ad in adapters.values())
    want = tlora.apply_lora(sharded_lora["start"], adapters, ALPHA, RANK)
    _, model, _, _ = load_pretrained_model(run["out_dir"], device="cpu", dtype=torch.float32)
    got = model.lm.state_dict()
    for site in ("layers_0.self_attn.q_proj", "layers_1.mlp.down_proj"):
        torch.testing.assert_close(got[f"{site}.weight"], want[f"{site}.weight"],
                                   atol=EXPORT_TOL, rtol=EXPORT_TOL, msg=site)
