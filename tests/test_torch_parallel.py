"""The port's ``parallel/`` against the JAX package's, in one process: the
mesh arithmetic, the sharding rules on the tiny Cambrian's parameters
(through the bridge's names and transposes), the runtime's no-op without
flags, and each rank's rows of a global batch."""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cambrian_tpu.constants import IMAGE_TOKEN_INDEX
from cambrian_tpu.data.packing import prepare_multimodal_data
from cambrian_tpu.models.cambrian import CambrianLM
from cambrian_tpu.models.config import tiny_debug
from cambrian_tpu.models.encoders.base import build_vision_tower_aux_list
from cambrian_tpu.parallel import mesh as jmesh
from cambrian_tpu.parallel import sharding as jsharding
from cambrian_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from cambrian_tpu_torch.models.builder import build_modules
from cambrian_tpu_torch.models.config import CambrianConfig
from cambrian_tpu_torch.parallel import distributed, mesh, sharding
from cambrian_tpu_torch.train.train_step import batch_shardings


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 16])
def test_mesh_config_resolves_as_jax(n):
    for data, fsdp, model in itertools.product([1, 2, -1], [1, 2, 4, -1], [1, 2, 4, -1]):
        want = got = None
        try:
            want = jmesh.MeshConfig(data, fsdp, model).resolve(n)
        except ValueError as e:
            want = str(e)
        try:
            got = mesh.MeshConfig(data, fsdp, model).resolve(n)
        except ValueError as e:
            got = str(e)
        assert got == want, (data, fsdp, model, n)
    assert mesh.AXES == jmesh.AXES


def _jax_spec(named_sharding, ndim):
    spec = tuple(named_sharding.spec)
    return spec + (None,) * (ndim - len(spec))


@pytest.fixture(scope="module")
def tiny_shapes():
    """The tiny Cambrian's flax parameter shapes (no values: the rules read
    paths and shapes only)."""
    cfg = tiny_debug(num_towers=2)
    towers = build_vision_tower_aux_list(cfg.mm_vision_tower_aux_list,
                                         cfg.mm_vision_tower_aux_token_len_list)
    model = CambrianLM(cfg, tuple(t.hidden_size for t in towers))
    b, s = 1, 40
    ids = np.full((b, s), 7, np.int64)
    ids[:, cfg.image_position] = IMAGE_TOKEN_INDEX
    pids, _, pmask, ppos, aux = prepare_multimodal_data(
        ids, ids.copy(), np.ones((b, s), bool), [(640, 360)], cfg.image_token_len,
        cfg.mm_vision_tower_aux_token_len_list, cfg.tokenizer_model_max_length)
    feats = [jnp.zeros((b, t.interp_size, t.hidden_size)) for t in towers]
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(pids),
                            jnp.asarray(pmask), jnp.asarray(ppos), feats,
                            [jnp.asarray(m) for m in aux])
    return cfg, shapes


@pytest.mark.parametrize("dims", [(2, 2, 2), (1, 2, 4)])
def test_param_shardings_match_jax(tiny_shapes, dims):
    """Every port parameter gets the spec JAX gives the flax leaf the bridge
    maps onto it: a Dense weight [out, in] the kernel's [in, out] spec
    reversed, the embedding and norms as they are."""
    cfg, shapes = tiny_shapes
    jax_mesh = jmesh.create_mesh(jmesh.MeshConfig(*dims), devices=jax.devices()[:8])
    jspecs = jsharding.infer_param_shardings(shapes, jax_mesh)
    flat_shapes = jax.tree_util.tree_leaves_with_path(shapes)
    flat_specs = jax.tree.leaves(jspecs, is_leaf=lambda x: hasattr(x, "spec"))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    names = list(state_dict_from_jax(zeros))        # the bridge's names, leaf order
    assert len(names) == len(flat_shapes) == len(flat_specs)
    with torch.device("meta"):
        lm, _ = build_modules(CambrianConfig.from_dict(cfg.to_dict()), torch.float32)
    port = dict(lm.named_parameters())
    assert set(port) == set(names)
    got = sharding.infer_param_shardings(port, dict(zip(mesh.AXES, dims)))
    kinds = set()
    for name, (path, leaf), spec in zip(names, flat_shapes, flat_specs):
        want = _jax_spec(spec, len(leaf.shape))
        if path[-1].key == "kernel":
            want = want[::-1]                                 # Dense kernel -> weight
        assert tuple(port[name].shape) == tuple(leaf.shape)[::-1 if path[-1].key == "kernel"
                                                            else 1], name
        assert got[name] == want, (name, got[name], want)
        kinds.add(want)
    # the rules' column-, row-parallel, embedding and head layouts all occur
    assert {("model", "fsdp"), ("fsdp", "model")} <= kinds
    assert any(isinstance(a, tuple) for k in kinds for a in k)


def test_batch_shardings_match_jax():
    assert sharding.batch_sharding(None, 3) == tuple(jsharding.batch_sharding(
        jmesh.create_mesh(jmesh.MeshConfig(2, 2, 2), devices=jax.devices()[:8]), 3).spec)
    specs = batch_shardings(None, num_towers=2)
    assert specs["input_ids"] == (("data", "fsdp"), None)
    assert specs["images"] == [(("data", "fsdp"), None, None, None)] * 2
    assert sharding.replicated() == ()


def test_initialize_distributed_without_flags_is_a_no_op(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize_distributed() is False
    assert not torch.distributed.is_initialized()
    assert distributed.is_main_process()
    assert distributed.dp_coordinate(None) == (0, 1)


class _Mesh:
    """What ``put_global_batch`` reads of a DeviceMesh: axis names, sizes
    and this rank's coordinate."""
    mesh_dim_names = mesh.AXES

    def __init__(self, dims, coord):
        self.dims, self.coord = dims, list(coord)

    def size(self, i):
        return self.dims[i]

    def get_coordinate(self):
        return self.coord


@pytest.mark.parametrize("dims", [(2, 2, 2), (1, 2, 4), (4, 2, 1), (2, 1, 4)])
def test_global_batch_rows_match_jax_batch_sharding(dims):
    """Each rank's rows of a global batch are the rows JAX's
    ``batch_sharding`` places on the device at the same mesh coordinate."""
    jax_mesh = jmesh.create_mesh(jmesh.MeshConfig(*dims), devices=jax.devices()[:8])
    rows = 8
    batch = {"input_ids": np.arange(rows * 3).reshape(rows, 3),
             "images": [np.arange(rows * 2, dtype=np.float32).reshape(rows, 2)]}
    index_map = jsharding.batch_sharding(jax_mesh, 2).devices_indices_map((rows, 3))
    for coord in itertools.product(*(range(d) for d in dims)):
        device = jax_mesh.devices[coord]
        want = np.arange(rows)[index_map[device][0]]
        got = distributed.put_global_batch(batch, _Mesh(dims, coord), "cpu")
        np.testing.assert_array_equal(got["input_ids"][:, 0].numpy() // 3, want)
        np.testing.assert_array_equal(got["images"][0][:, 0].numpy() // 2, want)
    with pytest.raises(ValueError, match="does not split"):
        distributed.put_global_batch({"x": np.zeros((3, 1))}, _Mesh(dims, (0, 0, 0)), "cpu")


def test_spec_of_a_plain_tensor_and_attention_rule():
    assert sharding.spec_of(torch.zeros(2, 2)) == ()
    assert sharding.attention_tp(8, 4, 4) and not sharding.attention_tp(8, 2, 4)
    assert not sharding.attention_tp(8, 8, 1)
    cfg = CambrianConfig.from_dict(tiny_debug(2).to_dict())
    assert sharding.local_kv_heads(cfg, None) == cfg.num_key_value_heads
    assert sharding.local_kv_heads(cfg, {"model": 2}) == cfg.num_key_value_heads // 2
    assert sharding.local_kv_heads(cfg, {"model": 4}) == cfg.num_key_value_heads


@pytest.mark.parametrize("stage", [1, 2])
def test_fsdp_units_hold_one_trainable_dtype(stage):
    """On Cambrian-8B built in bf16 (its norms, position tables and queries
    fp32), after the stage's freeze: every decoder layer, SVA sampler,
    tower block and tower is a unit, the root last, and each unit's own
    trainable parameters share one dtype, as FSDP2 requires."""
    from cambrian_tpu_torch import cambrian_8b
    from cambrian_tpu_torch.train.optimizer import TrainConfig
    from cambrian_tpu_torch.train.train_step import apply_freeze

    with torch.device("meta"):
        lm, towers = build_modules(cambrian_8b(), torch.bfloat16)
    apply_freeze(lm, towers, TrainConfig(tune_mm_mlp_adapter=stage == 1))
    order = sharding.fsdp_units(lm, towers)
    assert order[-1] is lm
    units = {id(m) for m in order}
    assert all(id(getattr(lm, f"layers_{i}")) in units for i in range(32))
    assert all(id(t) in units for t in towers)
    assert sum(id(b) in units for t in towers for b in sharding._tower_blocks(t)) == 27 + 23 + 40 + 40
    done, mixed = set(), []
    for unit in order:
        dtypes = {p.dtype for m in sharding._walk(unit, done)
                  for p in m.parameters(recurse=False) if p.requires_grad}
        done.add(id(unit))
        if len(dtypes) > 1:
            mixed.append(type(unit).__name__)
    assert not mixed
    trainable = {p.dtype for p in lm.parameters() if p.requires_grad}
    assert trainable == {torch.bfloat16, torch.float32}
