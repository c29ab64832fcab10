"""The port imports without JAX (nor flax, optax, orbax), without the JAX
package, without ``safetensors`` and without a GPU toolchain: kernels are
built on first use, never at import. The probe covers serving, checkpoint
I/O and tower loading, the training path and the op modules of kernels
K5-K8, continuous batching and the serving stack (worker, controller,
remote worker, web server), the eval harness, the data engine, profiling
and the projectors (the runner loads ``datasets`` only when it reads a
benchmark); a scan of the sources covers imports made inside functions."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import json, sys
import cambrian_tpu_torch
import cambrian_tpu_torch.inference
import cambrian_tpu_torch.models.builder
import cambrian_tpu_torch.serve.cli
import cambrian_tpu_torch.infer.continuous
import cambrian_tpu_torch.utils
import cambrian_tpu_torch.serve.model_worker
import cambrian_tpu_torch.serve.controller
import cambrian_tpu_torch.serve.register_worker
import cambrian_tpu_torch.serve.remote_worker
import cambrian_tpu_torch.serve.test_message
import cambrian_tpu_torch.serve.gradio_web_server
import cambrian_tpu_torch.ops.flash_attention as fa
import cambrian_tpu_torch.ops.quant as quant
import cambrian_tpu_torch.ops.norms as norms
import cambrian_tpu_torch.ops.dwconv as dwconv
import cambrian_tpu_torch.ops.sva_attention as sva_attention
import cambrian_tpu_torch.ops.fused_mlp as fused_mlp
import cambrian_tpu_torch.train.optimizer
import cambrian_tpu_torch.train.train_step
import cambrian_tpu_torch.train.trainer
import cambrian_tpu_torch.train.train
import cambrian_tpu_torch.data.dataset
import cambrian_tpu_torch.data.preprocess
import cambrian_tpu_torch.data.native_image
import cambrian_tpu_torch.checkpoint.save
import cambrian_tpu_torch.checkpoint.safetensors_io
import cambrian_tpu_torch.checkpoint.hf_vision
import cambrian_tpu_torch.eval
import cambrian_tpu_torch.eval.runner
import cambrian_tpu_torch.eval.score
import cambrian_tpu_torch.eval.tabulate
import cambrian_tpu_torch.dataengine.engine
import cambrian_tpu_torch.profiling
import cambrian_tpu_torch.models.projectors
print(json.dumps({
    "loaded": sorted(m for m in ("jax", "flax", "optax", "orbax", "triton", "PIL",
                                 "transformers", "safetensors", "datasets")
                     if m in sys.modules),
    "jax_package": sorted(m for m in sys.modules
                          if m == "cambrian_tpu" or m.startswith("cambrian_tpu.")),
    "built": sum(lib.cache_info().currsize for lib in (
        fa._library, fa._bwd_library, quant._library, norms._library, dwconv._library,
        sva_attention._library, fused_mlp._library)),
}))
"""


def test_import_loads_no_jax_and_builds_nothing():
    # a fresh interpreter: this test process has JAX loaded already
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120, check=True)
    probe = json.loads(out.stdout.strip().splitlines()[-1])
    assert probe == {"loaded": [], "jax_package": [], "built": 0}


# an import of jax, of the JAX package or of safetensors, at any depth
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|cambrian_tpu|safetensors)\b(?!_torch)",
                        re.MULTILINE)


def test_sources_import_no_jax_no_jax_package_no_safetensors():
    """Every module of the port and ``chip_smoke.py``, including imports
    inside functions, which the probe above does not reach."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "cambrian_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    found = {}
    for path in paths:
        with open(path) as f:
            hits = _FORBIDDEN.findall(f.read())
        if hits:
            found[os.path.relpath(path, REPO)] = hits
    assert len(paths) > 40 and not found, found


def test_from_jax_keeps_quantized_leaves():
    """A quantized Dense keeps its integer dtype and its ``scale`` name; a
    norm's ``scale`` still becomes ``weight``, float leaves become fp32."""
    import numpy as np

    from cambrian_tpu_torch.checkpoint.from_jax import state_dict_from_jax

    q = np.arange(-8, 8, dtype=np.int8).reshape(4, 4)
    sd = state_dict_from_jax({"params": {
        "q_proj": {"kernel_q": q, "scale": np.ones(4, np.float32)},
        "down_proj": {"kernel_q4": q[:2], "scale": np.ones((1, 4), np.float16)},
        "norm": {"scale": np.ones(4, np.float16)},
        "o_proj": {"kernel": np.ones((4, 2), np.float16)},
    }})
    assert sorted(sd) == ["down_proj.kernel_q4", "down_proj.scale", "norm.weight",
                          "o_proj.weight", "q_proj.kernel_q", "q_proj.scale"]
    assert sd["q_proj.kernel_q"].dtype == sd["down_proj.kernel_q4"].dtype == torch.int8
    assert sd["q_proj.kernel_q"].shape == (4, 4)       # no transpose
    np.testing.assert_array_equal(sd["q_proj.kernel_q"].numpy(), q)
    assert sd["down_proj.scale"].dtype == sd["norm.weight"].dtype == torch.float32
    assert sd["o_proj.weight"].shape == (2, 4)


@pytest.mark.parametrize("name", ["tiny_debug", "cambrian_8b"])
def test_config_round_trip_from_jax_config(name):
    """The parity tests hand the JAX config across as a dict; the port's copy
    of the config gives equal fields."""
    from cambrian_tpu.models import config as jconfig
    from cambrian_tpu_torch.models import config as tconfig

    jcfg = getattr(jconfig, name)()
    cfg = tconfig.CambrianConfig.from_dict(jcfg.to_dict())
    assert cfg.to_dict() == jcfg.to_dict()
    assert cfg.to_dict() == getattr(tconfig, name)().to_dict()
    assert cfg.image_block_len == jcfg.image_block_len
    assert cfg.vision_sampler_layer_indices == jcfg.vision_sampler_layer_indices
