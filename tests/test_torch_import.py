"""The port imports without JAX and without a GPU toolchain: kernels are
built on first use, never at import."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import json, sys
import cambrian_tpu_torch
import cambrian_tpu_torch.inference
import cambrian_tpu_torch.models.builder
import cambrian_tpu_torch.ops.flash_attention as fa
print(json.dumps({
    "loaded": sorted(m for m in ("jax", "flax", "triton", "PIL", "transformers",
                                 "safetensors") if m in sys.modules),
    "built": fa._library.cache_info().currsize,
}))
"""


def test_import_loads_no_jax_and_builds_nothing():
    # a fresh interpreter: this test process has JAX loaded already
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120, check=True)
    probe = json.loads(out.stdout.strip().splitlines()[-1])
    assert probe == {"loaded": [], "built": 0}
