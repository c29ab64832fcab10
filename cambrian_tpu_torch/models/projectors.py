"""Vision-to-decoder projectors (cambrian_tpu/models/projectors.py).

``SvaProjector`` is the counterpart of cambrian_tpu/models/cambrian.py::
_SvaProjector. The LLaVA-style baselines (reference
multimodal_projector/builder.py:54-78 and projectors.py:84-122) are
``LinearProjector`` (``linear``), ``MlpGeluProjector`` (``mlp{N}x_gelu``),
``IdentityProjector``, ``SEMlpProjector`` (``se_mlp``) and ``CAbstractor``,
dispatched by ``build_projector_module``. Module names are the flax ones
(``proj``, ``fc0``, ``se_fc1``, ``pre_0_conv``, ``readout``), so
``checkpoint/from_jax.py`` maps their trees mechanically; flax's Dense
infers its input width, so each port module takes ``in_dim``.
"""

import re

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.activations import gelu_exact
from ..ops.norms import LayerNorm


class SvaProjector(nn.Module):
    """Dense -> GELU -> Dense into the decoder width (``fc1``/``fc2``)."""

    def __init__(self, in_dim: int, hidden_size: int, dtype=torch.float32, device=None):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_size, dtype=dtype, device=device)
        self.fc2 = nn.Linear(hidden_size, hidden_size, dtype=dtype, device=device)

    def forward(self, x):
        return self.fc2(gelu_exact(self.fc1(x)))


class LinearProjector(nn.Module):
    def __init__(self, in_dim: int, hidden_size: int, dtype=torch.float32, device=None):
        super().__init__()
        self.proj = nn.Linear(in_dim, hidden_size, dtype=dtype, device=device)

    def forward(self, x):
        return self.proj(x)


class MlpGeluProjector(nn.Module):
    """``fc0`` into the decoder width, then ``depth - 1`` times exact GELU
    and ``fc{i}``."""

    def __init__(self, in_dim: int, hidden_size: int, depth: int = 2, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"fc{i}", nn.Linear(in_dim if i == 0 else hidden_size, hidden_size,
                                                dtype=dtype, device=device))

    def forward(self, x):
        x = self.fc0(x)
        for i in range(1, self.depth):
            x = getattr(self, f"fc{i}")(gelu_exact(x))
        return x


class IdentityProjector(nn.Module):
    def forward(self, x):
        return x


class SEMlpProjector(nn.Module):
    """Squeeze-excite MLP (multimodal_projector/builder.py:33-52): a gate from
    the token mean (``se_fc1``, GELU, ``se_fc2``, sigmoid; no biases), ``x *
    g + x``, then a 2-layer projection (``proj_fc1``, GELU, ``proj_fc2``)."""

    def __init__(self, in_dim: int, hidden_size: int, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.se_fc1 = nn.Linear(in_dim, in_dim, bias=False, **kw)
        self.se_fc2 = nn.Linear(in_dim, in_dim, bias=False, **kw)
        self.proj_fc1 = nn.Linear(in_dim, hidden_size, **kw)
        self.proj_fc2 = nn.Linear(hidden_size, hidden_size, **kw)

    def forward(self, x):
        g = self.se_fc2(gelu_exact(self.se_fc1(x.mean(1, keepdim=True))))
        x = x * torch.sigmoid(g) + x
        return self.proj_fc2(gelu_exact(self.proj_fc1(x)))


class CAbstractor(nn.Module):
    """Convolutional abstractor (reference projectors.py:84-122) on the
    square token grid: ``depth`` residual blocks (3x3 conv, padding 1;
    LayerNorm eps 1e-6; ``x + silu(h)``), a 2x2 average pool of stride 2
    (VALID: an odd side drops its last row and column), ``depth`` more
    blocks, then ``readout``. The tokens stay NHWC, as in flax; each
    convolution runs on an NCHW view."""

    def __init__(self, in_dim: int, hidden_size: int, depth: int = 3, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.depth = depth
        for stage in ("pre", "post"):
            for i in range(depth):
                self.add_module(f"{stage}_{i}_conv", nn.Conv2d(
                    in_dim, in_dim, 3, padding=1, dtype=dtype, device=device))
                self.add_module(f"{stage}_{i}_ln", LayerNorm(in_dim, 1e-6, device=device))
        self.readout = nn.Linear(in_dim, hidden_size, dtype=dtype, device=device)

    def _res_block(self, x, name):
        h = getattr(self, f"{name}_conv")(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return x + F.silu(getattr(self, f"{name}_ln")(h))

    def forward(self, tokens):
        b, n, c = tokens.shape
        side = int(n ** 0.5)
        x = tokens.reshape(b, side, side, c)
        for i in range(self.depth):
            x = self._res_block(x, f"pre_{i}")
        x = F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        for i in range(self.depth):
            x = self._res_block(x, f"post_{i}")
        x = self.readout(x)
        return x.reshape(b, -1, x.shape[-1])


def build_projector_module(config, in_dim: int, dtype=torch.float32, device=None) -> nn.Module:
    """The reference ``build_vision_projector`` dispatch on
    ``config.mm_projector_type`` (multimodal_projector/builder.py:54-78):
    ``in_dim`` wide tokens into ``config.hidden_size``."""
    ptype = getattr(config, "mm_projector_type", "linear")
    hidden = config.hidden_size
    kw = dict(dtype=dtype, device=device)
    if ptype == "linear":
        return LinearProjector(in_dim, hidden, **kw)
    m = re.match(r"^mlp(\d+)x_gelu$", ptype)
    if m:
        return MlpGeluProjector(in_dim, hidden, depth=int(m.group(1)), **kw)
    if ptype == "identity":
        return IdentityProjector()
    if ptype == "se_mlp":
        return SEMlpProjector(in_dim, hidden, **kw)
    if ptype == "CAbstractor":
        return CAbstractor(in_dim, hidden, **kw)
    raise ValueError(f"Unknown projector type: {ptype}")
