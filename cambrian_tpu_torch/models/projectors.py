"""Vision-to-decoder projectors (cambrian_tpu/models/projectors.py).

Only the SVA case is ported: ``SvaProjector`` is the counterpart of
cambrian_tpu/models/cambrian.py::_SvaProjector. The LLaVA-style projectors
(linear, mlpNx_gelu, se_mlp, CAbstractor) belong to a later slice;
``CambrianLM`` raises for them.
"""

import torch
from torch import nn

from ..ops.activations import gelu_exact


class SvaProjector(nn.Module):
    """Dense -> GELU -> Dense into the decoder width (``fc1``/``fc2``)."""

    def __init__(self, in_dim: int, hidden_size: int, dtype=torch.float32, device=None):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_size, dtype=dtype, device=device)
        self.fc2 = nn.Linear(hidden_size, hidden_size, dtype=dtype, device=device)

    def forward(self, x):
        return self.fc2(gelu_exact(self.fc1(x)))
