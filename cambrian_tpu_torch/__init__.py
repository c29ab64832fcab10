"""cambrian_tpu_torch: the PyTorch/CUDA port of cambrian_tpu.

The port keeps the JAX package's module paths and names, so each module's
counterpart is easy to find. It keeps its own copies of the framework-neutral
modules (constants, prompt templates, host-side image preprocessing, packing,
the config and the HF checkpoint name mapping) and imports nothing of
``cambrian_tpu``.

Importing this package loads neither ``jax`` nor a GPU toolchain: kernels are
compiled on first use (``cambrian_tpu_torch.ops.flash_attention``,
``cambrian_tpu_torch.ops.quant``).
"""

__version__ = "0.1.0"

from . import constants, conversation, mm_utils
from .constants import (
    DEFAULT_IM_END_TOKEN,
    DEFAULT_IM_START_TOKEN,
    DEFAULT_IMAGE_PATCH_TOKEN,
    DEFAULT_IMAGE_TOKEN,
    IGNORE_INDEX,
    IMAGE_TOKEN_INDEX,
)
from .conversation import Conversation, SeparatorStyle, conv_templates
from .data.packing import prepare_multimodal_data
from .mm_utils import (
    process_images,
    tokenizer_image_token,
    tokenizer_image_token_llama3,
)
from .models.config import CambrianConfig, cambrian_8b, tiny_debug
