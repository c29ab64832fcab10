from .base import (
    VisionTower,
    build_vision_tower,
    build_vision_tower_aux_list,
    extract_res_interp,
    register_tower,
)
from . import extra  # noqa: F401  (registers the long-tail towers and SD-2.1)
from . import sam    # noqa: F401  (registers SAM)
