"""Global constants shared by the whole framework.

Parity notes: values mirror the reference implementation's public constants
(cambrian/constants.py:1-13) so that checkpoints, prompts and the serving
protocol remain interchangeable.
"""

# Serving heartbeats (cambrian/constants.py:1-2)
CONTROLLER_HEART_BEAT_EXPIRATION = 30
WORKER_HEART_BEAT_INTERVAL = 15

LOGDIR = "."

# Model constants (cambrian/constants.py:7-13)
IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"
IMAGE_PLACEHOLDER = "<image-placeholder>"
