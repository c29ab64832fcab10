"""The benchmark of the PyTorch and CUDA port (``cambrian_tpu_torch``) on an
NVIDIA H100; ``run.py`` is its entry."""
