from .base import BENCHMARKS, Benchmark, register_benchmark
from . import benchmarks  # noqa: F401  (populates the registry)
