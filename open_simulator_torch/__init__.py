"""open_simulator_torch: the PyTorch/CUDA port of tpu-simon's scheduling core.

Same `simulate()` surface as `open_simulator_tpu`, running the serial
scheduling route on an NVIDIA GPU through hand-written CUDA kernels
(ops/csrc/schedule.cu), with plain PyTorch versions of every kernel as the
CPU path. This package imports no JAX and nothing of `open_simulator_tpu`.
"""

from .core.types import AppResource, NodeStatus, ResourceTypes, SimulateResult, UnscheduledPod
from .simulator.core import simulate
from .simulator.engine import Simulator

__version__ = "0.1.0"

__all__ = [
    "AppResource",
    "NodeStatus",
    "ResourceTypes",
    "SimulateResult",
    "Simulator",
    "UnscheduledPod",
    "simulate",
    "__version__",
]
