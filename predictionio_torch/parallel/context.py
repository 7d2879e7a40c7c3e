"""The runtime context handed to every DASE component.

Counterpart of ``predictionio_tpu.parallel.mesh.MeshContext``: where the
JAX package carries a device mesh, the port carries one explicit
``torch.device``. One card per process in this slice, so
``data_parallel_size()`` is 1; multi-card serving and training come with
the multi-device slice (ROADMAP.md).

No silent CPU: with no argument the context means ``cuda:0`` and raises
``RuntimeError`` when CUDA is absent. The CPU is reached only by asking
for it (``device="cpu"``), as the tests and ``--device cpu`` do.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda:0``; anything else -> that device. A CUDA
    device without CUDA raises instead of quietly running on the CPU."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "predictionio_torch runs on a CUDA device and none is "
                "available; pass device='cpu' (CLI: --device cpu) to run "
                "on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass
class DeviceContext:
    """Device, seed and free-form runtime config (the reference's
    SparkContext role, as ``MeshContext`` plays it in the JAX package)."""

    device: torch.device
    seed: int = 0
    config: Dict[str, str] = dataclasses.field(default_factory=dict)

    def __init__(self, device: DeviceLike = None, seed: int = 0,
                 config: Optional[Dict[str, str]] = None):
        self.device = resolve_device(device)
        self.seed = int(seed)
        self.config = dict(config or {})

    def rng(self) -> torch.Generator:
        """A generator on this context's device, seeded from ``seed``
        (the counterpart of ``MeshContext.rng``'s PRNG key; the streams
        differ, so tests feed both packages numpy-made inputs)."""
        return torch.Generator(device=self.device).manual_seed(self.seed)

    def data_parallel_size(self) -> int:
        return 1
