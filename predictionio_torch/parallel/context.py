"""The runtime context handed to every DASE component.

Counterpart of ``predictionio_tpu.parallel.mesh.MeshContext``: the port
computes on one device per process, so the context carries that explicit
``torch.device`` and, beside it, the mesh of the ``torch.distributed``
world the process belongs to (``parallel/mesh.py``): ``require_mesh()``
makes it on first use, and ``data_parallel_size()`` reads its ``data``
axis (1 with no world).

No silent CPU: with no argument the context means the current CUDA
device (``cuda:0`` unless ``parallel.multihost.initialize_from_env``
made the rank's card current) and raises ``RuntimeError`` when CUDA is
absent. The CPU is reached only by asking for it (``device="cpu"``), as
the tests and ``--device cpu`` do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device (``cuda:0`` unless a rank made
    its card current); anything else -> that device. A CUDA device
    without CUDA raises instead of quietly running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
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
    """Device, mesh, seed and free-form runtime config (the reference's
    SparkContext role, as ``MeshContext`` plays it in the JAX package).
    ``mesh`` None means no sharding until ``require_mesh()`` makes one
    over the world."""

    device: torch.device
    seed: int = 0
    config: Dict[str, str] = dataclasses.field(default_factory=dict)
    mesh: Any = None

    def __init__(self, device: DeviceLike = None, seed: int = 0,
                 config: Optional[Dict[str, str]] = None, mesh: Any = None):
        self.device = resolve_device(device)
        self.seed = int(seed)
        self.config = dict(config or {})
        self.mesh = mesh

    def require_mesh(self):
        """The context's mesh, made over the world (``create_mesh()``'s
        default layout) on first use."""
        if self.mesh is None:
            from predictionio_torch.parallel.mesh import create_mesh

            self.mesh = create_mesh()
        return self.mesh

    def rng(self) -> torch.Generator:
        """A generator on this context's device, seeded from ``seed``
        (the counterpart of ``MeshContext.rng``'s PRNG key; the streams
        differ, so tests feed both packages numpy-made inputs)."""
        return torch.Generator(device=self.device).manual_seed(self.seed)

    def data_parallel_size(self) -> int:
        from predictionio_torch.parallel.mesh import axis_size

        return axis_size(self.require_mesh(), "data")


class OnDevice:
    """Mixin for a model that keeps numpy arrays (as a blob of either
    package holds them) and computes on a device chosen at train or
    deploy time: ``to(device)`` picks it, ``serving_device()`` is that
    device or, when none was picked, the card. The device never
    pickles."""

    device: Optional[torch.device] = None

    def to(self, device: DeviceLike):
        self.device = resolve_device(device)
        return self

    def serving_device(self) -> torch.device:
        if self.device is None:
            self.to(None)   # the card, or RuntimeError without CUDA
        return self.device

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("device", None)
        return d
