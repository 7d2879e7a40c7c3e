"""The precisions a reference computes in: the configuration's own
(``bfloat16`` inputs with float32 sums, or ``float32``), and the one
below it that a control uses (``float8``: e4m3 with a scale a row, the
form a lower-precision path would take)."""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def rounder(name: str):
    """``t -> t`` rounded to ``name`` and back to ``t``'s dtype; for
    ``float8``, each row (last axis) is scaled to the format's range
    first."""
    if name == "float32":
        return lambda t: t
    if name == "bfloat16":
        return lambda t: t.to(torch.bfloat16).to(t.dtype)
    if name == "float8":
        def fp8(t):
            scale = (t.abs().amax(dim=-1, keepdim=True) / FP8_MAX).clamp_min(
                1e-30)
            return ((t / scale).to(torch.float8_e4m3fn).to(t.dtype)
                    * scale)
        return fp8
    raise ValueError(f"unknown precision {name!r}")


def lower(name: str) -> str:
    """The nearest precision below ``name`` (the control's)."""
    return {"float32": "bfloat16", "bfloat16": "float8"}[name]


def exact_matmuls() -> None:
    """float32 matmuls in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
