"""Roundings of a product's operands, for the controls: the reference
computed one precision below what a configuration states.

``fp8_e4m3`` rounds a tensor to float8 e4m3 under one scale per tensor (its
largest magnitude maps to the format's largest finite value, 448), as fp8
inference does, and returns it in float32."""
from __future__ import annotations

import torch

FP8_MAX = 448.0


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


ROUNDINGS = {"fp8_e4m3": fp8_e4m3}
