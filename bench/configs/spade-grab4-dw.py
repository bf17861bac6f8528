"""Plain reference of spade-grab4-dw's semantics: DW (paper App. F;
Gudapati et al.), an edge's suspiciousness is its transaction amount,
clamped positive.  float64 torch tensors in and out."""

import torch

USES_DEGREE = False


def esusp(raw: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    return torch.clamp(raw, min=1e-12)
