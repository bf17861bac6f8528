"""Plain reference of spade-grab4-fd's semantics: FD (paper App. F;
Fraudar, Hooi et al. KDD 2016), Fraudar's column weighting
``1 / log(x + 5)`` with ``x`` the destination's in-degree when the edge
arrives.  float64 torch tensors in and out."""

import torch

USES_DEGREE = True


def esusp(raw: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.log(deg + 5.0)
