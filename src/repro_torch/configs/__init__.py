"""Architecture registry of the port: ``get_config(arch)`` -> full config,
``get_smoke_config(arch)`` -> the reduced same-family config,
``ARCH_FAMILY`` -> ``"lm"`` | ``"gnn"`` | ``"recsys"`` | ``"spade"``,
``arch_shapes(arch)`` -> ``{shape name: ShapeSpec | Skip}`` and
``all_cells()`` -> every ``(arch, shape, spec)``.

All eleven architectures of ``repro`` are here: the five LMs (three dense,
and the MoE ``mixtral-8x7b`` and ``olmoe-1b-7b``), the four GNNs, the
recsys ``two-tower-retrieval`` and the paper's own workload,
``spade-grab``.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

from repro_torch.configs.base import (GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES, SPADE_SHAPES,
                                      GNNConfig, LMConfig, MoESpec, RecsysConfig, ShapeSpec,
                                      SpadeConfig)

__all__ = ["ARCHS", "ARCH_FAMILY", "GNN_SHAPES", "LM_SHAPES", "RECSYS_SHAPES",
           "SPADE_SHAPES", "GNNConfig", "LMConfig", "MoESpec", "RecsysConfig", "ShapeSpec",
           "SpadeConfig", "Skip", "all_cells", "arch_shapes", "get_config",
           "get_smoke_config"]

_MODULES = {
    "mixtral-8x7b": "mixtral_8x7b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "internlm2-20b": "internlm2_20b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "qwen3-14b": "qwen3_14b",
    "meshgraphnet": "meshgraphnet",
    "gat-cora": "gat_cora",
    "dimenet": "dimenet",
    "gcn-cora": "gcn_cora",
    "two-tower-retrieval": "two_tower_retrieval",
    "spade-grab": "spade_grab",
}

ARCHS = tuple(_MODULES)

ARCH_FAMILY = {
    "mixtral-8x7b": "lm",
    "olmoe-1b-7b": "lm",
    "internlm2-20b": "lm",
    "deepseek-coder-33b": "lm",
    "qwen3-14b": "lm",
    "meshgraphnet": "gnn",
    "gat-cora": "gnn",
    "dimenet": "gnn",
    "gcn-cora": "gnn",
    "two-tower-retrieval": "recsys",
    "spade-grab": "spade",
}


@dataclass(frozen=True)
class Skip:
    reason: str


def _module(arch: str):
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> LMConfig | GNNConfig | RecsysConfig | SpadeConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> LMConfig | GNNConfig | RecsysConfig | SpadeConfig:
    return _module(arch).SMOKE_CONFIG


def arch_shapes(arch: str) -> dict[str, ShapeSpec | Skip]:
    fam = ARCH_FAMILY[arch]
    if fam == "lm":
        out: dict[str, ShapeSpec | Skip] = dict(LM_SHAPES)
        if get_config(arch).sliding_window is None:
            # long_500k needs sub-quadratic attention: full-attention archs
            # skip it, the sliding-window mixtral runs it
            out["long_500k"] = Skip(
                "full-attention arch: 524288-token dense KV cache is not "
                "sub-quadratic; SWA/SSM archs only"
            )
        return out
    return dict({"gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES, "spade": SPADE_SHAPES}[fam])


def all_cells(include_spade: bool = True) -> list[tuple[str, str, ShapeSpec | Skip]]:
    """Every ``(arch, shape, spec)``: the 40 assigned cells and the paper's
    own two."""
    return [(arch, shape, spec) for arch in ARCHS
            if include_spade or ARCH_FAMILY[arch] != "spade"
            for shape, spec in arch_shapes(arch).items()]
