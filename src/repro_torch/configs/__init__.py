"""Architecture registry of the port: ``get_config(arch)`` -> full config,
``get_smoke_config(arch)`` -> the reduced same-family config,
``ARCH_FAMILY`` -> ``"lm"`` | ``"gnn"`` | ``"spade"``.

Here are the dense LMs, the four GNNs and the paper's own workload,
``spade-grab``.  The MoE archs
(``mixtral-8x7b``, ``olmoe-1b-7b``) wait for the port of ``models/moe.py``
(ROADMAP A.11) and ``two-tower-retrieval`` for ``models/two_tower.py``
(ROADMAP A.10); asking for one raises ``NotImplementedError``.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (GNN_SHAPES, LM_SHAPES, SPADE_SHAPES, GNNConfig,
                                      LMConfig, MoESpec, ShapeSpec, SpadeConfig)

__all__ = ["ARCHS", "ARCH_FAMILY", "GNN_SHAPES", "LM_SHAPES", "SPADE_SHAPES", "GNNConfig",
           "LMConfig", "MoESpec", "ShapeSpec", "SpadeConfig", "get_config",
           "get_smoke_config"]

_MODULES = {
    "internlm2-20b": "internlm2_20b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "qwen3-14b": "qwen3_14b",
    "meshgraphnet": "meshgraphnet",
    "gat-cora": "gat_cora",
    "dimenet": "dimenet",
    "gcn-cora": "gcn_cora",
    "spade-grab": "spade_grab",
}
_NOT_YET = {
    "mixtral-8x7b": "is a MoE LM; the port has no moe.py yet (ROADMAP A.11)",
    "olmoe-1b-7b": "is a MoE LM; the port has no moe.py yet (ROADMAP A.11)",
    "two-tower-retrieval": "is a recsys model; the port has no two_tower.py yet "
                           "(ROADMAP A.10)",
}

ARCHS = tuple(_MODULES)

ARCH_FAMILY = {
    "internlm2-20b": "lm",
    "deepseek-coder-33b": "lm",
    "qwen3-14b": "lm",
    "meshgraphnet": "gnn",
    "gat-cora": "gnn",
    "dimenet": "gnn",
    "gcn-cora": "gnn",
    "spade-grab": "spade",
}


def _module(arch: str):
    if arch in _NOT_YET:
        raise NotImplementedError(f"{arch} {_NOT_YET[arch]}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> LMConfig | GNNConfig | SpadeConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> LMConfig | GNNConfig | SpadeConfig:
    return _module(arch).SMOKE_CONFIG
