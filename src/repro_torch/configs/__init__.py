"""LM architecture registry of the port: ``get_config(arch)`` -> full
config, ``get_smoke_config(arch)`` -> the reduced same-family config.

Only the dense LMs are here.  The MoE archs (``mixtral-8x7b``,
``olmoe-1b-7b``) wait for the port of ``models/moe.py`` (ROADMAP A.11);
asking for one raises ``NotImplementedError``.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import LM_SHAPES, LMConfig, MoESpec, ShapeSpec

__all__ = ["ARCHS", "LM_SHAPES", "LMConfig", "MoESpec", "ShapeSpec",
           "get_config", "get_smoke_config"]

_MODULES = {
    "internlm2-20b": "internlm2_20b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "qwen3-14b": "qwen3_14b",
}
_NOT_YET = ("mixtral-8x7b", "olmoe-1b-7b")

ARCHS = tuple(_MODULES)


def _module(arch: str):
    if arch in _NOT_YET:
        raise NotImplementedError(
            f"{arch} is a MoE LM; the port has no moe.py yet (ROADMAP A.11)")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> LMConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> LMConfig:
    return _module(arch).SMOKE_CONFIG
