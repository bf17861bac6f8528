from .ops import peel_round
from .ref import peel_round_ref

__all__ = ["peel_round", "peel_round_ref"]
