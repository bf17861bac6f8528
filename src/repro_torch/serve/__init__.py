from .spade_service import DeviceServiceReport, EngineSpec, SpadeService

__all__ = ["SpadeService", "EngineSpec", "DeviceServiceReport"]
