from .device_service import run_device_service
from .service import ServiceReport, run_service
from .spade_service import DeviceServiceReport, EngineSpec, SpadeService

__all__ = ["SpadeService", "EngineSpec", "ServiceReport",
           "DeviceServiceReport", "run_service", "run_device_service"]
