from repro_torch.common.hardware import ORIN_AGX, HardwareSpec
from repro_torch.common.registry import get_arch, list_archs, register_arch

__all__ = ["register_arch", "get_arch", "list_archs", "ORIN_AGX",
           "HardwareSpec"]
