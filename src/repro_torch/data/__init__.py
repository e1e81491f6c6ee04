from repro_torch.data.workload import FunctionCallWorkload, ToolCatalog

__all__ = ["FunctionCallWorkload", "ToolCatalog"]
