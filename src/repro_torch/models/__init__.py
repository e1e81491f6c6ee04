from repro_torch.models.api import Model, get_model

__all__ = ["get_model", "Model"]
