"""Model configs the port serves. Importing this package registers each one;
use `repro_torch.common.registry.get_arch(name)`."""
from repro_torch.configs import carboncall_qwen2_7b, mamba2_370m  # noqa: F401
