"""Model configs the port serves. Importing this package registers each one;
use `repro_torch.common.registry.get_arch(name)`."""
from repro_torch.configs import (  # noqa: F401
    carboncall_qwen2_7b, hermes2_pro_8b, llama31_8b, mamba2_370m,
    qwen2_5_32b)
