"""Model configs the port serves. Importing this package registers each one;
use `repro_torch.common.registry.get_arch(name)`."""
from repro_torch.configs import (  # noqa: F401
    carboncall_qwen2_7b, hermes2_pro_8b, llama31_8b, llama4_scout,
    mamba2_370m, phi3_5_moe, qwen2_5_32b, zamba2_7b)
