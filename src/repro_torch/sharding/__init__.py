from repro_torch.sharding.param import ParamDef, init_leaf, init_params

__all__ = ["ParamDef", "init_leaf", "init_params"]
