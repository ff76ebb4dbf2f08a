"""Architecture configs of the LM families and the KWS model: the schema
(``base``) and one module of data per published architecture."""
from repro_torch.configs.base import (
    ArchConfig,
    MoEConfig,
    ShapeConfig,
    SHAPES,
    arch_names,
    get_arch,
)

__all__ = ["ArchConfig", "MoEConfig", "ShapeConfig", "SHAPES",
           "arch_names", "get_arch"]
