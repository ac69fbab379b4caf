from repro_torch.configs.base import SHAPES, ArchConfig, MoEConfig, ShapeConfig, shape_skip_reason
from repro_torch.configs.registry import ARCHS, get_arch

__all__ = ["ARCHS", "ArchConfig", "MoEConfig", "SHAPES", "ShapeConfig",
           "get_arch", "shape_skip_reason"]
