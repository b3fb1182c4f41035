from repro_torch.configs.base import (ARCH_IDS, LM_SHAPES, ModelConfig,
                                      ShapeConfig, TrainConfig, get_config,
                                      reduced, shape_by_name)

__all__ = ["ARCH_IDS", "LM_SHAPES", "ModelConfig", "ShapeConfig", "TrainConfig",
           "get_config", "reduced", "shape_by_name"]
