from repro_torch.configs.base import (SHAPES, ArchConfig, AttentionConfig,
                                ModelConfig, MoEConfig, ParallelConfig,
                                ShapeSpec, SSMConfig, TrainConfig, reduced)
from repro_torch.configs.registry import (cells, get_config, get_reduced_config,
                                    get_shape, list_archs)

__all__ = [
    "SHAPES", "ArchConfig", "AttentionConfig", "ModelConfig", "MoEConfig",
    "ParallelConfig", "ShapeSpec", "SSMConfig", "TrainConfig", "reduced",
    "cells", "get_config", "get_reduced_config", "get_shape", "list_archs",
]
