from repro_torch.configs.base import (
    SHAPES, SMOKE_SHAPE, ArchConfig, ShapeConfig, all_archs, dryrun_cells,
    get_arch, smoke_config,
)

__all__ = [
    "SHAPES", "SMOKE_SHAPE", "ArchConfig", "ShapeConfig", "all_archs",
    "dryrun_cells", "get_arch", "smoke_config",
]
