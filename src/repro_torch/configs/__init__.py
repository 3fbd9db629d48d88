"""Model and protection configuration."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoESpec, ProtectConfig, TrainConfig, Workload, WORKLOADS,
    workload_skips)
from repro_torch.configs.registry import get_config, list_archs  # noqa: F401
