"""Config system (port of splade_tpu.config): typed dataclasses + YAML + env
overrides + CLI overrides, in that order of precedence."""

from splade_tpu_torch.config.loader import (apply_env_overrides, load_config,
                                            save_config)
from splade_tpu_torch.config.v33 import (V33Config, V33DataConfig,
                                         V33LossConfig, V33MeshConfig,
                                         V33ModelConfig, V33TrainingConfig)

__all__ = [
    "V33Config", "V33ModelConfig", "V33LossConfig", "V33DataConfig",
    "V33TrainingConfig", "V33MeshConfig", "load_config", "save_config",
    "apply_env_overrides",
]
