from .base import (ARCH_IDS, ModelConfig, all_configs, get_config,
                   register)  # noqa: F401
