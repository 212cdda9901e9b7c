"""The dense decoder LM of the port: configs, layers, the stacked-unit LM."""
from repro_torch.models.config import ArchConfig, get_config, list_configs

__all__ = ["ArchConfig", "get_config", "list_configs"]
