from .defaults import Config, load_config, recompute_losses

__all__ = ["Config", "load_config", "recompute_losses"]
