from .defaults import Config, check_decode_options, load_config, recompute_losses

__all__ = ["Config", "check_decode_options", "load_config", "recompute_losses"]
