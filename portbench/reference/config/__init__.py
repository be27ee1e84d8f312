from .defaults import (Config, apply_overrides, check_decode_options, load_config,
                       recompute_losses)

__all__ = ["Config", "apply_overrides", "check_decode_options", "load_config",
           "recompute_losses"]
