from .defaults import Config, load_config

__all__ = ["Config", "load_config"]
