"""The config surface (counterpart of ``cruise_control_tpu/config``)."""
from cruise_control_tpu_torch.config.configdef import (
    Config, ConfigDef, ConfigException, ConfigKey, Importance, Type, resolve_class,
)
from cruise_control_tpu_torch.config.defaults import (
    CRUISE_CONTROL_CONFIG_DEF, DEFAULT_GOALS, DEFAULT_HARD_GOALS, cruise_control_config,
)

__all__ = [
    "Config", "ConfigDef", "ConfigException", "ConfigKey", "Importance", "Type",
    "resolve_class", "CRUISE_CONTROL_CONFIG_DEF", "DEFAULT_GOALS", "DEFAULT_HARD_GOALS",
    "cruise_control_config",
]
