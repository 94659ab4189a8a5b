"""(Counterpart of ``cruise_control_tpu/config/configdef.py``, copied
unchanged.) Typed config definition/validation framework.

Analogue of the reference's Kafka-style config framework
(cruise-control-core/src/main/java/com/linkedin/cruisecontrol/common/config/ConfigDef.java,
AbstractConfig.java): every tunable is a declared, typed, documented key with a
default and optional validator, and pluggable components are loaded through the
config (`getConfiguredInstance`). This is deliberately a fresh, small Python
design — dataclass key declarations + a dict-backed Config — rather than a port
of the Java builder API.
"""
from __future__ import annotations

import dataclasses
import enum
import importlib
from typing import Any, Callable, Iterable, Mapping, Sequence


class ConfigException(Exception):
    """Raised on invalid config keys/values (reference ConfigException.java)."""


# When not None, every key read through Config.get/__getitem__ records its
# RESOLVED canonical name here. tests/test_config_surface.py uses this to
# prove every canonical key is actually consumed somewhere (the anti-
# "defined-but-dead key" guard); no production path enables it.
READ_TRACKER: set | None = None


class Type(enum.Enum):
    BOOLEAN = "boolean"
    INT = "int"
    LONG = "long"  # kept distinct for doc parity; Python ints either way
    DOUBLE = "double"
    STRING = "string"
    LIST = "list"          # comma-separated string or sequence -> list[str]
    CLASS = "class"        # dotted path or class object
    PASSWORD = "password"  # string, redacted in dumps (core types/Password.java)


class Importance(enum.Enum):
    HIGH = "high"
    MEDIUM = "medium"
    LOW = "low"


def _coerce(name: str, typ: Type, value: Any) -> Any:
    if value is None:
        return None
    try:
        if typ is Type.BOOLEAN:
            if isinstance(value, bool):
                return value
            if isinstance(value, str):
                low = value.strip().lower()
                if low in ("true", "1", "yes"):
                    return True
                if low in ("false", "0", "no"):
                    return False
            raise ValueError(value)
        if typ in (Type.INT, Type.LONG):
            if isinstance(value, bool):
                raise ValueError(value)
            return int(value)
        if typ is Type.DOUBLE:
            return float(value)
        if typ in (Type.STRING, Type.PASSWORD):
            return str(value)
        if typ is Type.LIST:
            if isinstance(value, str):
                return [v.strip() for v in value.split(",") if v.strip()]
            return [str(v) for v in value]
        if typ is Type.CLASS:
            return value  # resolved lazily by get_class()
    except (TypeError, ValueError) as e:
        raise ConfigException(f"Invalid value {value!r} for config {name!r} of type {typ.value}") from e
    raise ConfigException(f"Unknown config type {typ}")


@dataclasses.dataclass(frozen=True)
class ConfigKey:
    name: str
    type: Type
    default: Any = None
    doc: str = ""
    importance: Importance = Importance.MEDIUM
    validator: Callable[[Any], bool] | None = None
    validator_doc: str = ""
    required: bool = False
    # Reference-compatible spelling of another key: setting this key sets the
    # canonical one (conflict if both are set to different values), and reads
    # of either name resolve to the canonical value. This is how the
    # reference's exact key names stay accepted where this framework's
    # canonical name differs (e.g. ``webserver.session.maxExpiryTimeMs`` ->
    # ``webserver.session.maxExpiryTime``).
    alias_of: str | None = None

    def validate(self, value: Any) -> Any:
        value = _coerce(self.name, self.type, value)
        if value is None:
            if self.required:
                raise ConfigException(f"Missing required config {self.name!r}")
            return None
        if self.validator is not None and not self.validator(value):
            raise ConfigException(
                f"Invalid value {value!r} for config {self.name!r}: {self.validator_doc or 'failed validation'}"
            )
        return value


def at_least(lo) -> Callable[[Any], bool]:
    return lambda v: v >= lo


def between(lo, hi) -> Callable[[Any], bool]:
    return lambda v: lo <= v <= hi


def in_set(*options) -> Callable[[Any], bool]:
    allowed = set(options)
    return lambda v: v in allowed


class ConfigDef:
    """A registry of ConfigKeys. Supports chained .define() like the reference."""

    def __init__(self, keys: Iterable[ConfigKey] = ()):  # noqa: D401
        self._keys: dict[str, ConfigKey] = {}
        for k in keys:
            self.define(k)

    def define(self, key: ConfigKey | None = None, /, **kwargs) -> "ConfigDef":
        if key is None:
            key = ConfigKey(**kwargs)
        if key.name in self._keys:
            raise ConfigException(f"Config {key.name!r} defined twice")
        self._keys[key.name] = key
        return self

    def merge(self, other: "ConfigDef") -> "ConfigDef":
        for k in other._keys.values():
            self.define(k)
        return self

    def keys(self) -> Mapping[str, ConfigKey]:
        return dict(self._keys)

    def resolve_name(self, name: str) -> str:
        """Canonical key name (follows alias_of; identity for canonical keys)."""
        key = self._keys.get(name)
        while key is not None and key.alias_of is not None:
            name = key.alias_of
            key = self._keys.get(name)
        return name

    def parse(self, props: Mapping[str, Any], ignore_unknown: bool = False) -> dict[str, Any]:
        unknown = set(props) - set(self._keys)
        if unknown and not ignore_unknown:
            raise ConfigException(f"Unknown config key(s): {sorted(unknown)}")
        # fold alias spellings onto their canonical keys first
        folded: dict[str, Any] = {}
        for name, value in props.items():
            canon = self.resolve_name(name)
            if canon in folded and folded[canon] != value:
                raise ConfigException(
                    f"Config {name!r} conflicts with its alias target "
                    f"{canon!r}: {value!r} vs {folded[canon]!r}")
            folded[canon] = value
        out: dict[str, Any] = {}
        for name, key in self._keys.items():
            if key.alias_of is not None:
                continue   # reads resolve through resolve_name
            raw = folded.get(name, key.default)
            out[name] = key.validate(raw)
        return out


REFERENCE_PACKAGE = "cruise_control_tpu."
PORT_PACKAGE = "cruise_control_tpu_torch."


def resolve_class(spec: Any):
    """Resolve a dotted ``pkg.mod.Class`` path (or pass through a class).
    A path into the reference's package (every class-valued default names
    one) resolves to the port's class of the same module path, so the port
    never imports the reference."""
    if isinstance(spec, type):
        return spec
    if callable(spec) and not isinstance(spec, str):
        return spec
    if not isinstance(spec, str):
        raise ConfigException(f"Cannot resolve class from {spec!r}")
    if spec.startswith(REFERENCE_PACKAGE):
        spec = PORT_PACKAGE + spec[len(REFERENCE_PACKAGE):]
    mod_name, _, cls_name = spec.rpartition(".")
    if not mod_name:
        raise ConfigException(f"Class spec {spec!r} must be a dotted path")
    try:
        mod = importlib.import_module(mod_name)
        return getattr(mod, cls_name)
    except (ImportError, AttributeError) as e:
        raise ConfigException(f"Cannot load class {spec!r}: {e}") from e


class Config:
    """Validated config bag with pluggable-instance loading.

    Reference: AbstractConfig.java — `getConfiguredInstance(s)` constructs the
    configured class and, if it implements `CruiseControlConfigurable`
    (here: has a ``configure(config)`` method), passes the config in.
    """

    def __init__(self, config_def: ConfigDef, props: Mapping[str, Any] | None = None,
                 ignore_unknown: bool = False):
        self._def = config_def
        self._props = dict(props or {})
        self._values = config_def.parse(self._props, ignore_unknown=ignore_unknown)

    def __contains__(self, name: str) -> bool:
        return self._def.resolve_name(name) in self._values

    def get(self, name: str, default: Any = None) -> Any:
        name = self._def.resolve_name(name)
        if READ_TRACKER is not None:
            READ_TRACKER.add(name)
        if name not in self._values:
            return default
        return self._values[name]

    def __getitem__(self, name: str) -> Any:
        name = self._def.resolve_name(name)
        if READ_TRACKER is not None:
            READ_TRACKER.add(name)
        try:
            return self._values[name]
        except KeyError:
            raise ConfigException(f"Unknown config {name!r}") from None

    def get_int(self, name: str) -> int:
        return self[name]

    def get_double(self, name: str) -> float:
        return self[name]

    def get_boolean(self, name: str) -> bool:
        return self[name]

    def get_string(self, name: str) -> str:
        return self[name]

    def get_list(self, name: str) -> list:
        return self[name] or []

    def get_class(self, name: str):
        spec = self[name]
        return None if spec is None else resolve_class(spec)

    def get_configured_instance(self, name: str, expected_type: type | None = None, **extra):
        cls = self.get_class(name)
        if cls is None:
            return None
        return self.configure_instance(cls, expected_type, **extra)

    def get_configured_instances(self, name: str, expected_type: type | None = None, **extra) -> list:
        specs = self.get_list(name)
        return [self.configure_instance(resolve_class(s), expected_type, **extra) for s in specs]

    def configure_instance(self, cls, expected_type: type | None = None, **extra):
        obj = cls()
        if expected_type is not None and not isinstance(obj, expected_type):
            raise ConfigException(f"{cls} is not a {expected_type}")
        configure = getattr(obj, "configure", None)
        if callable(configure):
            configure(self, **extra)
        return obj

    def values(self, redact: bool = True) -> dict[str, Any]:
        out = dict(self._values)
        if redact:
            for name, key in self._def.keys().items():
                if key.type is Type.PASSWORD and out.get(name):
                    out[name] = "[hidden]"
        return out

    def originals(self) -> dict[str, Any]:
        return dict(self._props)
