"""Case-insensitive string enums used across the library.

A copy of ``metrics_tpu/utilities/enums.py`` (the port never imports the
JAX package); the values are the ones checkpoints carry, so a JAX metric's
``aux:mode`` entry loads here unchanged.
"""
from enum import Enum
from typing import Optional, Union


class EnumStr(str, Enum):
    """String enum with case-insensitive ``from_str`` lookup."""

    @classmethod
    def from_str(cls, value: str) -> Optional["EnumStr"]:
        normalized = value.replace("-", "_").upper()
        try:
            return cls[normalized]
        except KeyError:
            pass
        try:  # e.g. 'multi-class' -> MULTICLASS
            return cls[normalized.replace("_", "")]
        except KeyError:
            return None

    @classmethod
    def from_str_or_raise(cls, value: Union[str, "EnumStr", None]) -> "EnumStr":
        if value is None:
            raise ValueError(f"None is not a valid {cls.__name__}")
        if isinstance(value, cls):
            return value
        out = cls.from_str(str(value))
        if out is None:
            raise ValueError(
                f"Invalid value {value!r} for {cls.__name__}; expected one of "
                f"{[e.value for e in cls]}"
            )
        return out

    def __eq__(self, other: object) -> bool:
        if isinstance(other, str):
            return self.value.lower() == other.lower()
        return super().__eq__(other)

    def __hash__(self) -> int:
        return hash(self.value.lower())


class DataType(EnumStr):
    """Classification input layout inferred by input formatting."""

    BINARY = "binary"
    MULTILABEL = "multi-label"
    MULTICLASS = "multi-class"
    MULTIDIM_MULTICLASS = "multi-dim multi-class"


class AverageMethod(EnumStr):
    """Averaging strategies for per-class statistics."""

    MICRO = "micro"
    MACRO = "macro"
    WEIGHTED = "weighted"
    NONE = "none"
    SAMPLES = "samples"


class MDMCAverageMethod(EnumStr):
    """Reduction over the extra dims of multi-dim multi-class inputs."""

    GLOBAL = "global"
    SAMPLEWISE = "samplewise"
