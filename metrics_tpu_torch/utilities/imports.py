"""Flags for the optional packages that some metrics use: the port's copy of
the part of ``metrics_tpu/utilities/imports.py`` it needs."""
import importlib.util


def _package_available(name: str) -> bool:
    try:
        return importlib.util.find_spec(name) is not None
    except (ImportError, ValueError):
        return False


_NLTK_AVAILABLE = _package_available("nltk")
_PESQ_AVAILABLE = _package_available("pesq")
_REGEX_AVAILABLE = _package_available("regex")
_TRANSFORMERS_AVAILABLE = _package_available("transformers")
