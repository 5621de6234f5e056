"""Package metadata (port of ``metrics_tpu/__about__.py``); the version is
``pyproject.toml``'s."""
__version__ = "0.1.0"
__author__ = "metrics_tpu contributors"
__license__ = "Apache-2.0"
__docs__ = "PyTorch/CUDA (NVIDIA Hopper) port of the metrics_tpu machine-learning metrics framework"
