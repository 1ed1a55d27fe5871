"""fedml_tpu_torch: the PyTorch/CUDA port of the fedml_tpu package.

Module paths mirror the JAX package (``fedml_tpu``), which stays the
reference each slice of the port is held against. This package imports
``torch`` and never ``jax`` or ``fedml_tpu``. Importing it builds nothing:
the CUDA kernels under ``ops/csrc`` are compiled at their first launch.

Entry points take ``device=`` and default to ``"cuda"``; without CUDA they
raise unless the caller asks for ``"cpu"``.
"""

from .device import get_device, resolve_device

__version__ = "0.1.0"

__all__ = ["get_device", "resolve_device", "__version__"]
