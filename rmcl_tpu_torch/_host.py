"""Import the JAX package's jax-free host modules without its ``__init__``.

The port shares ``rmcl_tpu.core.config`` (the config and its named presets),
``rmcl_tpu.serve.postprocess`` and, for raw requests, the ``rmcl_tpu.data``
image and text pipeline.  None of them imports jax, but
``rmcl_tpu/__init__.py`` does, to re-export the JAX model.  So when
``rmcl_tpu`` is not imported yet, ``reference_module`` registers it as a
bare package (its search path only) before importing the submodule.  In
such a process ``import rmcl_tpu`` then gives that bare package: import
JAX-side names from their submodules (``rmcl_tpu.models.vilt``), not from
the package.
"""

from __future__ import annotations

import importlib
import importlib.util
import sys


def reference_module(name: str):
    """``rmcl_tpu.<name>``, imported without running ``rmcl_tpu/__init__.py``."""
    if "rmcl_tpu" not in sys.modules:
        spec = importlib.util.find_spec("rmcl_tpu")
        if spec is None:
            raise ModuleNotFoundError(
                "rmcl_tpu_torch needs the rmcl_tpu package beside it for its "
                "config and host pipeline")
        sys.modules["rmcl_tpu"] = importlib.util.module_from_spec(spec)
    return importlib.import_module(f"rmcl_tpu.{name}")


def build_config(*names: str, **overrides):
    """``rmcl_tpu.core.config.build_config``: named presets, then overrides."""
    return reference_module("core.config").build_config(*names, **overrides)
