"""The JAX package's framework-free modules, shared without copying.

``gloc3d_tpu/config.py`` (stdlib only), ``gloc3d_tpu/data/native.py``
(numpy + ctypes, the native scan loader bridge), ``data/dataset.py``
(``TripletDataset``, numpy) and ``eval/recall.py`` (numpy) are loaded here
BY FILE PATH, so the ``gloc3d_tpu`` package ``__init__`` — which imports
jax — never runs: the port imports no JAX. Each module is registered in
``sys.modules`` under its own name before it executes, because
``typing.get_type_hints`` resolves the config dataclasses' string
annotations through that entry (``_Base.from_dict``, used by ``from_json``
and ``DescriptorBank.load``).
"""

from __future__ import annotations

import importlib.util
import os
import sys
from types import ModuleType

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name: str, relpath: str) -> ModuleType:
    if name in sys.modules:
        return sys.modules[name]
    path = os.path.join(_REPO, "gloc3d_tpu", relpath)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[name]
        raise
    return module


config = _load("gloc3d_tpu_torch._config", "config.py")
native = _load("gloc3d_tpu_torch._native", "data/native.py")
dataset = _load("gloc3d_tpu_torch._dataset", "data/dataset.py")
recall = _load("gloc3d_tpu_torch._recall", "eval/recall.py")
