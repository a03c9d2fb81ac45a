"""PEP 562 lazy exports for the package's ``__init__`` files, so that
importing one submodule does not import its siblings (and no import cycle
runs through a package ``__init__``)."""

from __future__ import annotations

import importlib
import sys
from typing import Callable, Dict, Tuple


def lazy_exports(package: str, exports: Dict[str, str]
                 ) -> Tuple[Callable, Callable]:
    """``__getattr__`` and ``__dir__`` for ``package`` that load each name
    of ``exports`` ({name: submodule}) from its submodule on first use; a
    name equal to its submodule's is the submodule itself."""

    def __getattr__(name):
        if name not in exports:
            raise AttributeError(
                f"module {package!r} has no attribute {name!r}")
        module = importlib.import_module(f"{package}.{exports[name]}")
        value = module if name == exports[name] else getattr(module, name)
        setattr(sys.modules[package], name, value)
        return value

    def __dir__():
        return sorted(set(vars(sys.modules[package])) | set(exports))

    return __getattr__, __dir__
