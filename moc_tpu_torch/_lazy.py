"""Package-level names imported at their first use (a PEP 562 module
``__getattr__``), so that importing a package does not import what only some
of its names need (``torch`` for ``moc_tpu_torch.utils``, the model zoo for
``data.patches``, the MOC core for the fused MIL folds)."""

from __future__ import annotations

import importlib
import sys


def lazy_exports(package: str, names: dict[str, str]):
    """A module ``__getattr__`` for ``package``: ``names[name]`` is the module
    that defines ``name``, or the submodule ``package.name`` itself. The value
    is bound on the package at first use."""

    def __getattr__(name: str):
        where = names.get(name)
        if where is None:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        module = importlib.import_module(where)
        value = module if where == f"{package}.{name}" else getattr(module, name)
        setattr(sys.modules[package], name, value)
        return value

    return __getattr__
