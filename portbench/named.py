"""Names in the benchmark's data files, found among the built-ins or as a
file of their own.

A configuration's ``data`` and a mix's ``pattern`` each name either an
entry of a built-in dict (``gen.DATA``, ``patterns.PATTERNS``) or a file
``<folder>/<name>.py`` beside it (``portbench/inputs/``,
``portbench/calls/``), so that a later configuration or mix is added as new
files. A file is loaded once a process, from the tree that is running.
"""

from __future__ import annotations

import importlib.util
import os
import re
import sys

NAME = re.compile(r"[A-Za-z0-9_]+")


def load(path: str, module: str):
    """The module of the file at ``path``, under the name ``module``,
    executed the first time and taken from ``sys.modules`` after."""
    mod = sys.modules.get(module)
    if mod is not None and mod.__file__ == path:
        return mod
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[module] = mod  # before it runs, as an import does (dataclasses look for it)
    spec.loader.exec_module(mod)
    return mod


def find(kind: str, name, builtin: dict, where: str, folder: str):
    """``builtin[name]``, or the module of ``<folder>/<name>.py``. A name
    that is not ``[A-Za-z0-9_]+``, or that is found in both places or in
    neither, is refused with a ``ValueError`` naming both."""
    rel = f"portbench/{os.path.basename(folder)}/"
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"{kind} {name!r} is not of [A-Za-z0-9_]+: it names an entry of "
                         f"{where} or a file {rel}<name>.py")
    path = os.path.join(folder, name + ".py")
    if name in builtin and os.path.isfile(path):
        raise ValueError(f"{kind} {name!r} is both in {where} and a file {rel}{name}.py")
    if name in builtin:
        return builtin[name]
    if not os.path.isfile(path):
        raise ValueError(f"{kind} {name!r} is neither in {where} ({', '.join(sorted(builtin))}) "
                         f"nor a file {rel}{name}.py")
    return load(path, f"portbench_{os.path.basename(folder)}_{name}")
