"""Files of the benchmark found by name: framebench/<folder>/<name>.py,
loaded as modules (a configuration kind, a motion, a camera path, a
per-layer metric's reader), and the functions a configuration's kind may
bring of its own (`kind_hook`)."""

from __future__ import annotations

import builtins
import contextlib
import functools
import importlib
import importlib.util
import os
import sys
import types

PROGRAM = "niagara_tpu_torch"
# a kind's own reference and comparison: they import nothing of the program
REFERENCE_HOOKS = ("reference_scene", "reference_render", "compare_extra")


def load(root: str, folder: str, name: str):
    path = os.path.join(root, "framebench", folder, f"{name}.py")
    if not os.path.exists(path):
        raise SystemExit(f"framebench: no {folder}/{name}.py")
    spec = importlib.util.spec_from_file_location(f"framebench_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def _is_program(name) -> bool:
    return isinstance(name, str) and name.split(".")[0] == PROGRAM


def program_globals(namespace: dict) -> list[str]:
    """Names in a module's namespace bound to a module of the program or to
    an object it defines."""
    return sorted(k for k, v in namespace.items()
                  if _is_program(v.__name__ if isinstance(v, types.ModuleType) else getattr(v, "__module__", None)))


@contextlib.contextmanager
def no_program(what: str):
    """Within: an import of the program ends the run."""
    real_import, real_import_module = builtins.__import__, importlib.import_module

    def refuse(name):
        raise SystemExit(f"framebench: {what} imports {name}; a configuration's reference and checks import "
                         f"nothing of {PROGRAM}")

    def guarded_import(name, globals=None, locals=None, fromlist=(), level=0):
        if level == 0 and _is_program(name):
            refuse(name)
        return real_import(name, globals, locals, fromlist, level)

    def guarded_import_module(name, package=None):
        if _is_program(name):
            refuse(name)
        return real_import_module(name, package)

    builtins.__import__, importlib.import_module = guarded_import, guarded_import_module
    try:
        yield
    finally:
        builtins.__import__, importlib.import_module = real_import, real_import_module


def kind_hook(kind, name: str):
    """The configuration kind's own `name` (REFERENCE_HOOKS or
    `program_extra`), or None where the kind has none and the harness's own
    code serves.  A reference hook is refused where its module or the
    kind's holds anything of the program, and runs where an import of the
    program ends the run."""
    fn = getattr(kind, name, None)
    if fn is None or name not in REFERENCE_HOOKS:
        return fn
    held = program_globals(vars(kind)) + program_globals(getattr(fn, "__globals__", {}))
    if held:
        raise SystemExit(f"framebench: kind {kind.__name__} defines {name} beside {sorted(set(held))} of the "
                         f"program; a configuration's reference and checks import nothing of {PROGRAM}")

    @functools.wraps(fn)
    def guarded(*args, **kw):
        with no_program(f"{kind.__name__}.{name}"):
            return fn(*args, **kw)

    return guarded
