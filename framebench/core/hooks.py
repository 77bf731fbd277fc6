"""Files of the benchmark found by name: framebench/<folder>/<name>.py,
loaded as modules (a configuration kind, a motion, a camera path, a
per-layer metric's reader)."""

from __future__ import annotations

import importlib.util
import os
import sys


def load(root: str, folder: str, name: str):
    path = os.path.join(root, "framebench", folder, f"{name}.py")
    if not os.path.exists(path):
        raise SystemExit(f"framebench: no {folder}/{name}.py")
    spec = importlib.util.spec_from_file_location(f"framebench_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod
