"""The port stands alone: niagara_tpu_torch and chip_smoke.py import torch,
numpy and the standard library, never the JAX package or JAX, and the C++
cooker the port runs is its own copy, equal in output to the reference's.

* an AST scan of every module of the port (its subpackages too, such as
  parallel/) and of chip_smoke.py;
* a fresh interpreter that imports every module of the port and
  chip_smoke.py with `jax`, `ml_dtypes` and `niagara_tpu` refused by a
  sys.meta_path finder;
* the port's cooker (cooker/bindings.py over cooker/native/) against
  niagara_tpu.cooker.bindings on the procedural mesh's OBJ: the parsed
  vertex stream and every cooked array equal byte for byte."""

import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from niagara_tpu.cooker import bindings as jbindings
from niagara_tpu_torch import cooker
from niagara_tpu_torch.cooker import bindings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "niagara_tpu")
PORT_FILES = sorted(glob.glob(os.path.join(REPO, "niagara_tpu_torch", "**", "*.py"), recursive=True)) + [
    os.path.join(REPO, "chip_smoke.py")]


def _imported(path):
    """Top-level package names of every absolute import in the file."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_package_import(path):
    bad = sorted(set(_imported(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_port_imports_with_jax_package_blocked():
    modules = sorted(
        "niagara_tpu_torch." + os.path.relpath(p, os.path.join(REPO, "niagara_tpu_torch"))[:-3].replace(os.sep, ".")
        for p in PORT_FILES[:-1])
    code = (
        "import importlib, sys\n"
        f"FORBIDDEN = {FORBIDDEN!r}\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in FORBIDDEN:\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in FORBIDDEN]\n"
        "print(len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(modules) > 20
    assert {"niagara_tpu_torch.parallel.__init__", "niagara_tpu_torch.parallel.mesh", "niagara_tpu_torch.bench",
            "niagara_tpu_torch.render.parity", "niagara_tpu_torch.entry"} <= set(modules)


def test_port_cooker_matches_reference(tmp_path):
    path = cooker.procedural_obj(str(tmp_path))
    assert bindings.lib_path().startswith(os.path.join(REPO, "niagara_tpu_torch", "build"))
    ours, ref = bindings.load_obj(path), jbindings.load_obj(path)
    assert ours.dtype.itemsize == ref.dtype.itemsize == 16 and ours.tobytes() == ref.tobytes()
    idx = np.arange(len(ours), dtype=np.uint32)
    a, b = bindings.cook_mesh(ours, idx), jbindings.cook_mesh(ref, idx)
    assert set(a) == set(b)
    for k in a:
        if isinstance(b[k], np.ndarray):
            assert a[k].dtype.itemsize == b[k].dtype.itemsize and a[k].tobytes() == b[k].tobytes(), k
        else:
            assert a[k] == b[k], k
    assert len(a["meshlets"]) > 1000 and a["lod_count"] >= 8
