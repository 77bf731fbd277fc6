"""Each frozen generator in framebench/data equals the program's as it
stands, byte for byte at a tiny size; the reference and the data import
nothing of the program.

    python -m pytest framebench -q
"""

from __future__ import annotations

import dataclasses
import os

import tinyrun  # noqa: F401  (puts framebench and the repository on sys.path)
from data import torus_field


def test_scatter_equals_synthesize_draws():
    from niagara_tpu_torch.cooker import synthesize_draws

    want = synthesize_draws(3, draw_count=1000)
    got = torus_field.scatter_draws(3, 1000, 0x42)
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), got[f.name]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f.name


def test_torus_equals_procedural_mesh(tmp_path):
    from niagara_tpu_torch.cooker import cook

    for a, b in zip(cook.procedural_mesh(), torus_field.torus_mesh()):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    with open(cook.procedural_obj(str(tmp_path))) as f:
        assert f.read() == torus_field.obj_text(*torus_field.torus_mesh())


def test_materials_equal_synthesize_materials():
    from niagara_tpu_torch.cooker import synth

    want = synth.synthesize_materials(100, tex_size=32)
    got = torus_field.checker_materials(100, tex_size=32)
    for k in want[0]:
        assert want[0][k].tobytes() == got[0][k].tobytes()
    assert all(a.tobytes() == b.tobytes() for wa, ga in zip(want[1], got[1]) for a, b in zip(wa, ga))
    assert want[2].tobytes() == got[2].tobytes() and want[3].tobytes() == got[3].tobytes()


def test_planar_uvs_equal_and_alpha_class():
    from niagara_tpu_torch.cooker import cook, synth

    g = cook.cook_procedural()
    want = dataclasses.replace(g)
    synth.synthesize_planar_uvs(want, 6.0)
    assert want.vuv.tobytes() == torus_field.planar_uvs(g.vpos, 6.0).tobytes()
    draws = synth.synthesize_draws(g.meshes.count, draw_count=64)
    _, d, mats, _, mips = synth.alpha_scene(g, draws)
    _, _, mat_idx, post = torus_field.checker_materials(64)
    assert d.material_index.tobytes() == mat_idx.tobytes() and d.post_pass.tobytes() == post.tobytes()


def test_tail_offset_equals_bench():
    from niagara_tpu_torch import bench

    for t in (0.0, 0.3, 7.5, 123.9):
        assert bench.sun_delta(t, "cpu").numpy().tobytes() == torus_field.tail_offset(t).tobytes()


def test_reference_and_data_import_nothing_of_the_program():
    """framebench/ref and framebench/data import no module of the program,
    of the JAX package or JAX (top-level names compared whole)."""
    import ast

    banned = {"niagara_tpu", "niagara_tpu_torch", "jax", "jaxlib", "flax"}
    for sub in ("ref", "data"):
        for dirpath, _, files in os.walk(os.path.join(tinyrun.HERE, sub)):
            for name in files:
                if not name.endswith(".py"):
                    continue
                tree = ast.parse(open(os.path.join(dirpath, name)).read())
                for node in ast.walk(tree):
                    mods = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                        [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0 else []
                    assert not {m.split(".")[0] for m in mods} & banned, (sub, name, mods)
