"""The torus field: a configuration kind.  Both sides get the same draws,
materials and textures, made from the configuration and the seed by the
frozen generators (framebench/data): the scatter from the PCG state
`--seed` (the upstream's is 0x42 = 66), the checker materials and their
alpha class.  The program cooks the torus's OBJ text with its own cooker
(set-up of the system under test); the reference takes the analytic
torus's grid and its own levels of detail (ref/lods.py)."""

from __future__ import annotations

import dataclasses
import functools
import json
import os

import numpy as np

from data import torus_field as torus_data


@dataclasses.dataclass
class Inputs:
    draws: dict  # numpy arrays: position, scale, orientation, mesh_index, meshlet_visibility_offset, post_pass,
    # material_index
    materials: dict
    mips: list  # per texture, its mip chain of uint8 [h, w, 4]

    def draw_arrays(self) -> dict:
        """Fresh copies (the program's upload writes some in place)."""
        return {k: np.array(v, copy=True) for k, v in self.draws.items()}


def make_inputs(config: dict, seed: int) -> Inputs:
    n = config["draws"]
    d = torus_data.scatter_draws(1, n, seed % (1 << 64), config["scatter_range"])
    m = config["materials"]
    mats, mips, mat_idx, post = torus_data.checker_materials(n, m["count"], m["tex_size"], m["seed"])
    d["material_index"][:] = mat_idx
    d["post_pass"][:] = post
    return Inputs(draws=d, materials=mats, mips=mips)


def program_geometry(config: dict, cache_root: str):
    """The program's cooked torus (its scene cache under `cache_root`),
    with planar uvs over its vertices."""
    from niagara_tpu_torch import cooker

    tdir = os.path.join(cache_root, "torus")
    os.makedirs(tdir, exist_ok=True)
    obj = os.path.join(tdir, "torus.obj")
    text = torus_data.obj_text(*torus_data.torus_mesh(**config["mesh"]))
    if not os.path.exists(obj) or open(obj).read() != text:
        with open(obj + ".tmp", "w") as f:
            f.write(text)
        os.replace(obj + ".tmp", obj)
    g = dataclasses.replace(cooker.cook_or_load([obj], cache_dir=tdir))
    g.vuv = torus_data.planar_uvs(g.vpos, config["materials"]["uv_tiles"])
    return g


@functools.lru_cache(maxsize=4)
def _levels(mesh_json: str, tiles: float):
    from ref import lods

    mesh = json.loads(mesh_json)
    pos, nrm, _ = torus_data.torus_mesh(**mesh)
    uv = torus_data.planar_uvs(pos, tiles).astype(np.float32)
    return lods.build_levels(pos, nrm, uv, mesh["ring_segments"], mesh["tube_segments"])


def reference_levels(config: dict) -> list:
    """The reference's levels of the analytic torus (finest first)."""
    return _levels(json.dumps(config["mesh"], sort_keys=True), float(config["materials"]["uv_tiles"]))
