"""Scene cooking and synthetic scenes, JAX-free (mirrors niagara_tpu/cooker/):
`cook` (OBJ -> C++ cooker -> Geometry, the procedural stand-in mesh),
`synth` (draw scatter, small scene, planar uvs, materials), `opacity`
(opacity-mask bake), `bindings` (ctypes to the C++ cooker in native/).
"""

from .cook import CACHE_DIR, DIAMETER, assemble, cook_obj_meshes, cook_procedural, procedural_mesh, procedural_obj
from .synth import (alpha_scene, small_alpha_scene, small_scene_draws, synthesize_draws, synthesize_materials,
                    synthesize_planar_uvs)

__all__ = [
    "CACHE_DIR", "DIAMETER", "alpha_scene", "assemble", "cook_obj_meshes", "cook_procedural", "procedural_mesh",
    "procedural_obj", "small_alpha_scene", "small_scene_draws", "synthesize_draws", "synthesize_materials",
    "synthesize_planar_uvs",
]
