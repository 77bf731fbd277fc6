"""Scene cooking and synthetic scenes, JAX-free (mirrors niagara_tpu/cooker/):
`cook` (OBJ -> C++ cooker -> Geometry through the scene cache, the
procedural stand-in mesh), `synth` (draw scatter, small scene, planar
uvs, materials, normal map, the alpha and glass scenes), `opacity`
(opacity-mask bake), `gltf` (glTF/.glb loader and scene cache),
`meshopt_codec` and `synth_city` (copies: EXT_meshopt_compression codecs,
the procedural street-canyon city), `bindings` (ctypes to the C++ cooker
and DDS decoder in native/).
"""

from .cook import (CACHE_DIR, DIAMETER, assemble, cook_obj_meshes, cook_or_load, cook_procedural, procedural_mesh,
                   procedural_obj)
from .synth import (alpha_scene, glass_scene, small_alpha_scene, small_glass_scene, small_scene_draws,
                    synthesize_draws, synthesize_materials, synthesize_normal_map, synthesize_planar_uvs)

__all__ = [
    "CACHE_DIR", "DIAMETER", "alpha_scene", "assemble", "cook_obj_meshes", "cook_or_load", "cook_procedural",
    "glass_scene", "procedural_mesh", "procedural_obj", "small_alpha_scene", "small_glass_scene", "small_scene_draws",
    "synthesize_draws", "synthesize_materials", "synthesize_normal_map", "synthesize_planar_uvs",
]
