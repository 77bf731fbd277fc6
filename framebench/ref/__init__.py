"""The plain reference that decides `correct`, written from the renderer's
semantics and independent of the program: it imports nothing of
niagara_tpu_torch, takes none of its cooked geometry, BVH, tables or
state, and shares none of its algorithms.

- lods.py: the torus's levels of detail, subsampled from the analytic
  surface's grid, each with its own measured geometric error.
- raster.py: a brute-force z-buffer of every draw inside the draw distance
  at the level its error allows (under a pixel), with no occlusion culling;
  triangles cut at the near plane, back faces culled where single-sided.
- rays.py: brute-force rays against every draw's triangles.
- sunmap.py: the sun's depth map where moving draws were, by rays.
- shade.py: texture lookup and the sun/ambient/specular lighting model.
- frame.py: one frame of a scene from the harness's inputs.
"""
