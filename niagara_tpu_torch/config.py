"""Engine-wide constants the port reads (the values of niagara_tpu/config.py)."""

# meshlet geometry budget (reference config.h:14-15)
MESH_MAXVTX = 64  # max vertices per meshlet
MESH_MAXTRI = 96  # max triangles per meshlet
TASK_WGSIZE = 64  # meshlets per task command of the sun map's command builder

# LOD slots per mesh (the reference's 8, extended to 16)
MAX_LODS = 16

# framebuffer tile, in pixels (rows, cols): the raster and shade kernels'
# unit of work and the pair-emission grid
TILE_H = 8
TILE_W = 128
