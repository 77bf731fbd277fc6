// Native geometry cooker — public C ABI consumed from Python via ctypes.
//
// The port's own copy of niagara_tpu/cooker/native's cook path (cooker.cpp,
// meshlet.cpp, simplify.cpp and these headers, unchanged but for the BVH
// declaration, which the port does not build); cooker/bindings.py builds it
// with g++ into niagara_tpu_torch/build/.
//
// TPU-native re-implementation of the reference's content pipeline
// (reference: src/scene.cpp:24-293 appendMeshlet/appendMeshlets/loadObj/
// appendMesh, built on the meshoptimizer library).  The algorithms are
// written from scratch: OBJ ingest + quantization, vertex dedup/remap,
// vertex-cache (tipsify) and fetch optimization, greedy meshlet clustering
// with bounding-sphere/cone computation, and quadric-error-metric LOD
// simplification.
#pragma once

#include <stdint.h>

#ifdef __cplusplus
extern "C"
{
#endif

	// Quantized vertex, 16 bytes — bit-layout of reference scene.h:60-66.
	typedef struct CkVertex
	{
		uint16_t vx, vy, vz; // fp16 position
		uint16_t tp;         // packed 8-8 octahedral tangent
		uint32_t np;         // 10-10-10 snorm normal + bit30 bitangent sign
		uint16_t tu, tv;     // fp16 uv
	} CkVertex;

	// Meshlet header, 24 bytes — bit-layout of reference scene.h:10-23.
	typedef struct CkMeshlet
	{
		uint16_t center[3]; // fp16 bits
		uint16_t radius;    // fp16 bits
		int8_t cone_axis[3];
		int8_t cone_cutoff;
		uint32_t data_offset;
		uint32_t base_vertex;
		uint8_t vertex_count;
		uint8_t triangle_count;
		uint8_t short_refs;
		uint8_t padding;
	} CkMeshlet;

	typedef struct CkLod
	{
		uint32_t index_offset;
		uint32_t index_count;
		uint32_t meshlet_offset;
		uint32_t meshlet_count;
		float error;
	} CkLod;

	// One fully cooked mesh: deduped vertices, LOD-concatenated indices,
	// meshlets per LOD, packed meshlet data stream.
	typedef struct CkCooked
	{
		CkVertex* vertices;
		uint32_t vertex_count;
		uint32_t* indices;
		uint32_t index_count;
		CkMeshlet* meshlets;
		uint32_t meshlet_count;
		uint32_t* meshlet_data;
		uint32_t meshlet_data_count;

		float center[3];
		float radius;
		uint32_t lod_count;
		uint32_t lod_rt;
		CkLod lods[16];
	} CkCooked;

	// --- End-to-end cooking ---

	// Parse an OBJ file into a flat (unindexed) quantized-vertex triangle
	// stream; caller frees with ck_free_vertices.  Returns vertex count
	// (3 per triangle) or 0 on failure.
	uint32_t ck_load_obj(const char* path, CkVertex** out_vertices);
	void ck_free_vertices(CkVertex* vertices);

	// Cook one mesh: dedup, optimize, build LOD chain + meshlets.
	// build_lods=0 produces a single LOD.  Returns null on failure.
	CkCooked* ck_cook_mesh(const CkVertex* vertices, uint32_t vertex_count,
	    const uint32_t* indices, uint32_t index_count,
	    float max_scale, int build_lods);
	void ck_free_cooked(CkCooked* cooked);

	// --- Individual stages (exposed for unit tests) ---

	// Vertex dedup: writes remap[i] = unique id for each input vertex; returns
	// unique count.  Uniqueness is full 16-byte vertex equality,
	// first-occurrence order.
	uint32_t ck_generate_vertex_remap(uint32_t* remap, const CkVertex* vertices,
	    uint32_t vertex_count);

	// Tipsify vertex-cache optimization, in-place on indices.
	void ck_optimize_vertex_cache(uint32_t* indices, uint32_t index_count,
	    uint32_t vertex_count);

	// Meshlet build over one index range.  Outputs are caller-allocated with
	// capacity max_meshlets (ck_meshlet_bound gives a generous estimate).
	// Returns the meshlet count, or ~0u if max_meshlets was insufficient
	// (caller should retry with a larger capacity).  positions: float3/vertex.
	uint32_t ck_build_meshlets(const float* positions, uint32_t vertex_count,
	    const uint32_t* indices, uint32_t index_count,
	    uint32_t max_vertices, uint32_t max_triangles, float cone_weight,
	    uint32_t max_meshlets,
	    uint32_t* out_meshlet_vertices, // [max_meshlets * max_vertices]
	    uint8_t* out_meshlet_triangles, // [max_meshlets * max_triangles * 3]
	    uint32_t* out_vertex_counts,    // [max_meshlets]
	    uint32_t* out_triangle_counts); // [max_meshlets]

	uint32_t ck_meshlet_bound(uint32_t index_count, uint32_t max_vertices,
	    uint32_t max_triangles);

	// Bounding sphere + backface cone for one meshlet (float output, before
	// quantization).  out = cx,cy,cz,radius, ax,ay,az,cutoff.
	void ck_compute_meshlet_bounds(const float* positions, uint32_t vertex_count,
	    const uint32_t* meshlet_vertices, uint32_t meshlet_vertex_count,
	    const uint8_t* meshlet_triangles, uint32_t triangle_count,
	    float* out8);

	// QEM simplification.  positions float3 [vertex_count]; indices in/out
	// (in-place allowed).  Returns new index count; *out_error receives the
	// max collapse error in normalized (unit-extent) units.
	uint32_t ck_simplify(uint32_t* dst_indices, const uint32_t* indices,
	    uint32_t index_count, const float* positions, uint32_t vertex_count,
	    uint32_t target_index_count, float target_error, float* out_error);

	// Extent scale of a mesh (max axis length of the AABB); multiplying a
	// normalized simplification error by this gives world units.
	float ck_simplify_scale(const float* positions, uint32_t vertex_count);

#ifdef __cplusplus
}
#endif
