// Cooker core: OBJ ingest, vertex dedup/remap, vertex-cache (tipsify) and
// fetch optimization, LOD chain + meshlet packing.
//
// Re-implements the behavior of the reference's loadObj/appendMesh cook path
// (reference: src/scene.cpp:117-293) with from-scratch algorithms in place of
// the meshoptimizer library calls.  Packed data layouts (Vertex, Meshlet,
// meshletdata stream) are bit-compatible with reference scene.h:10-66 so the
// TPU upload path and parity tests can treat both identically.

#include "cooker.h"
#include "half.h"

#include <assert.h>
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <algorithm>
#include <unordered_map>
#include <vector>

// from config.py; kept in sync by tests/test_cooker.py::test_config_consts
#define MESH_MAXVTX 64
#define MESH_MAXTRI 96
#define MESHLET_CONE_WEIGHT 0.25f
#define MAX_LODS 16

static const float kShadowLodError = 3e-3f; // reference scene.cpp:22

// ---------------------------------------------------------------- OBJ parse

namespace
{

struct ObjIndex
{
	int p, t, n;
};

static const char* parseFloats(const char* s, float* out, int n)
{
	for (int i = 0; i < n; ++i)
	{
		while (*s == ' ' || *s == '\t')
			s++;
		char* end = nullptr;
		out[i] = strtof(s, &end);
		if (end == s)
			out[i] = 0.f;
		s = end ? end : s;
	}
	return s;
}

// parse one face corner "v", "v/t", "v//n", "v/t/n"; 1-based, negatives
// relative to current array sizes (before the dummy-0 entry convention the
// arrays carry a zero element at index 0, like fast_obj)
static const char* parseCorner(const char* s, ObjIndex& idx, int np, int nt, int nn)
{
	auto fix = [](long v, int count) -> int {
		if (v > 0)
			return (int)v;
		if (v < 0)
			return count + (int)v; // count includes the dummy entry
		return 0;
	};

	char* end = nullptr;
	long p = strtol(s, &end, 10);
	s = end;
	idx.p = fix(p, np);
	idx.t = 0;
	idx.n = 0;
	if (*s == '/')
	{
		s++;
		if (*s != '/')
		{
			long t = strtol(s, &end, 10);
			s = end;
			idx.t = fix(t, nt);
		}
		if (*s == '/')
		{
			s++;
			long n = strtol(s, &end, 10);
			s = end;
			idx.n = fix(n, nn);
		}
	}
	return s;
}

} // namespace

extern "C" uint32_t ck_load_obj(const char* path, CkVertex** out_vertices)
{
	*out_vertices = nullptr;

	FILE* f = fopen(path, "rb");
	if (!f)
		return 0;
	fseek(f, 0, SEEK_END);
	long size = ftell(f);
	fseek(f, 0, SEEK_SET);
	std::vector<char> data(size + 1);
	if (fread(data.data(), 1, size, f) != (size_t)size)
	{
		fclose(f);
		return 0;
	}
	fclose(f);
	data[size] = 0;

	// dummy zero entries at index 0 (fast_obj convention: missing attribute
	// references resolve to zeros)
	std::vector<float> positions = {0, 0, 0};
	std::vector<float> normals = {0, 0, 0};
	std::vector<float> texcoords = {0, 0};
	std::vector<ObjIndex> corners;
	std::vector<uint32_t> faceSizes;

	const char* s = data.data();
	const char* endp = data.data() + size;
	while (s < endp)
	{
		// find line bounds
		const char* line = s;
		while (s < endp && *s != '\n')
			s++;
		const char* lineEnd = s;
		if (s < endp)
			s++;

		while (line < lineEnd && (*line == ' ' || *line == '\t'))
			line++;
		if (line >= lineEnd)
			continue;

		if (line[0] == 'v' && line + 1 < lineEnd)
		{
			float v[3];
			if (line[1] == ' ' || line[1] == '\t')
			{
				parseFloats(line + 2, v, 3);
				positions.insert(positions.end(), v, v + 3);
			}
			else if (line[1] == 'n')
			{
				parseFloats(line + 2, v, 3);
				normals.insert(normals.end(), v, v + 3);
			}
			else if (line[1] == 't')
			{
				parseFloats(line + 2, v, 2);
				texcoords.insert(texcoords.end(), v, v + 2);
			}
		}
		else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t'))
		{
			const char* c = line + 2;
			uint32_t count = 0;
			int np = (int)positions.size() / 3;
			int nt = (int)texcoords.size() / 2;
			int nn = (int)normals.size() / 3;
			while (c < lineEnd)
			{
				while (c < lineEnd && (*c == ' ' || *c == '\t' || *c == '\r'))
					c++;
				if (c >= lineEnd || *c == '\n')
					break;
				ObjIndex idx;
				c = parseCorner(c, idx, np, nt, nn);
				corners.push_back(idx);
				count++;
			}
			faceSizes.push_back(count);
		}
	}

	// count triangulated vertices
	size_t indexCount = 0;
	for (uint32_t fc : faceSizes)
		if (fc >= 3)
			indexCount += 3 * (fc - 2);

	CkVertex* verts = (CkVertex*)malloc(indexCount * sizeof(CkVertex));
	if (!verts)
		return 0;

	size_t vo = 0, co = 0;
	for (uint32_t fc : faceSizes)
	{
		for (uint32_t j = 0; j < fc; ++j)
		{
			const ObjIndex& gi = corners[co + j];
			if (fc < 3)
				continue;

			// fan triangulation, same replication pattern as the reference
			// (scene.cpp:141-147)
			if (j >= 3)
			{
				verts[vo + 0] = verts[vo - 3];
				verts[vo + 1] = verts[vo - 1];
				vo += 2;
			}

			CkVertex& v = verts[vo++];
			v.vx = f32_to_f16(positions[gi.p * 3 + 0]);
			v.vy = f32_to_f16(positions[gi.p * 3 + 1]);
			v.vz = f32_to_f16(positions[gi.p * 3 + 2]);
			v.tp = 0;
			v.np = (uint32_t)(quantize_snorm(normals[gi.n * 3 + 0], 10) + 511) |
			       (uint32_t)(quantize_snorm(normals[gi.n * 3 + 1], 10) + 511) << 10 |
			       (uint32_t)(quantize_snorm(normals[gi.n * 3 + 2], 10) + 511) << 20;
			v.tu = f32_to_f16(texcoords[gi.t * 2 + 0]);
			v.tv = f32_to_f16(texcoords[gi.t * 2 + 1]);
		}
		co += fc;
	}

	assert(vo == indexCount);
	*out_vertices = verts;
	return (uint32_t)indexCount;
}

extern "C" void ck_free_vertices(CkVertex* vertices)
{
	free(vertices);
}

// ------------------------------------------------------------ remap / dedup

namespace
{

struct VertexHash
{
	size_t operator()(const CkVertex& v) const
	{
		const uint32_t* p = (const uint32_t*)&v;
		uint64_t h = 0xcbf29ce484222325ull;
		for (int i = 0; i < 4; ++i)
		{
			h ^= p[i];
			h *= 0x100000001b3ull;
		}
		return (size_t)h;
	}
};

struct VertexEq
{
	bool operator()(const CkVertex& a, const CkVertex& b) const
	{
		return memcmp(&a, &b, sizeof(CkVertex)) == 0;
	}
};

} // namespace

extern "C" uint32_t ck_generate_vertex_remap(uint32_t* remap, const CkVertex* vertices, uint32_t vertex_count)
{
	std::unordered_map<CkVertex, uint32_t, VertexHash, VertexEq> map;
	map.reserve(vertex_count);
	uint32_t unique = 0;
	for (uint32_t i = 0; i < vertex_count; ++i)
	{
		auto it = map.find(vertices[i]);
		if (it == map.end())
		{
			map.emplace(vertices[i], unique);
			remap[i] = unique++;
		}
		else
		{
			remap[i] = it->second;
		}
	}
	return unique;
}

// drop triangles degenerate under position-only equality (fills the role of
// meshopt_filterIndexBuffer in reference scene.cpp:172)
static uint32_t filterDegenerate(uint32_t* indices, uint32_t index_count, const CkVertex* vertices)
{
	std::unordered_map<uint64_t, uint32_t> posmap;
	posmap.reserve(index_count);
	auto posKey = [&](uint32_t v) -> uint32_t {
		uint64_t key = (uint64_t)vertices[v].vx | ((uint64_t)vertices[v].vy << 16) | ((uint64_t)vertices[v].vz << 32);
		auto it = posmap.find(key);
		if (it != posmap.end())
			return it->second;
		uint32_t id = (uint32_t)posmap.size();
		posmap.emplace(key, id);
		return id;
	};

	uint32_t out = 0;
	for (uint32_t t = 0; t * 3 + 2 < index_count; ++t)
	{
		uint32_t a = posKey(indices[t * 3]), b = posKey(indices[t * 3 + 1]), c = posKey(indices[t * 3 + 2]);
		if (a == b || b == c || a == c)
			continue;
		indices[out++] = indices[t * 3];
		indices[out++] = indices[t * 3 + 1];
		indices[out++] = indices[t * 3 + 2];
	}
	return out;
}

// ------------------------------------------------- vertex cache optimization

// Tipsify (Sander, Nehab, Barczak 2007): linear-speed vertex cache
// optimization.  Fills the role of meshopt_optimizeVertexCache.
extern "C" void ck_optimize_vertex_cache(uint32_t* indices, uint32_t index_count, uint32_t vertex_count)
{
	const int cacheSize = 16;
	uint32_t triCount = index_count / 3;
	if (triCount == 0)
		return;

	// vertex -> triangles CSR
	std::vector<uint32_t> off(vertex_count + 1, 0);
	for (uint32_t i = 0; i < triCount * 3; ++i)
		off[indices[i] + 1]++;
	for (uint32_t i = 0; i < vertex_count; ++i)
		off[i + 1] += off[i];
	std::vector<uint32_t> adj(triCount * 3);
	{
		std::vector<uint32_t> cur(off.begin(), off.end() - 1);
		for (uint32_t t = 0; t < triCount; ++t)
			for (int k = 0; k < 3; ++k)
				adj[cur[indices[t * 3 + k]]++] = t;
	}

	std::vector<uint32_t> live(vertex_count);
	for (uint32_t v = 0; v < vertex_count; ++v)
		live[v] = off[v + 1] - off[v];

	std::vector<int32_t> cacheTime(vertex_count, -1);
	std::vector<uint8_t> emitted(triCount, 0);
	std::vector<uint32_t> deadEndStack;
	std::vector<uint32_t> output;
	output.reserve(triCount * 3);

	int32_t time = cacheSize + 1;
	uint32_t cursor = 0; // for dead-end restart
	int64_t fanning = 0; // current fanning vertex, -1 = none

	fanning = indices[0];

	auto emitTriangle = [&](uint32_t t) {
		for (int k = 0; k < 3; ++k)
		{
			uint32_t v = indices[t * 3 + k];
			output.push_back(v);
			deadEndStack.push_back(v);
			if (time - cacheTime[v] > cacheSize)
				cacheTime[v] = time++;
			if (live[v] > 0)
				live[v]--;
		}
		emitted[t] = 1;
	};

	auto nextVertex = [&]() -> int64_t {
		// 1-ring candidates of the previous fanning vertex (via dead-end stack)
		while (!deadEndStack.empty())
		{
			uint32_t v = deadEndStack.back();
			deadEndStack.pop_back();
			if (live[v] > 0)
				return v;
		}
		// dead-end: scan for any vertex with live triangles
		while (cursor < vertex_count)
		{
			if (live[cursor] > 0)
				return cursor;
			cursor++;
		}
		return -1;
	};

	while (fanning >= 0)
	{
		uint32_t fv = (uint32_t)fanning;

		// candidate next fanning vertices from the triangles we emit now
		std::vector<uint32_t> candidates;
		for (uint32_t j = off[fv]; j < off[fv + 1]; ++j)
		{
			uint32_t t = adj[j];
			if (emitted[t])
				continue;
			for (int k = 0; k < 3; ++k)
				candidates.push_back(indices[t * 3 + k]);
			emitTriangle(t);
		}

		// pick the candidate with max priority: stays in cache after fanning
		// -> prefer recently used with few live triangles
		int64_t best = -1;
		int32_t bestPriority = -1;
		for (uint32_t v : candidates)
		{
			if (live[v] == 0)
				continue;
			int32_t p = 0;
			int32_t inCache = time - cacheTime[v];
			if (cacheTime[v] >= 0 && inCache + 2 * (int32_t)live[v] <= cacheSize)
				p = time - cacheTime[v];
			if (p > bestPriority)
			{
				bestPriority = p;
				best = v;
			}
		}
		if (best < 0)
			best = nextVertex();
		fanning = best;
	}

	assert(output.size() == (size_t)triCount * 3);
	memcpy(indices, output.data(), output.size() * sizeof(uint32_t));
}

// reorder vertices by first use in the index buffer (role of
// meshopt_optimizeVertexFetch)
static uint32_t optimizeVertexFetch(CkVertex* vertices, uint32_t vertex_count, uint32_t* indices, uint32_t index_count)
{
	std::vector<uint32_t> remap(vertex_count, ~0u);
	uint32_t next = 0;
	for (uint32_t i = 0; i < index_count; ++i)
	{
		uint32_t v = indices[i];
		if (remap[v] == ~0u)
			remap[v] = next++;
		indices[i] = remap[v];
	}
	std::vector<CkVertex> nv(next);
	for (uint32_t v = 0; v < vertex_count; ++v)
		if (remap[v] != ~0u)
			nv[remap[v]] = vertices[v];
	memcpy(vertices, nv.data(), next * sizeof(CkVertex));
	return next;
}

// -------------------------------------------------------------- cook mesh

namespace
{

// append one meshlet's packed data + quantized header (mirrors reference
// scene.cpp:24-88 appendMeshlet)
static void packMeshlet(std::vector<CkMeshlet>& meshlets, std::vector<uint32_t>& meshletData,
    const float* positions,
    const uint32_t* mlVerts, uint32_t vcount,
    const uint8_t* mlTris, uint32_t tcount)
{
	size_t dataOffset = meshletData.size();

	uint32_t minVertex = ~0u, maxVertex = 0;
	for (uint32_t i = 0; i < vcount; ++i)
	{
		minVertex = std::min(mlVerts[i], minVertex);
		maxVertex = std::max(mlVerts[i], maxVertex);
	}
	bool shortRefs = maxVertex - minVertex < (1 << 16);

	for (uint32_t i = 0; i < vcount; ++i)
	{
		uint32_t ref = mlVerts[i] - minVertex;
		if (shortRefs && (i % 2))
			meshletData.back() |= ref << 16;
		else
			meshletData.push_back(ref);
	}

	// triangle bytes packed 4 per u32 (zero-padded)
	uint32_t indexGroupCount = (tcount * 3 + 3) / 4;
	size_t base = meshletData.size();
	meshletData.resize(base + indexGroupCount, 0);
	uint8_t* bytes = (uint8_t*)&meshletData[base];
	memcpy(bytes, mlTris, tcount * 3);

	float bounds[8];
	ck_compute_meshlet_bounds(positions, 0, mlVerts, vcount, mlTris, tcount, bounds);

	CkMeshlet m = {};
	m.data_offset = (uint32_t)dataOffset;
	m.base_vertex = minVertex;
	m.vertex_count = (uint8_t)vcount;
	m.triangle_count = (uint8_t)tcount;
	m.short_refs = shortRefs ? 1 : 0;

	m.center[0] = f32_to_f16(bounds[0]);
	m.center[1] = f32_to_f16(bounds[1]);
	m.center[2] = f32_to_f16(bounds[2]);
	m.radius = f32_to_f16(bounds[3]);

	// snorm8 cone with conservative cutoff inflation for axis quantization
	int8_t ax = (int8_t)quantize_snorm(bounds[4], 8);
	int8_t ay = (int8_t)quantize_snorm(bounds[5], 8);
	int8_t az = (int8_t)quantize_snorm(bounds[6], 8);
	float err = fabsf(ax / 127.f - bounds[4]) + fabsf(ay / 127.f - bounds[5]) + fabsf(az / 127.f - bounds[6]);
	int cutoff = (int)ceilf((bounds[7] + err) * 127.f);
	m.cone_axis[0] = ax;
	m.cone_axis[1] = ay;
	m.cone_axis[2] = az;
	m.cone_cutoff = (int8_t)std::min(cutoff, 127);

	meshlets.push_back(m);
}

static uint32_t appendMeshlets(std::vector<CkMeshlet>& meshlets, std::vector<uint32_t>& meshletData,
    const std::vector<float>& positions, const uint32_t* indices, uint32_t indexCount)
{
	uint32_t vertexCount = (uint32_t)positions.size() / 3;
	uint32_t bound = ck_meshlet_bound(indexCount, MESH_MAXVTX, MESH_MAXTRI);

	std::vector<uint32_t> mv;
	std::vector<uint8_t> mt;
	std::vector<uint32_t> vc, tc;

	uint32_t count = ~0u;
	while (count == ~0u)
	{
		mv.assign((size_t)bound * MESH_MAXVTX, 0);
		mt.assign((size_t)bound * MESH_MAXTRI * 3, 0);
		vc.assign(bound, 0);
		tc.assign(bound, 0);
		count = ck_build_meshlets(positions.data(), vertexCount, indices, indexCount,
		    MESH_MAXVTX, MESH_MAXTRI, MESHLET_CONE_WEIGHT, bound,
		    mv.data(), mt.data(), vc.data(), tc.data());
		bound *= 2;
	}

	for (uint32_t i = 0; i < count; ++i)
		packMeshlet(meshlets, meshletData, positions.data(),
		    &mv[(size_t)i * MESH_MAXVTX], vc[i], &mt[(size_t)i * MESH_MAXTRI * 3], tc[i]);

	return count;
}

} // namespace

extern "C" CkCooked* ck_cook_mesh(const CkVertex* in_vertices, uint32_t in_vertex_count,
    const uint32_t* in_indices, uint32_t in_index_count,
    float max_scale, int build_lods)
{
	std::vector<CkVertex> vertices(in_vertices, in_vertices + in_vertex_count);
	std::vector<uint32_t> indices(in_indices, in_indices + in_index_count);

	// 1. drop position-degenerate triangles (reference scene.cpp:172)
	uint32_t filtered = filterDegenerate(indices.data(), (uint32_t)indices.size(), vertices.data());
	indices.resize(filtered);

	// 2. full-vertex dedup (reference scene.cpp:174-180)
	std::vector<uint32_t> remap(vertices.size());
	uint32_t unique = ck_generate_vertex_remap(remap.data(), vertices.data(), (uint32_t)vertices.size());
	{
		std::vector<CkVertex> nv(unique);
		for (uint32_t i = 0; i < vertices.size(); ++i)
			nv[remap[i]] = vertices[i];
		vertices = std::move(nv);
		for (uint32_t& i : indices)
			i = remap[i];
	}

	// 3. vertex cache + fetch optimization (reference scene.cpp:184-186)
	ck_optimize_vertex_cache(indices.data(), (uint32_t)indices.size(), (uint32_t)vertices.size());
	uint32_t used = optimizeVertexFetch(vertices.data(), (uint32_t)vertices.size(), indices.data(), (uint32_t)indices.size());
	vertices.resize(used);

	// 4. dequantized positions + bounds (reference scene.cpp:198-221)
	std::vector<float> positions(vertices.size() * 3);
	for (size_t i = 0; i < vertices.size(); ++i)
	{
		positions[i * 3 + 0] = f16_to_f32(vertices[i].vx);
		positions[i * 3 + 1] = f16_to_f32(vertices[i].vy);
		positions[i * 3 + 2] = f16_to_f32(vertices[i].vz);
	}

	float center[3] = {0, 0, 0};
	for (size_t i = 0; i < vertices.size(); ++i)
		for (int k = 0; k < 3; ++k)
			center[k] += positions[i * 3 + k];
	for (int k = 0; k < 3; ++k)
		center[k] /= (float)vertices.size();
	float radius = 0;
	for (size_t i = 0; i < vertices.size(); ++i)
	{
		float dx = positions[i * 3 + 0] - center[0];
		float dy = positions[i * 3 + 1] - center[1];
		float dz = positions[i * 3 + 2] - center[2];
		radius = std::max(radius, sqrtf(dx * dx + dy * dy + dz * dz));
	}

	float lodScale = ck_simplify_scale(positions.data(), (uint32_t)vertices.size());

	CkCooked* out = (CkCooked*)calloc(1, sizeof(CkCooked));
	out->center[0] = center[0];
	out->center[1] = center[1];
	out->center[2] = center[2];
	out->radius = radius;

	// 5. LOD chain (reference scene.cpp:229-264)
	std::vector<uint32_t> allIndices;
	std::vector<uint32_t> lodIndices = indices;
	float lodError = 0.f;

	while (out->lod_count < MAX_LODS)
	{
		CkLod& lod = out->lods[out->lod_count++];
		lod.index_offset = (uint32_t)allIndices.size();
		lod.index_count = (uint32_t)lodIndices.size();
		allIndices.insert(allIndices.end(), lodIndices.begin(), lodIndices.end());
		lod.error = lodError * lodScale;

		if (!build_lods || out->lod_count >= MAX_LODS)
			break;

		const float maxError = 1e-1f;
		size_t nextTarget = ((size_t)((double)lodIndices.size() * 0.6) / 3) * 3;
		float nextError = 0.f;
		std::vector<uint32_t> nextIndices(lodIndices.size());
		uint32_t nextCount = ck_simplify(nextIndices.data(), lodIndices.data(), (uint32_t)lodIndices.size(),
		    positions.data(), (uint32_t)vertices.size(), (uint32_t)nextTarget, maxError, &nextError);

		if (nextCount == lodIndices.size() || nextCount == 0)
			break;
		if (nextCount >= (size_t)((double)lodIndices.size() * 0.85))
			break;

		nextIndices.resize(nextCount);
		lodIndices = std::move(nextIndices);
		// accumulate error across the chain (reference scene.cpp:260)
		lodError = std::max(lodError * 1.5f, nextError);

		ck_optimize_vertex_cache(lodIndices.data(), (uint32_t)lodIndices.size(), (uint32_t)vertices.size());
	}

	for (uint32_t i = 0; i < out->lod_count; ++i)
		if (out->lods[i].error * max_scale < kShadowLodError)
			out->lod_rt = i;

	// 6. meshlets per LOD (reference scene.cpp:270-276)
	std::vector<CkMeshlet> meshlets;
	std::vector<uint32_t> meshletData;
	for (uint32_t i = 0; i < out->lod_count; ++i)
	{
		CkLod& lod = out->lods[i];
		lod.meshlet_offset = (uint32_t)meshlets.size();
		lod.meshlet_count = appendMeshlets(meshlets, meshletData, positions,
		    allIndices.data() + lod.index_offset, lod.index_count);
	}

	// move into C arrays
	out->vertex_count = (uint32_t)vertices.size();
	out->vertices = (CkVertex*)malloc(vertices.size() * sizeof(CkVertex));
	memcpy(out->vertices, vertices.data(), vertices.size() * sizeof(CkVertex));

	out->index_count = (uint32_t)allIndices.size();
	out->indices = (uint32_t*)malloc(allIndices.size() * sizeof(uint32_t));
	memcpy(out->indices, allIndices.data(), allIndices.size() * sizeof(uint32_t));

	out->meshlet_count = (uint32_t)meshlets.size();
	out->meshlets = (CkMeshlet*)malloc(meshlets.size() * sizeof(CkMeshlet));
	memcpy(out->meshlets, meshlets.data(), meshlets.size() * sizeof(CkMeshlet));

	out->meshlet_data_count = (uint32_t)meshletData.size();
	out->meshlet_data = (uint32_t*)malloc(meshletData.size() * sizeof(uint32_t));
	memcpy(out->meshlet_data, meshletData.data(), meshletData.size() * sizeof(uint32_t));

	return out;
}

extern "C" void ck_free_cooked(CkCooked* cooked)
{
	if (!cooked)
		return;
	free(cooked->vertices);
	free(cooked->indices);
	free(cooked->meshlets);
	free(cooked->meshlet_data);
	free(cooked);
}
