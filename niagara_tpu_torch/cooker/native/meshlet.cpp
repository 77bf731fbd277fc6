// Meshlet clustering + cluster bounds.
//
// Fills the role of meshopt_buildMeshlets / meshopt_computeMeshletBounds in
// the reference's appendMeshlets (reference: src/scene.cpp:90-115, 24-88).
// Independent implementation: greedy adjacency-driven cluster growth seeded
// from the vertex-cache-optimized triangle order, scored by vertex reuse plus
// a cone-coherence term; bounds are a Ritter sphere over the meshlet's
// triangle corners plus a conservative backface cone quantized to snorm8.

#include "cooker.h"

#include <float.h>
#include <math.h>
#include <string.h>

#include <algorithm>
#include <vector>

namespace
{

struct V3
{
	float x, y, z;
};

static inline V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 cross(V3 a, V3 b)
{
	return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline float len(V3 a) { return sqrtf(dot(a, a)); }

} // namespace

extern "C" uint32_t ck_meshlet_bound(uint32_t index_count, uint32_t max_vertices, uint32_t max_triangles)
{
	uint32_t tris = index_count / 3;
	// A meshlet flushed on vertex budget holds >= max_vertices-2 triangles
	// (each added triangle adds >=0 new vertices, first adds 3); undersized
	// meshlets only appear at connected-component boundaries.  4x headroom
	// over the budget-limited estimate covers fragmented meshes; callers
	// retry with a larger capacity if ck_build_meshlets reports overflow.
	uint32_t perMeshlet = max_vertices > 3 ? (max_vertices - 2) : 1;
	if (perMeshlet > max_triangles)
		perMeshlet = max_triangles;
	uint32_t estimate = (tris + perMeshlet - 1) / std::max(perMeshlet, 1u);
	return estimate * 4 + 16;
}

extern "C" uint32_t ck_build_meshlets(const float* positions, uint32_t vertex_count,
    const uint32_t* indices, uint32_t index_count,
    uint32_t max_vertices, uint32_t max_triangles, float cone_weight,
    uint32_t max_meshlets,
    uint32_t* out_meshlet_vertices,
    uint8_t* out_meshlet_triangles,
    uint32_t* out_vertex_counts,
    uint32_t* out_triangle_counts)
{
	uint32_t triCount = index_count / 3;
	if (triCount == 0)
		return 0;

	// Triangle normals + centroids for cone scoring.
	std::vector<V3> triNormal(triCount), triCentroid(triCount);
	for (uint32_t t = 0; t < triCount; ++t)
	{
		V3 a = {positions[indices[t * 3 + 0] * 3 + 0], positions[indices[t * 3 + 0] * 3 + 1], positions[indices[t * 3 + 0] * 3 + 2]};
		V3 b = {positions[indices[t * 3 + 1] * 3 + 0], positions[indices[t * 3 + 1] * 3 + 1], positions[indices[t * 3 + 1] * 3 + 2]};
		V3 c = {positions[indices[t * 3 + 2] * 3 + 0], positions[indices[t * 3 + 2] * 3 + 1], positions[indices[t * 3 + 2] * 3 + 2]};
		V3 n = cross(sub(b, a), sub(c, a));
		float l = len(n);
		triNormal[t] = l > 0 ? V3{n.x / l, n.y / l, n.z / l} : V3{0, 0, 0};
		triCentroid[t] = {(a.x + b.x + c.x) / 3, (a.y + b.y + c.y) / 3, (a.z + b.z + c.z) / 3};
	}

	// vertex -> triangle adjacency (CSR)
	std::vector<uint32_t> vtOff(vertex_count + 1, 0);
	for (uint32_t i = 0; i < index_count; ++i)
		vtOff[indices[i] + 1]++;
	for (uint32_t i = 0; i < vertex_count; ++i)
		vtOff[i + 1] += vtOff[i];
	std::vector<uint32_t> vtData(index_count);
	{
		std::vector<uint32_t> cur(vtOff.begin(), vtOff.end() - 1);
		for (uint32_t t = 0; t < triCount; ++t)
			for (int k = 0; k < 3; ++k)
				vtData[cur[indices[t * 3 + k]]++] = t;
	}

	std::vector<uint8_t> used(triCount, 0);
	// meshlet-local vertex table: vertex -> local index + generation tag
	std::vector<uint32_t> localIndex(vertex_count, ~0u);
	std::vector<uint32_t> localGen(vertex_count, ~0u);

	uint32_t meshletCount = 0;
	uint32_t cursor = 0; // next unused triangle in input order (seed source)

	uint32_t* mv = out_meshlet_vertices;
	uint8_t* mt = out_meshlet_triangles;

	std::vector<uint32_t> candidates;
	candidates.reserve(1024);

	struct Scored
	{
		float score;
		uint32_t tri;
	};
	std::vector<Scored> scored;
	scored.reserve(1024);

	while (true)
	{
		while (cursor < triCount && used[cursor])
			cursor++;
		if (cursor >= triCount)
			break;
		if (meshletCount >= max_meshlets)
			return ~0u; // overflow: caller must retry with a larger capacity

		// start a new meshlet seeded at the first unused triangle
		uint32_t gen = meshletCount;
		uint32_t vcount = 0, tcount = 0;
		V3 coneSum = {0, 0, 0};

		uint32_t* mlVerts = mv + (size_t)meshletCount * max_vertices;
		uint8_t* mlTris = mt + (size_t)meshletCount * max_triangles * 3;

		uint32_t seed = cursor;

		auto tryAdd = [&](uint32_t t) -> bool {
			// count new vertices
			uint32_t nv = 0;
			uint32_t local[3];
			for (int k = 0; k < 3; ++k)
			{
				uint32_t v = indices[t * 3 + k];
				if (localGen[v] != gen)
					nv++;
			}
			if (vcount + nv > max_vertices || tcount + 1 > max_triangles)
				return false;
			for (int k = 0; k < 3; ++k)
			{
				uint32_t v = indices[t * 3 + k];
				if (localGen[v] != gen)
				{
					localGen[v] = gen;
					localIndex[v] = vcount;
					mlVerts[vcount] = v;
					vcount++;
				}
				local[k] = localIndex[v];
			}
			mlTris[tcount * 3 + 0] = (uint8_t)local[0];
			mlTris[tcount * 3 + 1] = (uint8_t)local[1];
			mlTris[tcount * 3 + 2] = (uint8_t)local[2];
			tcount++;
			used[t] = 1;
			coneSum.x += triNormal[t].x;
			coneSum.y += triNormal[t].y;
			coneSum.z += triNormal[t].z;
			return true;
		};

		tryAdd(seed);

		// grow: repeatedly pick the best unused triangle adjacent to the
		// current meshlet's vertices
		while (tcount < max_triangles)
		{
			candidates.clear();
			for (uint32_t li = 0; li < vcount; ++li)
			{
				uint32_t v = mlVerts[li];
				for (uint32_t j = vtOff[v]; j < vtOff[v + 1]; ++j)
				{
					uint32_t t = vtData[j];
					if (!used[t])
						candidates.push_back(t);
				}
			}
			if (candidates.empty())
				break;

			float coneLen = len(coneSum);
			V3 coneAxis = coneLen > 0 ? V3{coneSum.x / coneLen, coneSum.y / coneLen, coneSum.z / coneLen} : V3{0, 0, 0};

			// score candidates: prefer vertex reuse; cone term keeps normals
			// coherent for backface-cone quality.  Try them best-first until
			// one fits the budgets — flushing only when none fits keeps
			// meshlets full.
			std::sort(candidates.begin(), candidates.end());
			candidates.erase(std::unique(candidates.begin(), candidates.end()), candidates.end());

			scored.clear();
			for (uint32_t t : candidates)
			{
				uint32_t shared = 0;
				for (int k = 0; k < 3; ++k)
					shared += localGen[indices[t * 3 + k]] == gen;
				float score = (float)shared + cone_weight * dot(triNormal[t], coneAxis);
				scored.push_back({score, t});
			}
			std::sort(scored.begin(), scored.end(), [](const Scored& a, const Scored& b) { return a.score > b.score; });

			bool added = false;
			for (const Scored& s : scored)
				if (tryAdd(s.tri))
				{
					added = true;
					break;
				}
			if (!added)
				break;
		}

		out_vertex_counts[meshletCount] = vcount;
		out_triangle_counts[meshletCount] = tcount;
		meshletCount++;
	}

	return meshletCount;
}

extern "C" void ck_compute_meshlet_bounds(const float* positions, uint32_t vertex_count,
    const uint32_t* meshlet_vertices, uint32_t meshlet_vertex_count,
    const uint8_t* meshlet_triangles, uint32_t triangle_count,
    float* out8)
{
	(void)vertex_count;

	// Gather corner points.
	std::vector<V3> pts(meshlet_vertex_count);
	for (uint32_t i = 0; i < meshlet_vertex_count; ++i)
	{
		uint32_t v = meshlet_vertices[i];
		pts[i] = {positions[v * 3 + 0], positions[v * 3 + 1], positions[v * 3 + 2]};
	}

	// Ritter bounding sphere: start from the most distant axis-extreme pair,
	// then grow to include stragglers.
	uint32_t pmin[3] = {0, 0, 0}, pmax[3] = {0, 0, 0};
	for (uint32_t i = 1; i < meshlet_vertex_count; ++i)
	{
		const float* p = &pts[i].x;
		for (int k = 0; k < 3; ++k)
		{
			if (p[k] < (&pts[pmin[k]].x)[k])
				pmin[k] = i;
			if (p[k] > (&pts[pmax[k]].x)[k])
				pmax[k] = i;
		}
	}
	float bestDist = -1;
	int bestAxis = 0;
	for (int k = 0; k < 3; ++k)
	{
		float d = len(sub(pts[pmax[k]], pts[pmin[k]]));
		if (d > bestDist)
		{
			bestDist = d;
			bestAxis = k;
		}
	}
	V3 a = pts[pmin[bestAxis]], b = pts[pmax[bestAxis]];
	V3 center = {(a.x + b.x) * 0.5f, (a.y + b.y) * 0.5f, (a.z + b.z) * 0.5f};
	float radius = bestDist * 0.5f;
	for (uint32_t i = 0; i < meshlet_vertex_count; ++i)
	{
		V3 d = sub(pts[i], center);
		float dist = len(d);
		if (dist > radius)
		{
			float newRadius = (radius + dist) * 0.5f;
			float shift = (dist - radius) * 0.5f / dist;
			center = {center.x + d.x * shift, center.y + d.y * shift, center.z + d.z * shift};
			radius = newRadius;
		}
	}

	// Backface cone from triangle normals.
	V3 axisSum = {0, 0, 0};
	std::vector<V3> normals(triangle_count);
	for (uint32_t t = 0; t < triangle_count; ++t)
	{
		V3 p0 = pts[meshlet_triangles[t * 3 + 0]];
		V3 p1 = pts[meshlet_triangles[t * 3 + 1]];
		V3 p2 = pts[meshlet_triangles[t * 3 + 2]];
		V3 n = cross(sub(p1, p0), sub(p2, p0));
		float l = len(n);
		normals[t] = l > 0 ? V3{n.x / l, n.y / l, n.z / l} : V3{0, 0, 0};
		axisSum.x += normals[t].x;
		axisSum.y += normals[t].y;
		axisSum.z += normals[t].z;
	}
	float axisLen = len(axisSum);
	V3 axis = axisLen > 0 ? V3{axisSum.x / axisLen, axisSum.y / axisLen, axisSum.z / axisLen} : V3{0, 0, 0};

	float mindot = 1.f;
	for (uint32_t t = 0; t < triangle_count; ++t)
		mindot = std::min(mindot, dot(normals[t], axis));

	// cutoff = sin of the cone half-angle; <=0 degenerate -> 1 disables culling
	float cutoff = mindot <= 0.f ? 1.f : sqrtf(std::max(0.f, 1.f - mindot * mindot));

	out8[0] = center.x;
	out8[1] = center.y;
	out8[2] = center.z;
	out8[3] = radius;
	out8[4] = axis.x;
	out8[5] = axis.y;
	out8[6] = axis.z;
	out8[7] = cutoff;
}
