// Quadric-error-metric mesh simplifier (pass-based halfedge collapse).
//
// Fills the role of meshopt_simplifyWithAttributes in the reference's LOD
// build loop (reference: src/scene.cpp:229-264).  Independent implementation:
// Garland-Heckbert plane quadrics accumulated per *position* (so attribute
// seams don't block collapses), border-edge constraint quadrics, pass-based
// greedy collapse with triangle-flip rejection, and a returned max-collapse
// error in unit-extent-normalized distance units (multiply by
// ck_simplify_scale for world units, like meshopt_simplifyScale).

#include "cooker.h"

#include <float.h>
#include <math.h>
#include <stdlib.h>
#include <string.h>

#include <algorithm>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace
{

struct Vec3
{
	float x, y, z;
};

static inline Vec3 sub(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline Vec3 cross(Vec3 a, Vec3 b)
{
	return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline float dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline float length(Vec3 a) { return sqrtf(dot(a, a)); }

// Symmetric 4x4 quadric, 10 unique coefficients.
struct Quadric
{
	double a2, ab, ac, ad;
	double b2, bc, bd;
	double c2, cd;
	double d2;

	void add(const Quadric& q)
	{
		a2 += q.a2; ab += q.ab; ac += q.ac; ad += q.ad;
		b2 += q.b2; bc += q.bc; bd += q.bd;
		c2 += q.c2; cd += q.cd;
		d2 += q.d2;
	}

	double eval(Vec3 p) const
	{
		// p^T Q p with p = (x, y, z, 1)
		return p.x * (a2 * p.x + 2 * (ab * p.y + ac * p.z + ad)) +
		       p.y * (b2 * p.y + 2 * (bc * p.z + bd)) +
		       p.z * (c2 * p.z + 2 * cd) +
		       d2;
	}
};

static Quadric planeQuadric(Vec3 n, float d, float w)
{
	Quadric q;
	q.a2 = (double)w * n.x * n.x; q.ab = (double)w * n.x * n.y; q.ac = (double)w * n.x * n.z; q.ad = (double)w * n.x * d;
	q.b2 = (double)w * n.y * n.y; q.bc = (double)w * n.y * n.z; q.bd = (double)w * n.y * d;
	q.c2 = (double)w * n.z * n.z; q.cd = (double)w * n.z * d;
	q.d2 = (double)w * d * d;
	return q;
}

struct Simplifier
{
	uint32_t vertexCount;
	std::vector<Vec3> pos;        // normalized positions per canonical position id (indexed by posId)
	std::vector<uint32_t> posOf;  // vertex -> original canonical position id
	std::vector<uint32_t> vremap; // vertex union-find (wedge collapse target)
	std::vector<uint32_t> premap; // position union-find
	std::vector<Quadric> quadric; // per live canonical position

	std::vector<uint32_t> tris; // 3 ids per triangle (vertex ids, resolved lazily)
	std::vector<uint8_t> dead;

	uint32_t vfind(uint32_t v)
	{
		while (vremap[v] != v)
		{
			vremap[v] = vremap[vremap[v]];
			v = vremap[v];
		}
		return v;
	}

	uint32_t pfind(uint32_t p)
	{
		while (premap[p] != p)
		{
			premap[p] = premap[premap[p]];
			p = premap[p];
		}
		return p;
	}

	uint32_t posOfVertex(uint32_t v) { return pfind(posOf[vfind(v)]); }
};

struct PairHash
{
	size_t operator()(uint64_t v) const { return std::hash<uint64_t>()(v); }
};

} // namespace

extern "C" float ck_simplify_scale(const float* positions, uint32_t vertex_count)
{
	if (vertex_count == 0)
		return 0.f;
	float mn[3] = {FLT_MAX, FLT_MAX, FLT_MAX}, mx[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
	for (uint32_t i = 0; i < vertex_count; ++i)
		for (int k = 0; k < 3; ++k)
		{
			float v = positions[i * 3 + k];
			mn[k] = v < mn[k] ? v : mn[k];
			mx[k] = v > mx[k] ? v : mx[k];
		}
	float extent = 0.f;
	for (int k = 0; k < 3; ++k)
		extent = std::max(extent, mx[k] - mn[k]);
	return extent;
}

extern "C" uint32_t ck_simplify(uint32_t* dst_indices, const uint32_t* indices,
    uint32_t index_count, const float* positions, uint32_t vertex_count,
    uint32_t target_index_count, float target_error, float* out_error)
{
	if (out_error)
		*out_error = 0.f;
	if (index_count == 0 || vertex_count == 0)
		return 0;

	Simplifier s;
	s.vertexCount = vertex_count;

	// Normalize positions into a unit-extent space; errors are reported in
	// this space (the caller converts with ck_simplify_scale).
	float mn[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
	float extent = ck_simplify_scale(positions, vertex_count);
	for (uint32_t i = 0; i < vertex_count; ++i)
		for (int k = 0; k < 3; ++k)
			mn[k] = std::min(mn[k], positions[i * 3 + k]);
	float inv = extent > 0.f ? 1.f / extent : 1.f;

	// Canonical position ids: exact-equality dedup of positions so attribute
	// seams (same position, different normal/uv vertex) don't split topology.
	std::unordered_map<uint64_t, uint32_t> posmap;
	posmap.reserve(vertex_count * 2);
	s.posOf.resize(vertex_count);
	std::vector<Vec3> vpos(vertex_count);
	for (uint32_t i = 0; i < vertex_count; ++i)
	{
		Vec3 p = {(positions[i * 3 + 0] - mn[0]) * inv,
		    (positions[i * 3 + 1] - mn[1]) * inv,
		    (positions[i * 3 + 2] - mn[2]) * inv};
		vpos[i] = p;
		uint32_t bits[3];
		memcpy(bits, &p, 12);
		uint64_t key = (uint64_t)bits[0] * 0x9E3779B97F4A7C15ull ^ ((uint64_t)bits[1] << 21) ^ ((uint64_t)bits[2] << 42);
		// note: hash collisions resolved by probing chain with equality check
		auto it = posmap.find(key);
		while (it != posmap.end())
		{
			Vec3 q = s.pos[it->second];
			if (q.x == p.x && q.y == p.y && q.z == p.z)
				break;
			key += 0x100000001b3ull;
			it = posmap.find(key);
		}
		if (it == posmap.end())
		{
			uint32_t id = (uint32_t)s.pos.size();
			posmap.emplace(key, id);
			s.pos.push_back(p);
			s.posOf[i] = id;
		}
		else
		{
			s.posOf[i] = it->second;
		}
	}

	uint32_t posCount = (uint32_t)s.pos.size();
	s.vremap.resize(vertex_count);
	for (uint32_t i = 0; i < vertex_count; ++i)
		s.vremap[i] = i;
	s.premap.resize(posCount);
	for (uint32_t i = 0; i < posCount; ++i)
		s.premap[i] = i;

	uint32_t triCount = index_count / 3;
	s.tris.assign(indices, indices + triCount * 3);
	s.dead.assign(triCount, 0);

	// --- Initial quadrics (per canonical position) ---
	s.quadric.assign(posCount, Quadric{});

	// Count undirected position-edge multiplicity for border detection.
	std::unordered_map<uint64_t, uint32_t, PairHash> edgeCount;
	edgeCount.reserve(triCount * 3);

	auto edgeKey = [](uint32_t a, uint32_t b) -> uint64_t {
		return a < b ? ((uint64_t)a << 32 | b) : ((uint64_t)b << 32 | a);
	};

	for (uint32_t t = 0; t < triCount; ++t)
	{
		uint32_t p0 = s.posOf[s.tris[t * 3 + 0]];
		uint32_t p1 = s.posOf[s.tris[t * 3 + 1]];
		uint32_t p2 = s.posOf[s.tris[t * 3 + 2]];
		if (p0 == p1 || p1 == p2 || p0 == p2)
		{
			s.dead[t] = 1;
			continue;
		}
		Vec3 a = s.pos[p0], b = s.pos[p1], c = s.pos[p2];
		Vec3 n = cross(sub(b, a), sub(c, a));
		float twoArea = length(n);
		if (twoArea > 0.f)
		{
			Vec3 nn = {n.x / twoArea, n.y / twoArea, n.z / twoArea};
			float d = -dot(nn, a);
			Quadric q = planeQuadric(nn, d, twoArea * 0.5f);
			s.quadric[p0].add(q);
			s.quadric[p1].add(q);
			s.quadric[p2].add(q);
		}
		edgeCount[edgeKey(p0, p1)]++;
		edgeCount[edgeKey(p1, p2)]++;
		edgeCount[edgeKey(p2, p0)]++;
	}

	// Border constraint quadrics: a plane through the border edge,
	// perpendicular to the adjacent triangle, weighted by edge length^2.
	std::unordered_set<uint64_t> borderEdges;
	std::vector<uint8_t> borderPos(posCount, 0);
	for (uint32_t t = 0; t < triCount; ++t)
	{
		if (s.dead[t])
			continue;
		uint32_t p[3] = {s.posOf[s.tris[t * 3 + 0]], s.posOf[s.tris[t * 3 + 1]], s.posOf[s.tris[t * 3 + 2]]};
		Vec3 a = s.pos[p[0]], b = s.pos[p[1]], c = s.pos[p[2]];
		Vec3 n = cross(sub(b, a), sub(c, a));
		float nl = length(n);
		if (nl == 0.f)
			continue;
		Vec3 nn = {n.x / nl, n.y / nl, n.z / nl};
		for (int e = 0; e < 3; ++e)
		{
			uint32_t pa = p[e], pb = p[(e + 1) % 3];
			if (edgeCount[edgeKey(pa, pb)] != 1)
				continue;
			borderEdges.insert(edgeKey(pa, pb));
			borderPos[pa] = borderPos[pb] = 1;
			Vec3 ea = s.pos[pa], eb = s.pos[pb];
			Vec3 edge = sub(eb, ea);
			Vec3 m = cross(edge, nn);
			float ml = length(m);
			if (ml == 0.f)
				continue;
			m = {m.x / ml, m.y / ml, m.z / ml};
			float d = -dot(m, ea);
			float w = dot(edge, edge); // length^2 weight
			Quadric q = planeQuadric(m, d, w);
			s.quadric[pa].add(q);
			s.quadric[pb].add(q);
		}
	}

	uint32_t aliveTris = 0;
	for (uint32_t t = 0; t < triCount; ++t)
		aliveTris += !s.dead[t];

	double maxError = 0.0;
	double targetErrorSq = (double)target_error * target_error;

	struct Candidate
	{
		float error;
		uint32_t u, v; // vertex ids (directed: collapse u -> v)
	};

	// --- Collapse passes ---
	std::vector<Candidate> cands;
	std::vector<uint32_t> posTriOff, posTriData;
	std::vector<uint8_t> dirty(posCount, 0);

	for (int pass = 0; pass < 64; ++pass)
	{
		if (aliveTris * 3 <= target_index_count)
			break;

		// Resolve triangles, drop degenerates, rebuild adjacency + borders.
		std::fill(dirty.begin(), dirty.end(), 0);
		std::vector<uint32_t> posTriCount(posCount, 0);
		for (uint32_t t = 0; t < triCount; ++t)
		{
			if (s.dead[t])
				continue;
			uint32_t v0 = s.vfind(s.tris[t * 3 + 0]);
			uint32_t v1 = s.vfind(s.tris[t * 3 + 1]);
			uint32_t v2 = s.vfind(s.tris[t * 3 + 2]);
			s.tris[t * 3 + 0] = v0;
			s.tris[t * 3 + 1] = v1;
			s.tris[t * 3 + 2] = v2;
			uint32_t p0 = s.posOfVertex(v0), p1 = s.posOfVertex(v1), p2 = s.posOfVertex(v2);
			if (p0 == p1 || p1 == p2 || p0 == p2)
			{
				s.dead[t] = 1;
				aliveTris--;
				continue;
			}
			posTriCount[p0]++;
			posTriCount[p1]++;
			posTriCount[p2]++;
		}

		if (aliveTris * 3 <= target_index_count)
			break;

		posTriOff.assign(posCount + 1, 0);
		for (uint32_t i = 0; i < posCount; ++i)
			posTriOff[i + 1] = posTriOff[i] + posTriCount[i];
		posTriData.resize(posTriOff[posCount]);
		{
			std::vector<uint32_t> cur(posTriOff.begin(), posTriOff.end() - 1);
			for (uint32_t t = 0; t < triCount; ++t)
			{
				if (s.dead[t])
					continue;
				for (int k = 0; k < 3; ++k)
					posTriData[cur[s.posOfVertex(s.tris[t * 3 + k])]++] = t;
			}
		}

		// Border classification for the current topology.
		edgeCount.clear();
		for (uint32_t t = 0; t < triCount; ++t)
		{
			if (s.dead[t])
				continue;
			uint32_t p0 = s.posOfVertex(s.tris[t * 3 + 0]);
			uint32_t p1 = s.posOfVertex(s.tris[t * 3 + 1]);
			uint32_t p2 = s.posOfVertex(s.tris[t * 3 + 2]);
			edgeCount[edgeKey(p0, p1)]++;
			edgeCount[edgeKey(p1, p2)]++;
			edgeCount[edgeKey(p2, p0)]++;
		}
		std::fill(borderPos.begin(), borderPos.end(), 0);
		borderEdges.clear();
		for (auto& kv : edgeCount)
			if (kv.second == 1)
			{
				borderEdges.insert(kv.first);
				borderPos[(uint32_t)(kv.first >> 32)] = 1;
				borderPos[(uint32_t)kv.first] = 1;
			}

		// Candidate edges (deduped directed position pairs).
		cands.clear();
		std::unordered_set<uint64_t> seen;
		seen.reserve(aliveTris * 6);
		for (uint32_t t = 0; t < triCount; ++t)
		{
			if (s.dead[t])
				continue;
			for (int e = 0; e < 3; ++e)
			{
				uint32_t u = s.tris[t * 3 + e];
				uint32_t v = s.tris[t * 3 + (e + 1) % 3];
				uint32_t pu = s.posOfVertex(u), pv = s.posOfVertex(v);
				for (int dir = 0; dir < 2; ++dir)
				{
					uint32_t cu = dir ? v : u, cv = dir ? u : v;
					uint32_t cpu = dir ? pv : pu, cpv = dir ? pu : pv;
					if (!seen.insert((uint64_t)cpu << 32 | cpv).second)
						continue;
					// border rule: a border position may only slide along a
					// border edge; interior positions may collapse anywhere
					if (borderPos[cpu] && !borderEdges.count(edgeKey(cpu, cpv)))
						continue;
					Quadric q = s.quadric[cpu];
					q.add(s.quadric[cpv]);
					double err = q.eval(s.pos[cpv]);
					cands.push_back({(float)err, cu, cv});
				}
			}
		}

		std::sort(cands.begin(), cands.end(), [](const Candidate& a, const Candidate& b) { return a.error < b.error; });

		uint32_t applied = 0;
		for (const Candidate& c : cands)
		{
			if (aliveTris * 3 <= target_index_count)
				break;
			if ((double)c.error > targetErrorSq)
				break;

			uint32_t u = s.vfind(c.u), v = s.vfind(c.v);
			uint32_t pu = s.posOfVertex(u), pv = s.posOfVertex(v);
			if (pu == pv || dirty[pu] || dirty[pv])
				continue;

			// Flip check: triangles around pu that don't contain pv must keep
			// their orientation when pu moves to pv's position.
			bool flips = false;
			Vec3 newPos = s.pos[pv];
			for (uint32_t i = posTriOff[pu]; i < posTriOff[pu + 1] && !flips; ++i)
			{
				uint32_t t = posTriData[i];
				if (s.dead[t])
					continue;
				uint32_t tp[3];
				Vec3 tv[3], tvNew[3];
				bool hasPv = false;
				for (int k = 0; k < 3; ++k)
				{
					tp[k] = s.posOfVertex(s.tris[t * 3 + k]);
					tv[k] = s.pos[tp[k]];
					tvNew[k] = tp[k] == pu ? newPos : tv[k];
					hasPv |= tp[k] == pv;
				}
				if (hasPv)
					continue; // will die in the collapse
				Vec3 n0 = cross(sub(tv[1], tv[0]), sub(tv[2], tv[0]));
				Vec3 n1 = cross(sub(tvNew[1], tvNew[0]), sub(tvNew[2], tvNew[0]));
				if (dot(n0, n1) <= 0.f)
					flips = true;
			}
			if (flips)
				continue;

			// Commit.  Redirect all wedges currently at position pu to the
			// target wedge v *before* the position union (afterwards old-pu
			// and old-pv wedges would be indistinguishable), then merge the
			// position and kill triangles that degenerated.
			for (uint32_t i = posTriOff[pu]; i < posTriOff[pu + 1]; ++i)
			{
				uint32_t t = posTriData[i];
				if (s.dead[t])
					continue;
				for (int k = 0; k < 3; ++k)
				{
					uint32_t w = s.vfind(s.tris[t * 3 + k]);
					if (w != v && s.posOfVertex(w) == pu)
						s.vremap[w] = v;
				}
			}
			s.premap[pu] = pv;
			s.quadric[pv].add(s.quadric[pu]);
			for (uint32_t i = posTriOff[pu]; i < posTriOff[pu + 1]; ++i)
			{
				uint32_t t = posTriData[i];
				if (s.dead[t])
					continue;
				uint32_t p0 = s.posOfVertex(s.tris[t * 3 + 0]);
				uint32_t p1 = s.posOfVertex(s.tris[t * 3 + 1]);
				uint32_t p2 = s.posOfVertex(s.tris[t * 3 + 2]);
				if (p0 == p1 || p1 == p2 || p0 == p2)
				{
					s.dead[t] = 1;
					aliveTris--;
				}
			}

			dirty[pu] = dirty[pv] = 1;
			maxError = std::max(maxError, (double)c.error);
			applied++;
		}

		if (applied == 0)
			break;
	}

	// Emit surviving triangles with resolved wedges.
	uint32_t out = 0;
	for (uint32_t t = 0; t < triCount; ++t)
	{
		if (s.dead[t])
			continue;
		uint32_t v0 = s.vfind(s.tris[t * 3 + 0]);
		uint32_t v1 = s.vfind(s.tris[t * 3 + 1]);
		uint32_t v2 = s.vfind(s.tris[t * 3 + 2]);
		uint32_t p0 = s.posOfVertex(v0), p1 = s.posOfVertex(v1), p2 = s.posOfVertex(v2);
		if (p0 == p1 || p1 == p2 || p0 == p2)
			continue;
		dst_indices[out++] = v0;
		dst_indices[out++] = v1;
		dst_indices[out++] = v2;
	}

	if (out_error)
		*out_error = (float)sqrt(std::max(maxError, 0.0));
	return out;
}
