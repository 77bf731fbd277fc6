// BVH builders for ray-traced shadows.
//
// Fills the role of the reference's BLAS/TLAS construction (scenert.cpp:16-579)
// with a TPU-first twist: *stackless skip-pointer* BVHs in depth-first
// layout, so device-side traversal is a single while-loop with one node fetch
// per step (no per-ray stack) — the shape jax.lax.while_loop wants.
//
// Two entry points mirror the reference's two levels:
//   ck_build_bvh        — triangle BLAS (one per mesh at lodRT, object space;
//                         reference buildBLAS scenert.cpp:16-185)
//   ck_build_bvh_boxes  — box BVH over instance world AABBs, leaf size 1
//                         (reference createTLAS/buildTLAS scenert.cpp:520-579;
//                         rebuilt host-side on animation like the refit path
//                         niagara.cpp:1476-1482)
//
// Node encoding (8 floats):
//   [0:3] aabb min, [3:6] aabb max,
//   [6]   skip index as float bits (int32: node to jump to on miss;
//         on hit the next node is i+1),
//   [7]   leaf info as float bits: -1 for internal, else first_prim*16+count
//         (count <= max_leaf).

#include "cooker.h"

#include <float.h>
#include <math.h>
#include <stdlib.h>
#include <string.h>

#include <algorithm>
#include <vector>

namespace
{

const int MAX_LEAF = 8;

struct Box
{
	float mn[3], mx[3];

	void reset()
	{
		for (int k = 0; k < 3; ++k)
		{
			mn[k] = FLT_MAX;
			mx[k] = -FLT_MAX;
		}
	}

	void add(const float* p)
	{
		for (int k = 0; k < 3; ++k)
		{
			mn[k] = std::min(mn[k], p[k]);
			mx[k] = std::max(mx[k], p[k]);
		}
	}

	void add(const Box& b)
	{
		for (int k = 0; k < 3; ++k)
		{
			mn[k] = std::min(mn[k], b.mn[k]);
			mx[k] = std::max(mx[k], b.mx[k]);
		}
	}
};

struct Builder
{
	int maxLeaf = MAX_LEAF;
	std::vector<uint32_t> order; // primitive permutation
	std::vector<Box> triBox;
	std::vector<float> triCentroid;
	std::vector<float> nodes; // 8 floats per node

	uint32_t emit(const Box& b, int32_t skip, int32_t leaf)
	{
		uint32_t id = (uint32_t)(nodes.size() / 8);
		nodes.insert(nodes.end(), {b.mn[0], b.mn[1], b.mn[2], b.mx[0], b.mx[1], b.mx[2], 0, 0});
		memcpy(&nodes[id * 8 + 6], &skip, 4);
		memcpy(&nodes[id * 8 + 7], &leaf, 4);
		return id;
	}

	void patchSkip(uint32_t id, int32_t skip)
	{
		memcpy(&nodes[id * 8 + 6], &skip, 4);
	}

	// build [begin, end) of `order`; returns root node id.  Skip pointers are
	// patched afterwards via subtree extents (DFS layout: skip = end of
	// subtree).
	uint32_t build(uint32_t begin, uint32_t end)
	{
		Box bounds;
		bounds.reset();
		Box cbounds;
		cbounds.reset();
		for (uint32_t i = begin; i < end; ++i)
		{
			bounds.add(triBox[order[i]]);
			cbounds.add(&triCentroid[order[i] * 3]);
		}

		uint32_t count = end - begin;
		if (count <= (uint32_t)maxLeaf)
		{
			int32_t leaf = (int32_t)(begin * 16 + count);
			uint32_t id = emit(bounds, 0, leaf);
			patchSkip(id, (int32_t)(id + 1)); // leaf: miss and hit both continue at i+1
			return id;
		}

		// split along the widest centroid axis at the median
		int axis = 0;
		float best = -1;
		for (int k = 0; k < 3; ++k)
		{
			float w = cbounds.mx[k] - cbounds.mn[k];
			if (w > best)
			{
				best = w;
				axis = k;
			}
		}

		uint32_t mid = begin + count / 2;
		std::nth_element(order.begin() + begin, order.begin() + mid, order.begin() + end,
		    [&](uint32_t a, uint32_t b) { return triCentroid[a * 3 + axis] < triCentroid[b * 3 + axis]; });

		uint32_t id = emit(bounds, 0, -1);
		build(begin, mid);
		build(mid, end);
		// skip of this node = first node after the whole subtree
		patchSkip(id, (int32_t)(nodes.size() / 8));
		return id;
	}
};

} // namespace

extern "C" uint32_t ck_build_bvh(const float* positions, uint32_t vertex_count,
    const uint32_t* indices, uint32_t index_count,
    float* out_nodes, uint32_t max_nodes,
    uint32_t* out_tri_order)
{
	(void)vertex_count;
	uint32_t triCount = index_count / 3;
	if (triCount == 0)
		return 0;

	Builder b;
	b.order.resize(triCount);
	b.triBox.resize(triCount);
	b.triCentroid.resize(triCount * 3);
	b.nodes.reserve((size_t)triCount * 4);

	for (uint32_t t = 0; t < triCount; ++t)
	{
		b.order[t] = t;
		Box& box = b.triBox[t];
		box.reset();
		for (int c = 0; c < 3; ++c)
			box.add(&positions[indices[t * 3 + c] * 3]);
		for (int k = 0; k < 3; ++k)
			b.triCentroid[t * 3 + k] = (box.mn[k] + box.mx[k]) * 0.5f;
	}

	b.build(0, triCount);

	uint32_t nodeCount = (uint32_t)(b.nodes.size() / 8);
	if (nodeCount > max_nodes)
		return ~0u; // caller retries with a larger buffer

	memcpy(out_nodes, b.nodes.data(), b.nodes.size() * sizeof(float));
	memcpy(out_tri_order, b.order.data(), triCount * sizeof(uint32_t));
	return nodeCount;
}

// Box BVH (TLAS over instance world AABBs).  boxes = [count][6] floats
// (min3, max3); leaf info encodes first_box*16+count with count <= max_leaf
// over the returned `order` permutation.
extern "C" uint32_t ck_build_bvh_boxes(const float* boxes, uint32_t count,
    uint32_t max_leaf,
    float* out_nodes, uint32_t max_nodes,
    uint32_t* out_order)
{
	if (count == 0)
		return 0;
	if (max_leaf == 0 || max_leaf > 15)
		max_leaf = 1;

	Builder b;
	b.maxLeaf = (int)max_leaf;
	b.order.resize(count);
	b.triBox.resize(count);
	b.triCentroid.resize((size_t)count * 3);
	b.nodes.reserve((size_t)count * 8);

	for (uint32_t i = 0; i < count; ++i)
	{
		b.order[i] = i;
		Box& box = b.triBox[i];
		for (int k = 0; k < 3; ++k)
		{
			box.mn[k] = boxes[i * 6 + k];
			box.mx[k] = boxes[i * 6 + 3 + k];
			b.triCentroid[i * 3 + k] = (box.mn[k] + box.mx[k]) * 0.5f;
		}
	}

	b.build(0, count);

	uint32_t nodeCount = (uint32_t)(b.nodes.size() / 8);
	if (nodeCount > max_nodes)
		return ~0u;

	memcpy(out_nodes, b.nodes.data(), b.nodes.size() * sizeof(float));
	memcpy(out_order, b.order.data(), count * sizeof(uint32_t));
	return nodeCount;
}

// Topology-preserving bound refit (reference TLAS MODE_UPDATE,
// niagara.cpp:1476-1482): recompute node AABBs bottom-up over the existing
// DFS skip-pointer layout.  Reverse DFS order visits children before
// parents; internal node i's children are i+1 and skip(i+1) (the second
// child starts where the first subtree ends; this builder always splits in
// two).  boxes = [count][6] floats in LEAF order (the `order` permutation
// from the original build).  O(nodes), no allocation.
extern "C" void ck_refit_bvh_boxes(float* nodes, uint32_t node_count,
    const float* boxes, uint32_t count)
{
	(void)count;
	for (uint32_t ii = node_count; ii-- > 0;)
	{
		float* n = nodes + (size_t)ii * 8;
		int32_t leaf;
		memcpy(&leaf, n + 7, 4);
		if (leaf >= 0)
		{
			uint32_t first = (uint32_t)leaf >> 4;
			uint32_t cnt = (uint32_t)leaf & 15;
			Box b;
			b.reset();
			for (uint32_t t = 0; t < cnt; ++t)
			{
				b.add(&boxes[(first + t) * 6 + 0]);
				b.add(&boxes[(first + t) * 6 + 3]);
			}
			memcpy(n + 0, b.mn, 12);
			memcpy(n + 3, b.mx, 12);
		}
		else
		{
			int32_t skip, skip1;
			memcpy(&skip, n + 6, 4);
			const float* c1 = nodes + (size_t)(ii + 1) * 8;
			memcpy(&skip1, c1 + 6, 4);
			Box b;
			b.reset();
			b.add(c1 + 0);
			b.add(c1 + 3);
			if (skip1 < skip) // second child exists
			{
				const float* c2 = nodes + (size_t)skip1 * 8;
				b.add(c2 + 0);
				b.add(c2 + 3);
			}
			memcpy(n + 0, b.mn, 12);
			memcpy(n + 3, b.mx, 12);
		}
	}
}
