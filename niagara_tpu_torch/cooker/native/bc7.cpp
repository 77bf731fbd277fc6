// The port's own copy of niagara_tpu/cooker/native/bc7.cpp, unchanged below this
// note but for the reference renderer's path in the next paragraph;
// cooker/bindings.py builds it with g++ into niagara_tpu_torch/build/.
//
// BC7 block decompression, written from the Khronos/D3D BC7 format
// specification (the reference consumes the same format through its vendored
// bcdec.h; this is an independent implementation — role of
// the reference renderer's src/textures.cpp:262-381 for BC7 DDS content).
//
// BC7: 128-bit blocks, 8 modes selected by the position of the lowest set
// bit.  Each mode defines subset count, partition/rotation bits, endpoint
// precision, shared or per-endpoint P-bits and index widths.  Endpoints are
// expanded to 8 bits by left-shift + high-bit replication, then interpolated
// with the 64-denominator weight tables.

#include <stdint.h>
#include <string.h>

// spec constant tables (identical in every conformant implementation) -----

// 4x4 partition assignments for 2-subset modes, indexed [partition][texel].
// Exported (ck_*): BC6H shares the first 32 shapes + anchors (bc6h.cpp).
extern const uint8_t ck_kPartition2[64][16];
extern const uint8_t ck_kAnchor2[64];
const uint8_t ck_kPartition2[64][16] = {
	{0,0,1,1,0,0,1,1,0,0,1,1,0,0,1,1},{0,0,0,1,0,0,0,1,0,0,0,1,0,0,0,1},
	{0,1,1,1,0,1,1,1,0,1,1,1,0,1,1,1},{0,0,0,1,0,0,1,1,0,0,1,1,0,1,1,1},
	{0,0,0,0,0,0,0,1,0,0,0,1,0,0,1,1},{0,0,1,1,0,1,1,1,0,1,1,1,1,1,1,1},
	{0,0,0,1,0,0,1,1,0,1,1,1,1,1,1,1},{0,0,0,0,0,0,0,1,0,0,1,1,0,1,1,1},
	{0,0,0,0,0,0,0,0,0,0,0,1,0,0,1,1},{0,0,1,1,0,1,1,1,1,1,1,1,1,1,1,1},
	{0,0,0,0,0,0,0,1,0,1,1,1,1,1,1,1},{0,0,0,0,0,0,0,0,0,0,0,1,0,1,1,1},
	{0,0,0,1,0,1,1,1,1,1,1,1,1,1,1,1},{0,0,0,0,0,0,0,0,1,1,1,1,1,1,1,1},
	{0,0,0,0,1,1,1,1,1,1,1,1,1,1,1,1},{0,0,0,0,0,0,0,0,0,0,0,0,1,1,1,1},
	{0,0,0,0,1,0,0,0,1,1,1,0,1,1,1,1},{0,1,1,1,0,0,0,1,0,0,0,0,0,0,0,0},
	{0,0,0,0,0,0,0,0,1,0,0,0,1,1,1,0},{0,1,1,1,0,0,1,1,0,0,0,1,0,0,0,0},
	{0,0,1,1,0,0,0,1,0,0,0,0,0,0,0,0},{0,0,0,0,1,0,0,0,1,1,0,0,1,1,1,0},
	{0,0,0,0,0,0,0,0,1,0,0,0,1,1,0,0},{0,1,1,1,0,0,1,1,0,0,1,1,0,0,0,1},
	{0,0,1,1,0,0,0,1,0,0,0,1,0,0,0,0},{0,0,0,0,1,0,0,0,1,0,0,0,1,1,0,0},
	{0,1,1,0,0,1,1,0,0,1,1,0,0,1,1,0},{0,0,1,1,0,1,1,0,0,1,1,0,1,1,0,0},
	{0,0,0,1,0,1,1,1,1,1,1,0,1,0,0,0},{0,0,0,0,1,1,1,1,1,1,1,1,0,0,0,0},
	{0,1,1,1,0,0,0,1,1,0,0,0,1,1,1,0},{0,0,1,1,1,0,0,1,1,0,0,1,1,1,0,0},
	{0,1,0,1,0,1,0,1,0,1,0,1,0,1,0,1},{0,0,0,0,1,1,1,1,0,0,0,0,1,1,1,1},
	{0,1,0,1,1,0,1,0,0,1,0,1,1,0,1,0},{0,0,1,1,0,0,1,1,1,1,0,0,1,1,0,0},
	{0,0,1,1,1,1,0,0,0,0,1,1,1,1,0,0},{0,1,0,1,0,1,0,1,1,0,1,0,1,0,1,0},
	{0,1,1,0,1,0,0,1,0,1,1,0,1,0,0,1},{0,1,0,1,1,0,1,0,1,0,1,0,0,1,0,1},
	{0,1,1,1,0,0,1,1,1,1,0,0,1,1,1,0},{0,0,0,1,0,0,1,1,1,1,0,0,1,0,0,0},
	{0,0,1,1,0,0,1,0,0,1,0,0,1,1,0,0},{0,0,1,1,1,0,1,1,1,1,0,1,1,1,0,0},
	{0,1,1,0,1,0,0,1,1,0,0,1,0,1,1,0},{0,0,1,1,1,1,0,0,1,1,0,0,0,0,1,1},
	{0,1,1,0,0,1,1,0,1,0,0,1,1,0,0,1},{0,0,0,0,0,1,1,0,0,1,1,0,0,0,0,0},
	{0,1,0,0,1,1,1,0,0,1,0,0,0,0,0,0},{0,0,1,0,0,1,1,1,0,0,1,0,0,0,0,0},
	{0,0,0,0,0,0,1,0,0,1,1,1,0,0,1,0},{0,0,0,0,0,1,0,0,1,1,1,0,0,1,0,0},
	{0,1,1,0,1,1,0,0,1,0,0,1,0,0,1,1},{0,0,1,1,0,1,1,0,1,1,0,0,1,0,0,1},
	{0,1,1,0,0,0,1,1,1,0,0,1,1,1,0,0},{0,0,1,1,1,0,0,1,1,1,0,0,0,1,1,0},
	{0,1,1,0,1,1,0,0,1,1,0,0,1,0,0,1},{0,1,1,0,0,0,1,1,0,0,1,1,1,0,0,1},
	{0,1,1,1,1,1,1,0,1,0,0,0,0,0,0,1},{0,0,0,1,1,0,0,0,1,1,1,0,0,1,1,1},
	{0,0,0,0,1,1,1,1,0,0,1,1,0,0,1,1},{0,0,1,1,0,0,1,1,1,1,1,1,0,0,0,0},
	{0,0,1,0,0,0,1,0,1,1,1,0,1,1,1,0},{0,1,0,0,0,1,0,0,0,1,1,1,0,1,1,1},
};

// anchor (fix-up) index of the second subset in 2-subset modes
const uint8_t ck_kAnchor2[64] = {
	15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
	15,  2,  8,  2,  2,  8,  8, 15,  2,  8,  2,  2,  8,  8,  2,  2,
	15, 15,  6,  8,  2,  8, 15, 15,  2,  8,  2,  2,  2, 15, 15,  6,
	 6,  2,  6,  8, 15, 15,  2,  2, 15, 15, 15, 15, 15,  2,  2, 15,
};

namespace
{

// 4x4 partition assignments for 3-subset modes
static const uint8_t kPartition3[64][16] = {
	{0,0,1,1,0,0,1,1,0,2,2,1,2,2,2,2},{0,0,0,1,0,0,1,1,2,2,1,1,2,2,2,1},
	{0,0,0,0,2,0,0,1,2,2,1,1,2,2,1,1},{0,2,2,2,0,0,2,2,0,0,1,1,0,1,1,1},
	{0,0,0,0,0,0,0,0,1,1,2,2,1,1,2,2},{0,0,1,1,0,0,1,1,0,0,2,2,0,0,2,2},
	{0,0,2,2,0,0,2,2,1,1,1,1,1,1,1,1},{0,0,1,1,0,0,1,1,2,2,1,1,2,2,1,1},
	{0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2},{0,0,0,0,1,1,1,1,1,1,1,1,2,2,2,2},
	{0,0,0,0,1,1,1,1,2,2,2,2,2,2,2,2},{0,0,1,2,0,0,1,2,0,0,1,2,0,0,1,2},
	{0,1,1,2,0,1,1,2,0,1,1,2,0,1,1,2},{0,1,2,2,0,1,2,2,0,1,2,2,0,1,2,2},
	{0,0,1,1,0,1,1,2,1,1,2,2,1,2,2,2},{0,0,1,1,2,0,0,1,2,2,0,0,2,2,2,0},
	{0,0,0,1,0,0,1,1,0,1,1,2,1,1,2,2},{0,1,1,1,0,0,1,1,2,0,0,1,2,2,0,0},
	{0,0,0,0,1,1,2,2,1,1,2,2,1,1,2,2},{0,0,2,2,0,0,2,2,0,0,2,2,1,1,1,1},
	{0,1,1,1,0,1,1,1,0,2,2,2,0,2,2,2},{0,0,0,1,0,0,0,1,2,2,2,1,2,2,2,1},
	{0,0,0,0,0,0,1,1,0,1,2,2,0,1,2,2},{0,0,0,0,1,1,0,0,2,2,1,0,2,2,1,0},
	{0,1,2,2,0,1,2,2,0,0,1,1,0,0,0,0},{0,0,1,2,0,0,1,2,1,1,2,2,2,2,2,2},
	{0,1,1,0,1,2,2,1,1,2,2,1,0,1,1,0},{0,0,0,0,0,1,1,0,1,2,2,1,1,2,2,1},
	{0,0,2,2,1,1,0,2,1,1,0,2,0,0,2,2},{0,1,1,0,0,1,1,0,2,0,0,2,2,2,2,2},
	{0,0,1,1,0,1,2,2,0,1,2,2,0,0,1,1},{0,0,0,0,2,0,0,0,2,2,1,1,2,2,2,1},
	{0,0,0,0,0,0,0,2,1,1,2,2,1,2,2,2},{0,2,2,2,0,0,2,2,0,0,1,2,0,0,1,1},
	{0,0,1,1,0,0,1,2,0,0,2,2,0,2,2,2},{0,1,2,0,0,1,2,0,0,1,2,0,0,1,2,0},
	{0,0,0,0,1,1,1,1,2,2,2,2,0,0,0,0},{0,1,2,0,1,2,0,1,2,0,1,2,0,1,2,0},
	{0,1,2,0,2,0,1,2,1,2,0,1,0,1,2,0},{0,0,1,1,2,2,0,0,1,1,2,2,0,0,1,1},
	{0,0,1,1,1,1,2,2,2,2,0,0,0,0,1,1},{0,1,0,1,0,1,0,1,2,2,2,2,2,2,2,2},
	{0,0,0,0,0,0,0,0,2,1,2,1,2,1,2,1},{0,0,2,2,1,1,2,2,0,0,2,2,1,1,2,2},
	{0,0,2,2,0,0,1,1,0,0,2,2,0,0,1,1},{0,2,2,0,1,2,2,1,0,2,2,0,1,2,2,1},
	{0,1,0,1,2,2,2,2,2,2,2,2,0,1,0,1},{0,0,0,0,2,1,2,1,2,1,2,1,2,1,2,1},
	{0,1,0,1,0,1,0,1,0,1,0,1,2,2,2,2},{0,2,2,2,0,1,1,1,0,2,2,2,0,1,1,1},
	{0,0,0,2,1,1,1,2,0,0,0,2,1,1,1,2},{0,0,0,0,2,1,1,2,2,1,1,2,2,1,1,2},
	{0,2,2,2,0,1,1,1,0,1,1,1,0,2,2,2},{0,0,0,2,1,1,1,2,1,1,1,2,0,0,0,2},
	{0,1,1,0,0,1,1,0,0,1,1,0,2,2,2,2},{0,0,0,0,0,0,0,0,2,1,1,2,2,1,1,2},
	{0,1,1,0,0,1,1,0,2,2,2,2,2,2,2,2},{0,0,2,2,0,0,1,1,0,0,1,1,0,0,2,2},
	{0,0,2,2,1,1,2,2,1,1,2,2,0,0,2,2},{0,0,0,0,0,0,0,0,0,0,0,0,2,1,1,2},
	{0,0,0,2,0,0,0,1,0,0,0,2,0,0,0,1},{0,2,2,2,1,2,2,2,0,2,2,2,1,2,2,2},
	{0,1,0,1,2,2,2,2,2,2,2,2,2,2,2,2},{0,1,1,1,2,0,1,1,2,2,0,1,2,2,2,0},
};

#define kPartition2 ck_kPartition2
#define kAnchor2 ck_kAnchor2

// anchor indices of subsets 1 and 2 in 3-subset modes
static const uint8_t kAnchor3a[64] = {
	 3,  3, 15, 15,  8,  3, 15, 15,  8,  8,  6,  6,  6,  5,  3,  3,
	 3,  3,  8, 15,  3,  3,  6, 10,  5,  8,  8,  6,  8,  5, 15, 15,
	 8, 15,  3,  5,  6, 10,  8, 15, 15,  3, 15,  5, 15, 15, 15, 15,
	 3, 15,  5,  5,  5,  8,  5, 10,  5, 10,  8, 13, 15, 12,  3,  3,
};
static const uint8_t kAnchor3b[64] = {
	15,  8,  8,  3, 15, 15,  3,  8, 15, 15, 15, 15, 15, 15, 15,  8,
	15,  8, 15,  3, 15,  8, 15,  8,  3, 15,  6, 10, 15, 15, 10,  8,
	15,  3, 15, 10, 10,  8,  9, 10,  6, 15,  8, 15,  3,  6,  6,  8,
	15,  3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,  3, 15, 15,  8,
};

// interpolation weights (denominator 64)
static const uint8_t kWeight2[4] = {0, 21, 43, 64};
static const uint8_t kWeight3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
static const uint8_t kWeight4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

struct BitReader
{
	const uint8_t* data;
	int pos = 0;

	uint32_t read(int n)
	{
		uint32_t v = 0;
		for (int i = 0; i < n; ++i, ++pos)
			v |= (uint32_t)((data[pos >> 3] >> (pos & 7)) & 1) << i;
		return v;
	}
};

struct ModeInfo
{
	uint8_t subsets;       // number of subsets
	uint8_t partitionBits; // partition selector width
	uint8_t rotationBits;
	uint8_t indexModeBits; // mode 4 index-selection bit
	uint8_t colorBits;     // per-channel endpoint precision (rgb)
	uint8_t alphaBits;     // alpha endpoint precision (0 = opaque)
	uint8_t pBits;         // unique P-bits per block (0, 2, 4 or 6)
	uint8_t sharedPBits;   // 1: one P-bit per subset shared by both endpoints
	uint8_t indexBits;     // primary index width
	uint8_t indexBits2;    // secondary index width (modes 4/5)
};

static const ModeInfo kModes[8] = {
	/*0*/ {3, 4, 0, 0, 4, 0, 6, 0, 3, 0},
	/*1*/ {2, 6, 0, 0, 6, 0, 2, 1, 3, 0},
	/*2*/ {3, 6, 0, 0, 5, 0, 0, 0, 2, 0},
	/*3*/ {2, 6, 0, 0, 7, 0, 4, 0, 2, 0},
	/*4*/ {1, 0, 2, 1, 5, 6, 0, 0, 2, 3},
	/*5*/ {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
	/*6*/ {1, 0, 0, 0, 7, 7, 2, 0, 4, 0},
	/*7*/ {2, 6, 0, 0, 5, 5, 4, 0, 2, 0},
};

static inline uint8_t expandTo8(uint32_t v, int bits)
{
	// left-align then replicate high bits into the vacated low bits
	uint32_t x = v << (8 - bits);
	return (uint8_t)(x | (x >> bits));
}

static inline uint8_t lerp64(uint8_t a, uint8_t b, uint8_t w)
{
	return (uint8_t)(((64 - w) * (uint32_t)a + w * (uint32_t)b + 32) >> 6);
}

} // namespace

// Decode one 128-bit BC7 block into 16 RGBA texels (row-major 4x4).
extern "C" void ck_decode_bc7_block(const uint8_t* block, uint8_t out[16][4])
{
	BitReader br{block};

	int mode = 0;
	while (mode < 8 && br.read(1) == 0)
		++mode;
	if (mode == 8)
	{
		// reserved: spec decodes as transparent black
		memset(out, 0, 16 * 4);
		return;
	}

	const ModeInfo& m = kModes[mode];
	int subsets = m.subsets;

	uint32_t partition = m.partitionBits ? br.read(m.partitionBits) : 0;
	uint32_t rotation = m.rotationBits ? br.read(m.rotationBits) : 0;
	uint32_t indexMode = m.indexModeBits ? br.read(m.indexModeBits) : 0;

	// endpoints: channel-major in the bit stream (all R, all G, all B, all A)
	uint8_t ep[6][4]; // up to 3 subsets x 2 endpoints, rgba
	int nEp = subsets * 2;
	for (int ch = 0; ch < 3; ++ch)
		for (int e = 0; e < nEp; ++e)
			ep[e][ch] = (uint8_t)br.read(m.colorBits);
	if (m.alphaBits)
		for (int e = 0; e < nEp; ++e)
			ep[e][3] = (uint8_t)br.read(m.alphaBits);

	// P-bits append one low bit to every endpoint channel; shared mode has
	// one bit per subset covering both of its endpoints (mode 1)
	int cb = m.colorBits, ab = m.alphaBits;
	if (m.pBits)
	{
		uint32_t pb[6];
		int nP = m.sharedPBits ? subsets : nEp;
		for (int i = 0; i < nP; ++i)
			pb[i] = br.read(1);
		for (int e = 0; e < nEp; ++e)
		{
			uint32_t p = m.sharedPBits ? pb[e >> 1] : pb[e];
			for (int ch = 0; ch < 4; ++ch)
			{
				int bits = ch == 3 ? ab : cb;
				if (bits)
					ep[e][ch] = (uint8_t)((ep[e][ch] << 1) | p);
			}
		}
		cb += 1;
		if (ab)
			ab += 1;
	}

	// expand endpoints to 8 bits
	for (int e = 0; e < nEp; ++e)
	{
		for (int ch = 0; ch < 3; ++ch)
			ep[e][ch] = expandTo8(ep[e][ch], cb);
		ep[e][3] = ab ? expandTo8(ep[e][3], ab) : 255;
	}

	// subset + anchor assignment per texel
	uint8_t subsetOf[16];
	uint8_t anchor[3] = {0, 0, 0};
	if (subsets == 1)
		memset(subsetOf, 0, 16);
	else if (subsets == 2)
	{
		memcpy(subsetOf, kPartition2[partition], 16);
		anchor[1] = kAnchor2[partition];
	}
	else
	{
		memcpy(subsetOf, kPartition3[partition], 16);
		anchor[1] = kAnchor3a[partition];
		anchor[2] = kAnchor3b[partition];
	}

	// index streams: anchor texels store one bit less (high bit implied 0).
	// The anchor of subset 0 is texel 0; other subsets use the spec tables.
	uint8_t idx1[16], idx2[16];
	for (int t = 0; t < 16; ++t)
	{
		bool isAnchor = (subsetOf[t] == 0) ? (t == 0) : (t == anchor[subsetOf[t]]);
		idx1[t] = (uint8_t)br.read(m.indexBits - (isAnchor ? 1 : 0));
	}
	if (m.indexBits2)
		for (int t = 0; t < 16; ++t)
			idx2[t] = (uint8_t)br.read(m.indexBits2 - (t == 0 ? 1 : 0));

	const uint8_t* w1 = m.indexBits == 2 ? kWeight2 : (m.indexBits == 3 ? kWeight3 : kWeight4);
	const uint8_t* w2 = m.indexBits2 == 2 ? kWeight2 : kWeight3;

	for (int t = 0; t < 16; ++t)
	{
		int s = subsetOf[t];
		const uint8_t* e0 = ep[s * 2];
		const uint8_t* e1 = ep[s * 2 + 1];

		uint8_t colorWeight, alphaWeight;
		if (m.indexBits2 == 0)
			colorWeight = alphaWeight = w1[idx1[t]];
		else if (indexMode == 0)
		{
			colorWeight = w1[idx1[t]];
			alphaWeight = w2[idx2[t]];
		}
		else
		{
			colorWeight = w2[idx2[t]];
			alphaWeight = w1[idx1[t]];
		}

		uint8_t px[4];
		for (int ch = 0; ch < 3; ++ch)
			px[ch] = lerp64(e0[ch], e1[ch], colorWeight);
		px[3] = lerp64(e0[3], e1[3], alphaWeight);

		// rotation swaps alpha with one color channel (modes 4/5)
		if (rotation)
		{
			uint8_t tmp = px[3];
			px[3] = px[rotation - 1];
			px[rotation - 1] = tmp;
		}

		memcpy(out[t], px, 4);
	}
}
