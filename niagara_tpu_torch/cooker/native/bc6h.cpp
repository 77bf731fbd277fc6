// The port's own copy of niagara_tpu/cooker/native/bc6h.cpp, unchanged below this
// note; cooker/bindings.py builds it with g++ into niagara_tpu_torch/build/.
//
// BC6H (HDR) block decompression, written from the D3D11 BC6H format
// specification (role of the reference's vendored bcdec.h for BC6H DDS
// content; independent implementation, fuzz-verified against Pillow).
//
// BC6H: 128-bit blocks of 4x4 half-float RGB texels.  14 modes (2- or
// 5-bit selector); endpoints are 6..16-bit with optional delta transform
// against the first endpooint; two-region modes share the first 32 BC7
// partition shapes.  The per-mode bit layouts are heavily interleaved, so
// they are expressed here as declarative field tables (spec data) consumed
// by a single generic reader, rather than unrolled read code.

#include <stdint.h>
#include <string.h>

// first 32 two-subset partition shapes + anchors (bc7.cpp, spec constants)
extern const uint8_t ck_kPartition2[64][16];
extern const uint8_t ck_kAnchor2[64];

namespace
{

struct Op
{
	uint8_t ch;    // 0=r, 1=g, 2=b, 3=partition
	uint8_t ep;    // endpoint index 0..3 (w,x,y,z)
	uint8_t shift; // destination bit position
	uint8_t count; // bits to read
	uint8_t rev;   // 1: bit-reversed destination (modes 12/13 high bits)
};

#define END {255, 0, 0, 0, 0}

// field sequences per mode (D3D spec "Table.A"); P = partition selector
static const Op kMode0[] = {{1,2,4,1,0},{2,2,4,1,0},{2,3,4,1,0},{0,0,0,10,0},{1,0,0,10,0},{2,0,0,10,0},{0,1,0,5,0},{1,3,4,1,0},{1,2,0,4,0},{1,1,0,5,0},{2,3,0,1,0},{1,3,0,4,0},{2,1,0,5,0},{2,3,1,1,0},{2,2,0,4,0},{0,2,0,5,0},{2,3,2,1,0},{0,3,0,5,0},{2,3,3,1,0},{3,0,0,5,0},END};
static const Op kMode1[] = {{1,2,5,1,0},{1,3,4,1,0},{1,3,5,1,0},{0,0,0,7,0},{2,3,0,1,0},{2,3,1,1,0},{2,2,4,1,0},{1,0,0,7,0},{2,2,5,1,0},{2,3,2,1,0},{1,2,4,1,0},{2,0,0,7,0},{2,3,3,1,0},{2,3,5,1,0},{2,3,4,1,0},{0,1,0,6,0},{1,2,0,4,0},{1,1,0,6,0},{1,3,0,4,0},{2,1,0,6,0},{2,2,0,4,0},{0,2,0,6,0},{0,3,0,6,0},{3,0,0,5,0},END};
static const Op kMode2[] = {{0,0,0,10,0},{1,0,0,10,0},{2,0,0,10,0},{0,1,0,5,0},{0,0,10,1,0},{1,2,0,4,0},{1,1,0,4,0},{1,0,10,1,0},{2,3,0,1,0},{1,3,0,4,0},{2,1,0,4,0},{2,0,10,1,0},{2,3,1,1,0},{2,2,0,4,0},{0,2,0,5,0},{2,3,2,1,0},{0,3,0,5,0},{2,3,3,1,0},{3,0,0,5,0},END};
static const Op kMode3[] = {{0,0,0,10,0},{1,0,0,10,0},{2,0,0,10,0},{0,1,0,4,0},{0,0,10,1,0},{1,3,4,1,0},{1,2,0,4,0},{1,1,0,5,0},{1,0,10,1,0},{1,3,0,4,0},{2,1,0,4,0},{2,0,10,1,0},{2,3,1,1,0},{2,2,0,4,0},{0,2,0,4,0},{2,3,0,1,0},{2,3,2,1,0},{0,3,0,4,0},{1,2,4,1,0},{2,3,3,1,0},{3,0,0,5,0},END};
static const Op kMode4[] = {{0,0,0,10,0},{1,0,0,10,0},{2,0,0,10,0},{0,1,0,4,0},{0,0,10,1,0},{2,2,4,1,0},{1,2,0,4,0},{1,1,0,4,0},{1,0,10,1,0},{2,3,0,1,0},{1,3,0,4,0},{2,1,0,5,0},{2,0,10,1,0},{2,2,0,4,0},{0,2,0,4,0},{2,3,1,1,0},{2,3,2,1,0},{0,3,0,4,0},{2,3,4,1,0},{2,3,3,1,0},{3,0,0,5,0},END};
static const Op kMode5[] = {{0,0,0,9,0},{2,2,4,1,0},{1,0,0,9,0},{1,2,4,1,0},{2,0,0,9,0},{2,3,4,1,0},{0,1,0,5,0},{1,3,4,1,0},{1,2,0,4,0},{1,1,0,5,0},{2,3,0,1,0},{1,3,0,4,0},{2,1,0,5,0},{2,3,1,1,0},{2,2,0,4,0},{0,2,0,5,0},{2,3,2,1,0},{0,3,0,5,0},{2,3,3,1,0},{3,0,0,5,0},END};
static const Op kMode6[] = {{0,0,0,8,0},{1,3,4,1,0},{2,2,4,1,0},{1,0,0,8,0},{2,3,2,1,0},{1,2,4,1,0},{2,0,0,8,0},{2,3,3,1,0},{2,3,4,1,0},{0,1,0,6,0},{1,2,0,4,0},{1,1,0,5,0},{2,3,0,1,0},{1,3,0,4,0},{2,1,0,5,0},{2,3,1,1,0},{2,2,0,4,0},{0,2,0,6,0},{0,3,0,6,0},{3,0,0,5,0},END};
static const Op kMode7[] = {{0,0,0,8,0},{2,3,0,1,0},{2,2,4,1,0},{1,0,0,8,0},{1,2,5,1,0},{1,2,4,1,0},{2,0,0,8,0},{1,3,5,1,0},{2,3,4,1,0},{0,1,0,5,0},{1,3,4,1,0},{1,2,0,4,0},{1,1,0,6,0},{1,3,0,4,0},{2,1,0,5,0},{2,3,1,1,0},{2,2,0,4,0},{0,2,0,5,0},{2,3,2,1,0},{0,3,0,5,0},{2,3,3,1,0},{3,0,0,5,0},END};
static const Op kMode8[] = {{0,0,0,8,0},{2,3,1,1,0},{2,2,4,1,0},{1,0,0,8,0},{2,2,5,1,0},{1,2,4,1,0},{2,0,0,8,0},{2,3,5,1,0},{2,3,4,1,0},{0,1,0,5,0},{1,3,4,1,0},{1,2,0,4,0},{1,1,0,5,0},{2,3,0,1,0},{1,3,0,4,0},{2,1,0,6,0},{2,2,0,4,0},{0,2,0,5,0},{2,3,2,1,0},{0,3,0,5,0},{2,3,3,1,0},{3,0,0,5,0},END};
static const Op kMode9[] = {{0,0,0,6,0},{1,3,4,1,0},{2,3,0,1,0},{2,3,1,1,0},{2,2,4,1,0},{1,0,0,6,0},{1,2,5,1,0},{2,2,5,1,0},{2,3,2,1,0},{1,2,4,1,0},{2,0,0,6,0},{1,3,5,1,0},{2,3,3,1,0},{2,3,5,1,0},{2,3,4,1,0},{0,1,0,6,0},{1,2,0,4,0},{1,1,0,6,0},{1,3,0,4,0},{2,1,0,6,0},{2,2,0,4,0},{0,2,0,6,0},{0,3,0,6,0},{3,0,0,5,0},END};
static const Op kMode10[] = {{0,0,0,10,0},{1,0,0,10,0},{2,0,0,10,0},{0,1,0,10,0},{1,1,0,10,0},{2,1,0,10,0},END};
static const Op kMode11[] = {{0,0,0,10,0},{1,0,0,10,0},{2,0,0,10,0},{0,1,0,9,0},{0,0,10,1,0},{1,1,0,9,0},{1,0,10,1,0},{2,1,0,9,0},{2,0,10,1,0},END};
static const Op kMode12[] = {{0,0,0,10,0},{1,0,0,10,0},{2,0,0,10,0},{0,1,0,8,0},{0,0,10,2,1},{1,1,0,8,0},{1,0,10,2,1},{2,1,0,8,0},{2,0,10,2,1},END};
static const Op kMode13[] = {{0,0,0,10,0},{1,0,0,10,0},{2,0,0,10,0},{0,1,0,4,0},{0,0,10,6,1},{1,1,0,4,0},{1,0,10,6,1},{2,1,0,4,0},{2,0,10,6,1},END};

static const Op* kModeOps[14] = {kMode0, kMode1, kMode2, kMode3, kMode4, kMode5, kMode6,
                                 kMode7, kMode8, kMode9, kMode10, kMode11, kMode12, kMode13};

// endpoint precision (W) and delta widths per channel
static const int8_t kBitsW[14] = {10, 7, 11, 11, 11, 9, 8, 8, 8, 6, 10, 11, 12, 16};
static const int8_t kBitsR[14] = {5, 6, 5, 4, 4, 5, 6, 5, 5, 6, 10, 9, 8, 4};
static const int8_t kBitsG[14] = {5, 6, 4, 5, 4, 5, 5, 6, 5, 6, 10, 9, 8, 4};
static const int8_t kBitsB[14] = {5, 6, 4, 4, 5, 5, 5, 5, 6, 6, 10, 9, 8, 4};

static const int kWeight3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
static const int kWeight4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

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

static inline int extendSign(int v, int bits)
{
	return (v << (32 - bits)) >> (32 - bits);
}

// spec unquantization to the 17-bit interpolation domain
static int unquantize(int v, int bits, bool isSigned)
{
	if (!isSigned)
	{
		if (bits >= 15)
			return v;
		if (v == 0)
			return 0;
		if (v == (1 << bits) - 1)
			return 0xFFFF;
		return ((v << 16) + 0x8000) >> bits;
	}
	if (bits >= 16)
		return v;
	int s = v < 0;
	if (s)
		v = -v;
	int unq;
	if (v == 0)
		unq = 0;
	else if (v >= (1 << (bits - 1)) - 1)
		unq = 0x7FFF;
	else
		unq = ((v << 15) + 0x4000) >> (bits - 1);
	return s ? -unq : unq;
}

// final scale to half-float bits (31/64 unsigned, 31/32 signed)
static uint16_t finishUnquantize(int v, bool isSigned)
{
	if (!isSigned)
		return (uint16_t)((v * 31) >> 6);
	v = v < 0 ? -(((-v) * 31) >> 5) : (v * 31) >> 5;
	int s = 0;
	if (v < 0)
	{
		s = 0x8000;
		v = -v;
	}
	return (uint16_t)(s | v);
}

} // namespace

// Decode one 128-bit BC6H block into 16 half-float RGB texels (row-major).
extern "C" void ck_decode_bc6h_block(const uint8_t* block, uint16_t out[16][3], int is_signed)
{
	BitReader br{block};

	int mode = (int)br.read(2);
	if (mode > 1)
		mode |= (int)br.read(3) << 2;

	// map the 5-bit code to a dense mode index; reserved codes decode black
	int mi;
	switch (mode)
	{
	case 0b00: mi = 0; break;
	case 0b01: mi = 1; break;
	case 0b00010: mi = 2; break;
	case 0b00110: mi = 3; break;
	case 0b01010: mi = 4; break;
	case 0b01110: mi = 5; break;
	case 0b10010: mi = 6; break;
	case 0b10110: mi = 7; break;
	case 0b11010: mi = 8; break;
	case 0b11110: mi = 9; break;
	case 0b00011: mi = 10; break;
	case 0b00111: mi = 11; break;
	case 0b01011: mi = 12; break;
	case 0b01111: mi = 13; break;
	default:
		memset(out, 0, 16 * 3 * sizeof(uint16_t));
		return;
	}

	int e[3][4] = {};
	int partition = 0;
	for (const Op* op = kModeOps[mi]; op->ch != 255; ++op)
	{
		uint32_t v = br.read(op->count);
		if (op->rev)
		{
			uint32_t r = 0;
			for (int i = 0; i < op->count; ++i)
				r = (r << 1) | ((v >> i) & 1);
			v = r;
		}
		if (op->ch == 3)
			partition = (int)v;
		else
			e[op->ch][op->ep] |= (int)v << op->shift;
	}

	bool twoRegion = mi < 10;
	int nEp = twoRegion ? 4 : 2;
	const int8_t bitsW = kBitsW[mi];
	const int8_t bitsD[3] = {kBitsR[mi], kBitsG[mi], kBitsB[mi]};

	if (is_signed)
		for (int c = 0; c < 3; ++c)
			e[c][0] = extendSign(e[c][0], bitsW);

	bool transformed = mi != 9 && mi != 10;  // modes 10/11 store raw endpoints
	if (transformed || is_signed)
		for (int c = 0; c < 3; ++c)
			for (int i = 1; i < nEp; ++i)
				e[c][i] = extendSign(e[c][i], bitsD[c]);

	if (transformed)
		for (int c = 0; c < 3; ++c)
			for (int i = 1; i < nEp; ++i)
			{
				e[c][i] = (e[c][i] + e[c][0]) & ((1 << bitsW) - 1);
				if (is_signed)
					e[c][i] = extendSign(e[c][i], bitsW);
			}

	for (int c = 0; c < 3; ++c)
		for (int i = 0; i < nEp; ++i)
			e[c][i] = unquantize(e[c][i], bitsW, is_signed != 0);

	const int* weights = twoRegion ? kWeight3 : kWeight4;
	for (int t = 0; t < 16; ++t)
	{
		int subset, anchor;
		if (twoRegion)
		{
			subset = ck_kPartition2[partition][t];
			anchor = subset == 0 ? 0 : ck_kAnchor2[partition];
		}
		else
		{
			subset = 0;
			anchor = 0;
		}
		int bits = (twoRegion ? 3 : 4) - (t == anchor ? 1 : 0);
		int idx = (int)br.read(bits);
		int w = weights[idx];
		for (int c = 0; c < 3; ++c)
		{
			int a = e[c][subset * 2], b = e[c][subset * 2 + 1];
			int v = (a * (64 - w) + b * w + 32) >> 6;
			out[t][c] = finishUnquantize(v, is_signed != 0);
		}
	}
}
