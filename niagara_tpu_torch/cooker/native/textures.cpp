// The port's own copy of niagara_tpu/cooker/native/textures.cpp, unchanged below this
// note; cooker/bindings.py builds it with g++ into niagara_tpu_torch/build/.
//
// DDS container parsing + BC block decompression.
//
// Role of the reference's textures.cpp (DDS header parse + GPU upload of BC
// blocks) and its vendored bcdec.h (CPU BC decode for the OMM bake).  TPUs
// have no BC sampler hardware, so unlike the reference we decode to RGBA8 at
// load time and the device samples a plain texel table.
//
// Supported: BC1 (DXT1), BC2 (DXT3), BC3 (DXT5), BC4 (ATI1), BC5 (ATI2),
// BC7 (bc7.cpp), BC6H HDR tone-clamped to 8-bit (bc6h.cpp), and
// uncompressed RGBA8.

#include "cooker.h"

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <algorithm>
#include <vector>

extern "C" void ck_decode_bc7_block(const uint8_t* block, uint8_t out[16][4]);
extern "C" void ck_decode_bc6h_block(const uint8_t* block, uint16_t out[16][3], int is_signed);

namespace
{
// half -> float (standard bit expansion; inputs are finite BC6H outputs)
static float halfToFloat(uint16_t h)
{
	uint32_t sign = (uint32_t)(h & 0x8000) << 16;
	uint32_t em = h & 0x7FFF;
	uint32_t bits;
	if (em == 0)
		bits = sign;
	else if ((em & 0x7C00) == 0)
	{
		// subnormal half: normalize
		int e = -1;
		uint32_t m = em;
		do { ++e; m <<= 1; } while ((m & 0x400) == 0);
		bits = sign | ((uint32_t)(127 - 15 - e + 1) << 23) | ((m & 0x3FF) << 13);
	}
	else
		bits = sign | ((((em >> 10) - 15 + 127) & 0xFF) << 23) | ((em & 0x3FF) << 13);
	float f;
	memcpy(&f, &bits, 4);
	return f;
}
} // namespace

namespace
{

struct BlockColors
{
	uint8_t c[4][4]; // rgba
};

static void decodeColorBlock(const uint8_t* b, BlockColors& out, bool bc1_punchthrough)
{
	uint16_t c0 = (uint16_t)(b[0] | (b[1] << 8));
	uint16_t c1 = (uint16_t)(b[2] | (b[3] << 8));

	auto expand = [](uint16_t c, uint8_t* rgb) {
		rgb[0] = (uint8_t)(((c >> 11) & 31) * 255 / 31);
		rgb[1] = (uint8_t)(((c >> 5) & 63) * 255 / 63);
		rgb[2] = (uint8_t)((c & 31) * 255 / 31);
	};

	expand(c0, out.c[0]);
	expand(c1, out.c[1]);
	out.c[0][3] = out.c[1][3] = out.c[2][3] = out.c[3][3] = 255;

	if (!bc1_punchthrough || c0 > c1)
	{
		for (int k = 0; k < 3; ++k)
		{
			out.c[2][k] = (uint8_t)((2 * out.c[0][k] + out.c[1][k] + 1) / 3);
			out.c[3][k] = (uint8_t)((out.c[0][k] + 2 * out.c[1][k] + 1) / 3);
		}
	}
	else
	{
		for (int k = 0; k < 3; ++k)
		{
			out.c[2][k] = (uint8_t)((out.c[0][k] + out.c[1][k]) / 2);
			out.c[3][k] = 0;
		}
		out.c[3][3] = 0; // transparent black
	}
}

// 8-byte BC4 block -> 16 alpha values
static void decodeAlphaBlock(const uint8_t* b, uint8_t out[16])
{
	int a0 = b[0], a1 = b[1];
	int pal[8];
	pal[0] = a0;
	pal[1] = a1;
	if (a0 > a1)
		for (int i = 1; i < 7; ++i)
			pal[i + 1] = ((7 - i) * a0 + i * a1) / 7;
	else
	{
		for (int i = 1; i < 5; ++i)
			pal[i + 1] = ((5 - i) * a0 + i * a1) / 5;
		pal[6] = 0;
		pal[7] = 255;
	}
	uint64_t bits = 0;
	for (int i = 0; i < 6; ++i)
		bits |= (uint64_t)b[2 + i] << (8 * i);
	for (int i = 0; i < 16; ++i)
		out[i] = (uint8_t)pal[(bits >> (3 * i)) & 7];
}

// decode one 4x4 block into rgba at (bx,by) of a w x h image
static void putBlock(uint8_t* rgba, uint32_t w, uint32_t h, uint32_t bx, uint32_t by, const uint8_t px[16][4])
{
	for (int y = 0; y < 4; ++y)
	{
		uint32_t iy = by * 4 + y;
		if (iy >= h)
			break;
		for (int x = 0; x < 4; ++x)
		{
			uint32_t ix = bx * 4 + x;
			if (ix >= w)
				break;
			memcpy(&rgba[(iy * w + ix) * 4], px[y * 4 + x], 4);
		}
	}
}

static void decodeMip(int format, const uint8_t* src, uint8_t* rgba, uint32_t w, uint32_t h)
{
	uint32_t bw = (w + 3) / 4, bh = (h + 3) / 4;
	size_t blockSize = (format == 1 || format == 4) ? 8 : 16;

	for (uint32_t by = 0; by < bh; ++by)
		for (uint32_t bx = 0; bx < bw; ++bx)
		{
			const uint8_t* b = src + (by * bw + bx) * blockSize;
			uint8_t px[16][4];
			BlockColors cols;

			switch (format)
			{
			case 1: // BC1
			{
				decodeColorBlock(b, cols, true);
				uint32_t idx = (uint32_t)(b[4] | (b[5] << 8) | (b[6] << 16) | ((uint32_t)b[7] << 24));
				for (int i = 0; i < 16; ++i)
					memcpy(px[i], cols.c[(idx >> (2 * i)) & 3], 4);
				break;
			}
			case 2: // BC2: explicit alpha + color
			{
				decodeColorBlock(b + 8, cols, false);
				uint32_t idx = (uint32_t)(b[12] | (b[13] << 8) | (b[14] << 16) | ((uint32_t)b[15] << 24));
				for (int i = 0; i < 16; ++i)
				{
					memcpy(px[i], cols.c[(idx >> (2 * i)) & 3], 4);
					uint8_t a4 = (uint8_t)((b[i / 2] >> ((i % 2) * 4)) & 15);
					px[i][3] = (uint8_t)(a4 * 17);
				}
				break;
			}
			case 3: // BC3: BC4 alpha + color
			{
				uint8_t alpha[16];
				decodeAlphaBlock(b, alpha);
				decodeColorBlock(b + 8, cols, false);
				uint32_t idx = (uint32_t)(b[12] | (b[13] << 8) | (b[14] << 16) | ((uint32_t)b[15] << 24));
				for (int i = 0; i < 16; ++i)
				{
					memcpy(px[i], cols.c[(idx >> (2 * i)) & 3], 4);
					px[i][3] = alpha[i];
				}
				break;
			}
			case 4: // BC4: single channel
			{
				uint8_t r[16];
				decodeAlphaBlock(b, r);
				for (int i = 0; i < 16; ++i)
				{
					px[i][0] = r[i];
					px[i][1] = px[i][2] = 0;
					px[i][3] = 255;
				}
				break;
			}
			case 5: // BC5: two channels
			{
				uint8_t r[16], g[16];
				decodeAlphaBlock(b, r);
				decodeAlphaBlock(b + 8, g);
				for (int i = 0; i < 16; ++i)
				{
					px[i][0] = r[i];
					px[i][1] = g[i];
					px[i][2] = 0;
					px[i][3] = 255;
				}
				break;
			}
			case 7: // BC7 (bc7.cpp)
				ck_decode_bc7_block(b, px);
				break;
			case 8: // BC6H unsigned (bc6h.cpp); HDR tone-clamped to RGBA8
			case 9: // BC6H signed
			{
				uint16_t halves[16][3];
				ck_decode_bc6h_block(b, halves, format == 9);
				for (int i = 0; i < 16; ++i)
				{
					for (int c = 0; c < 3; ++c)
					{
						float v = halfToFloat(halves[i][c]);
						v = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
						px[i][c] = (uint8_t)(v * 255.0f + 0.5f);
					}
					px[i][3] = 255;
				}
				break;
			}
			default:
				memset(px, 128, sizeof(px));
			}

			putBlock(rgba, w, h, bx, by, px);
		}
}

} // namespace

// Parse a DDS file and decode all mips to RGBA8.
// out_info: [0]=width, [1]=height, [2]=mip_count, [3]=format (1..5 = BC1..5,
//           6 = rgba8, 0 = unsupported).
// Returns a malloc'd RGBA8 buffer with mips concatenated (caller frees with
// ck_free_rgba), or null on failure.
extern "C" uint8_t* ck_load_dds(const char* path, uint32_t* out_info)
{
	memset(out_info, 0, 4 * sizeof(uint32_t));

	FILE* f = fopen(path, "rb");
	if (!f)
		return nullptr;
	fseek(f, 0, SEEK_END);
	long size = ftell(f);
	fseek(f, 0, SEEK_SET);
	std::vector<uint8_t> data(size);
	if (size < 128 || fread(data.data(), 1, size, f) != (size_t)size)
	{
		fclose(f);
		return nullptr;
	}
	fclose(f);

	if (memcmp(data.data(), "DDS ", 4) != 0)
		return nullptr;

	auto rd = [&](size_t off) { uint32_t v; memcpy(&v, &data[off], 4); return v; };

	uint32_t height = rd(12);
	uint32_t width = rd(16);
	uint32_t mipCount = std::max(rd(28), 1u);
	uint32_t pfFlags = rd(80);
	uint32_t fourcc = rd(84);

	size_t offset = 128;
	int format = 0;
	if (pfFlags & 0x4) // FOURCC
	{
		if (fourcc == 0x31545844) format = 1;      // DXT1
		else if (fourcc == 0x33545844) format = 2; // DXT3
		else if (fourcc == 0x35545844) format = 3; // DXT5
		else if (fourcc == 0x31495441) format = 4; // ATI1/BC4
		else if (fourcc == 0x32495441) format = 5; // ATI2/BC5
		else if (fourcc == 0x30315844)             // DX10 header
		{
			uint32_t dxgi = rd(128);
			offset = 148;
			if (dxgi >= 70 && dxgi <= 72) format = 1;      // BC1
			else if (dxgi >= 73 && dxgi <= 75) format = 2; // BC2
			else if (dxgi >= 76 && dxgi <= 78) format = 3; // BC3
			else if (dxgi >= 79 && dxgi <= 81) format = 4; // BC4
			else if (dxgi >= 82 && dxgi <= 84) format = 5; // BC5
			else if (dxgi == 28 || dxgi == 29) format = 6; // RGBA8
			else if (dxgi >= 97 && dxgi <= 99) format = 7; // BC7
			else if (dxgi == 95) format = 8;               // BC6H_UF16
			else if (dxgi == 96) format = 9;               // BC6H_SF16
		}
	}
	else if (pfFlags & 0x40) // uncompressed RGB(A)
	{
		if (rd(88) == 32)
			format = 6;
	}

	if (format == 0)
		return nullptr;

	// total output texels
	size_t total = 0;
	{
		uint32_t w = width, h = height;
		for (uint32_t m = 0; m < mipCount; ++m)
		{
			total += (size_t)w * h;
			w = std::max(w / 2, 1u);
			h = std::max(h / 2, 1u);
		}
	}

	uint8_t* rgba = (uint8_t*)malloc(total * 4);
	if (!rgba)
		return nullptr;

	uint8_t* dst = rgba;
	uint32_t w = width, h = height;
	for (uint32_t m = 0; m < mipCount; ++m)
	{
		size_t srcSize;
		if (format == 6)
			srcSize = (size_t)w * h * 4;
		else
		{
			size_t blockSize = (format == 1 || format == 4) ? 8 : 16;
			srcSize = (size_t)((w + 3) / 4) * ((h + 3) / 4) * blockSize;
		}
		if (offset + srcSize > (size_t)size)
		{
			free(rgba);
			return nullptr;
		}

		if (format == 6)
			memcpy(dst, &data[offset], srcSize);
		else
			decodeMip(format, &data[offset], dst, w, h);

		offset += srcSize;
		dst += (size_t)w * h * 4;
		w = std::max(w / 2, 1u);
		h = std::max(h / 2, 1u);
	}

	out_info[0] = width;
	out_info[1] = height;
	out_info[2] = mipCount;
	out_info[3] = (uint32_t)format;
	return rgba;
}

extern "C" void ck_free_rgba(uint8_t* p)
{
	free(p);
}
