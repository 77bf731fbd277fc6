// IEEE 754 half-float conversion with round-to-nearest-even.
// Matches numpy's float32<->float16 conversion bit-for-bit (including
// subnormals), which the Python side of the cooker uses as its oracle.
#pragma once

#include <stdint.h>
#include <string.h>

static inline uint16_t f32_to_f16(float fv)
{
	uint32_t x;
	memcpy(&x, &fv, 4);

	uint32_t sign = (x >> 16) & 0x8000u;
	uint32_t mant = x & 0x7fffffu;
	uint32_t expbits = (x >> 23) & 0xffu;
	int32_t exp = (int32_t)expbits - 127;

	if (expbits == 0xffu)
		return (uint16_t)(sign | 0x7c00u | (mant ? 0x200u : 0u)); // inf / nan

	if (exp > 15)
		return (uint16_t)(sign | 0x7c00u); // overflow -> inf

	if (exp >= -14)
	{
		// normal half; mantissa carry on rounding propagates into the exponent
		uint32_t half = sign | (uint32_t)((exp + 15) << 10) | (mant >> 13);
		uint32_t rem = mant & 0x1fffu;
		if (rem > 0x1000u || (rem == 0x1000u && (half & 1u)))
			half++;
		return (uint16_t)half;
	}

	if (exp >= -25)
	{
		// subnormal half
		uint32_t m = mant | 0x800000u;
		int shift = 13 + (-14 - exp);
		uint32_t half = sign | (m >> shift);
		uint32_t rem = m & ((1u << shift) - 1u);
		uint32_t halfway = 1u << (shift - 1);
		if (rem > halfway || (rem == halfway && (half & 1u)))
			half++;
		return (uint16_t)half;
	}

	return (uint16_t)sign; // underflow to signed zero
}

static inline float f16_to_f32(uint16_t h)
{
	uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
	uint32_t em = h & 0x7fffu;
	uint32_t r;

	if (em >= 0x7c00u)
	{
		r = sign | 0x7f800000u | ((em & 0x3ffu) << 13); // inf/nan
	}
	else if (em >= 0x400u)
	{
		r = sign | ((em + ((127 - 15) << 10)) << 13); // normal
	}
	else if (em != 0)
	{
		// subnormal: normalize
		int e = -14;
		uint32_t m = em;
		while ((m & 0x400u) == 0)
		{
			m <<= 1;
			e--;
		}
		m &= 0x3ffu;
		r = sign | ((uint32_t)(e + 127) << 23) | (m << 13);
	}
	else
	{
		r = sign; // zero
	}

	float f;
	memcpy(&f, &r, 4);
	return f;
}

static inline int quantize_snorm(float v, int bits)
{
	float scale = (float)((1 << (bits - 1)) - 1);
	v = v < -1.f ? -1.f : (v > 1.f ? 1.f : v);
	return (int)(v >= 0.f ? v * scale + 0.5f : v * scale - 0.5f);
}
