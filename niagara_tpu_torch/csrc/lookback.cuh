// Decoupled look-back over 32-bit status words, shared by the ordered
// compactions of setup.cu and cull.cu.
//
// Each tile of a single-pass compaction publishes one status word: 2 flag
// bits (its own count, or its inclusive prefix) and 30 value bits.  Tiles
// take their index from an atomic ticket, so every tile before one has
// started and the look-back cannot wait on a tile that is not running.

#pragma once

#include <stdint.h>

namespace lookback {

constexpr unsigned kAggregate = 1u << 30;  // status flags: the tile's own count ...
constexpr unsigned kPrefix = 2u << 30;     // ... or its inclusive prefix
constexpr unsigned kValue = kAggregate - 1u;

// Exclusive prefix of tile vb: warp-wide look-back over the status words
// of the tiles before it (called by one full warp).
__device__ __forceinline__ int look_back(const unsigned* status, int vb, int lane) {
  int excl = 0;
  for (int j = vb - 1;;) {
    const int idx = j - lane;
    const unsigned s = idx >= 0 ? *(const volatile unsigned*)(status + idx) : kPrefix;
    const unsigned flag = s >> 30;
    const unsigned pmask = __ballot_sync(0xffffffffu, flag == 2u);
    const unsigned need = pmask ? (pmask & (0u - pmask)) * 2u - 1u : 0xffffffffu;  // lanes up to the nearest prefix
    if (__ballot_sync(0xffffffffu, flag == 0u) & need) continue;  // not published yet: read again
    int v = (need >> lane) & 1u ? (int)(s & kValue) : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    excl += v;
    if (pmask) return excl;
    j -= 32;
  }
}

// The inclusive prefix of tile vb once it is published (one thread spins).
__device__ __forceinline__ int wait_prefix(const unsigned* status, int vb) {
  unsigned s;
  do s = *(const volatile unsigned*)(status + vb);
  while ((s >> 30) != 2u);
  return (int)(s & kValue);
}

}  // namespace lookback
