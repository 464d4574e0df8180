// Kernel P1's per-lane arithmetic: the geometry of a lane's rows and
// column, and the fold of one record chunk into the lane's accumulators.
//
// The selection comes as packed words, t_words [K, ceil(N / 32)], bit i of
// word w the selection bit of row 32 w + i (LSB first, the reference's
// pack_lanes layout).  Rows are grouped in tiles of 32, one selection word
// a key and tile.  A record of R bytes is `cols` chunks of VEC bytes (16
// where R % 16 == 0, else 4); TPR lanes cover a row (a power of two, the
// chunks of one column group of at most 32), so a warp covers RPP = 32 /
// TPR consecutive rows of one tile at a time and every lane of it tests the
// same word.  Lane l owns column l % TPR of its group and row l / TPR of
// each such pass.
//
// Plain C++ over uint32_t; it also compiles on the host.

#pragma once

#include "dcf_walk.cuh"

namespace dcf {

// The pass p of a tile: a lane's row within the 32 rows of the tile.
template <int TPR>
DCF_HD int pir_row_in_tile(int lane, int p) {
  return p * (32 / TPR) + lane / TPR;
}

// One chunk x of a row into a lane's KK accumulators: key k takes it where
// bit `pos` (the row within its tile) of its selection word w[k] is set.
// XOR is exact in any order, so the folds of a column's lanes and blocks
// may be combined in any order.
template <int KK, int W>
DCF_HD void pir_fold(uint32_t (*acc)[W], const uint32_t* w, int pos,
                     const uint32_t* x) {
  for (int k = 0; k < KK; ++k) {
    const uint32_t m = 0u - ((w[k] >> pos) & 1u);
    for (int q = 0; q < W; ++q) acc[k][q] ^= x[q] & m;
  }
}

}  // namespace dcf
