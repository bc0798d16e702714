// The cell of the anti-diagonal affine-gap DP, shared by the fill variants
// (wavefront_fill_variants.cu) and the cluster tile fill
// (tile_fill_cluster.cu).  The recurrence is the one in the docstring of
// sedef_tpu_torch/ops/wavefront.py.

#pragma once

#include <stdint.h>

namespace sedef {

constexpr int WILD = 4;

struct Score {
  int match, mis, gapo, qe2, max_sc;
};

// One cell.  (xs, vs): x and v of lane t - 1 in the row before; (ub, yb): u
// and y of lane t in the row before; all after boundary injection.  The
// strict '>' tests in order and then the clamp decide the direction byte.
__device__ __forceinline__ int dp_cell(int sc, int xs, int vs, int ub, int yb,
                                       const Score& s, int& u, int& v, int& x,
                                       int& y) {
  int z = sc + s.qe2;
  const int a = xs + vs;
  const int b = yb + ub;
  int d = a > z ? 1 : 0;
  z = max(z, a);
  d = b > z ? 2 : d;
  z = max(z, b);
  z = min(z, s.max_sc);
  const int z2 = z - s.gapo;
  const int a2 = a - z2;
  const int b2 = b - z2;
  u = z - vs;
  v = z - ub;
  x = max(a2, 0);
  y = max(b2, 0);
  return d | (a2 > 0 ? 8 : 0) | (b2 > 0 ? 16 : 0);
}

}  // namespace sedef
