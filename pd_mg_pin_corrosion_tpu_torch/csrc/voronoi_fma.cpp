// Nearest-seed Voronoi assignment of the grain generator (reference
// grains.cpp:56-70), host C++, linked into the port's native library beside
// native/pdcorr_native.cpp (native.py builds both with g++).
//
// Seeds are lattice nodes, so many solid nodes lie at exactly the same
// distance from two seeds in exact arithmetic, and the rounding of the
// squared distance decides which grain they join. pdcorr_native.cpp's
// `d2 += dd * dd` rounds as its compiler chooses to contract and vectorize
// it, so the grains change with the host and the compiler. Here every step
// is one explicit fused multiply-add, d2 = fma(dd, dd, d2), which std::fma
// rounds correctly on every host (hardware or libm): 19,497 grain-boundary
// flags at config/params_3d.cfg, the count of the banked run in
// docs/runs/3d_1M. Ties between equal d2 go to the lower seed index.

#include <cmath>
#include <cstdint>

extern "C" void voronoi_assign_fma(const double* pos, int64_t n_pts, int dim,
                                   const double* seeds, int64_t n_seeds,
                                   int32_t* out) {
    for (int64_t i = 0; i < n_pts; ++i) {
        double best = 1e300;
        int32_t bg = 0;
        for (int64_t g = 0; g < n_seeds; ++g) {
            double d2 = 0.0;
            for (int d = 0; d < dim; ++d) {
                const double dd = pos[i * dim + d] - seeds[g * dim + d];
                d2 = std::fma(dd, dd, d2);
            }
            if (d2 < best) {
                best = d2;
                bg = static_cast<int32_t>(g);
            }
        }
        out[i] = bg;
    }
}
