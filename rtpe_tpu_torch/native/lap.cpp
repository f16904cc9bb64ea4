// Square linear assignment problem solver (Hungarian algorithm with
// potentials, O(n^3) successive-shortest-path formulation).
//
// Native replacement for the reference's pure-Python `munkres` dependency
// (used by AE grouping, reference rtpe/third_party/group.py:14,19-23).
// Matrices here are tiny (<= max_num_people + joints per step, ~30x30),
// but the solve sits in the per-image decode loop, so a C++ solve keeps
// the host side negligible next to the device compute.

#include <cfloat>
#include <cstdlib>
#include <vector>

extern "C" {

// cost: n*n row-major. rows: out, filled 0..n-1. cols: out, cols[r] is the
// column assigned to row r. Returns 0 on success.
int lap_solve(const double* cost, int n, int* rows, int* cols) {
    if (n <= 0) return 1;
    // potentials over rows (u) and columns (v); p[j] = row matched to col j
    std::vector<double> u(n + 1, 0.0), v(n + 1, 0.0);
    std::vector<int> p(n + 1, 0), way(n + 1, 0);
    for (int i = 1; i <= n; ++i) {
        p[0] = i;
        int j0 = 0;
        std::vector<double> minv(n + 1, DBL_MAX);
        std::vector<char> used(n + 1, 0);
        do {
            used[j0] = 1;
            int i0 = p[j0], j1 = -1;
            double delta = DBL_MAX;
            for (int j = 1; j <= n; ++j) {
                if (used[j]) continue;
                double cur = cost[(i0 - 1) * n + (j - 1)] - u[i0] - v[j];
                if (cur < minv[j]) { minv[j] = cur; way[j] = j0; }
                if (minv[j] < delta) { delta = minv[j]; j1 = j; }
            }
            if (j1 < 0) return 2;  // numerical breakdown
            for (int j = 0; j <= n; ++j) {
                if (used[j]) { u[p[j]] += delta; v[j] -= delta; }
                else         { minv[j] -= delta; }
            }
            j0 = j1;
        } while (p[j0] != 0);
        do {
            int j1 = way[j0];
            p[j0] = p[j1];
            j0 = j1;
        } while (j0);
    }
    for (int j = 1; j <= n; ++j) {
        if (p[j] >= 1 && p[j] <= n) {
            rows[p[j] - 1] = p[j] - 1;
            cols[p[j] - 1] = j - 1;
        }
    }
    return 0;
}

}  // extern "C"
