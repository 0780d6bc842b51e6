// Exact Earth Mover's Distance via the transportation simplex (MODI method).
//
// TPU-native replacement for the reference's dependency on OpenCV's cv::EMD
// (meta_tuning_sun_d/Models/models/emd_utils.py:65-76): a first-party C++
// solver used host-side for parity validation of the on-device Sinkhorn path.
// Cross-checked against cv2.EMD in tests (mirroring emd_utils.py:97-133).
//
// Problem: min sum c_ij x_ij  s.t.  sum_j x_ij = a_i, sum_i x_ij = b_j, x >= 0
// with sum(a) == sum(b) (balanced; the DeepEMD weights are normalized so).
//
// Build:  g++ -O2 -shared -fPIC -o libemd.so emd_solver.cpp
// C ABI:  emd_exact(cost, a, b, n1, n2, flow_out, cost_out) -> 0 on success.

#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Cell {
    int i, j;
};

// Spanning-tree node indexing: rows are [0, n1), cols are [n1, n1+n2).
class TransportSimplex {
  public:
    TransportSimplex(const double* cost, const double* a, const double* b,
                     int n1, int n2)
        : n1_(n1), n2_(n2), cost_(cost),
          flow_(static_cast<size_t>(n1) * n2, 0.0),
          is_basic_(static_cast<size_t>(n1) * n2, false) {
        a_.assign(a, a + n1);
        b_.assign(b, b + n2);
    }

    int solve() {
        northwest_corner();
        const int max_iters = 4 * n1_ * n2_ + 64;
        for (int iter = 0; iter < max_iters; ++iter) {
            compute_potentials();
            int ei = -1, ej = -1;
            double best = -1e-9;  // tolerance against cycling on ties
            for (int i = 0; i < n1_; ++i) {
                for (int j = 0; j < n2_; ++j) {
                    if (is_basic_[idx(i, j)]) continue;
                    double red = cost_[idx(i, j)] - u_[i] - v_[j];
                    if (red < best) {
                        best = red;
                        ei = i;
                        ej = j;
                    }
                }
            }
            if (ei < 0) return 0;  // optimal
            if (!pivot(ei, ej)) return 1;
        }
        return 2;  // iteration cap hit (should not happen on these sizes)
    }

    const double* flow() const { return flow_.data(); }

    double objective() const {
        double s = 0.0;
        for (int i = 0; i < n1_; ++i)
            for (int j = 0; j < n2_; ++j) s += cost_[idx(i, j)] * flow_[idx(i, j)];
        return s;
    }

  private:
    size_t idx(int i, int j) const { return static_cast<size_t>(i) * n2_ + j; }

    void add_basic(int i, int j) {
        if (!is_basic_[idx(i, j)]) {
            is_basic_[idx(i, j)] = true;
            basis_.push_back({i, j});
        }
    }

    void remove_basic(int i, int j) {
        is_basic_[idx(i, j)] = false;
        for (size_t k = 0; k < basis_.size(); ++k) {
            if (basis_[k].i == i && basis_[k].j == j) {
                basis_[k] = basis_.back();
                basis_.pop_back();
                return;
            }
        }
    }

    void northwest_corner() {
        std::vector<double> a(a_), b(b_);
        int i = 0, j = 0;
        while (i < n1_ && j < n2_) {
            double f = a[i] < b[j] ? a[i] : b[j];
            flow_[idx(i, j)] = f;
            add_basic(i, j);
            a[i] -= f;
            b[j] -= f;
            // advance; on ties advance only one side to keep n1+n2-1 basics
            if (a[i] <= 1e-15 && i + 1 < n1_) {
                ++i;
            } else if (b[j] <= 1e-15 && j + 1 < n2_) {
                ++j;
            } else if (a[i] <= 1e-15 && b[j] <= 1e-15) {
                break;  // both exhausted at the last cell
            } else if (a[i] <= 1e-15) {
                ++i;
            } else {
                ++j;
            }
        }
    }

    // Solve u_i + v_j = c_ij over the basis tree (BFS from row 0, u_0 = 0).
    void compute_potentials() {
        u_.assign(n1_, std::numeric_limits<double>::quiet_NaN());
        v_.assign(n2_, std::numeric_limits<double>::quiet_NaN());
        u_[0] = 0.0;
        bool progress = true;
        while (progress) {
            progress = false;
            for (const Cell& c : basis_) {
                bool un = u_[c.i] == u_[c.i];  // not NaN
                bool vn = v_[c.j] == v_[c.j];
                if (un && !vn) {
                    v_[c.j] = cost_[idx(c.i, c.j)] - u_[c.i];
                    progress = true;
                } else if (!un && vn) {
                    u_[c.i] = cost_[idx(c.i, c.j)] - v_[c.j];
                    progress = true;
                }
            }
        }
        // disconnected components (degenerate trees): pin them at 0
        for (int i = 0; i < n1_; ++i)
            if (u_[i] != u_[i]) u_[i] = 0.0;
        for (int j = 0; j < n2_; ++j)
            if (v_[j] != v_[j]) v_[j] = 0.0;
    }

    // Find the unique alternating cycle created by adding (ei, ej): a path in
    // the basis tree from row ei to col ej. BFS over basis adjacency.
    bool find_path(int ei, int ej, std::vector<Cell>& path) {
        int n = n1_ + n2_;
        std::vector<int> parent(n, -2);
        std::vector<Cell> via(n, {-1, -1});
        std::vector<int> queue;
        queue.push_back(ei);  // row-node ei
        parent[ei] = -1;
        for (size_t qh = 0; qh < queue.size(); ++qh) {
            int node = queue[qh];
            for (const Cell& c : basis_) {
                int from, to;
                if (node < n1_ && c.i == node) {
                    from = node;
                    to = n1_ + c.j;
                } else if (node >= n1_ && c.j == node - n1_) {
                    from = node;
                    to = c.i;
                } else {
                    continue;
                }
                if (parent[to] != -2) continue;
                parent[to] = from;
                via[to] = c;
                if (to == n1_ + ej) {  // reached the column of the new cell
                    // reconstruct: path of basis cells from ei ... to col ej
                    path.clear();
                    int cur = to;
                    while (parent[cur] != -1) {
                        path.push_back(via[cur]);
                        cur = parent[cur];
                    }
                    return true;
                }
                queue.push_back(to);
            }
        }
        return false;
    }

    bool pivot(int ei, int ej) {
        std::vector<Cell> path;
        if (!find_path(ei, ej, path)) return false;
        // cycle = (ei, ej) [+] then alternating [-, +, -, ...] along path.
        // path is ordered col-side-first (from reconstruction); determine sign
        // by walking from (ei, ej): the path edges alternate starting with -.
        // Reorder path from the ei end:
        std::vector<Cell> ordered(path.rbegin(), path.rend());
        double theta = std::numeric_limits<double>::infinity();
        int leave_i = -1, leave_j = -1;
        for (size_t k = 0; k < ordered.size(); ++k) {
            if (k % 2 == 0) {  // minus edge
                double f = flow_[idx(ordered[k].i, ordered[k].j)];
                if (f < theta) {
                    theta = f;
                    leave_i = ordered[k].i;
                    leave_j = ordered[k].j;
                }
            }
        }
        flow_[idx(ei, ej)] += theta;
        for (size_t k = 0; k < ordered.size(); ++k) {
            double sgn = (k % 2 == 0) ? -1.0 : 1.0;
            flow_[idx(ordered[k].i, ordered[k].j)] += sgn * theta;
        }
        add_basic(ei, ej);
        remove_basic(leave_i, leave_j);
        return true;
    }

    int n1_, n2_;
    const double* cost_;
    std::vector<double> a_, b_, flow_, u_, v_;
    std::vector<bool> is_basic_;
    std::vector<Cell> basis_;
};

}  // namespace

extern "C" {

// Returns 0 on success. flow_out must hold n1*n2 doubles.
int emd_exact(const double* cost, const double* a, const double* b, int n1,
              int n2, double* flow_out, double* cost_out) {
    TransportSimplex ts(cost, a, b, n1, n2);
    int rc = ts.solve();
    std::memcpy(flow_out, ts.flow(), sizeof(double) * n1 * n2);
    if (cost_out) *cost_out = ts.objective();
    return rc;
}

// Batched variant.
int emd_exact_batch(const double* cost, const double* a, const double* b,
                    int nbatch, int n1, int n2, double* flow_out,
                    double* cost_out) {
    int rc_all = 0;
    for (int k = 0; k < nbatch; ++k) {
        int rc = emd_exact(cost + static_cast<size_t>(k) * n1 * n2,
                           a + static_cast<size_t>(k) * n1,
                           b + static_cast<size_t>(k) * n2, n1, n2,
                           flow_out + static_cast<size_t>(k) * n1 * n2,
                           cost_out ? cost_out + k : nullptr);
        if (rc != 0) rc_all = rc;
    }
    return rc_all;
}
}
