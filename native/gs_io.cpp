// Native IO/compute helpers for the Gaussian-splatting framework.
//
// The reference implementation does its data loading in C++
// (colmap_loader.cpp, tinyply) and its init-time kNN as an O(N^2) CPU loop
// (main.mm:18-56).  This library keeps the genuinely-native pieces native:
//   * COLMAP points3D.bin walking (variable-length track records defeat
//     numpy vectorization),
//   * mean k-nearest-neighbour distances via a uniform-grid index
//     (O(N) expected instead of the reference's O(N^2)).
//
// Exposed as a plain C ABI consumed through ctypes (io/native.py); every
// caller has a pure-Python fallback, so this is an accelerator, not a
// dependency.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct FileBuf {
    std::vector<unsigned char> data;
    bool ok = false;
};

FileBuf read_file(const char* path) {
    FileBuf buf;
    FILE* f = std::fopen(path, "rb");
    if (!f) return buf;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    if (size < 0) { std::fclose(f); return buf; }
    buf.data.resize(static_cast<size_t>(size));
    size_t got = size ? std::fread(buf.data.data(), 1, buf.data.size(), f) : 0;
    std::fclose(f);
    buf.ok = (got == buf.data.size());
    return buf;
}

template <typename T>
T read_le(const unsigned char* p) {
    T v;
    std::memcpy(&v, p, sizeof(T));
    return v;  // host is little-endian on every supported target
}

}  // namespace

extern "C" {

// Number of points in a COLMAP points3D.bin, or -1 on error.
long long gsio_count_points(const char* path) {
    FileBuf buf = read_file(path);
    if (!buf.ok || buf.data.size() < 8) return -1;
    return static_cast<long long>(read_le<uint64_t>(buf.data.data()));
}

// Parse points3D.bin into caller-allocated arrays:
//   positions [n,3] float32, colors [n,3] float32 in [0,1], errors [n].
// Returns the number of points parsed (== n on success).
long long gsio_load_points(const char* path, float* positions, float* colors,
                           float* errors, long long capacity) {
    FileBuf buf = read_file(path);
    if (!buf.ok || buf.data.size() < 8) return -1;
    const unsigned char* p = buf.data.data();
    const unsigned char* end = p + buf.data.size();
    uint64_t num = read_le<uint64_t>(p);
    p += 8;
    if (static_cast<long long>(num) > capacity) return -1;
    for (uint64_t i = 0; i < num; i++) {
        // id(8) xyz(3*8) rgb(3) error(8) track_len(8) track(track_len*8)
        if (p + 51 > end) return static_cast<long long>(i);
        positions[i * 3 + 0] = static_cast<float>(read_le<double>(p + 8));
        positions[i * 3 + 1] = static_cast<float>(read_le<double>(p + 16));
        positions[i * 3 + 2] = static_cast<float>(read_le<double>(p + 24));
        colors[i * 3 + 0] = p[32] / 255.0f;
        colors[i * 3 + 1] = p[33] / 255.0f;
        colors[i * 3 + 2] = p[34] / 255.0f;
        errors[i] = static_cast<float>(read_le<double>(p + 35));
        uint64_t track = read_le<uint64_t>(p + 43);
        p += 51 + track * 8;
    }
    return static_cast<long long>(num);
}

// Mean distance to the k nearest neighbours for every point, via a uniform
// grid sized so the expected occupancy is a few points per cell.  Exact: the
// search ring expands until the kth-best distance is certified.
int gsio_knn_mean_dist(const float* pts, long long n, int k, float* out) {
    if (n <= 0 || k <= 0) return -1;
    if (n == 1) { out[0] = 0.1f; return 0; }  // reference default (main.mm:55)
    const long long kk = std::min<long long>(k, n - 1);

    float lo[3] = {pts[0], pts[1], pts[2]};
    float hi[3] = {pts[0], pts[1], pts[2]};
    for (long long i = 0; i < n; i++) {
        for (int d = 0; d < 3; d++) {
            lo[d] = std::min(lo[d], pts[i * 3 + d]);
            hi[d] = std::max(hi[d], pts[i * 3 + d]);
        }
    }
    float span = 1e-6f;
    for (int d = 0; d < 3; d++) span = std::max(span, hi[d] - lo[d]);
    // ~4 points per cell on average
    int cells = std::max(1, (int)std::cbrt((double)n / 4.0));
    float cell = span / cells;
    int dims[3];
    for (int d = 0; d < 3; d++)
        dims[d] = std::max(1, (int)std::floor((hi[d] - lo[d]) / cell) + 1);
    const long long ncell = (long long)dims[0] * dims[1] * dims[2];

    auto cell_of = [&](long long i, int* c) {
        for (int d = 0; d < 3; d++) {
            int v = (int)((pts[i * 3 + d] - lo[d]) / cell);
            c[d] = std::min(std::max(v, 0), dims[d] - 1);
        }
    };
    auto cell_idx = [&](const int* c) {
        return ((long long)c[2] * dims[1] + c[1]) * dims[0] + c[0];
    };

    // counting sort into cell buckets
    std::vector<int> counts(ncell + 1, 0);
    std::vector<int> cidx(n);
    for (long long i = 0; i < n; i++) {
        int c[3];
        cell_of(i, c);
        cidx[i] = (int)cell_idx(c);
        counts[cidx[i] + 1]++;
    }
    for (long long i = 0; i < ncell; i++) counts[i + 1] += counts[i];
    std::vector<int> order(n);
    {
        std::vector<int> cursor(counts.begin(), counts.end() - 1);
        for (long long i = 0; i < n; i++) order[cursor[cidx[i]]++] = (int)i;
    }

    std::vector<float> best(kk);
    for (long long i = 0; i < n; i++) {
        long long found = 0;
        float worst = 1e30f;
        const float x = pts[i * 3], y = pts[i * 3 + 1], z = pts[i * 3 + 2];
        int c[3];
        cell_of(i, c);
        for (int ring = 0;; ring++) {
            // points in ring r are at distance >= (r-1)*cell from anywhere in
            // the query's cell; certified once that bound beats the kth best
            if (found >= kk && (float)(ring - 1) * cell >= std::sqrt(worst)) break;
            bool any_cell = false;
            int lo0 = std::max(c[0] - ring, 0), hi0 = std::min(c[0] + ring, dims[0] - 1);
            int lo1 = std::max(c[1] - ring, 0), hi1 = std::min(c[1] + ring, dims[1] - 1);
            int lo2 = std::max(c[2] - ring, 0), hi2 = std::min(c[2] + ring, dims[2] - 1);
            for (int cz = lo2; cz <= hi2; cz++)
                for (int cy = lo1; cy <= hi1; cy++)
                    for (int cx = lo0; cx <= hi0; cx++) {
                        // only the shell of this ring
                        if (ring > 0 && std::abs(cx - c[0]) != ring &&
                            std::abs(cy - c[1]) != ring && std::abs(cz - c[2]) != ring)
                            continue;
                        any_cell = true;
                        int cc[3] = {cx, cy, cz};
                        long long ci = cell_idx(cc);
                        for (int s = counts[ci]; s < counts[ci + 1]; s++) {
                            long long j = order[s];
                            if (j == i) continue;
                            float dx = pts[j * 3] - x, dy = pts[j * 3 + 1] - y,
                                  dz = pts[j * 3 + 2] - z;
                            float d2 = dx * dx + dy * dy + dz * dz;
                            if (found < kk) {
                                best[found++] = d2;
                                if (found == kk)
                                    worst = *std::max_element(best.begin(), best.end());
                            } else if (d2 < worst) {
                                *std::max_element(best.begin(), best.end()) = d2;
                                worst = *std::max_element(best.begin(), best.end());
                            }
                        }
                    }
            if (!any_cell && ring > dims[0] + dims[1] + dims[2]) break;  // safety
        }
        float sum = 0.0f;
        for (long long b = 0; b < found; b++) sum += std::sqrt(best[b]);
        out[i] = found ? sum / found : 0.1f;
    }
    return 0;
}

}  // extern "C"
