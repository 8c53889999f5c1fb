// Native mesh-runtime kernels for iifea.
//
// Host-side replacements for the heavy O(n) preprocessing the reference
// delegates to DOLFIN's C++ mesh runtime (SURVEY.md §2.3 N1): unique-facet
// extraction with cell adjacency, P2 edge numbering, and the extraction-
// operator CSV parser (readExOp's file loop, common.py:645-665). Exposed via
// a plain C ABI for ctypes (no pybind11 in this environment).
//
// Build: make -C csrc  (produces libmeshops.so)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct KeyHash {
    size_t operator()(const std::vector<int32_t>& k) const {
        size_t h = 1469598103934665603ull;
        for (int32_t v : k) {
            h ^= static_cast<size_t>(v) + 0x9e3779b97f4a7c15ull;
            h *= 1099511628211ull;
        }
        return h;
    }
};

struct FacetTable {
    std::vector<int32_t> facets;       // n_facets * dim vertex ids (sorted)
    std::vector<int32_t> facet_cells;  // n_facets * 2
    std::vector<int32_t> facet_local;  // n_facets * 2
    int dim = 0;
};

// local facet -> vertex indices of the reference cell, facet i opposite
// vertex i (must match TRI_FACETS / TET_FACETS in reference_elements.py)
const int TRI_F[3][2] = {{1, 2}, {2, 0}, {0, 1}};
const int TET_F[4][3] = {{1, 2, 3}, {0, 3, 2}, {0, 1, 3}, {0, 2, 1}};

}  // namespace

extern "C" {

// Build the unique-facet table. cells: (n_cells, dim+1) int32. Returns an
// opaque handle; query sizes with facets_count, copy out with facets_fill.
void* mesh_build_facets(const int32_t* cells, int64_t n_cells, int dim) {
    auto* t = new FacetTable();
    t->dim = dim;
    const int nlf = dim + 1;      // facets per cell
    const int nfv = dim;          // vertices per facet
    std::unordered_map<std::vector<int32_t>, int64_t, KeyHash> seen;
    seen.reserve(static_cast<size_t>(n_cells) * nlf / 2 + 16);
    std::vector<int32_t> key(nfv);

    for (int64_t c = 0; c < n_cells; ++c) {
        const int32_t* cv = cells + c * (dim + 1);
        for (int lf = 0; lf < nlf; ++lf) {
            for (int j = 0; j < nfv; ++j) {
                key[j] = cv[dim == 2 ? TRI_F[lf][j] : TET_F[lf][j]];
            }
            // insertion-sort the tiny key
            for (int a = 1; a < nfv; ++a) {
                int32_t v = key[a];
                int b = a - 1;
                while (b >= 0 && key[b] > v) { key[b + 1] = key[b]; --b; }
                key[b + 1] = v;
            }
            auto it = seen.find(key);
            if (it == seen.end()) {
                int64_t id = static_cast<int64_t>(t->facets.size()) / nfv;
                seen.emplace(key, id);
                t->facets.insert(t->facets.end(), key.begin(), key.end());
                t->facet_cells.push_back(static_cast<int32_t>(c));
                t->facet_cells.push_back(-1);
                t->facet_local.push_back(lf);
                t->facet_local.push_back(-1);
            } else {
                int64_t id = it->second;
                t->facet_cells[2 * id + 1] = static_cast<int32_t>(c);
                t->facet_local[2 * id + 1] = lf;
            }
        }
    }
    return t;
}

int64_t facets_count(void* handle) {
    auto* t = static_cast<FacetTable*>(handle);
    return static_cast<int64_t>(t->facet_cells.size()) / 2;
}

void facets_fill(void* handle, int32_t* facets, int32_t* facet_cells,
                 int32_t* facet_local) {
    auto* t = static_cast<FacetTable*>(handle);
    std::memcpy(facets, t->facets.data(), t->facets.size() * sizeof(int32_t));
    std::memcpy(facet_cells, t->facet_cells.data(),
                t->facet_cells.size() * sizeof(int32_t));
    std::memcpy(facet_local, t->facet_local.data(),
                t->facet_local.size() * sizeof(int32_t));
}

void facets_free(void* handle) { delete static_cast<FacetTable*>(handle); }

// Number unique edges of a simplex mesh (P2 dof numbering). edges_per_cell
// pairs are given by the caller (Exodus midside order). Writes per-cell edge
// ids into edge_ids (n_cells * n_edges) offset by n_verts; returns the number
// of unique edges.
int64_t mesh_number_edges(const int32_t* cells, int64_t n_cells, int nv,
                          const int32_t* edge_pairs, int n_edges,
                          int32_t n_verts, int32_t* edge_ids) {
    std::unordered_map<uint64_t, int32_t> seen;
    seen.reserve(static_cast<size_t>(n_cells) * n_edges / 2 + 16);
    int32_t next = 0;
    for (int64_t c = 0; c < n_cells; ++c) {
        const int32_t* cv = cells + c * nv;
        for (int e = 0; e < n_edges; ++e) {
            int32_t a = cv[edge_pairs[2 * e]];
            int32_t b = cv[edge_pairs[2 * e + 1]];
            if (a > b) { int32_t tmp = a; a = b; b = tmp; }
            uint64_t key = (static_cast<uint64_t>(a) << 32) |
                           static_cast<uint32_t>(b);
            auto it = seen.find(key);
            int32_t id;
            if (it == seen.end()) {
                id = next++;
                seen.emplace(key, id);
            } else {
                id = it->second;
            }
            edge_ids[c * n_edges + e] = n_verts + id;
        }
    }
    return next;
}

// Count whitespace-delimited numeric rows in an extraction CSV.
int64_t exop_count(const char* path) {
    FILE* f = std::fopen(path, "r");
    if (!f) return -1;
    int64_t n = 0;
    double a, b, c;
    while (std::fscanf(f, "%lf %lf %lf", &a, &b, &c) == 3) ++n;
    std::fclose(f);
    return n;
}

// Parse (fg_id, bg_id, weight) triples; arrays must hold n entries.
int64_t exop_parse(const char* path, int64_t n, int64_t* fg, int64_t* bg,
                   double* w) {
    FILE* f = std::fopen(path, "r");
    if (!f) return -1;
    int64_t i = 0;
    double a, b, c;
    while (i < n && std::fscanf(f, "%lf %lf %lf", &a, &b, &c) == 3) {
        fg[i] = static_cast<int64_t>(a);
        bg[i] = static_cast<int64_t>(b);
        w[i] = c;
        ++i;
    }
    std::fclose(f);
    return i;
}

}  // extern "C"
