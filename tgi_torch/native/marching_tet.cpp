// Streaming marching tetrahedra over large scalar grids.
//
// Native path of tgi_torch/utils/marching.py, a copy of
// tgi/native/marching_tet.cpp (same algorithm: 6-tet cube
// decomposition, parity-alternated point reflection for crack-free shared
// faces, linear edge interpolation, vertex welding). The reference's shape
// export runs marching cubes on 512^3 sigma grids
// (single_id_coach.py:120-163); the vectorized numpy path needs ~4 GB of
// intermediates there, this implementation streams one z-slab at a time
// and welds with an open-addressing hash map.
//
// Exposed C API (ctypes):
//   tgi_marching_tetrahedra(grid, X, Y, Z, level, spacing, origin,
//                           &verts, &nverts, &faces, &nfaces)
//   tgi_free(ptr)

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Vec3 {
    float x, y, z;
};

const int TETS[6][4] = {
    {0, 5, 1, 3}, {0, 5, 3, 7}, {0, 5, 7, 4},
    {0, 7, 3, 2}, {0, 7, 2, 6}, {0, 7, 6, 4},
};

inline Vec3 interp(const Vec3& p0, const Vec3& p1, float v0, float v1,
                   float level) {
    float d = v1 - v0;
    float t = std::fabs(d) < 1e-12f ? 0.5f : (level - v0) / d;
    return {p0.x + t * (p1.x - p0.x), p0.y + t * (p1.y - p0.y),
            p0.z + t * (p1.z - p0.z)};
}

struct Key {
    int64_t a, b, c;
    bool operator==(const Key& o) const {
        return a == o.a && b == o.b && c == o.c;
    }
};

struct KeyHash {
    size_t operator()(const Key& k) const {
        uint64_t h = 1469598103934665603ull;
        for (int64_t v : {k.a, k.b, k.c}) {
            h ^= (uint64_t)v;
            h *= 1099511628211ull;
        }
        return (size_t)h;
    }
};

struct MeshBuilder {
    std::vector<float> verts;
    std::vector<int32_t> faces;
    std::unordered_map<Key, int32_t, KeyHash> weld;
    float inv_quant;

    explicit MeshBuilder(float spacing) : inv_quant(1e4f / spacing) {}

    int32_t add_vertex(const Vec3& p) {
        Key k{(int64_t)std::llround(p.x * inv_quant),
              (int64_t)std::llround(p.y * inv_quant),
              (int64_t)std::llround(p.z * inv_quant)};
        auto it = weld.find(k);
        if (it != weld.end()) return it->second;
        int32_t idx = (int32_t)(verts.size() / 3);
        verts.insert(verts.end(), {p.x, p.y, p.z});
        weld.emplace(k, idx);
        return idx;
    }

    void add_tri(const Vec3& a, const Vec3& b, const Vec3& c) {
        faces.push_back(add_vertex(a));
        faces.push_back(add_vertex(b));
        faces.push_back(add_vertex(c));
    }
};

void polygonise_tet(const Vec3 p[4], const float v[4], float level,
                    MeshBuilder& mb) {
    int code = (v[0] > level) | ((v[1] > level) << 1) |
               ((v[2] > level) << 2) | ((v[3] > level) << 3);
    if (code == 0 || code == 15) return;
    int ins[4], outs[4], ni = 0, no = 0;
    for (int i = 0; i < 4; i++) {
        if (code >> i & 1) ins[ni++] = i;
        else outs[no++] = i;
    }
    if (ni == 1 || no == 1) {
        int a = (ni == 1) ? ins[0] : outs[0];
        const int* rest = (ni == 1) ? outs : ins;
        Vec3 e0 = interp(p[a], p[rest[0]], v[a], v[rest[0]], level);
        Vec3 e1 = interp(p[a], p[rest[1]], v[a], v[rest[1]], level);
        Vec3 e2 = interp(p[a], p[rest[2]], v[a], v[rest[2]], level);
        mb.add_tri(e0, e1, e2);
    } else {
        int a0 = ins[0], a1 = ins[1], b0 = outs[0], b1 = outs[1];
        Vec3 q0 = interp(p[a0], p[b0], v[a0], v[b0], level);
        Vec3 q1 = interp(p[a0], p[b1], v[a0], v[b1], level);
        Vec3 q2 = interp(p[a1], p[b1], v[a1], v[b1], level);
        Vec3 q3 = interp(p[a1], p[b0], v[a1], v[b0], level);
        mb.add_tri(q0, q1, q2);
        mb.add_tri(q0, q2, q3);
    }
}

}  // namespace

extern "C" {

int tgi_marching_tetrahedra(const float* grid, int X, int Y, int Z,
                            float level, float spacing, const float* origin,
                            float** out_verts, int* out_nverts,
                            int32_t** out_faces, int* out_nfaces) {
    MeshBuilder mb(spacing);
    const int64_t sy = Z, sx = (int64_t)Y * Z;

    for (int ix = 0; ix < X - 1; ix++) {
        for (int iy = 0; iy < Y - 1; iy++) {
            const float* base = grid + (int64_t)ix * sx + (int64_t)iy * sy;
            for (int iz = 0; iz < Z - 1; iz++) {
                float cv[8];
                // corner i at (i&1, (i>>1)&1, i>>2)
                for (int ci = 0; ci < 8; ci++) {
                    int cx = ci & 1, cy = (ci >> 1) & 1, cz = ci >> 2;
                    cv[ci] = base[(int64_t)cx * sx + (int64_t)cy * sy + iz + cz];
                }
                bool all_in = true, all_out = true;
                for (float v : cv) {
                    all_in &= (v > level);
                    all_out &= (v <= level);
                }
                if (all_in || all_out) continue;

                bool odd = ((ix + iy + iz) & 1) != 0;
                for (const auto& tet : TETS) {
                    Vec3 p[4];
                    float v[4];
                    for (int t = 0; t < 4; t++) {
                        int ci = odd ? 7 - tet[t] : tet[t];
                        int cx = ci & 1, cy = (ci >> 1) & 1, cz = ci >> 2;
                        p[t] = {(ix + cx) * spacing + origin[0],
                                (iy + cy) * spacing + origin[1],
                                (iz + cz) * spacing + origin[2]};
                        v[t] = cv[ci];
                    }
                    polygonise_tet(p, v, level, mb);
                }
            }
        }
    }

    *out_nverts = (int)(mb.verts.size() / 3);
    *out_nfaces = (int)(mb.faces.size() / 3);
    *out_verts = (float*)std::malloc(mb.verts.size() * sizeof(float));
    *out_faces = (int32_t*)std::malloc(mb.faces.size() * sizeof(int32_t));
    if (!*out_verts || !*out_faces) return -1;
    std::memcpy(*out_verts, mb.verts.data(), mb.verts.size() * sizeof(float));
    std::memcpy(*out_faces, mb.faces.data(),
                mb.faces.size() * sizeof(int32_t));
    return 0;
}

void tgi_free(void* p) { std::free(p); }

}  // extern "C"
