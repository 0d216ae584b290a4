// pt_runtime — native host runtime for the path tracer.
//
// The reference implements its host-side runtime (scene parsing, data
// marshalling, acceleration-structure handling) in C++ (src/main_cli.cpp
// scene loop, src/*_cu_helper.cpp, include/object.cpp AABB grouping, and the
// vendored-but-unused tiny_obj_loader.h).  This library is the
// framework's native equivalent: one shared object exposing a C ABI consumed
// from Python via ctypes (runtime/native.py), covering
//   1. the E/V/F/R/M/S/T/G/L text-scene grammar (token-tolerant, matching
//      the reference's `while(input >> t)` stray-token behavior),
//   2. a tinyobj-compatible OBJ/MTL subset,
//   3. a median-split BVH/cluster builder that reorders triangles into
//      spatially coherent leaves (data for a BVH traversal).
//
// Build: make -C csrc   (produces build/libpt_runtime.so)

#include <cctype>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <fstream>
#include <map>
#include <numeric>
#include <sstream>
#include <string>
#include <vector>

namespace {

struct Mtl {
    float r = 0, g = 0, b = 0, rough = 0, metal = 0, eta = 0;
    // legacy Phong tail (reference Material_Old, object.h:17-25): only Ks and
    // refract are live on the device — inside check_visibility's RGB shadow
    // transmittance (geometric.cuh:293-325).  The reference never populates
    // them (to_cmtl_old is dead code, SURVEY.md quirk 12); the extension 'K'
    // record activates the machinery.
    float ks_r = 0, ks_g = 0, ks_b = 0, refract = 0;
};

struct Scene {
    // camera
    float eye[3] = {0, 0, 0}, look[3] = {0, 0, 0}, up[3] = {0, 1, 0};
    float fov = 50.0f;
    int width = 0, height = 0;
    // geometry: spheres 10 floats (c3, r, mtl6); triangles 15 (v9, mtl6)
    std::vector<float> spheres;
    std::vector<int> sphere_groups;
    std::vector<float> triangles;
    std::vector<int> tri_groups;
    // lights: 12 floats (pos3, dir3, illum3, cutoff_rad, is_parallel, ball_r)
    std::vector<float> lights;
    // legacy shadow-transmittance materials, 4 floats per object (ks3,
    // refract); all-zero unless the scene uses the 'K' extension record
    std::vector<float> sphere_legacy;
    std::vector<float> tri_legacy;
    // textures (OBJ vt/map_Kd; empty for text scenes): per-triangle vertex
    // UVs (6 floats), per-triangle texture id (-1 = untextured, else index
    // into tex_paths), and the referenced image paths in first-use order.
    // Decoding stays on the Python side (runtime/native.py) — the id is
    // remapped there when a decode fails, matching obj_loader.tex_of.
    std::vector<float> tri_uv;
    std::vector<int> tri_tex;
    std::vector<std::string> tex_paths;
};

constexpr double kPi = 3.14159265358979323846;

// ---------------------------------------------------------------------------
// text-scene parser (grammar of src/main_cli.cpp:99-141)
// ---------------------------------------------------------------------------

bool parse_scene_text(const std::string& text, Scene* out) {
    // tokenize with //-comments stripped per line
    std::vector<std::string> toks;
    std::istringstream lines(text);
    std::string line;
    while (std::getline(lines, line)) {
        auto cut = line.find("//");
        if (cut != std::string::npos) line = line.substr(0, cut);
        std::istringstream ls(line);
        std::string t;
        while (ls >> t) toks.push_back(t);
    }

    Mtl mtl;
    int group = 0;
    size_t i = 0;
    auto want = [&](size_t k) { return i + k <= toks.size(); };
    auto num = [&](size_t j) { return std::strtof(toks[i + j].c_str(), nullptr); };

    while (i < toks.size()) {
        const std::string& t = toks[i++];
        if (t.size() != 1) continue;  // stray-token tolerance (quirk 9)
        switch (t[0]) {
            case 'E':
                if (!want(3)) return true;
                out->eye[0] = num(0); out->eye[1] = num(1); out->eye[2] = num(2);
                i += 3; break;
            case 'V':
                if (!want(6)) return true;
                for (int k = 0; k < 3; ++k) out->look[k] = num(k);
                for (int k = 0; k < 3; ++k) out->up[k] = num(3 + k);
                i += 6; break;
            case 'F':
                if (!want(1)) return true;
                out->fov = num(0); i += 1; break;
            case 'R':
                if (!want(2)) return true;
                out->width = (int)num(0); out->height = (int)num(1);
                i += 2; break;
            case 'M':
                // a new material definition starts with a clean legacy tail
                if (!want(6)) return true;
                mtl = {num(0), num(1), num(2), num(3), num(4), num(5)};
                i += 6; break;
            case 'K':
                // extension: legacy Ks + refract for the current material
                // (activates the RGB shadow-transmittance machinery the
                // reference carries but never feeds, geometric.cuh:293-325;
                // the reference parser skips unknown tags, so 'K' files
                // remain loadable there)
                if (!want(4)) return true;
                mtl.ks_r = num(0); mtl.ks_g = num(1); mtl.ks_b = num(2);
                mtl.refract = num(3);
                i += 4; break;
            case 'S': {
                if (!want(4)) return true;
                float row[10] = {num(0), num(1), num(2), num(3),
                                 mtl.r, mtl.g, mtl.b, mtl.rough, mtl.metal,
                                 mtl.eta};
                out->spheres.insert(out->spheres.end(), row, row + 10);
                float leg[4] = {mtl.ks_r, mtl.ks_g, mtl.ks_b, mtl.refract};
                out->sphere_legacy.insert(out->sphere_legacy.end(), leg,
                                          leg + 4);
                out->sphere_groups.push_back(group);
                i += 4; break;
            }
            case 'T': {
                if (!want(9)) return true;
                float row[15];
                for (int k = 0; k < 9; ++k) row[k] = num(k);
                row[9] = mtl.r; row[10] = mtl.g; row[11] = mtl.b;
                row[12] = mtl.rough; row[13] = mtl.metal; row[14] = mtl.eta;
                out->triangles.insert(out->triangles.end(), row, row + 15);
                float leg[4] = {mtl.ks_r, mtl.ks_g, mtl.ks_b, mtl.refract};
                out->tri_legacy.insert(out->tri_legacy.end(), leg, leg + 4);
                out->tri_groups.push_back(group);
                i += 9; break;
            }
            case 'G':
                if (!want(1)) return true;
                group = (int)num(0); i += 1; break;
            case 'L': {
                if (!want(12)) return true;
                float row[12];
                for (int k = 0; k < 12; ++k) row[k] = num(k);
                row[9] = (float)(row[9] * kPi / 180.0);  // deg -> rad
                out->lights.insert(out->lights.end(), row, row + 12);
                i += 12; break;
            }
            default: break;  // unknown single char: skip
        }
    }
    return true;
}

// ---------------------------------------------------------------------------
// OBJ/MTL parser (subset matching scene/obj_loader.py)
// ---------------------------------------------------------------------------

struct MtlDef {
    float kd[3] = {0.8f, 0.8f, 0.8f};
    float ns = 10.0f, ni = 0.0f, d = 1.0f;
    int illum = 2;
    float pm = -1.0f, pr = -1.0f;  // (native default light matches Python)
    std::string map_kd;            // diffuse texture filename (MTL-relative)

    Mtl resolve() const {
        Mtl m;
        float rough = pr >= 0 ? pr : std::sqrt(2.0f / (ns + 2.0f));
        float metal;
        if (pm >= 0) metal = pm;
        else if (illum == 3 || illum == 5) { metal = 1.0f; rough = std::min(rough, 0.05f); }
        else metal = 0.0f;
        bool dielectric = d < 1.0f || illum == 4 || illum == 6 || illum == 7
            || illum == 9;
        m.r = kd[0]; m.g = kd[1]; m.b = kd[2];
        m.rough = rough; m.metal = metal;
        m.eta = dielectric ? ni : 0.0f;
        return m;
    }
};

std::string dir_of(const std::string& path) {
    auto cut = path.find_last_of("/\\");
    return cut == std::string::npos ? std::string(".") : path.substr(0, cut);
}

void parse_mtl_file(const std::string& path, std::map<std::string, MtlDef>* out) {
    std::ifstream f(path);
    if (!f) return;
    std::string line;
    MtlDef* cur = nullptr;
    while (std::getline(f, line)) {
        auto cut = line.find('#');
        if (cut != std::string::npos) line = line.substr(0, cut);
        std::istringstream ls(line);
        std::string key;
        if (!(ls >> key)) continue;
        for (auto& c : key) c = (char)std::tolower((unsigned char)c);
        if (key == "newmtl") {
            std::string name; ls >> name;
            cur = &(*out)[name];
        } else if (!cur) {
            continue;
        } else if (key == "kd") {
            ls >> cur->kd[0] >> cur->kd[1] >> cur->kd[2];
        } else if (key == "ns") { ls >> cur->ns;
        } else if (key == "ni") { ls >> cur->ni;
        } else if (key == "d") { ls >> cur->d;
        } else if (key == "tr") { float tr; if (ls >> tr) cur->d = 1.0f - tr;
        } else if (key == "illum") { float v; if (ls >> v) cur->illum = (int)v;
        } else if (key == "pm") { ls >> cur->pm;
        } else if (key == "pr") { ls >> cur->pr;
        } else if (key == "map_kd") {
            // options (-o, -s ...) precede the filename: keep the LAST
            // token, matching obj_loader._parse_mtl's tok[-1]
            std::string t2, last;
            while (ls >> t2) last = t2;
            if (!last.empty()) cur->map_kd = last;
        }
    }
}

bool parse_obj_file(const std::string& path, Scene* out) {
    std::ifstream f(path);
    if (!f) return false;
    std::vector<float> verts;  // xyz triples
    std::vector<float> uvs;    // uv pairs (vt records)
    std::map<std::string, MtlDef> mtls;
    std::map<std::string, int> tex_ids;  // joined path -> tex_paths index
    Mtl cur{0.8f, 0.8f, 0.8f, 0.5f, 0.0f, 0.0f};
    int cur_tex = -1;
    int group = 0, next_group = 0;
    std::string line;

    auto vidx = [&](const std::string& tok) -> long {
        long i = std::strtol(tok.c_str(), nullptr, 10);
        long n = (long)verts.size() / 3;
        return i > 0 ? i - 1 : n + i;
    };
    // vt index of a face token, or -1 when absent (v or v//vn forms) —
    // obj_loader.tidx
    auto tuvidx = [&](const std::string& tok) -> long {
        auto s1 = tok.find('/');
        if (s1 == std::string::npos) return -1;
        auto rest = tok.substr(s1 + 1);
        auto s2 = rest.find('/');
        std::string t2 = s2 == std::string::npos ? rest : rest.substr(0, s2);
        if (t2.empty()) return -1;
        long i = std::strtol(t2.c_str(), nullptr, 10);
        long n = (long)uvs.size() / 2;
        return i > 0 ? i - 1 : n + i;
    };

    while (std::getline(f, line)) {
        auto cut = line.find('#');
        if (cut != std::string::npos) line = line.substr(0, cut);
        std::istringstream ls(line);
        std::string key;
        if (!(ls >> key)) continue;
        if (key == "v") {
            float x, y, z;
            if (ls >> x >> y >> z) { verts.push_back(x); verts.push_back(y); verts.push_back(z); }
        } else if (key == "vt") {
            float u, v = 0.0f;
            if (ls >> u) { ls >> v; uvs.push_back(u); uvs.push_back(v); }
        } else if (key == "mtllib") {
            std::string name; ls >> name;
            parse_mtl_file(dir_of(path) + "/" + name, &mtls);
        } else if (key == "usemtl") {
            std::string name; ls >> name;
            auto it = mtls.find(name);
            if (it != mtls.end()) {
                cur = it->second.resolve();
                cur_tex = -1;
                if (!it->second.map_kd.empty()) {
                    // dedup by joined path in first-use order (the Python
                    // side normpaths + decodes and remaps failed ids to -1)
                    std::string p = dir_of(path) + "/" + it->second.map_kd;
                    auto t = tex_ids.find(p);
                    if (t == tex_ids.end()) {
                        cur_tex = (int)out->tex_paths.size();
                        tex_ids[p] = cur_tex;
                        out->tex_paths.push_back(p);
                    } else {
                        cur_tex = t->second;
                    }
                }
            }
        } else if (key == "o" || key == "g") {
            group = ++next_group;
        } else if (key == "f") {
            std::vector<long> idx, uvi;
            std::string tok;
            while (ls >> tok) { idx.push_back(vidx(tok)); uvi.push_back(tuvidx(tok)); }
            for (size_t k = 1; k + 1 < idx.size(); ++k) {
                long a = idx[0], b = idx[k], c = idx[k + 1];
                long n = (long)verts.size() / 3;
                if (a < 0 || b < 0 || c < 0 || a >= n || b >= n || c >= n)
                    continue;
                float row[15] = {
                    verts[3 * a], verts[3 * a + 1], verts[3 * a + 2],
                    verts[3 * b], verts[3 * b + 1], verts[3 * b + 2],
                    verts[3 * c], verts[3 * c + 1], verts[3 * c + 2],
                    cur.r, cur.g, cur.b, cur.rough, cur.metal, cur.eta};
                out->triangles.insert(out->triangles.end(), row, row + 15);
                out->tri_groups.push_back(group);
                // UVs: all three corners must be in range at FACE time,
                // else zeros + untextured (obj_loader's in_range rule)
                long ua = uvi[0], ub = uvi[k], uc = uvi[k + 1];
                long nu = (long)uvs.size() / 2;
                bool in_range = ua >= 0 && ub >= 0 && uc >= 0
                    && ua < nu && ub < nu && uc < nu;
                if (in_range) {
                    float uvrow[6] = {uvs[2 * ua], uvs[2 * ua + 1],
                                      uvs[2 * ub], uvs[2 * ub + 1],
                                      uvs[2 * uc], uvs[2 * uc + 1]};
                    out->tri_uv.insert(out->tri_uv.end(), uvrow, uvrow + 6);
                } else {
                    out->tri_uv.insert(out->tri_uv.end(), {0, 0, 0, 0, 0, 0});
                }
                out->tri_tex.push_back(in_range ? cur_tex : -1);
            }
        }
    }
    return true;
}

// ---------------------------------------------------------------------------
// median-split cluster builder (the BVH the reference never built on GPU)
// ---------------------------------------------------------------------------

struct BuildCtx {
    const float* tris;  // 9 floats per tri (v0 v1 v2)
    std::vector<float> cx, cy, cz;  // centroids
    std::vector<int> order;
    std::vector<float> aabbs;   // 6 per cluster
    std::vector<int> ranges;    // 2 per cluster (start, count)
    int leaf_size;
};

void build_rec(BuildCtx* ctx, int lo, int hi) {
    if (hi - lo <= ctx->leaf_size) {
        float mn[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
        float mx[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
        for (int k = lo; k < hi; ++k) {
            const float* t = ctx->tris + 9 * ctx->order[k];
            for (int v = 0; v < 3; ++v)
                for (int a = 0; a < 3; ++a) {
                    mn[a] = std::min(mn[a], t[3 * v + a]);
                    mx[a] = std::max(mx[a], t[3 * v + a]);
                }
        }
        ctx->aabbs.insert(ctx->aabbs.end(), {mn[0], mn[1], mn[2],
                                             mx[0], mx[1], mx[2]});
        ctx->ranges.push_back(lo);
        ctx->ranges.push_back(hi - lo);
        return;
    }
    // split on the widest centroid axis at the median
    float mn[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
    float mx[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    const std::vector<float>* cs[3] = {&ctx->cx, &ctx->cy, &ctx->cz};
    for (int k = lo; k < hi; ++k) {
        int t = ctx->order[k];
        for (int a = 0; a < 3; ++a) {
            float c = (*cs[a])[t];
            mn[a] = std::min(mn[a], c);
            mx[a] = std::max(mx[a], c);
        }
    }
    int axis = 0;
    float best = mx[0] - mn[0];
    for (int a = 1; a < 3; ++a)
        if (mx[a] - mn[a] > best) { best = mx[a] - mn[a]; axis = a; }
    int mid = (lo + hi) / 2;
    std::nth_element(ctx->order.begin() + lo, ctx->order.begin() + mid,
                     ctx->order.begin() + hi,
                     [&](int a, int b) { return (*cs[axis])[a] < (*cs[axis])[b]; });
    build_rec(ctx, lo, mid);
    build_rec(ctx, mid, hi);
}

}  // namespace

extern "C" {

void* pt_parse_scene_file(const char* path) {
    std::ifstream f(path);
    if (!f) return nullptr;
    std::stringstream ss;
    ss << f.rdbuf();
    auto* s = new Scene();
    if (!parse_scene_text(ss.str(), s)) { delete s; return nullptr; }
    return s;
}

void* pt_parse_obj_file(const char* path) {
    auto* s = new Scene();
    if (!parse_obj_file(path, s)) { delete s; return nullptr; }
    return s;
}

void pt_scene_free(void* h) { delete (Scene*)h; }

int pt_num_spheres(void* h) { return (int)((Scene*)h)->spheres.size() / 10; }
int pt_num_triangles(void* h) { return (int)((Scene*)h)->triangles.size() / 15; }
int pt_num_lights(void* h) { return (int)((Scene*)h)->lights.size() / 12; }

void pt_get_spheres(void* h, float* out) {
    auto& v = ((Scene*)h)->spheres;
    std::memcpy(out, v.data(), v.size() * sizeof(float));
}
void pt_get_triangles(void* h, float* out) {
    auto& v = ((Scene*)h)->triangles;
    std::memcpy(out, v.data(), v.size() * sizeof(float));
}
void pt_get_lights(void* h, float* out) {
    auto& v = ((Scene*)h)->lights;
    std::memcpy(out, v.data(), v.size() * sizeof(float));
}
// Legacy shadow-transmittance materials (ks3 + refract per object); rows the
// parser did not populate (e.g. OBJ scenes) come back zero — the same
// zero-initialized state the reference's device mtl_old fields have
// (SURVEY.md quirk 12).
void pt_get_legacy(void* h, float* sph_out, float* tri_out) {
    auto* s = (Scene*)h;
    size_t ns = s->spheres.size() / 10, nt = s->triangles.size() / 15;
    std::memset(sph_out, 0, ns * 4 * sizeof(float));
    std::memset(tri_out, 0, nt * 4 * sizeof(float));
    if (!s->sphere_legacy.empty())
        std::memcpy(sph_out, s->sphere_legacy.data(),
                    std::min(s->sphere_legacy.size(), ns * 4) * sizeof(float));
    if (!s->tri_legacy.empty())
        std::memcpy(tri_out, s->tri_legacy.data(),
                    std::min(s->tri_legacy.size(), nt * 4) * sizeof(float));
}

// Textures (OBJ vt/map_Kd).  tri_uv is zero-filled when the parse carried
// no vt records (text scenes); tri_tex indexes the path list returned by
// pt_get_texture_path (decode + failed-id remap happen on the Python side).
void pt_get_tri_uv(void* h, float* out) {
    auto* s = (Scene*)h;
    size_t nt = s->triangles.size() / 15;
    std::memset(out, 0, nt * 6 * sizeof(float));
    if (!s->tri_uv.empty())
        std::memcpy(out, s->tri_uv.data(),
                    std::min(s->tri_uv.size(), nt * 6) * sizeof(float));
}
void pt_get_tri_tex(void* h, int* out) {
    auto* s = (Scene*)h;
    size_t nt = s->triangles.size() / 15;
    for (size_t i = 0; i < nt; ++i)
        out[i] = i < s->tri_tex.size() ? s->tri_tex[i] : -1;
}
int pt_num_textures(void* h) { return (int)((Scene*)h)->tex_paths.size(); }
// Copies path i (NUL-terminated) into buf; returns 0, or the required
// capacity when buf is too small, or -1 on a bad index.
int pt_get_texture_path(void* h, int i, char* buf, int cap) {
    auto* s = (Scene*)h;
    if (i < 0 || i >= (int)s->tex_paths.size()) return -1;
    const std::string& p = s->tex_paths[i];
    int need = (int)p.size() + 1;
    if (need > cap) return need;
    std::memcpy(buf, p.c_str(), need);
    return 0;
}

void pt_get_groups(void* h, int* sphere_groups, int* tri_groups) {
    auto* s = (Scene*)h;
    std::memcpy(sphere_groups, s->sphere_groups.data(),
                s->sphere_groups.size() * sizeof(int));
    std::memcpy(tri_groups, s->tri_groups.data(),
                s->tri_groups.size() * sizeof(int));
}
void pt_get_camera(void* h, float* out12) {
    auto* s = (Scene*)h;
    float buf[12] = {s->eye[0], s->eye[1], s->eye[2],
                     s->look[0], s->look[1], s->look[2],
                     s->up[0], s->up[1], s->up[2],
                     s->fov, (float)s->width, (float)s->height};
    std::memcpy(out12, buf, sizeof(buf));
}

// Builds spatially coherent clusters over triangles (9 floats each).
// order_out: n indices (triangle permutation, cluster-contiguous)
// aabb_out:  max_clusters*6 floats; range_out: max_clusters*2 ints
// Returns the cluster count (<= max_clusters) or -1 on overflow.
int pt_build_clusters(const float* tris, int n, int leaf_size,
                      int* order_out, float* aabb_out, int* range_out,
                      int max_clusters) {
    BuildCtx ctx;
    ctx.tris = tris;
    ctx.leaf_size = std::max(1, leaf_size);
    ctx.cx.resize(n); ctx.cy.resize(n); ctx.cz.resize(n);
    for (int i = 0; i < n; ++i) {
        const float* t = tris + 9 * i;
        ctx.cx[i] = (t[0] + t[3] + t[6]) / 3.0f;
        ctx.cy[i] = (t[1] + t[4] + t[7]) / 3.0f;
        ctx.cz[i] = (t[2] + t[5] + t[8]) / 3.0f;
    }
    ctx.order.resize(n);
    std::iota(ctx.order.begin(), ctx.order.end(), 0);
    build_rec(&ctx, 0, n);
    int m = (int)ctx.ranges.size() / 2;
    if (m > max_clusters) return -1;
    std::memcpy(order_out, ctx.order.data(), n * sizeof(int));
    std::memcpy(aabb_out, ctx.aabbs.data(), m * 6 * sizeof(float));
    std::memcpy(range_out, ctx.ranges.data(), m * 2 * sizeof(int));
    return m;
}

}  // extern "C"
