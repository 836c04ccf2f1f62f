// Native host-side runtime for tuturenderer_tpu.
//
// The reference renderer's host layer is C++ (OBJ loading via the vendored
// objl loader OBJ_Loader.h:430-717, BVH build BVH.hpp:47-123, ASCII PPM
// read/write PPMGenerator.hpp:812-845/1027-1084). This library provides the
// renderer's native equivalents — scalar, branchy host work that
// Python is slow at — exposed through a C ABI consumed via ctypes
// (tuturenderer_tpu/native.py). Device compute stays in JAX.
//
// Components:
//   obj_load        : v/vt/vn/f parser with fan triangulation and generated
//                     flat normals (objl semantics)
//   bvh_build       : longest-axis median-split BVH flattened to arrays
//                     (the reference's heuristic, multi-primitive leaves)
//   ppm_read/write  : ASCII P3 with max-value normalization and the
//                     clamp+gamma quantization of writePixel
//
// Build: make -C native   (g++ -O2 -shared -fPIC)

#include <algorithm>
#include <array>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <numeric>
#include <sstream>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- OBJ

struct ObjResult {
  // triangle soup: n_tris * 9 floats each (verts, normals), n_tris * 6 (uv)
  float* verts;
  float* normals;
  float* uvs;
  int64_t n_tris;
  int32_t ok;
};

static void obj_free_result(ObjResult* r) {
  delete[] r->verts;
  delete[] r->normals;
  delete[] r->uvs;
  r->verts = r->normals = r->uvs = nullptr;
}

void tutu_obj_free(ObjResult* r) { obj_free_result(r); }

ObjResult* tutu_obj_load(const char* path) {
  auto* res = new ObjResult{nullptr, nullptr, nullptr, 0, 0};
  std::ifstream in(path);
  if (!in.is_open()) return res;

  std::vector<float> pos, nrm, uv;
  struct Corner { int v, t, n; };
  std::vector<std::array<Corner, 3>> tris;

  std::string line;
  std::vector<Corner> corners;
  while (std::getline(in, line)) {
    if (line.empty() || line[0] == '#') continue;
    std::istringstream ss(line);
    std::string tag;
    ss >> tag;
    if (tag == "v") {
      float x, y, z;
      ss >> x >> y >> z;
      pos.push_back(x); pos.push_back(y); pos.push_back(z);
    } else if (tag == "vn") {
      float x, y, z;
      ss >> x >> y >> z;
      nrm.push_back(x); nrm.push_back(y); nrm.push_back(z);
    } else if (tag == "vt") {
      float u, v;
      ss >> u >> v;
      uv.push_back(u); uv.push_back(v);
    } else if (tag == "f") {
      corners.clear();
      std::string tok;
      while (ss >> tok) {
        Corner c{0, -1, -1};
        // v, v/t, v//n, v/t/n ; negative indices relative
        int vals[3] = {0, 0, 0};
        bool has[3] = {false, false, false};
        int field = 0;
        int sign = 1;
        int acc = 0;
        bool any = false;
        for (size_t i = 0; i <= tok.size(); ++i) {
          char ch = i < tok.size() ? tok[i] : '/';
          if (ch == '/') {
            if (any) { vals[field] = sign * acc; has[field] = true; }
            field++; sign = 1; acc = 0; any = false;
            if (field > 2) break;
          } else if (ch == '-') {
            sign = -1;
          } else if (isdigit((unsigned char)ch)) {
            acc = acc * 10 + (ch - '0');
            any = true;
          }
        }
        int nv = (int)pos.size() / 3;
        int nt = (int)uv.size() / 2;
        int nn = (int)nrm.size() / 3;
        if (has[0]) c.v = vals[0] > 0 ? vals[0] - 1 : nv + vals[0];
        if (has[1]) c.t = vals[1] > 0 ? vals[1] - 1 : nt + vals[1];
        if (has[2]) c.n = vals[2] > 0 ? vals[2] - 1 : nn + vals[2];
        corners.push_back(c);
      }
      for (size_t k = 1; k + 1 < corners.size(); ++k)
        tris.push_back({corners[0], corners[k], corners[k + 1]});
    }
  }

  int64_t n = (int64_t)tris.size();
  res->n_tris = n;
  res->verts = new float[n * 9];
  res->normals = new float[n * 9];
  res->uvs = new float[n * 6];
  for (int64_t i = 0; i < n; ++i) {
    float* v = res->verts + i * 9;
    float* nn = res->normals + i * 9;
    float* tt = res->uvs + i * 6;
    for (int j = 0; j < 3; ++j) {
      const Corner& c = tris[i][j];
      v[j * 3 + 0] = pos[c.v * 3 + 0];
      v[j * 3 + 1] = pos[c.v * 3 + 1];
      v[j * 3 + 2] = pos[c.v * 3 + 2];
      if (c.t >= 0) {
        tt[j * 2 + 0] = uv[c.t * 2 + 0];
        tt[j * 2 + 1] = uv[c.t * 2 + 1];
      } else {
        tt[j * 2 + 0] = -1.f;
        tt[j * 2 + 1] = -1.f;
      }
    }
    bool all_n = tris[i][0].n >= 0 && tris[i][1].n >= 0 && tris[i][2].n >= 0;
    if (all_n) {
      for (int j = 0; j < 3; ++j) {
        const Corner& c = tris[i][j];
        nn[j * 3 + 0] = nrm[c.n * 3 + 0];
        nn[j * 3 + 1] = nrm[c.n * 3 + 1];
        nn[j * 3 + 2] = nrm[c.n * 3 + 2];
      }
    } else {
      // generated flat normal (objl behavior for missing vn)
      float e1[3], e2[3], fn[3];
      for (int k = 0; k < 3; ++k) {
        e1[k] = v[3 + k] - v[k];
        e2[k] = v[6 + k] - v[k];
      }
      fn[0] = e1[1] * e2[2] - e1[2] * e2[1];
      fn[1] = e1[2] * e2[0] - e1[0] * e2[2];
      fn[2] = e1[0] * e2[1] - e1[1] * e2[0];
      float len = std::sqrt(fn[0] * fn[0] + fn[1] * fn[1] + fn[2] * fn[2]);
      if (len > 0) { fn[0] /= len; fn[1] /= len; fn[2] /= len; }
      for (int j = 0; j < 3; ++j)
        for (int k = 0; k < 3; ++k) nn[j * 3 + k] = fn[k];
    }
  }
  res->ok = 1;
  return res;
}

void tutu_obj_result_free(ObjResult* r) {
  obj_free_result(r);
  delete r;
}

// ---------------------------------------------------------------- BVH

struct BvhResult {
  float* bb_min;    // n_nodes * 3
  float* bb_max;
  int32_t* left;    // n_nodes
  int32_t* right;
  int32_t* start;
  int32_t* count;
  int32_t* prim;    // n_prims
  int64_t n_nodes;
  int64_t n_prims;
};

struct BvhBuilder {
  const float* lo;
  const float* hi;
  const float* centroid;
  int leaf_size;
  std::vector<float> bb_min, bb_max;
  std::vector<int32_t> left, right, start, count, order;

  int new_node() {
    bb_min.insert(bb_min.end(), {0, 0, 0});
    bb_max.insert(bb_max.end(), {0, 0, 0});
    left.push_back(-1);
    right.push_back(-1);
    start.push_back(0);
    count.push_back(0);
    return (int)left.size() - 1;
  }

  int rec(std::vector<int32_t>& idx, int lo_i, int hi_i) {
    int node = new_node();
    float mn[3] = {1e30f, 1e30f, 1e30f}, mx[3] = {-1e30f, -1e30f, -1e30f};
    for (int i = lo_i; i < hi_i; ++i) {
      for (int k = 0; k < 3; ++k) {
        mn[k] = std::min(mn[k], lo[idx[i] * 3 + k]);
        mx[k] = std::max(mx[k], hi[idx[i] * 3 + k]);
      }
    }
    for (int k = 0; k < 3; ++k) {
      bb_min[node * 3 + k] = mn[k];
      bb_max[node * 3 + k] = mx[k];
    }
    int n = hi_i - lo_i;
    if (n <= leaf_size) {
      start[node] = (int)order.size();
      count[node] = n;
      for (int i = lo_i; i < hi_i; ++i) order.push_back(idx[i]);
      return node;
    }
    float ext[3] = {mx[0] - mn[0], mx[1] - mn[1], mx[2] - mn[2]};
    int axis = 0;
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;
    int mid = lo_i + n / 2;
    std::nth_element(idx.begin() + lo_i, idx.begin() + mid,
                     idx.begin() + hi_i,
                     [&](int32_t a, int32_t b) {
                       return centroid[a * 3 + axis] < centroid[b * 3 + axis];
                     });
    int l = rec(idx, lo_i, mid);
    int r = rec(idx, mid, hi_i);
    left[node] = l;
    right[node] = r;
    return node;
  }
};

BvhResult* tutu_bvh_build(const float* verts, int64_t n_tris, int leaf_size) {
  std::vector<float> lo(n_tris * 3), hi(n_tris * 3), cen(n_tris * 3);
  for (int64_t i = 0; i < n_tris; ++i) {
    for (int k = 0; k < 3; ++k) {
      float a = verts[i * 9 + 0 + k];
      float b = verts[i * 9 + 3 + k];
      float c = verts[i * 9 + 6 + k];
      float mn = std::min(a, std::min(b, c));
      float mx = std::max(a, std::max(b, c));
      lo[i * 3 + k] = mn;
      hi[i * 3 + k] = mx;
      cen[i * 3 + k] = 0.5f * (mn + mx);
    }
  }
  BvhBuilder bld;
  bld.lo = lo.data();
  bld.hi = hi.data();
  bld.centroid = cen.data();
  bld.leaf_size = leaf_size;
  std::vector<int32_t> idx(n_tris);
  std::iota(idx.begin(), idx.end(), 0);
  if (n_tris > 0) bld.rec(idx, 0, (int)n_tris);

  auto* res = new BvhResult();
  res->n_nodes = (int64_t)bld.left.size();
  res->n_prims = (int64_t)bld.order.size();
  res->bb_min = new float[bld.bb_min.size()];
  res->bb_max = new float[bld.bb_max.size()];
  res->left = new int32_t[bld.left.size()];
  res->right = new int32_t[bld.right.size()];
  res->start = new int32_t[bld.start.size()];
  res->count = new int32_t[bld.count.size()];
  res->prim = new int32_t[std::max<size_t>(bld.order.size(), 1)];
  std::memcpy(res->bb_min, bld.bb_min.data(), bld.bb_min.size() * 4);
  std::memcpy(res->bb_max, bld.bb_max.data(), bld.bb_max.size() * 4);
  std::memcpy(res->left, bld.left.data(), bld.left.size() * 4);
  std::memcpy(res->right, bld.right.data(), bld.right.size() * 4);
  std::memcpy(res->start, bld.start.data(), bld.start.size() * 4);
  std::memcpy(res->count, bld.count.data(), bld.count.size() * 4);
  if (!bld.order.empty())
    std::memcpy(res->prim, bld.order.data(), bld.order.size() * 4);
  return res;
}

void tutu_bvh_free(BvhResult* r) {
  delete[] r->bb_min;
  delete[] r->bb_max;
  delete[] r->left;
  delete[] r->right;
  delete[] r->start;
  delete[] r->count;
  delete[] r->prim;
  delete r;
}

// ---------------------------------------------------------------- PPM

// write ASCII P3 with clamp + gamma (PPMGenerator::writePixel semantics)
int32_t tutu_ppm_write(const char* path, const float* rgb, int32_t w,
                       int32_t h, float gamma) {
  FILE* f = fopen(path, "w");
  if (!f) return 0;
  fprintf(f, "P3\n%d\n%d\n255\n", w, h);
  for (int64_t i = 0; i < (int64_t)w * h; ++i) {
    int v[3];
    for (int k = 0; k < 3; ++k) {
      float c = rgb[i * 3 + k];
      if (!(c == c)) c = 0.f;            // NaN -> 0
      c = c < 0.f ? 0.f : (c > 1.f ? 1.f : c);
      v[k] = (int)(255.f * std::pow(c, gamma));
    }
    fprintf(f, "%d %d %d\n", v[0], v[1], v[2]);
  }
  fclose(f);
  return 1;
}

struct PpmResult {
  float* rgb;
  int32_t w, h, ok;
};

PpmResult* tutu_ppm_read(const char* path) {
  auto* res = new PpmResult{nullptr, 0, 0, 0};
  std::ifstream in(path);
  if (!in.is_open()) return res;
  std::string magic;
  in >> magic;
  if (magic != "P3") return res;
  int w, h;
  float maxv;
  in >> w >> h >> maxv;
  res->w = w;
  res->h = h;
  res->rgb = new float[(int64_t)w * h * 3];
  for (int64_t i = 0; i < (int64_t)w * h * 3; ++i) {
    float v;
    in >> v;
    res->rgb[i] = v / maxv;
  }
  res->ok = 1;
  return res;
}

void tutu_ppm_free(PpmResult* r) {
  delete[] r->rgb;
  delete r;
}

}  // extern "C"
