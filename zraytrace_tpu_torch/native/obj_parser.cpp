// Native Wavefront OBJ parser.
//
// The same source as zraytrace_tpu/native/obj_parser.cpp. Semantics
// match the Python reader (io/obj.py) and the reference
// (obj_reader.zig): 'v' vertices, 'f' faces of 3..6 vertices
// fan-triangulated as {0,1,2} {2,3,0} {3,4,0} {4,5,0}
// (obj_reader.zig:85-107), 'vn' counted but unused, face vertex tokens
// v, v/t, v/t/n, v//n with 1-based indices.
//
// C ABI for ctypes: two-pass protocol — zrt_parse_obj with null outputs
// returns counts; the second call fills caller-allocated buffers.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Counts {
  int64_t vertices = 0;
  int64_t triangles = 0;
  int64_t faces = 0;
  int64_t normals = 0;
};

// Fan pattern per face size (obj_reader.zig:85-107).
const int kFan[4][4][3] = {
    {{0, 1, 2}},
    {{0, 1, 2}, {2, 3, 0}},
    {{0, 1, 2}, {2, 3, 0}, {3, 4, 0}},
    {{0, 1, 2}, {2, 3, 0}, {3, 4, 0}, {4, 5, 0}},
};
const int kFanTris[4] = {1, 2, 3, 4};

bool parse(const char *path, Counts *counts, float *out_vertices,
           int32_t *out_tris) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return false;
  char line[20001];
  int64_t n_v = 0, n_t = 0, n_f = 0, n_vn = 0;
  while (std::fgets(line, sizeof(line), f)) {
    if (line[0] == 'v' && line[1] == ' ') {
      float x, y, z;
      if (std::sscanf(line + 2, "%f %f %f", &x, &y, &z) == 3) {
        if (out_vertices) {
          out_vertices[3 * n_v + 0] = x;
          out_vertices[3 * n_v + 1] = y;
          out_vertices[3 * n_v + 2] = z;
        }
        n_v++;
      }
    } else if (line[0] == 'f' && line[1] == ' ') {
      int64_t idx[7];
      int nv = 0;
      const char *p = line + 2;
      while (*p && nv < 7) {  // read one extra to detect >6-gons
        while (*p == ' ' || *p == '\t') p++;
        if (*p == '\0' || *p == '\n' || *p == '\r') break;
        char *end;
        long v = std::strtol(p, &end, 10);
        if (end == p) break;
        idx[nv++] = v - 1;  // 1-based -> 0-based (obj_reader.zig:50-60)
        p = end;
        while (*p && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') p++;
      }
      if (nv < 3 || nv > 6) {
        std::fclose(f);
        return false;  // WrongNumberOfFaceVertexes (obj_reader.zig:49-51)
      }
      const int pat = nv - 3;
      for (int t = 0; t < kFanTris[pat]; ++t) {
        if (out_tris) {
          out_tris[3 * n_t + 0] = static_cast<int32_t>(idx[kFan[pat][t][0]]);
          out_tris[3 * n_t + 1] = static_cast<int32_t>(idx[kFan[pat][t][1]]);
          out_tris[3 * n_t + 2] = static_cast<int32_t>(idx[kFan[pat][t][2]]);
        }
        n_t++;
      }
      n_f++;
    } else if (line[0] == 'v' && line[1] == 'n' && line[2] == ' ') {
      n_vn++;  // parsed but unused, parity with obj_reader.zig:176-184
    }
  }
  std::fclose(f);
  counts->vertices = n_v;
  counts->triangles = n_t;
  counts->faces = n_f;
  counts->normals = n_vn;
  return true;
}

}  // namespace

extern "C" {

// Pass 1: out_vertices == nullptr -> fills counts only.
// Pass 2: buffers sized by pass-1 counts. Returns 0 on success, -1 on
// open failure, -2 on malformed face.
int32_t zrt_parse_obj(const char *path, int64_t *out_counts /*4*/,
                      float *out_vertices, int32_t *out_tris) {
  Counts c;
  if (!parse(path, &c, out_vertices, out_tris)) {
    FILE *probe = std::fopen(path, "rb");
    if (!probe) return -1;
    std::fclose(probe);
    return -2;
  }
  out_counts[0] = c.vertices;
  out_counts[1] = c.triangles;
  out_counts[2] = c.faces;
  out_counts[3] = c.normals;
  return 0;
}
}
