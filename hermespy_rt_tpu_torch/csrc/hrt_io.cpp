// Native scene I/O and flattening for hermespy_rt_tpu_torch.
//
// The HRT binary serializer of the reference tracer (its src/scene.c:7-83:
// magic "HRT", u32 mesh count, per-mesh vertex/index/material/velocity
// records, little-endian, packed) and the binary PLY reader of its Sionna
// importer (src/scene_fromSionna.c:103-164), as a C ABI library that
// reports errors by status code and message instead of exit(), and flattens
// a mesh soup into the triangle SoA with normals in native code.  The same
// source as csrc/hrt_io.cpp of the JAX package.
//
// Bound with ctypes by hermespy_rt_tpu_torch/scene/native.py, which builds
// it with g++ into hermespy_rt_tpu_torch/_build/.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <cmath>
#include <string>
#include <vector>

namespace {

struct Mesh {
  std::vector<float> vs;       // 3 * num_vertices
  std::vector<uint32_t> is;    // 3 * num_triangles
  uint32_t material_index = 0;
  float velocity[3] = {0.f, 0.f, 0.f};
};

struct Scene {
  std::vector<Mesh> meshes;
};

thread_local std::string g_error;

int fail(const char* msg) {
  g_error = msg;
  return -1;
}

constexpr uint32_t kMaxMeshes = 1000;      // scene.c:52-55 caps
constexpr uint32_t kMaxPlyElems = 1000000; // scene_fromSionna.c:135 caps

bool read_u32(FILE* f, uint32_t* v) { return std::fread(v, 4, 1, f) == 1; }

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Scene handle API
// ---------------------------------------------------------------------------

const char* hrt_last_error() { return g_error.c_str(); }

void* hrt_scene_new() { return new Scene(); }

void hrt_scene_free(void* scene) { delete static_cast<Scene*>(scene); }

int hrt_scene_num_meshes(void* scene) {
  return static_cast<int>(static_cast<Scene*>(scene)->meshes.size());
}

int hrt_scene_num_triangles(void* scene) {
  size_t n = 0;
  for (auto& m : static_cast<Scene*>(scene)->meshes) n += m.is.size() / 3;
  return static_cast<int>(n);
}

int hrt_mesh_info(void* scene, int mesh, uint32_t* num_vertices,
                  uint32_t* num_triangles, uint32_t* material_index,
                  float* velocity) {
  auto& s = *static_cast<Scene*>(scene);
  if (mesh < 0 || mesh >= (int)s.meshes.size()) return fail("mesh index");
  auto& m = s.meshes[mesh];
  *num_vertices = (uint32_t)(m.vs.size() / 3);
  *num_triangles = (uint32_t)(m.is.size() / 3);
  *material_index = m.material_index;
  std::memcpy(velocity, m.velocity, 12);
  return 0;
}

int hrt_mesh_copy(void* scene, int mesh, float* vertices, uint32_t* indices) {
  auto& s = *static_cast<Scene*>(scene);
  if (mesh < 0 || mesh >= (int)s.meshes.size()) return fail("mesh index");
  auto& m = s.meshes[mesh];
  std::memcpy(vertices, m.vs.data(), m.vs.size() * 4);
  std::memcpy(indices, m.is.data(), m.is.size() * 4);
  return 0;
}

int hrt_scene_add_mesh(void* scene, const float* vertices,
                       uint32_t num_vertices, const uint32_t* indices,
                       uint32_t num_triangles, uint32_t material_index,
                       const float* velocity) {
  auto& s = *static_cast<Scene*>(scene);
  Mesh m;
  m.vs.assign(vertices, vertices + 3 * (size_t)num_vertices);
  m.is.assign(indices, indices + 3 * (size_t)num_triangles);
  m.material_index = material_index;
  std::memcpy(m.velocity, velocity, 12);
  s.meshes.push_back(std::move(m));
  return 0;
}

// ---------------------------------------------------------------------------
// HRT load/save (byte-compatible with the reference's src/scene.c)
// ---------------------------------------------------------------------------

int hrt_load(const char* path, void* scene_out) {
  auto& scene = *static_cast<Scene*>(scene_out);
  FILE* f = std::fopen(path, "rb");
  if (!f) return fail("cannot open scene file");
  char magic[3];
  if (std::fread(magic, 1, 3, f) != 3 || std::memcmp(magic, "HRT", 3)) {
    std::fclose(f);
    return fail("bad magic, not an HRT file");
  }
  uint32_t num_meshes;
  if (!read_u32(f, &num_meshes) || num_meshes == 0 ||
      num_meshes > kMaxMeshes) {
    std::fclose(f);
    return fail("invalid mesh count");
  }
  scene.meshes.clear();
  scene.meshes.resize(num_meshes);
  for (uint32_t i = 0; i < num_meshes; ++i) {
    Mesh& m = scene.meshes[i];
    uint32_t nv, nt;
    if (!read_u32(f, &nv)) goto trunc;
    m.vs.resize(3 * (size_t)nv);
    if (std::fread(m.vs.data(), 12, nv, f) != nv) goto trunc;
    if (!read_u32(f, &nt)) goto trunc;
    m.is.resize(3 * (size_t)nt);
    if (std::fread(m.is.data(), 4, 3 * (size_t)nt, f) != 3 * (size_t)nt)
      goto trunc;
    if (!read_u32(f, &m.material_index)) goto trunc;
    if (std::fread(m.velocity, 4, 3, f) != 3) goto trunc;
  }
  std::fclose(f);
  return 0;
trunc:
  std::fclose(f);
  return fail("truncated HRT file");
}

int hrt_save(const char* path, void* scene_in) {
  auto& scene = *static_cast<Scene*>(scene_in);
  FILE* f = std::fopen(path, "wb");
  if (!f) return fail("cannot open output file");
  std::fwrite("HRT", 1, 3, f);
  uint32_t num_meshes = (uint32_t)scene.meshes.size();
  std::fwrite(&num_meshes, 4, 1, f);
  for (auto& m : scene.meshes) {
    uint32_t nv = (uint32_t)(m.vs.size() / 3);
    uint32_t nt = (uint32_t)(m.is.size() / 3);
    std::fwrite(&nv, 4, 1, f);
    std::fwrite(m.vs.data(), 12, nv, f);
    std::fwrite(&nt, 4, 1, f);
    std::fwrite(m.is.data(), 4, 3 * (size_t)nt, f);
    std::fwrite(&m.material_index, 4, 1, f);
    std::fwrite(m.velocity, 4, 3, f);
  }
  std::fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// Binary PLY reader (format of the reference's src/scene_fromSionna.c:85-99)
// ---------------------------------------------------------------------------

int hrt_load_ply(const char* path, void* scene_out, uint32_t material_index,
                 const float* velocity) {
  auto& scene = *static_cast<Scene*>(scene_out);
  FILE* f = std::fopen(path, "rb");
  if (!f) return fail("cannot open PLY file");

  char line[256];
  uint32_t nv = 0, nt = 0;
  int vertex_floats = 0;
  bool in_vertex = false, saw_ply = false, little = false;
  while (std::fgets(line, sizeof line, f)) {
    if (!std::strncmp(line, "ply", 3)) saw_ply = true;
    else if (!std::strncmp(line, "format binary_little_endian", 27))
      little = true;
    else if (!std::strncmp(line, "element vertex ", 15)) {
      nv = (uint32_t)std::strtoul(line + 15, nullptr, 10);
      in_vertex = true;
    } else if (!std::strncmp(line, "element face ", 13)) {
      nt = (uint32_t)std::strtoul(line + 13, nullptr, 10);
      in_vertex = false;
    } else if (!std::strncmp(line, "property float", 14) && in_vertex)
      ++vertex_floats;
    else if (!std::strncmp(line, "end_header", 10))
      break;
  }
  if (!saw_ply || !little) { std::fclose(f); return fail("not a binary_little_endian PLY"); }
  if (nv == 0 || nt == 0) { std::fclose(f); return fail("PLY vertex or face element missing"); }
  if (nv > kMaxPlyElems || nt > kMaxPlyElems) { std::fclose(f); return fail("PLY element too big"); }
  if (vertex_floats < 3) { std::fclose(f); return fail("PLY needs float x,y,z"); }

  Mesh m;
  m.material_index = material_index;
  if (velocity) std::memcpy(m.velocity, velocity, 12);
  m.vs.resize(3 * (size_t)nv);
  size_t stride = 4 * (size_t)vertex_floats;
  std::vector<unsigned char> row(stride);
  for (uint32_t i = 0; i < nv; ++i) {
    if (std::fread(row.data(), 1, stride, f) != stride) {
      std::fclose(f);
      return fail("truncated PLY vertex data");
    }
    std::memcpy(&m.vs[3 * (size_t)i], row.data(), 12);
  }
  m.is.resize(3 * (size_t)nt);
  for (uint32_t i = 0; i < nt; ++i) {
    unsigned char cnt;
    if (std::fread(&cnt, 1, 1, f) != 1) { std::fclose(f); return fail("truncated PLY face"); }
    if (cnt != 3) { std::fclose(f); return fail("face is not a triangle"); }
    if (std::fread(&m.is[3 * (size_t)i], 4, 3, f) != 3) {
      std::fclose(f);
      return fail("truncated PLY face indices");
    }
  }
  std::fclose(f);
  scene.meshes.push_back(std::move(m));
  return 0;
}

// ---------------------------------------------------------------------------
// Flattening: mesh soup -> padded triangle SoA + unit normals (what
// scene/model.py::flatten_scene computes before sorting; normal convention
// normalize((v2-v1)x(v3-v1)) as the reference's src/compute_paths.c:208-224)
// ---------------------------------------------------------------------------

int hrt_flatten(void* scene_in, uint32_t pad_triangles,
                float* v0, float* e1, float* e2, float* normal,
                float* velocity, int32_t* material, int32_t* mesh_id) {
  auto& scene = *static_cast<Scene*>(scene_in);
  size_t t = 0;
  for (size_t mi = 0; mi < scene.meshes.size(); ++mi) {
    Mesh& m = scene.meshes[mi];
    size_t nt = m.is.size() / 3;
    for (size_t j = 0; j < nt; ++j, ++t) {
      if (t >= pad_triangles) return fail("pad_triangles too small");
      const float* a = &m.vs[3 * (size_t)m.is[3 * j]];
      const float* b = &m.vs[3 * (size_t)m.is[3 * j + 1]];
      const float* c = &m.vs[3 * (size_t)m.is[3 * j + 2]];
      float E1[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
      float E2[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
      float N[3] = {E1[1] * E2[2] - E1[2] * E2[1],
                    E1[2] * E2[0] - E1[0] * E2[2],
                    E1[0] * E2[1] - E1[1] * E2[0]};
      float len = std::sqrt(N[0] * N[0] + N[1] * N[1] + N[2] * N[2]);
      float inv = len > 0 ? 1.0f / len : 0.0f;
      for (int k = 0; k < 3; ++k) {
        v0[3 * t + k] = a[k];
        e1[3 * t + k] = E1[k];
        e2[3 * t + k] = E2[k];
        normal[3 * t + k] = N[k] * inv;
        velocity[3 * t + k] = m.velocity[k];
      }
      material[t] = (int32_t)m.material_index;
      mesh_id[t] = (int32_t)mi;
    }
  }
  for (; t < pad_triangles; ++t) {
    for (int k = 0; k < 3; ++k)
      v0[3 * t + k] = e1[3 * t + k] = e2[3 * t + k] = normal[3 * t + k] =
          velocity[3 * t + k] = 0.0f;
    material[t] = 0;
    mesh_id[t] = -1;
  }
  return 0;
}

}  // extern "C"
