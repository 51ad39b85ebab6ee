// pronerf_native: host-side runtime of pronerf_tpu_torch, built with g++ at
// first use (pronerf_tpu_torch/native/__init__.py) and bound with ctypes.
//
// The port's own copy of the JAX package's native/pronerf_native.cpp: the
// same functions in the same code, built with the same compiler line, so that
// one seed gives both packages the same ray pool bit for bit. It owns the
// start-up work that plain NumPy does slowly:
//
//  - build_ray_pool: per-pixel ray generation for all training views +
//    target colors, multithreaded, with an optional in-place Fisher-Yates
//    shuffle (seeded mt19937_64; layout [M, 3(o,d,rgb), 3]).
//  - colmap_points3d_visibility: single-pass points3D.bin track scan into a
//    dense [n_train, n_points] visibility matrix.
//  - greedy_cover: the reference-view max-coverage loop over that matrix.
//
// Exposed as a plain C ABI for ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

extern "C" {

// images: [T, H, W, 3] float32 (train subset, already gathered)
// poses:  [T, 3, 4] float32 c2w (train subset)
// K:      [3, 3] float32
// out_rays: [T*H*W, 3, 3] float32 (origin, direction, rgb)
// out_ids:  [T*H*W] int32 (train-subset view index)
// seed/shuffle: Fisher-Yates permutation applied to both outputs.
int build_ray_pool(const float* images, const float* poses, const float* K,
                   int T, int H, int W, float* out_rays, int32_t* out_ids,
                   uint64_t seed, int shuffle) {
  const float fx = K[0], cx = K[2], fy = K[4], cy = K[5];
  const int64_t per_view = (int64_t)H * W;

  auto fill_view = [&](int t) {
    const float* R = poses + (int64_t)t * 12;  // rows of [R|t]
    const float ox = R[3], oy = R[7], oz = R[11];
    const float* img = images + (int64_t)t * per_view * 3;
    float* dst = out_rays + (int64_t)t * per_view * 9;
    int32_t* ids = out_ids + (int64_t)t * per_view;
    int64_t p = 0;
    for (int j = 0; j < H; ++j) {
      const float dy = -((float)j - cy) / fy;
      for (int i = 0; i < W; ++i, ++p) {
        const float dx = ((float)i - cx) / fx;
        // world dir = R * [dx, dy, -1]
        float* r = dst + p * 9;
        r[0] = ox; r[1] = oy; r[2] = oz;
        r[3] = R[0] * dx + R[1] * dy - R[2];
        r[4] = R[4] * dx + R[5] * dy - R[6];
        r[5] = R[8] * dx + R[9] * dy - R[10];
        const float* px = img + p * 3;
        r[6] = px[0]; r[7] = px[1]; r[8] = px[2];
        ids[p] = t;
      }
    }
  };

  unsigned n_threads = std::thread::hardware_concurrency();
  if (n_threads == 0) n_threads = 4;
  std::vector<std::thread> workers;
  for (int t = 0; t < T; ++t) {
    workers.emplace_back(fill_view, t);
    if (workers.size() == n_threads || t == T - 1) {
      for (auto& w : workers) w.join();
      workers.clear();
    }
  }

  if (shuffle) {
    const int64_t M = (int64_t)T * per_view;
    std::mt19937_64 rng(seed);
    for (int64_t i = M - 1; i > 0; --i) {
      const int64_t j = (int64_t)(rng() % (uint64_t)(i + 1));
      float tmp[9];
      std::memcpy(tmp, out_rays + i * 9, sizeof(tmp));
      std::memcpy(out_rays + i * 9, out_rays + j * 9, sizeof(tmp));
      std::memcpy(out_rays + j * 9, tmp, sizeof(tmp));
      std::swap(out_ids[i], out_ids[j]);
    }
  }
  return 0;
}

// Parse points3D.bin and fill vis [n_train, n_points] (0/1 float32).
// image_rank: dense map image_id -> train rank (or -1), length max_image_id+1.
// Returns the number of 3D points, or -1 on IO error, -2 if the buffer is
// too small (call with n_points_cap=0 to query the count).
int64_t colmap_points3d_visibility(const char* path, const int32_t* image_rank,
                                   int64_t max_image_id, int32_t n_train,
                                   float* vis, int64_t n_points_cap) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  uint64_t n_points = 0;
  if (std::fread(&n_points, 8, 1, f) != 1) { std::fclose(f); return -1; }
  if (n_points_cap == 0) { std::fclose(f); return (int64_t)n_points; }
  if ((int64_t)n_points > n_points_cap) { std::fclose(f); return -2; }

  std::vector<int32_t> track;
  for (uint64_t p = 0; p < n_points; ++p) {
    // id(8) xyz(24) rgb(3) error(8) track_len(8) track(8*len)
    if (std::fseek(f, 8 + 24 + 3 + 8, SEEK_CUR) != 0) { std::fclose(f); return -1; }
    uint64_t track_len = 0;
    if (std::fread(&track_len, 8, 1, f) != 1) { std::fclose(f); return -1; }
    track.resize(track_len * 2);
    if (track_len &&
        std::fread(track.data(), 8, track_len, f) != track_len) {
      std::fclose(f);
      return -1;
    }
    for (uint64_t k = 0; k < track_len; ++k) {
      const int32_t image_id = track[2 * k];
      if (image_id >= 0 && image_id <= max_image_id) {
        const int32_t rank = image_rank[image_id];
        if (rank >= 0 && rank < n_train) {
          vis[(int64_t)rank * n_points_cap + (int64_t)p] = 1.0f;
        }
      }
    }
  }
  std::fclose(f);
  return (int64_t)n_points;
}

// Greedy max-coverage: pick n_pick rows of vis [n_train, n_points]
// (row-major, stride n_points), removing covered points each round.
// vis is clobbered. out_picks gets row indices.
int greedy_cover(float* vis, int32_t n_train, int64_t n_points,
                 int32_t n_pick, int32_t* out_picks) {
  std::vector<char> taken(n_train, 0);
  for (int32_t r = 0; r < n_pick; ++r) {
    double best_total = -1.0;
    int32_t best = -1;
    for (int32_t t = 0; t < n_train; ++t) {
      double total = 0.0;
      const float* row = vis + (int64_t)t * n_points;
      for (int64_t p = 0; p < n_points; ++p) total += row[p];
      if (total > best_total) { best_total = total; best = t; }
    }
    if (best_total <= 0.0) {
      // all points covered: fall back to any unpicked view
      for (int32_t t = 0; t < n_train; ++t)
        if (!taken[t]) { best = t; break; }
    }
    out_picks[r] = best;
    taken[best] = 1;
    const float* brow = vis + (int64_t)best * n_points;
    std::vector<float> bcopy(brow, brow + n_points);
    for (int32_t t = 0; t < n_train; ++t) {
      float* row = vis + (int64_t)t * n_points;
      for (int64_t p = 0; p < n_points; ++p) {
        row[p] -= bcopy[p];
        if (row[p] < 0.0f) row[p] = 0.0f;
      }
    }
  }
  return 0;
}

}  // extern "C"
