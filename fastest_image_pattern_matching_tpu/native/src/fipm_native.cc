// fipm_native — C++ runtime components for the JAX pattern-matching
// framework: BMP codec, threaded batch image loader, and host-side
// post-processing (greedy peak extraction + rotated-rect NMS oracle).
//
// The reference's runtime is C++ end to end; here the compute path is
// JAX/XLA on the accelerator and this library supplies the native runtime around
// it: zero-dependency image IO (the reference reads BMPs via OpenCV,
// MatchToolDlg.cpp:506-525), a prefetching data loader for corpus
// inspection (the reference's camera grabber thread analogue,
// src/CameraPreviewDialog.cpp:42-131), and exact host implementations of
// the sequential tails (GetNextMaxLoc, MatchToolDlg.cpp:1558-1582;
// FilterWithRotatedRect, :1498-1557) used for small candidate counts and
// as test oracles.
//
// Exposed as a plain C ABI for ctypes.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// BMP codec (8-bit paletted, 24/32-bit BGR; uncompressed)
// ---------------------------------------------------------------------------

// Reads the BMP at `path`; on success fills *w/*h and returns a malloc'd
// grayscale buffer (row-major, top-down) the caller frees with
// fipm_free(). Returns nullptr on failure.
uint8_t* fipm_bmp_load_gray(const char* path, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  uint8_t header[54];
  if (fread(header, 1, 54, f) != 54 || header[0] != 'B' || header[1] != 'M') {
    fclose(f);
    return nullptr;
  }
  auto rd32 = [&](int off) {
    return (int32_t)(header[off] | header[off + 1] << 8 |
                     header[off + 2] << 16 | (uint32_t)header[off + 3] << 24);
  };
  auto rd16 = [&](int off) { return header[off] | header[off + 1] << 8; };
  int32_t data_off = rd32(10);
  int32_t hdr_size = rd32(14);
  int32_t width = rd32(18);
  int32_t height = rd32(22);
  int bpp = rd16(28);
  int32_t compression = rd32(30);
  if (width <= 0 || compression != 0 ||
      (bpp != 8 && bpp != 24 && bpp != 32)) {
    fclose(f);
    return nullptr;
  }
  bool bottom_up = height > 0;
  int32_t habs = height > 0 ? height : -height;

  // Palette for 8-bit (maps index -> gray via BT.601 on the RGBQUADs).
  std::vector<uint8_t> pal_gray(256, 0);
  if (bpp == 8) {
    int n_colors = rd32(46);
    if (n_colors <= 0 || n_colors > 256) n_colors = 256;
    if (fseek(f, 14 + hdr_size, SEEK_SET) != 0) { fclose(f); return nullptr; }
    std::vector<uint8_t> pal(4 * n_colors);
    if (fread(pal.data(), 1, pal.size(), f) != pal.size()) {
      fclose(f);
      return nullptr;
    }
    for (int i = 0; i < n_colors; i++) {
      double b = pal[4 * i], g = pal[4 * i + 1], r = pal[4 * i + 2];
      pal_gray[i] = (uint8_t)std::lround(0.299 * r + 0.587 * g + 0.114 * b);
    }
  }

  int bytes_pp = bpp / 8;
  size_t stride = ((size_t)width * bytes_pp + 3) & ~3u;
  std::vector<uint8_t> row(stride);
  uint8_t* out = (uint8_t*)malloc((size_t)width * habs);
  if (!out) { fclose(f); return nullptr; }
  if (fseek(f, data_off, SEEK_SET) != 0) { free(out); fclose(f); return nullptr; }
  for (int y = 0; y < habs; y++) {
    if (fread(row.data(), 1, stride, f) != stride) {
      free(out);
      fclose(f);
      return nullptr;
    }
    int oy = bottom_up ? habs - 1 - y : y;
    uint8_t* dst = out + (size_t)oy * width;
    if (bpp == 8) {
      for (int x = 0; x < width; x++) dst[x] = pal_gray[row[x]];
    } else {
      for (int x = 0; x < width; x++) {
        double b = row[x * bytes_pp], g = row[x * bytes_pp + 1],
               r = row[x * bytes_pp + 2];
        dst[x] = (uint8_t)std::lround(0.299 * r + 0.587 * g + 0.114 * b);
      }
    }
  }
  fclose(f);
  *w = width;
  *h = habs;
  return out;
}

// Writes `img` (row-major top-down grayscale) as an 8-bit paletted BMP.
int fipm_bmp_save_gray(const char* path, const uint8_t* img, int w, int h) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  size_t stride = ((size_t)w + 3) & ~3u;
  uint32_t data_off = 54 + 256 * 4;
  uint32_t file_size = data_off + (uint32_t)(stride * h);
  uint8_t header[54] = {0};
  header[0] = 'B';
  header[1] = 'M';
  auto wr32 = [&](int off, uint32_t v) {
    header[off] = v & 0xff;
    header[off + 1] = (v >> 8) & 0xff;
    header[off + 2] = (v >> 16) & 0xff;
    header[off + 3] = (v >> 24) & 0xff;
  };
  auto wr16 = [&](int off, uint16_t v) {
    header[off] = v & 0xff;
    header[off + 1] = (v >> 8) & 0xff;
  };
  wr32(2, file_size);
  wr32(10, data_off);
  wr32(14, 40);
  wr32(18, (uint32_t)w);
  wr32(22, (uint32_t)h);
  wr16(26, 1);
  wr16(28, 8);
  wr32(34, (uint32_t)(stride * h));
  wr32(46, 256);
  fwrite(header, 1, 54, f);
  for (int i = 0; i < 256; i++) {
    uint8_t q[4] = {(uint8_t)i, (uint8_t)i, (uint8_t)i, 0};
    fwrite(q, 1, 4, f);
  }
  std::vector<uint8_t> row(stride, 0);
  for (int y = h - 1; y >= 0; y--) {  // bottom-up
    memcpy(row.data(), img + (size_t)y * w, w);
    fwrite(row.data(), 1, stride, f);
  }
  fclose(f);
  return 0;
}

void fipm_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// Host greedy peak extraction (GetNextMaxLoc oracle,
// MatchToolDlg.cpp:1558-1582)
// ---------------------------------------------------------------------------

// score: [hs*ws] f32 row-major (modified in place: suppression paints -1).
// Returns number of peaks written to out_x/out_y/out_v (up to k).
int fipm_extract_peaks(float* score, int hs, int ws, int k, int tw, int th,
                       double max_overlap, int* out_x, int* out_y,
                       float* out_v) {
  int n = 0;
  int sw = (int)(2 * tw * (1 - max_overlap));
  int sh = (int)(2 * th * (1 - max_overlap));
  for (int i = 0; i < k; i++) {
    int best = 0;
    float bv = score[0];
    for (int j = 1; j < hs * ws; j++)
      if (score[j] > bv) {
        bv = score[j];
        best = j;
      }
    int y = best / ws, x = best % ws;
    out_x[n] = x;
    out_y[n] = y;
    out_v[n] = bv;
    n++;
    int x0 = (int)(x - tw * (1 - max_overlap));
    int y0 = (int)(y - th * (1 - max_overlap));
    int xa = std::max(x0, 0), ya = std::max(y0, 0);
    int xb = std::min(x0 + sw - 1, ws - 1), yb = std::min(y0 + sh - 1, hs - 1);
    for (int yy = ya; yy <= yb; yy++)
      for (int xx = xa; xx <= xb; xx++) score[yy * ws + xx] = -1.0f;
  }
  return n;
}

// ---------------------------------------------------------------------------
// Host rotated-rect NMS (FilterWithRotatedRect oracle,
// MatchToolDlg.cpp:1498-1557): Sutherland-Hodgman quad clip + greedy pass.
// ---------------------------------------------------------------------------

struct Pt {
  double x, y;
};

static double cross_edge(const Pt& a, const Pt& b, const Pt& p) {
  return (b.x - a.x) * (p.y - a.y) - (b.y - a.y) * (p.x - a.x);
}

static double quad_intersection_area(const Pt* qa, const Pt* qb) {
  std::vector<Pt> poly(qa, qa + 4), next;
  for (int e = 0; e < 4; e++) {
    const Pt& a = qb[e];
    const Pt& b = qb[(e + 1) % 4];
    next.clear();
    int n = (int)poly.size();
    for (int i = 0; i < n; i++) {
      const Pt& cur = poly[i];
      const Pt& nxt = poly[(i + 1) % n];
      double sc = cross_edge(a, b, cur), sn = cross_edge(a, b, nxt);
      if (sc >= 0) next.push_back(cur);
      if ((sc >= 0) != (sn >= 0)) {
        double t = sc / (sc - sn);
        next.push_back({cur.x + t * (nxt.x - cur.x),
                        cur.y + t * (nxt.y - cur.y)});
      }
    }
    poly = next;
    if (poly.empty()) return 0.0;
  }
  if (poly.size() < 3) return 0.0;
  double area = 0;
  for (size_t i = 0; i < poly.size(); i++) {
    const Pt& p = poly[i];
    const Pt& q = poly[(i + 1) % poly.size()];
    area += p.x * q.y - q.x * p.y;
  }
  return std::fabs(area) * 0.5;
}

// quads: [n][4][2] doubles (LT, RT, RB, LB), score-sorted desc; alive:
// in/out byte mask. templ_area = stop-layer rect area.
void fipm_filter_overlaps(const double* quads, int n, uint8_t* alive,
                          double templ_area, double max_overlap) {
  auto q = [&](int i) { return (const Pt*)(quads + (size_t)i * 8); };
  for (int i = 0; i < n - 1; i++) {
    if (!alive[i]) continue;
    for (int j = i + 1; j < n; j++) {
      if (!alive[j]) continue;
      double inter = quad_intersection_area(q(i), q(j));
      bool contain = inter >= templ_area * (1.0 - 1e-6);
      if (contain || inter / templ_area > max_overlap) alive[j] = 0;
    }
  }
}

// ---------------------------------------------------------------------------
// Threaded batch loader: N worker threads decode BMPs into a ring of
// preallocated slots; the consumer takes filled slots in submission order.
// ---------------------------------------------------------------------------

struct LoaderJob {
  std::string path;
  int index;
};

struct LoaderResult {
  std::vector<uint8_t> data;
  int w = 0, h = 0, index = -1, ok = 0;
};

struct Loader {
  std::vector<std::thread> workers;
  std::queue<LoaderJob> jobs;
  std::mutex mu;
  std::condition_variable cv_job, cv_res;
  std::vector<LoaderResult> results;
  std::atomic<int> next_emit{0};
  bool done = false;

  void work() {
    for (;;) {
      LoaderJob job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_job.wait(lk, [&] { return done || !jobs.empty(); });
        if (jobs.empty()) return;
        job = jobs.front();
        jobs.pop();
      }
      int w = 0, h = 0;
      uint8_t* buf = fipm_bmp_load_gray(job.path.c_str(), &w, &h);
      {
        std::lock_guard<std::mutex> lk(mu);
        LoaderResult& r = results[job.index];
        if (buf) {
          r.data.assign(buf, buf + (size_t)w * h);
          r.w = w;
          r.h = h;
          r.ok = 1;
          free(buf);
        }
        r.index = job.index;
      }
      cv_res.notify_all();
    }
  }
};

void* fipm_loader_create(const char** paths, int n, int n_threads) {
  Loader* L = new Loader();
  L->results.resize(n);
  for (int i = 0; i < n; i++) L->jobs.push({paths[i], i});
  int nt = std::max(1, std::min(n_threads, 16));
  for (int t = 0; t < nt; t++) L->workers.emplace_back([L] { L->work(); });
  L->cv_job.notify_all();
  return L;
}

// Blocks until item `index` is decoded; returns 1 on success and copies
// into out (caller allocates w*h after calling fipm_loader_shape).
int fipm_loader_shape(void* handle, int index, int* w, int* h) {
  Loader* L = (Loader*)handle;
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_res.wait(lk, [&] { return L->results[index].index == index; });
  if (!L->results[index].ok) return 0;
  *w = L->results[index].w;
  *h = L->results[index].h;
  return 1;
}

int fipm_loader_take(void* handle, int index, uint8_t* out) {
  Loader* L = (Loader*)handle;
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_res.wait(lk, [&] { return L->results[index].index == index; });
  LoaderResult& r = L->results[index];
  if (!r.ok) return 0;
  memcpy(out, r.data.data(), r.data.size());
  return 1;
}

void fipm_loader_destroy(void* handle) {
  Loader* L = (Loader*)handle;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->done = true;
  }
  L->cv_job.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
