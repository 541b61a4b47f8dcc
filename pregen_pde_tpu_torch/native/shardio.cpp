// shardio — native shard I/O for the datagen streaming path.
//
// The native-runtime counterpart of the reference's compiled layer: where the
// reference JIT-builds CUDA ops via torch cpp_extension
// (CNO_Experiments/torch_utils/custom_ops.py:53-151), this framework
// JIT-builds this C++ library (see native/__init__.py) for the host-side I/O
// subsystem: a background-thread NPY shard writer with a bounded queue
// (double buffering: the TPU solves the next batch while the previous batch
// hits disk) and a fast NPY reader. No Python GIL on the write path.
//
// C ABI only — bound via ctypes (no pybind11 in this environment).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

std::string npy_header(const int64_t* shape, int ndim) {
  std::string dict = "{'descr': '<f4', 'fortran_order': False, 'shape': (";
  for (int i = 0; i < ndim; ++i) {
    dict += std::to_string(shape[i]);
    if (i + 1 < ndim) dict += ", ";
  }
  if (ndim == 1) dict += ",";  // 1-tuple needs the trailing comma
  dict += "), }";
  // pad so that magic(6)+ver(2)+hlen(2)+dict+'\n' is a multiple of 64
  size_t base = 6 + 2 + 2;
  size_t total = base + dict.size() + 1;
  size_t pad = (64 - (total % 64)) % 64;
  dict.append(pad, ' ');
  dict += '\n';

  std::string out;
  out.reserve(base + dict.size());
  out += "\x93NUMPY";
  out += '\x01';
  out += '\x00';
  uint16_t hlen = static_cast<uint16_t>(dict.size());
  out += static_cast<char>(hlen & 0xff);
  out += static_cast<char>((hlen >> 8) & 0xff);
  out += dict;
  return out;
}

int write_npy_file(const char* path, const float* data, const int64_t* shape,
                   int ndim) {
  int64_t count = 1;
  for (int i = 0; i < ndim; ++i) count *= shape[i];
  std::string header = npy_header(shape, ndim);
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  int ok = 0;
  if (std::fwrite(header.data(), 1, header.size(), f) != header.size()) ok = -2;
  if (ok == 0 && std::fwrite(data, sizeof(float), static_cast<size_t>(count), f) !=
                     static_cast<size_t>(count))
    ok = -3;
  if (std::fclose(f) != 0 && ok == 0) ok = -4;
  return ok;
}

struct Job {
  std::string path;
  std::vector<float> data;
  std::vector<int64_t> shape;
};

struct Writer {
  std::string dir, prefix;
  size_t max_depth;
  std::queue<Job> q;
  std::mutex m;
  std::condition_variable cv_space, cv_work;
  std::thread worker;
  std::atomic<bool> closing{false};
  std::atomic<int> error{0};
  std::atomic<int64_t> written{0};
  int next_idx = 0;

  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(m);
        cv_work.wait(lk, [&] { return !q.empty() || closing.load(); });
        if (q.empty()) {
          if (closing.load()) return;
          continue;
        }
        job = std::move(q.front());
        q.pop();
        cv_space.notify_all();
      }
      int rc = write_npy_file(job.path.c_str(), job.data.data(),
                              job.shape.data(),
                              static_cast<int>(job.shape.size()));
      if (rc != 0)
        error.store(rc);
      else
        written.fetch_add(job.shape.empty() ? 0 : job.shape[0]);
    }
  }
};

}  // namespace

extern "C" {

void* shard_writer_create(const char* dir, const char* prefix,
                          int queue_depth, int start_index) {
  auto* w = new Writer();
  w->dir = dir;
  w->prefix = prefix;
  w->max_depth = queue_depth > 0 ? static_cast<size_t>(queue_depth) : 2;
  w->next_idx = start_index > 0 ? start_index : 0;  // resume numbering
  w->worker = std::thread([w] { w->run(); });
  return w;
}

// Enqueue one float32 batch; blocks only when the queue is full. Returns the
// shard index, or a negative error code from a previous disk write.
int shard_writer_write(void* handle, const float* data, const int64_t* shape,
                       int ndim) {
  auto* w = static_cast<Writer*>(handle);
  if (int e = w->error.load()) return e;
  int64_t count = 1;
  for (int i = 0; i < ndim; ++i) count *= shape[i];
  Job job;
  job.shape.assign(shape, shape + ndim);
  job.data.assign(data, data + count);
  int idx;
  {
    std::unique_lock<std::mutex> lk(w->m);
    w->cv_space.wait(lk, [&] { return w->q.size() < w->max_depth; });
    idx = w->next_idx++;
    job.path = w->dir + "/" + w->prefix + "_batch_" + std::to_string(idx) + ".npy";
    w->q.push(std::move(job));
  }
  w->cv_work.notify_one();
  return idx;
}

// Drain the queue, join the worker, free the handle. Returns total
// trajectories written (shape[0] summed), or a negative error code.
int64_t shard_writer_close(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  {
    std::unique_lock<std::mutex> lk(w->m);
    w->cv_space.wait(lk, [&] { return w->q.empty(); });
  }
  w->closing.store(true);
  w->cv_work.notify_all();
  w->worker.join();
  int64_t result = w->error.load() ? w->error.load() : w->written.load();
  delete w;
  return result;
}

int npy_write(const char* path, const float* data, const int64_t* shape,
              int ndim) {
  return write_npy_file(path, data, shape, ndim);
}

// Parse an NPY v1/v2 float32 header; fills shape_out (max 8 dims), returns
// ndim, or negative on error / non-f32.
int npy_read_header(const char* path, int64_t* shape_out, int64_t* offset_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  unsigned char magic[8];
  if (std::fread(magic, 1, 8, f) != 8 || std::memcmp(magic, "\x93NUMPY", 6)) {
    std::fclose(f);
    return -2;
  }
  uint32_t hlen;
  if (magic[6] == 1) {
    unsigned char b[2];
    if (std::fread(b, 1, 2, f) != 2) { std::fclose(f); return -3; }
    hlen = b[0] | (b[1] << 8);
  } else {
    unsigned char b[4];
    if (std::fread(b, 1, 4, f) != 4) { std::fclose(f); return -3; }
    hlen = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
  }
  std::string dict(hlen, '\0');
  if (std::fread(dict.data(), 1, hlen, f) != hlen) { std::fclose(f); return -3; }
  long data_off = std::ftell(f);
  std::fclose(f);
  if (dict.find("'<f4'") == std::string::npos) return -4;
  if (dict.find("'fortran_order': False") == std::string::npos) return -5;
  size_t lp = dict.find('(');
  size_t rp = dict.find(')', lp);
  if (lp == std::string::npos || rp == std::string::npos) return -6;
  std::string tup = dict.substr(lp + 1, rp - lp - 1);
  int ndim = 0;
  const char* p = tup.c_str();
  while (*p && ndim < 8) {
    while (*p == ' ' || *p == ',') ++p;
    if (!*p) break;
    shape_out[ndim++] = std::strtoll(p, const_cast<char**>(&p), 10);
  }
  *offset_out = data_off;
  return ndim;
}

// Read the full float32 payload into out (caller-allocated, out_size floats).
int64_t npy_read_f32(const char* path, float* out, int64_t out_size) {
  int64_t shape[8];
  int64_t offset;
  int ndim = npy_read_header(path, shape, &offset);
  if (ndim < 0) return ndim;
  int64_t count = 1;
  for (int i = 0; i < ndim; ++i) count *= shape[i];
  if (count > out_size) return -7;
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, static_cast<long>(offset), SEEK_SET);
  int64_t got = static_cast<int64_t>(
      std::fread(out, sizeof(float), static_cast<size_t>(count), f));
  std::fclose(f);
  return got == count ? count : -8;
}

}  // extern "C"
