// odin_io — native corpus IO engine.
//
// The reference delegates its IO-heavy corpus work to Python multiprocessing
// (odin/utils/mpi.py) and external binaries (sox/soundfile).  Here the host
// runtime gets a native engine: RIFF/PCM wav decoding and padded-batch
// packing run in C++ (multi-threaded where cores exist), handing the device
// pipeline a ready (N, T) float32 block with lengths — no per-file Python
// overhead on the hot ingest path.
//
// A copy of the JAX package's native/odin_io.cpp for the PyTorch port.
// Build: g++ -O3 -shared -fPIC -o libodin_io.so odin_io.cpp -lpthread
// (odin_tpu_torch/_build.py's build_host, into build/odin_tpu_torch/ at
// first use).  Exposed via ctypes in odin_tpu_torch/native.py.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>
#include <atomic>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// RIFF/WAVE PCM decoder (8/16/32-bit int + 32-bit float, mono-mix)
// Returns number of samples written to `out` (capacity `max_samples`),
// sets *sr_out; returns -1 on parse error.
// ---------------------------------------------------------------------------
static int decode_wav_buffer(const uint8_t* buf, int64_t n_bytes,
                             float* out, int64_t max_samples,
                             int32_t* sr_out) {
  if (n_bytes < 44 || memcmp(buf, "RIFF", 4) || memcmp(buf + 8, "WAVE", 4))
    return -1;
  int64_t pos = 12;
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t sr = 0;
  const uint8_t* data = nullptr;
  uint32_t data_len = 0;
  while (pos + 8 <= n_bytes) {
    const char* id = reinterpret_cast<const char*>(buf + pos);
    uint32_t sz;
    memcpy(&sz, buf + pos + 4, 4);
    if (!memcmp(id, "fmt ", 4) && pos + 8 + 16 <= n_bytes) {
      memcpy(&fmt, buf + pos + 8, 2);
      memcpy(&channels, buf + pos + 10, 2);
      memcpy(&sr, buf + pos + 12, 4);
      memcpy(&bits, buf + pos + 22, 2);
    } else if (!memcmp(id, "data", 4)) {
      data = buf + pos + 8;
      data_len = static_cast<uint32_t>(
          std::min<int64_t>(sz, n_bytes - pos - 8));
    }
    pos += 8 + sz + (sz & 1);
  }
  if (!data || !channels || !bits || (fmt != 1 && fmt != 3)) return -1;
  const int64_t bytes_per = bits / 8;
  const int64_t frames = data_len / (bytes_per * channels);
  const int64_t n = std::min<int64_t>(frames, max_samples);
  const float inv_ch = 1.0f / channels;
  for (int64_t i = 0; i < n; ++i) {
    float acc = 0.0f;
    for (int c = 0; c < channels; ++c) {
      const uint8_t* p = data + (i * channels + c) * bytes_per;
      float v = 0.0f;
      if (fmt == 3 && bits == 32) {           // float32
        memcpy(&v, p, 4);
      } else if (bits == 16) {
        int16_t s;
        memcpy(&s, p, 2);
        v = s / 32768.0f;
      } else if (bits == 32) {
        int32_t s;
        memcpy(&s, p, 4);
        v = static_cast<float>(s / 2147483648.0);
      } else if (bits == 8) {                 // unsigned 8-bit
        v = (p[0] - 128) / 128.0f;
      } else {
        return -1;
      }
      acc += v;
    }
    out[i] = acc * inv_ch;
  }
  *sr_out = static_cast<int32_t>(sr);
  return static_cast<int>(n);
}

int odin_decode_wav(const uint8_t* buf, int64_t n_bytes, float* out,
                    int64_t max_samples, int32_t* sr_out) {
  return decode_wav_buffer(buf, n_bytes, out, max_samples, sr_out);
}

// ---------------------------------------------------------------------------
// Batch packer: decode `n_files` wav files into a zero-padded (n, max_samples)
// float32 block + per-row valid lengths + sample rates, fanned over threads.
// Returns 0 on success; rows that fail to parse get length 0.
// ---------------------------------------------------------------------------
int odin_pack_batch(const char** paths, int32_t n_files, float* out,
                    int64_t max_samples, int32_t* lengths, int32_t* srs,
                    int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    std::vector<uint8_t> buf;
    while (true) {
      int32_t i = next.fetch_add(1);
      if (i >= n_files) break;
      lengths[i] = 0;
      srs[i] = 0;
      FILE* f = fopen(paths[i], "rb");
      if (!f) continue;
      fseek(f, 0, SEEK_END);
      long sz = ftell(f);
      fseek(f, 0, SEEK_SET);
      buf.resize(sz);
      size_t got = fread(buf.data(), 1, sz, f);
      fclose(f);
      if (static_cast<long>(got) != sz) continue;
      float* row = out + static_cast<int64_t>(i) * max_samples;
      memset(row, 0, max_samples * sizeof(float));
      int32_t sr = 0;
      int n = decode_wav_buffer(buf.data(), sz, row, max_samples, &sr);
      if (n > 0) {
        lengths[i] = n;
        srs[i] = sr;
      }
    }
  };
  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Strided framing: (n_samples,) -> (n_frames, frame_length) with window
// multiply fused — the host-side fallback of the device framing kernel.
// ---------------------------------------------------------------------------
int64_t odin_frame_signal(const float* y, int64_t n_samples,
                          const float* window, int32_t frame_length,
                          int32_t step_length, float* out_frames,
                          int64_t max_frames) {
  if (n_samples < frame_length) return 0;
  int64_t n_frames = 1 + (n_samples - frame_length) / step_length;
  n_frames = std::min(n_frames, max_frames);
  for (int64_t t = 0; t < n_frames; ++t) {
    const float* src = y + t * step_length;
    float* dst = out_frames + t * frame_length;
    if (window) {
      for (int32_t k = 0; k < frame_length; ++k) dst[k] = src[k] * window[k];
    } else {
      memcpy(dst, src, frame_length * sizeof(float));
    }
  }
  return n_frames;
}

// ---------------------------------------------------------------------------
// Threaded indexed gather: out[j] = src[idx[j]] for fixed-size items — the
// batch-assembly hot path of the host input pipeline (numpy fancy indexing
// is a single-threaded per-row copy; this fans the memcpys over threads).
// Dtype-agnostic: operates on raw bytes.
// ---------------------------------------------------------------------------
int odin_gather(const uint8_t* src, int64_t item_bytes, const int64_t* idx,
                int64_t n_idx, uint8_t* out, int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next(0);
  const int64_t chunk = 16;  // rows per grab — keeps the atomic cold
  auto worker = [&]() {
    while (true) {
      int64_t j0 = next.fetch_add(chunk);
      if (j0 >= n_idx) break;
      int64_t j1 = std::min(j0 + chunk, n_idx);
      for (int64_t j = j0; j < j1; ++j)
        memcpy(out + j * item_bytes, src + idx[j] * item_bytes, item_bytes);
    }
  };
  if (n_threads == 1 || n_idx < 64) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
  return 0;
}

}  // extern "C"
