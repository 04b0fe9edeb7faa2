// WAV decode and encode for the data loader of diffsep_tpu_torch.
//
// The port's copy of native/wavio.cpp: PCM16/PCM24/PCM32/float32 WAV into
// planar float32 [-1, 1] buffers, and a batch of files decoded by a pool
// of threads, so that the loader's host reads keep pace with the card.
// data/native_io.py builds it with the host C++ compiler at first use and
// binds its plain C ABI with ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct WavInfo {
  uint16_t format = 0;       // 1 = PCM, 3 = IEEE float
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  uint32_t data_offset = 0;  // byte offset of sample data
  uint32_t data_size = 0;    // bytes of sample data
};

bool parse_header(const uint8_t* buf, size_t len, WavInfo* info) {
  if (len < 44 || memcmp(buf, "RIFF", 4) != 0 || memcmp(buf + 8, "WAVE", 4) != 0)
    return false;
  size_t pos = 12;
  bool have_fmt = false;
  while (pos + 8 <= len) {
    const char* id = reinterpret_cast<const char*>(buf + pos);
    uint32_t chunk_size;
    memcpy(&chunk_size, buf + pos + 4, 4);
    if (memcmp(id, "fmt ", 4) == 0 && chunk_size >= 16) {
      memcpy(&info->format, buf + pos + 8, 2);
      memcpy(&info->channels, buf + pos + 10, 2);
      memcpy(&info->sample_rate, buf + pos + 12, 4);
      memcpy(&info->bits, buf + pos + 22, 2);
      have_fmt = true;
    } else if (memcmp(id, "data", 4) == 0) {
      info->data_offset = static_cast<uint32_t>(pos + 8);
      info->data_size = chunk_size;
      if (info->data_offset + info->data_size > len)
        info->data_size = static_cast<uint32_t>(len - info->data_offset);
      return have_fmt;
    }
    pos += 8 + chunk_size + (chunk_size & 1);  // chunks are word-aligned
  }
  return false;
}

// Decode interleaved samples to planar float32 (channel-major).
void decode_samples(const uint8_t* data, const WavInfo& info, float* out,
                    int64_t n_frames) {
  const int c = info.channels;
  if (info.format == 3 && info.bits == 32) {
    const float* src = reinterpret_cast<const float*>(data);
    for (int64_t i = 0; i < n_frames; ++i)
      for (int ch = 0; ch < c; ++ch) out[ch * n_frames + i] = src[i * c + ch];
  } else if (info.bits == 16) {
    const int16_t* src = reinterpret_cast<const int16_t*>(data);
    constexpr float k = 1.0f / 32768.0f;
    for (int64_t i = 0; i < n_frames; ++i)
      for (int ch = 0; ch < c; ++ch)
        out[ch * n_frames + i] = src[i * c + ch] * k;
  } else if (info.bits == 32) {
    const int32_t* src = reinterpret_cast<const int32_t*>(data);
    constexpr float k = 1.0f / 2147483648.0f;
    for (int64_t i = 0; i < n_frames; ++i)
      for (int ch = 0; ch < c; ++ch)
        out[ch * n_frames + i] = src[i * c + ch] * k;
  } else if (info.bits == 24) {
    constexpr float k = 1.0f / 8388608.0f;
    for (int64_t i = 0; i < n_frames; ++i)
      for (int ch = 0; ch < c; ++ch) {
        const uint8_t* p = data + (i * c + ch) * 3;
        int32_t v = (p[0] << 8) | (p[1] << 16) | (p[2] << 24);
        out[ch * n_frames + i] = (v >> 8) * k;
      }
  }
}

std::vector<uint8_t> read_file(const char* path) {
  std::vector<uint8_t> buf;
  FILE* f = fopen(path, "rb");
  if (!f) return buf;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  buf.resize(sz);
  if (fread(buf.data(), 1, sz, f) != static_cast<size_t>(sz)) buf.clear();
  fclose(f);
  return buf;
}

}  // namespace

extern "C" {

// Query (n_channels, n_frames, sample_rate); returns 0 on success.
int wav_info(const char* path, int32_t* channels, int64_t* n_frames,
             int32_t* sample_rate) {
  auto buf = read_file(path);
  WavInfo info;
  if (buf.empty() || !parse_header(buf.data(), buf.size(), &info)) return -1;
  if (info.channels == 0 || info.bits == 0) return -2;
  *channels = info.channels;
  *n_frames = info.data_size / (info.channels * info.bits / 8);
  *sample_rate = static_cast<int32_t>(info.sample_rate);
  return 0;
}

// Decode into caller-allocated planar float32 buffer (channels, n_frames).
int wav_read(const char* path, float* out, int64_t n_frames) {
  auto buf = read_file(path);
  WavInfo info;
  if (buf.empty() || !parse_header(buf.data(), buf.size(), &info)) return -1;
  decode_samples(buf.data() + info.data_offset, info, out, n_frames);
  return 0;
}

// Decode a batch of equal-role files concurrently. paths: array of C
// strings; outs: array of per-file output pointers; lens: per-file frame
// counts. Returns number of failures.
int wav_read_batch(const char** paths, float** outs, const int64_t* lens,
                   int n_files, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<int> failures(n_threads, 0);
  std::vector<std::thread> workers;
  for (int t = 0; t < n_threads; ++t) {
    workers.emplace_back([&, t]() {
      for (int i = t; i < n_files; i += n_threads)
        if (wav_read(paths[i], outs[i], lens[i]) != 0) failures[t]++;
    });
  }
  for (auto& w : workers) w.join();
  int total = 0;
  for (int f : failures) total += f;
  return total;
}

// Encode planar float32 (channels, n_frames) to PCM16 WAV.
int wav_write(const char* path, const float* data, int32_t channels,
              int64_t n_frames, int32_t sample_rate) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  uint32_t data_size = static_cast<uint32_t>(n_frames * channels * 2);
  uint32_t riff_size = 36 + data_size;
  uint16_t fmt = 1, bits = 16;
  uint16_t block = channels * 2;
  uint32_t byterate = sample_rate * block;
  fwrite("RIFF", 1, 4, f);
  fwrite(&riff_size, 4, 1, f);
  fwrite("WAVEfmt ", 1, 8, f);
  uint32_t fmt_size = 16;
  fwrite(&fmt_size, 4, 1, f);
  fwrite(&fmt, 2, 1, f);
  uint16_t ch16 = static_cast<uint16_t>(channels);
  fwrite(&ch16, 2, 1, f);
  fwrite(&sample_rate, 4, 1, f);
  fwrite(&byterate, 4, 1, f);
  fwrite(&block, 2, 1, f);
  fwrite(&bits, 2, 1, f);
  fwrite("data", 1, 4, f);
  fwrite(&data_size, 4, 1, f);
  std::vector<int16_t> row(channels);
  for (int64_t i = 0; i < n_frames; ++i) {
    for (int ch = 0; ch < channels; ++ch) {
      float v = data[ch * n_frames + i];
      v = v > 1.0f ? 1.0f : (v < -1.0f ? -1.0f : v);
      row[ch] = static_cast<int16_t>(v * 32767.0f);
    }
    fwrite(row.data(), 2, channels, f);
  }
  fclose(f);
  return 0;
}

}  // extern "C"
