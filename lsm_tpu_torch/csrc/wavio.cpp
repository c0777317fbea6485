// Native batch WAV decoder for lsm_tpu_torch's data loader: a copy of the
// JAX package's native/wavio.cpp below this comment (tests/test_torch_native.py
// holds the two equal), so the port has no file of that package to build.
//
// It decodes many RIFF/WAVE files in parallel worker threads, downmixes to
// mono, resamples to the target rate with a windowed-sinc (Kaiser) kernel
// (resample_sinc below) and pads or truncates into one contiguous
// (n, target_len) batch on a float32, int16 or mu-law wire. It is built
// with g++ at first use by ops/_build.py (`wavio_library`) and bound with
// ctypes in io/native.py; io/wav.py falls back to its NumPy decoder where
// no compiler exists.
//
// Supported encodings: PCM 8/16/24/32-bit and IEEE float32/64, any channel
// count. Per-file failures set ok[i] = 0 and zero the row instead of
// aborting the batch.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Chunk {
  const uint8_t* data;
  size_t size;
};

bool read_file(const char* path, std::vector<uint8_t>& buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  if (n < 0) {
    std::fclose(f);
    return false;
  }
  std::fseek(f, 0, SEEK_SET);
  buf.resize(static_cast<size_t>(n));
  size_t got = n ? std::fread(buf.data(), 1, static_cast<size_t>(n), f) : 0;
  std::fclose(f);
  return got == static_cast<size_t>(n);
}

inline uint32_t rd_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}
inline uint16_t rd_u16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}

struct WavInfo {
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  const uint8_t* data = nullptr;
  size_t data_size = 0;
};

// RIFF chunk walk shared by the f32 decoder and the PCM16 fast path.
bool parse_wav(const std::vector<uint8_t>& raw, WavInfo* info) {
  if (raw.size() < 44 || std::memcmp(raw.data(), "RIFF", 4) != 0 ||
      std::memcmp(raw.data() + 8, "WAVE", 4) != 0)
    return false;
  size_t pos = 12;
  while (pos + 8 <= raw.size()) {
    const uint8_t* cid = raw.data() + pos;
    uint32_t size = rd_u32(raw.data() + pos + 4);
    if (pos + 8 + size > raw.size()) size = static_cast<uint32_t>(raw.size() - pos - 8);
    const uint8_t* body = raw.data() + pos + 8;
    if (std::memcmp(cid, "fmt ", 4) == 0 && size >= 16) {
      info->fmt = rd_u16(body);
      info->channels = rd_u16(body + 2);
      info->rate = rd_u32(body + 4);
      info->bits = rd_u16(body + 14);
      if (info->fmt == 0xFFFE) {
        // EXTENSIBLE: the real format code is the first two bytes of the
        // SubFormat GUID at offset 24 (cbSize-22 extension). Assuming
        // PCM would decode extensible IEEE-float files as int32 noise
        // (mirrors lsm_tpu/io/wav.py decode_wav).
        info->fmt = size >= 26 ? rd_u16(body + 24) : 0;
      }
    } else if (std::memcmp(cid, "data", 4) == 0) {
      info->data = body;
      info->data_size = size;
    }
    pos += 8 + size + (size & 1);
  }
  return info->data && info->channels != 0 && info->rate != 0;
}

// Decode to mono float32 at the file's native rate. Returns false on error.
bool decode_wav_mono(const std::vector<uint8_t>& raw, std::vector<float>& out,
                     uint32_t* rate_out) {
  WavInfo w;
  if (!parse_wav(raw, &w)) return false;
  const uint16_t fmt = w.fmt, channels = w.channels, bits = w.bits;
  const uint32_t rate = w.rate;
  const uint8_t* data = w.data;

  size_t bytes_per = bits / 8;
  if (bytes_per == 0) return false;
  size_t n_frames = w.data_size / (bytes_per * channels);
  out.resize(n_frames);
  const float inv_ch = 1.0f / static_cast<float>(channels);

  if (fmt == 1 && bits == 16) {
    for (size_t i = 0; i < n_frames; ++i) {
      float acc = 0.0f;
      const uint8_t* p = data + i * 2 * channels;
      for (int c = 0; c < channels; ++c) {
        int16_t v = static_cast<int16_t>(rd_u16(p + 2 * c));
        acc += static_cast<float>(v);
      }
      out[i] = acc * inv_ch / 32768.0f;
    }
  } else if (fmt == 1 && bits == 8) {
    for (size_t i = 0; i < n_frames; ++i) {
      float acc = 0.0f;
      const uint8_t* p = data + i * channels;
      for (int c = 0; c < channels; ++c)
        acc += static_cast<float>(p[c]) - 128.0f;
      out[i] = acc * inv_ch / 128.0f;
    }
  } else if (fmt == 1 && bits == 24) {
    for (size_t i = 0; i < n_frames; ++i) {
      float acc = 0.0f;
      const uint8_t* p = data + i * 3 * channels;
      for (int c = 0; c < channels; ++c) {
        const uint8_t* q = p + 3 * c;
        int32_t v = static_cast<int32_t>(q[0]) | (static_cast<int32_t>(q[1]) << 8) |
                    (static_cast<int32_t>(q[2]) << 16);
        if (v >= (1 << 23)) v -= (1 << 24);
        acc += static_cast<float>(v);
      }
      out[i] = acc * inv_ch / 8388608.0f;
    }
  } else if (fmt == 1 && bits == 32) {
    for (size_t i = 0; i < n_frames; ++i) {
      float acc = 0.0f;
      const uint8_t* p = data + i * 4 * channels;
      for (int c = 0; c < channels; ++c) {
        int32_t v = static_cast<int32_t>(rd_u32(p + 4 * c));
        acc += static_cast<float>(v);
      }
      out[i] = acc * inv_ch / 2147483648.0f;
    }
  } else if (fmt == 3 && bits == 32) {
    for (size_t i = 0; i < n_frames; ++i) {
      float acc = 0.0f;
      const uint8_t* p = data + i * 4 * channels;
      for (int c = 0; c < channels; ++c) {
        float v;
        std::memcpy(&v, p + 4 * c, 4);
        acc += v;
      }
      out[i] = acc * inv_ch;
    }
  } else if (fmt == 3 && bits == 64) {
    for (size_t i = 0; i < n_frames; ++i) {
      double acc = 0.0;
      const uint8_t* p = data + i * 8 * channels;
      for (int c = 0; c < channels; ++c) {
        double v;
        std::memcpy(&v, p + 8 * c, 8);
        acc += v;
      }
      out[i] = static_cast<float>(acc * inv_ch);
    }
  } else {
    return false;
  }
  *rate_out = rate;
  return true;
}

// Kaiser-windowed-sinc resample matching lsm_tpu.io.wav.resample_sinc
// (soxr_hq-class quality; keep constants in sync with io/wav.py).
constexpr double kSincZeros = 16.0;
constexpr double kSincBeta = 12.26526;
constexpr double kSincRolloff = 0.945;

// Modified Bessel I0 via the power series (converges to double precision
// for the beta range used here; same values as numpy.i0).
double bessel_i0(double x) {
  double sum = 1.0, term = 1.0;
  double half_x = 0.5 * x;
  for (int k = 1; k < 64; ++k) {
    double t = half_x / k;
    term *= t * t;
    sum += term;
    if (term < sum * 1e-17) break;
  }
  return sum;
}

inline double sinc(double t) {
  if (t == 0.0) return 1.0;
  double p = M_PI * t;
  return std::sin(p) / p;
}

void resample_sinc(const std::vector<float>& x, uint32_t src, uint32_t dst,
                   std::vector<float>& y) {
  if (src == dst) {
    y = x;
    return;
  }
  double ratio = static_cast<double>(dst) / src;
  size_t n_in = x.size();
  // Half-to-even rounding to match Python round() in the NumPy twin
  // (llround rounds half away from zero and diverges at exact .5).
  size_t n_out =
      static_cast<size_t>(std::nearbyint(static_cast<double>(n_in) * ratio));
  if (n_out <= 1 || n_in <= 1) {
    y.assign(n_out, 0.0f);
    return;
  }
  double fc = (ratio < 1.0 ? ratio : 1.0) * kSincRolloff;
  double half = kSincZeros / fc;
  double inv_i0_beta = 1.0 / bessel_i0(kSincBeta);
  int n_taps = static_cast<int>(std::ceil(2.0 * half));
  y.resize(n_out);
  for (size_t i = 0; i < n_out; ++i) {
    double pos = static_cast<double>(i) / ratio;
    long lo = static_cast<long>(std::floor(pos - half)) + 1;
    double acc = 0.0;
    for (int k = 0; k < n_taps; ++k) {
      long j = lo + k;
      if (j < 0 || j >= static_cast<long>(n_in)) continue;
      double t = pos - static_cast<double>(j);
      double u = t / half;
      double arg = 1.0 - u * u;
      if (arg < 0.0) arg = 0.0;
      double w = fc * sinc(fc * t) * bessel_i0(kSincBeta * std::sqrt(arg)) *
                 inv_i0_beta;
      acc += w * static_cast<double>(x[j]);
    }
    y[i] = static_cast<float>(acc);
  }
}

void process_one(const char* path, int sample_rate, double duration,
                 int target_len, float* row, int* ok) {
  std::vector<uint8_t> raw;
  std::vector<float> mono, res;
  std::memset(row, 0, sizeof(float) * target_len);
  *ok = 0;
  if (!read_file(path, raw)) return;
  uint32_t rate = 0;
  if (!decode_wav_mono(raw, mono, &rate)) return;
  // Truncate at the source rate first (librosa duration semantics).
  size_t max_src = static_cast<size_t>(duration * rate);
  if (mono.size() > max_src) mono.resize(max_src);
  resample_sinc(mono, rate, static_cast<uint32_t>(sample_rate), res);
  size_t n = res.size() < static_cast<size_t>(target_len)
                 ? res.size()
                 : static_cast<size_t>(target_len);
  std::memcpy(row, res.data(), n * sizeof(float));
  *ok = 1;
}

void process_one_i16(const char* path, int sample_rate, double duration,
                     int target_len, int16_t* row, int* ok) {
  // int16 PCM output mode: the device wire for the cold
  // disk->predictions path (featurize_batch converts with the exact
  // /32768 on device — half the H2D bytes). For the corpus's native
  // format (mono PCM16 at the target rate) the row is a straight
  // sample copy with NO float round-trip; everything else decodes
  // through the f32 path and quantizes with the same truncate-toward-
  // zero convention as io/wav.py:to_pcm16_wire (bit-identical batches
  // from either backend).
  std::vector<uint8_t> raw;
  std::memset(row, 0, sizeof(int16_t) * target_len);
  *ok = 0;
  if (!read_file(path, raw)) return;
  WavInfo w;
  if (!parse_wav(raw, &w)) return;
  if (w.fmt == 1 && w.bits == 16 && w.channels == 1 &&
      w.rate == static_cast<uint32_t>(sample_rate)) {
    size_t n_frames = w.data_size / 2;
    size_t max_src = static_cast<size_t>(duration * w.rate);
    if (n_frames > max_src) n_frames = max_src;
    if (n_frames > static_cast<size_t>(target_len))
      n_frames = static_cast<size_t>(target_len);
    // Little-endian host (x86/ARM): raw samples ARE the row bytes.
    std::memcpy(row, w.data, n_frames * 2);
    *ok = 1;
    return;
  }
  std::vector<float> mono, res;
  uint32_t rate = 0;
  if (!decode_wav_mono(raw, mono, &rate)) return;
  size_t max_src = static_cast<size_t>(duration * rate);
  if (mono.size() > max_src) mono.resize(max_src);
  resample_sinc(mono, rate, static_cast<uint32_t>(sample_rate), res);
  size_t n = res.size() < static_cast<size_t>(target_len)
                 ? res.size()
                 : static_cast<size_t>(target_len);
  for (size_t i = 0; i < n; ++i) {
    float v = res[i] * 32768.0f;
    if (v > 32767.0f) v = 32767.0f;
    if (v < -32768.0f) v = -32768.0f;
    row[i] = static_cast<int16_t>(v);  // truncate toward zero, like astype
  }
  *ok = 1;
}

// G.711 mu-law encode via a 64 KB int16 lookup table, built once with the
// exact CCITT algorithm the Python twin uses (lsm_tpu/ops/ulaw.py:
// encode_ulaw — clip +-32635, bias 0x84, 8 exponent segments, complement).
// One table lookup per sample keeps the PCM16 fast path a streaming pass
// over the raw file bytes: no float round-trip, ~1 byte out per 2 in.
const uint8_t* ulaw_table() {
  static uint8_t table[65536];
  static std::once_flag once;
  std::call_once(once, []() {
    for (int i = 0; i < 65536; ++i) {
      int32_t x = static_cast<int16_t>(i);
      int sign = x < 0 ? 0x80 : 0;
      int32_t mag = x < 0 ? -x : x;
      if (mag > 32635) mag = 32635;
      mag += 0x84;
      int exp = 7;
      for (int mask = 0x4000; (mag & mask) == 0 && exp > 0; mask >>= 1) --exp;
      int mant = (mag >> (exp + 3)) & 0x0F;
      table[i] = static_cast<uint8_t>(~(sign | (exp << 4) | mant));
    }
  });
  return table;
}

void process_one_ulaw(const char* path, int sample_rate, double duration,
                      int target_len, uint8_t* row, int* ok) {
  // uint8 G.711 mu-law output mode: the bandwidth-constrained device wire
  // (quarter of f32, half of int16; featurize_batch decodes on device via
  // ops/ulaw.py:decode_ulaw_device). LOSSY (~38 dB SNR for speech) but
  // measured accuracy-neutral end to end (tests/test_ulaw.py, docs/
  // VALIDATION.md "Streaming serving ingest"); the lossless int16 wire
  // stays the default. Byte-identical to encode_ulaw(<int16 wire>) from
  // either backend: PCM16-at-rate files stream through the LUT directly,
  // everything else decodes f32 and quantizes with the to_pcm16_wire
  // convention first.
  const uint8_t* lut = ulaw_table();
  std::vector<uint8_t> raw;
  // Zero int16 PCM encodes to mu-law byte 0xFF, so padding is 0xFF too
  // (decode(0xFF) == 0 — the silent-padding contract of io/wav.py).
  std::memset(row, 0xFF, target_len);
  *ok = 0;
  if (!read_file(path, raw)) return;
  WavInfo w;
  if (!parse_wav(raw, &w)) return;
  if (w.fmt == 1 && w.bits == 16 && w.channels == 1 &&
      w.rate == static_cast<uint32_t>(sample_rate)) {
    size_t n_frames = w.data_size / 2;
    size_t max_src = static_cast<size_t>(duration * w.rate);
    if (n_frames > max_src) n_frames = max_src;
    if (n_frames > static_cast<size_t>(target_len))
      n_frames = static_cast<size_t>(target_len);
    for (size_t i = 0; i < n_frames; ++i)
      row[i] = lut[rd_u16(w.data + 2 * i)];
    *ok = 1;
    return;
  }
  std::vector<float> mono, res;
  uint32_t rate = 0;
  if (!decode_wav_mono(raw, mono, &rate)) return;
  size_t max_src = static_cast<size_t>(duration * rate);
  if (mono.size() > max_src) mono.resize(max_src);
  resample_sinc(mono, rate, static_cast<uint32_t>(sample_rate), res);
  size_t n = res.size() < static_cast<size_t>(target_len)
                 ? res.size()
                 : static_cast<size_t>(target_len);
  for (size_t i = 0; i < n; ++i) {
    float v = res[i] * 32768.0f;
    if (v > 32767.0f) v = 32767.0f;
    if (v < -32768.0f) v = -32768.0f;
    row[i] = lut[static_cast<uint16_t>(static_cast<int16_t>(v))];
  }
  *ok = 1;
}

// Shared dynamic-scheduling worker pool for the batch entry points.
template <typename Fn>
int run_batch(int n, int n_threads, int* ok, Fn&& per_item) {
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads > n) n_threads = n > 0 ? n : 1;
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      per_item(i);
    }
  };
  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  int n_ok = 0;
  for (int i = 0; i < n; ++i) n_ok += ok[i];
  return n_ok;
}

}  // namespace

extern "C" {

// Decode `n` files into out[n * target_len]; ok[i] = 1 on success.
// Returns the number of successfully decoded files.
int wavio_decode_batch(const char** paths, int n, int sample_rate,
                       double duration, int target_len, float* out, int* ok,
                       int n_threads) {
  return run_batch(n, n_threads, ok, [&](int i) {
    process_one(paths[i], sample_rate, duration, target_len,
                out + static_cast<size_t>(i) * target_len, ok + i);
  });
}

// int16-wire variant of wavio_decode_batch (optional symbol: older .so
// builds lack it and callers fall back to the f32 path + host convert).
int wavio_decode_batch_i16(const char** paths, int n, int sample_rate,
                           double duration, int target_len, int16_t* out,
                           int* ok, int n_threads) {
  return run_batch(n, n_threads, ok, [&](int i) {
    process_one_i16(paths[i], sample_rate, duration, target_len,
                    out + static_cast<size_t>(i) * target_len, ok + i);
  });
}

// uint8 G.711 mu-law wire variant (optional symbol, like _i16): quarter of
// the f32 H2D bytes for the bandwidth-constrained cold path; lossy — the
// int16 wire remains the bit-transparent default.
int wavio_decode_batch_ulaw(const char** paths, int n, int sample_rate,
                            double duration, int target_len, uint8_t* out,
                            int* ok, int n_threads) {
  ulaw_table();  // build once before the workers race on it
  return run_batch(n, n_threads, ok, [&](int i) {
    process_one_ulaw(paths[i], sample_rate, duration, target_len,
                     out + static_cast<size_t>(i) * target_len, ok + i);
  });
}

int wavio_abi_version() { return 1; }

}  // extern "C"
