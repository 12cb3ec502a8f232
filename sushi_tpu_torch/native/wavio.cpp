// Native WAV ingest: RIFF parse + channel downmix + nearest-neighbor
// downsample, fused in one streaming pass.
//
// This is the framework's native equivalent of the reference's hot ingest
// loop (Sushi's wav.py:104-162, which leans on OpenCV's C++ resize
// and NumPy's C core).  Exposed through a plain C ABI consumed via ctypes;
// sushi_tpu_torch/media/stream.py falls back to the NumPy path when the library
// is unavailable.
//
// Semantics (must match the Python path bit-for-bit):
//  * frames are read in 1-second chunks;
//  * each chunk downmixes N channels to mono by float32 averaging;
//  * each chunk is resampled to round(chunk_frames * rate_ratio) samples,
//    picking source index floor(dst * chunk_len / dst_len) computed in
//    double (OpenCV INTER_NEAREST arithmetic);
//  * output is written at out[padding .. padding + total_written).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <string>
#include <vector>

namespace {

constexpr uint16_t kFormatPcm = 0x0001;
constexpr uint16_t kFormatFloat = 0x0003;
constexpr uint16_t kFormatExtensible = 0xFFFE;

struct WavHeader {
  uint16_t channels = 0;
  uint32_t framerate = 0;
  uint16_t sample_width = 0;  // bytes
  bool float_samples = false;
  int64_t frames_count = 0;
  int64_t data_offset = 0;
};

int64_t file_size_of(std::FILE* file) {
  const int64_t pos = std::ftell(file);
  std::fseek(file, 0, SEEK_END);
  const int64_t size = std::ftell(file);
  std::fseek(file, pos, SEEK_SET);
  return size;
}

// returns 0 on success, negative error code otherwise
int parse_header(std::FILE* file, WavHeader* header) {
  char four[4];
  uint32_t chunk_size = 0;
  if (std::fread(four, 1, 4, file) != 4 || std::memcmp(four, "RIFF", 4) != 0) return -1;
  if (std::fread(&chunk_size, 4, 1, file) != 1) return -1;
  if (std::fread(four, 1, 4, file) != 4 || std::memcmp(four, "WAVE", 4) != 0) return -2;

  const int64_t total_size = file_size_of(file);
  bool fmt_read = false;
  while (std::fread(four, 1, 4, file) == 4 && std::fread(&chunk_size, 4, 1, file) == 1) {
    if (std::memcmp(four, "fmt ", 4) == 0) {
      if (chunk_size < 16) return -3;
      struct {
        uint16_t format_tag, channels;
        uint32_t framerate, byte_rate;
        uint16_t block_align, bits;
      } fmt;
      if (std::fread(&fmt, 16, 1, file) != 1) return -3;
      if (fmt.format_tag != kFormatPcm && fmt.format_tag != kFormatExtensible &&
          fmt.format_tag != kFormatFloat)
        return -4;
      uint16_t effective_tag = fmt.format_tag;
      uint32_t consumed = 16;
      if (fmt.format_tag == kFormatExtensible && chunk_size >= 26) {
        // effective format = first word of the SubFormat GUID (offset 24,
        // after cbSize + wValidBitsPerSample + dwChannelMask) — mirrors
        // riff.py so both ingest paths classify float WAVs identically
        uint8_t ext[10];
        if (std::fread(ext, 1, 10, file) != 10) return -3;
        effective_tag = static_cast<uint16_t>(ext[8] | (ext[9] << 8));
        if (effective_tag != kFormatPcm && effective_tag != kFormatFloat) return -4;
        consumed = 26;
      }
      header->float_samples = effective_tag == kFormatFloat;
      header->channels = fmt.channels;
      header->framerate = fmt.framerate;
      header->sample_width = (fmt.bits + 7) / 8;
      if (header->float_samples && header->sample_width != 4) return -4;
      // widths downmix() cannot decode (e.g. 8-bit PCM) must fail the
      // probe so the caller falls back to the Python path's loud
      // "Unsupported sample width" error instead of all-zero audio
      if (header->sample_width < 2 || header->sample_width > 4) return -4;
      std::fseek(file, static_cast<long>(chunk_size - consumed + (chunk_size % 2)), SEEK_CUR);
      fmt_read = true;
    } else if (std::memcmp(four, "data", 4) == 0) {
      if (!fmt_read) return -5;
      const int64_t frame_size =
          static_cast<int64_t>(header->channels) * header->sample_width;
      if (frame_size <= 0) return -5;
      header->data_offset = std::ftell(file);
      if (total_size > 0xFFFFFFFFLL) {
        header->frames_count = (total_size - header->data_offset) / frame_size;
      } else {
        header->frames_count = static_cast<int64_t>(chunk_size) / frame_size;
      }
      return 0;
    } else {
      std::fseek(file, static_cast<long>(chunk_size) + (chunk_size % 2), SEEK_CUR);
    }
  }
  return -5;
}

// decode + downmix one chunk of raw frames into mono float32
void downmix(const uint8_t* raw, int64_t frames, const WavHeader& header, float* mono) {
  const int channels = header.channels;
  if (header.sample_width == 2) {
    const int16_t* samples = reinterpret_cast<const int16_t*>(raw);
    if (channels == 1) {
      for (int64_t i = 0; i < frames; ++i) mono[i] = static_cast<float>(samples[i]);
    } else if (channels == 2) {
      // stereo int16 is the overwhelmingly common case; the fixed-trip-count
      // body (sum then /2, bit-identical to the generic accumulate order)
      // auto-vectorizes where the runtime `channels` inner loop cannot
      for (int64_t i = 0; i < frames; ++i) {
        const float acc = static_cast<float>(samples[2 * i]) + static_cast<float>(samples[2 * i + 1]);
        mono[i] = acc / 2.0f;
      }
    } else {
      for (int64_t i = 0; i < frames; ++i) {
        float acc = 0.0f;
        for (int c = 0; c < channels; ++c) acc += static_cast<float>(samples[i * channels + c]);
        mono[i] = acc / static_cast<float>(channels);
      }
    }
  } else if (header.sample_width == 3) {
    // keep the two high bytes of each little-endian 24-bit sample (the
    // int16 the reference builds, wav.py:71-74)
    for (int64_t i = 0; i < frames; ++i) {
      float acc = 0.0f;
      for (int c = 0; c < channels; ++c) {
        const uint8_t* sample = raw + (i * channels + c) * 3;
        const int16_t high = static_cast<int16_t>(
            static_cast<uint16_t>(sample[1]) | (static_cast<uint16_t>(sample[2]) << 8));
        acc += static_cast<float>(high);
      }
      mono[i] = acc / static_cast<float>(channels);
    }
  } else if (header.sample_width == 4 && header.float_samples) {
    const float* samples = reinterpret_cast<const float*>(raw);
    for (int64_t i = 0; i < frames; ++i) {
      float acc = 0.0f;
      for (int c = 0; c < channels; ++c) acc += samples[i * channels + c];
      mono[i] = acc / static_cast<float>(channels);
    }
  } else if (header.sample_width == 4) {
    const int32_t* samples = reinterpret_cast<const int32_t*>(raw);
    for (int64_t i = 0; i < frames; ++i) {
      float acc = 0.0f;
      for (int c = 0; c < channels; ++c) acc += static_cast<float>(samples[i * channels + c]);
      mono[i] = acc / static_cast<float>(channels);
    }
  }
}

// single-frame downmix — per-sample arithmetic identical to downmix()
// (same accumulation order, same divide), so fusing frame selection into
// the decode changes WHICH frames are decoded, never their values
inline float downmix_frame(const uint8_t* raw, int64_t i, const WavHeader& header) {
  const int channels = header.channels;
  if (header.sample_width == 2) {
    const int16_t* samples = reinterpret_cast<const int16_t*>(raw) + i * channels;
    if (channels == 1) return static_cast<float>(samples[0]);
    float acc = 0.0f;
    for (int c = 0; c < channels; ++c) acc += static_cast<float>(samples[c]);
    return acc / static_cast<float>(channels);
  }
  if (header.sample_width == 3) {
    float acc = 0.0f;
    for (int c = 0; c < channels; ++c) {
      const uint8_t* sample = raw + (i * channels + c) * 3;
      const int16_t high = static_cast<int16_t>(
          static_cast<uint16_t>(sample[1]) | (static_cast<uint16_t>(sample[2]) << 8));
      acc += static_cast<float>(high);
    }
    return acc / static_cast<float>(channels);
  }
  if (header.float_samples) {
    const float* samples = reinterpret_cast<const float*>(raw) + i * channels;
    float acc = 0.0f;
    for (int c = 0; c < channels; ++c) acc += samples[c];
    return acc / static_cast<float>(channels);
  }
  const int32_t* samples = reinterpret_cast<const int32_t*>(raw) + i * channels;
  float acc = 0.0f;
  for (int c = 0; c < channels; ++c) acc += static_cast<float>(samples[c]);
  return acc / static_cast<float>(channels);
}

}  // namespace

extern "C" {

// Probe: fills info = [frames_count, framerate, channels, sample_width].
// Returns 0 on success, negative error code otherwise.
int sushi_wav_probe(const char* path, int64_t* info) {
  std::FILE* file = std::fopen(path, "rb");
  if (!file) return -10;
  WavHeader header;
  const int err = parse_header(file, &header);
  std::fclose(file);
  if (err) return err;
  info[0] = header.frames_count;
  info[1] = header.framerate;
  info[2] = header.channels;
  info[3] = header.sample_width;
  return 0;
}

// Load + downmix + per-second NN-downsample into out[offset...].
// out must have room for offset + ceil(frames/framerate)*ceil-ish samples;
// the actual written count is returned through *written.
// Returns 0 on success, negative error code otherwise.
int sushi_wav_load(const char* path, int32_t sample_rate, float* out, int64_t out_capacity,
                   int64_t offset, int64_t* written) {
  std::FILE* file = std::fopen(path, "rb");
  if (!file) return -10;
  WavHeader header;
  int err = parse_header(file, &header);
  if (err) {
    std::fclose(file);
    return err;
  }

  const int64_t chunk_frames = header.framerate;  // one second
  const double rate_ratio = static_cast<double>(sample_rate) / header.framerate;
  const double total_seconds =
      static_cast<double>(header.frames_count) / static_cast<double>(header.framerate);
  const int64_t frame_size = static_cast<int64_t>(header.channels) * header.sample_width;

  std::vector<uint8_t> raw(static_cast<size_t>(chunk_frames * frame_size));
  std::vector<float> mono(static_cast<size_t>(chunk_frames));

  int64_t cursor = offset;
  double seconds_read = 0.0;
  while (seconds_read < total_seconds) {
    const size_t bytes = std::fread(raw.data(), 1, raw.size(), file);
    // a tail that is not a whole number of samples makes the NumPy path's
    // frombuffer raise (except 24-bit, which it byte-truncates); error out
    // so the caller falls back and both paths treat the file identically
    if (header.sample_width != 3 && bytes % static_cast<size_t>(header.sample_width) != 0) {
      std::fclose(file);
      return -6;
    }
    const int64_t frames = static_cast<int64_t>(bytes) / frame_size;
    if (frames == 0) break;

    const int64_t new_length = std::llround(static_cast<double>(frames) * rate_ratio);
    if (cursor + new_length > out_capacity) {
      std::fclose(file);
      return -20;
    }
    if (new_length == frames) {
      downmix(raw.data(), frames, header, mono.data());
      std::memcpy(out + cursor, mono.data(), static_cast<size_t>(frames) * sizeof(float));
    } else if (new_length < frames) {
      // downsampling keeps only floor(d*scale) frames — decode just those
      // instead of downmixing the whole chunk (4x less decode work at the
      // canonical 48k -> 12k); per-frame arithmetic is downmix()'s exactly
      const double scale = static_cast<double>(frames) / static_cast<double>(new_length);
      const int64_t stride = static_cast<int64_t>(scale);
      if (static_cast<double>(stride) == scale && header.sample_width == 2 &&
          header.channels == 2) {
        // canonical case (integral ratio, stereo int16) as one tight loop:
        // d*scale is integral and < 2^53, so floor(d*scale) == d*stride
        const int16_t* samples = reinterpret_cast<const int16_t*>(raw.data());
        for (int64_t d = 0; d < new_length; ++d) {
          const int16_t* frame = samples + 2 * d * stride;
          out[cursor + d] =
              (static_cast<float>(frame[0]) + static_cast<float>(frame[1])) / 2.0f;
        }
      } else {
        for (int64_t d = 0; d < new_length; ++d) {
          int64_t s = static_cast<int64_t>(std::floor(d * scale));
          if (s > frames - 1) s = frames - 1;
          out[cursor + d] = downmix_frame(raw.data(), s, header);
        }
      }
    } else {
      // upsampling (analysis rate above source rate): output indices repeat,
      // so the bulk downmix stays cheaper than per-output decode
      downmix(raw.data(), frames, header, mono.data());
      const double scale = static_cast<double>(frames) / static_cast<double>(new_length);
      for (int64_t d = 0; d < new_length; ++d) {
        int64_t s = static_cast<int64_t>(std::floor(d * scale));
        if (s > frames - 1) s = frames - 1;
        out[cursor + d] = mono[static_cast<size_t>(s)];
      }
    }
    cursor += new_length;
    seconds_read += 1.0;
  }
  std::fclose(file);
  *written = cursor - offset;
  return 0;
}

// Full analysis-stream preparation: decode + downmix + downsample into a
// caller-provided padded float32 buffer, then edge-pad, 3x-median clip,
// rescale to [0,1] and (optionally) quantize to uint8 — the whole of the
// reference's WavStream.__init__ arithmetic (wav.py:108-156) in one pass.
//
// buffer: float32[buffer_len], zero-initialized by the caller;
//         buffer_len = 2*padding + sample_count.
// out_u8: when non-null, receives the quantized uint8 stream (same length)
//         and `buffer` is left in its post-normalize float state.
// Returns 0 on success; -30 when audio is silent/empty (degenerate range).
int sushi_wav_prepare(const char* path, int32_t sample_rate, float* buffer, int64_t buffer_len,
                      int64_t padding, uint8_t* out_u8) {
  int64_t written = 0;
  const int err = sushi_wav_load(path, sample_rate, buffer, buffer_len, padding, &written);
  if (err) return err;
  if (written == 0) return -30;

  // edge padding
  const float head = buffer[padding];
  for (int64_t i = 0; i < padding; ++i) buffer[i] = head;
  const float tail = buffer[buffer_len - padding - 1];
  for (int64_t i = buffer_len - padding; i < buffer_len; ++i) buffer[i] = tail;

  // medians of the non-negative and non-positive subsets (NumPy semantics:
  // even count averages the two middle values)
  std::vector<float> side;
  side.reserve(static_cast<size_t>(buffer_len));
  auto median_of = [&side]() -> float {
    const size_t n = side.size();
    // np.median of an empty subset is NaN; the NaN then poisons the range
    // check so a stream with no samples on one side of zero fails loudly
    // exactly like the NumPy path
    if (n == 0) return std::numeric_limits<float>::quiet_NaN();
    const size_t hi = n / 2;
    std::nth_element(side.begin(), side.begin() + hi, side.end());
    const float upper = side[hi];
    if (n % 2 == 1) return upper;
    const float lower = *std::max_element(side.begin(), side.begin() + hi);
    return (lower + upper) / 2.0f;
  };

  // mirror the NumPy path's precision exactly: float(np.median(...)) * 3
  // is a DOUBLE, the clip/subtract scalars cast to float32 individually,
  // and the divisor is float32 of the double difference — computing
  // 3*median or the range in float32 directly can differ by 1 ulp for
  // float32/int32-sourced medians and flip boundary uint8 samples
  side.clear();
  for (int64_t i = 0; i < buffer_len; ++i)
    if (buffer[i] >= 0.0f) side.push_back(buffer[i]);
  const double max_d = static_cast<double>(median_of()) * 3.0;

  side.clear();
  for (int64_t i = 0; i < buffer_len; ++i)
    if (buffer[i] <= 0.0f) side.push_back(buffer[i]);
  const double min_d = static_cast<double>(median_of()) * 3.0;

  if (!(max_d - min_d > 0.0)) return -30;
  const float max_value = static_cast<float>(max_d);
  const float min_value = static_cast<float>(min_d);
  const float range = static_cast<float>(max_d - min_d);

  // op-for-op float32 parity with the NumPy path (clip, subtract, divide,
  // *255, +0.5, truncate); the build disables FP contraction so no FMA
  // merges two rounded ops into one
  if (out_u8 != nullptr) {
    for (int64_t i = 0; i < buffer_len; ++i) {
      float v = buffer[i];
      v = v < min_value ? min_value : (v > max_value ? max_value : v);
      v = v - min_value;
      v = v / range;
      v = v * 255.0f;
      v = v + 0.5f;
      out_u8[i] = static_cast<uint8_t>(v);
    }
  } else {
    for (int64_t i = 0; i < buffer_len; ++i) {
      float v = buffer[i];
      v = v < min_value ? min_value : (v > max_value ? max_value : v);
      v = v - min_value;
      buffer[i] = v / range;
    }
  }
  return 0;
}

}  // extern "C"
