// Native NIST SPHERE decoder: PCM, mu-law/A-law, and embedded shorten-v2.
//
// Replacement for the reference's external `sph2pipe` C tool,
// which its WSJ0 pipeline downloads and compiles
// (/root/reference/app/datasets/WSJ0/install.sh:11-17) and shells out to
// per file (WSJ0/process.py:46-49).  This is a from-scratch implementation
// of the published formats:
//   * NIST SPHERE header: 1024-byte (or declared-size) ASCII key/value
//     preamble ("NIST_1A\n   1024\n ... end_head").
//   * shorten v2 bitstream (Robinson, "SHORTEN: simple lossless and
//     near-lossless waveform compression", Cambridge TR156, 1994): Rice
//     coded residuals of fixed polynomial (DIFF0..3) or quantized-LPC
//     predictors, block means, bitshift, verbatim chunks.
//
// Exposed as a C ABI for ctypes (danet_tpu/native/sphere.py).
//
// Build: `make` in this directory -> libsphere.so

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// error helper
// ---------------------------------------------------------------------------
struct DecodeError {
  std::string msg;
  explicit DecodeError(std::string m) : msg(std::move(m)) {}
};

// ---------------------------------------------------------------------------
// SPHERE header
// ---------------------------------------------------------------------------
struct SphereHeader {
  int64_t header_bytes = 1024;
  int32_t sample_rate = 16000;
  int32_t channel_count = 1;
  int32_t sample_n_bytes = 2;
  int64_t sample_count = 0;
  bool big_endian = false;     // sample_byte_format "10" = big
  std::string sample_coding = "pcm";
};

SphereHeader parse_header(const uint8_t* data, size_t size) {
  if (size < 16 || std::memcmp(data, "NIST_1A", 7) != 0)
    throw DecodeError("not a NIST SPHERE file (bad magic)");
  // line 2 holds the total header size as ASCII
  const char* p = reinterpret_cast<const char*>(data);
  const char* nl = static_cast<const char*>(memchr(p, '\n', size));
  if (!nl) throw DecodeError("truncated header");
  SphereHeader h;
  h.header_bytes = strtol(nl + 1, nullptr, 10);
  if (h.header_bytes <= 0 || (size_t)h.header_bytes > size)
    throw DecodeError("bad header size");

  std::string header(p, (size_t)h.header_bytes);
  size_t pos = header.find('\n', header.find('\n') + 1) + 1;
  while (pos < header.size()) {
    size_t eol = header.find('\n', pos);
    if (eol == std::string::npos) break;
    std::string line = header.substr(pos, eol - pos);
    pos = eol + 1;
    if (line.rfind("end_head", 0) == 0) break;
    // "key -i 123" | "key -sN str" | "key -r 1.0"
    size_t sp1 = line.find(' ');
    if (sp1 == std::string::npos) continue;
    std::string key = line.substr(0, sp1);
    size_t sp2 = line.find(' ', sp1 + 1);
    if (sp2 == std::string::npos) continue;
    std::string val = line.substr(sp2 + 1);
    if (key == "sample_rate") h.sample_rate = atoi(val.c_str());
    else if (key == "channel_count") h.channel_count = atoi(val.c_str());
    else if (key == "sample_n_bytes") h.sample_n_bytes = atoi(val.c_str());
    else if (key == "sample_count") h.sample_count = atoll(val.c_str());
    else if (key == "sample_byte_format") h.big_endian = (val == "10");
    else if (key == "sample_coding") h.sample_coding = val;
  }
  return h;
}

// ---------------------------------------------------------------------------
// companding
// ---------------------------------------------------------------------------
int16_t ulaw2linear(uint8_t code) {
  code = ~code;
  int sign = code & 0x80;
  int exponent = (code >> 4) & 0x07;
  int mantissa = code & 0x0F;
  int sample = (((mantissa << 3) + 0x84) << exponent) - 0x84;
  return (int16_t)(sign ? -sample : sample);
}

int16_t alaw2linear(uint8_t code) {
  // G.711 convention: after the 0x55 XOR, a SET sign bit means POSITIVE
  code ^= 0x55;
  int sign = code & 0x80;
  int exponent = (code >> 4) & 0x07;
  int mantissa = code & 0x0F;
  int sample = exponent ? ((mantissa << 4) + 0x108) << (exponent - 1)
                        : (mantissa << 4) + 8;
  return (int16_t)(sign ? sample : -sample);
}

// ---------------------------------------------------------------------------
// shorten v2 bitstream
// ---------------------------------------------------------------------------
// constants from the shorten 2.x format
constexpr int kFnSize = 2;
constexpr int kEnergySize = 3;
constexpr int kBitshiftSize = 2;
constexpr int kLpcQSize = 2;
constexpr int kLpcQuant = 5;
constexpr int kXByteSize = 7;
constexpr int kVerbatimCkSize = 5;
constexpr int kVerbatimByteSize = 8;
constexpr int kUlongSize = 2;
constexpr int kNWrap = 3;

enum ShortenFn {
  FN_DIFF0 = 0, FN_DIFF1 = 1, FN_DIFF2 = 2, FN_DIFF3 = 3,
  FN_QUIT = 4, FN_BLOCKSIZE = 5, FN_BITSHIFT = 6, FN_QLPC = 7,
  FN_ZERO = 8, FN_VERBATIM = 9,
};

enum ShortenType {
  TYPE_AU1 = 0, TYPE_S8 = 1, TYPE_U8 = 2, TYPE_S16HL = 3, TYPE_U16HL = 4,
  TYPE_S16LH = 5, TYPE_U16LH = 6, TYPE_ULAW = 7, TYPE_AU2 = 8,
  TYPE_AU3 = 9, TYPE_ALAW = 10,
};

// MSB-first bit reader over the byte stream (the format packs bits into
// big-endian 32-bit words consumed MSB-first, which is byte-sequential).
class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size)
      : data_(data), size_(size) {}

  uint32_t bit() {
    if (byte_pos_ >= size_) throw DecodeError("shorten: bitstream overrun");
    uint32_t b = (data_[byte_pos_] >> (7 - bit_pos_)) & 1u;
    if (++bit_pos_ == 8) { bit_pos_ = 0; ++byte_pos_; }
    return b;
  }

  uint32_t bits(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | bit();
    return v;
  }

  // Rice code: unary run of zeros terminated by 1, then n fixed bits.
  uint32_t uvar(int n) {
    uint32_t result = 0;
    while (!bit()) {
      if (++result > (1u << 24)) throw DecodeError("shorten: runaway unary");
    }
    return (result << n) | bits(n);
  }

  // self-describing unsigned: bit-length via uvar(ULONGSIZE), then value
  uint32_t ulong_() {
    uint32_t nbit = uvar(kUlongSize);
    if (nbit > 31) throw DecodeError("shorten: ulong width too large");
    return uvar((int)nbit);
  }

  // signed: uvar(n+1), LSB is the sign (zigzag)
  int32_t var(int n) {
    uint32_t u = uvar(n + 1);
    return (u & 1) ? -(int32_t)(u >> 1) - 1 : (int32_t)(u >> 1);
  }

 private:
  const uint8_t* data_;
  size_t size_;
  size_t byte_pos_ = 0;
  int bit_pos_ = 0;
};

int64_t rounded_shift_down(int64_t x, int n) {
  return (n == 0) ? x : ((x >> (n - 1)) + 1) >> 1;
}

std::vector<int16_t> decode_shorten(const uint8_t* data, size_t size,
                                    int* out_nchan) {
  if (size < 5 || std::memcmp(data, "ajkg", 4) != 0)
    throw DecodeError("shorten: bad magic");
  int version = data[4];
  if (version < 1 || version > 2)
    throw DecodeError("shorten: unsupported version " +
                      std::to_string(version));
  BitReader br(data + 5, size - 5);

  auto uint_get = [&](int nbit) -> uint32_t {
    return br.ulong_();  // version >= 1: all header fields self-describing
    (void)nbit;
  };

  uint32_t ftype = uint_get(4);
  uint32_t nchan = uint_get(0);
  if (nchan == 0 || nchan > 16) throw DecodeError("shorten: bad nchan");
  uint32_t blocksize = uint_get(0);
  uint32_t maxnlpc = uint_get(kLpcQSize);
  uint32_t nmean = uint_get(0);
  uint32_t nskip = uint_get(0);
  for (uint32_t i = 0; i < nskip; i++) br.uvar(kXByteSize);
  if (blocksize == 0 || blocksize > (1u << 20))
    throw DecodeError("shorten: bad blocksize");
  if (maxnlpc > 1024) throw DecodeError("shorten: bad maxnlpc");
  if (nmean > 65536) throw DecodeError("shorten: bad nmean");

  const int nwrap = std::max<int>(kNWrap, (int)maxnlpc);
  // shorten v2: V2LPCQOFFSET = 1 << LPCQUANT (quantized-LPC rounding bias)
  const int32_t lpcqoffset = (version >= 2) ? (1 << kLpcQuant) : 0;

  int64_t init_mean = 0;
  if (ftype == TYPE_U8) init_mean = 0x80;
  if (ftype == TYPE_U16HL || ftype == TYPE_U16LH) init_mean = 0x8000;

  std::vector<std::vector<int64_t>> cbuf(
      nchan, std::vector<int64_t>(nwrap + blocksize, 0));
  std::vector<std::vector<int64_t>> offset(
      nchan, std::vector<int64_t>(std::max<uint32_t>(nmean, 1), init_mean));
  std::vector<int32_t> qlpc(maxnlpc > 0 ? maxnlpc : 1);

  std::vector<int16_t> out;
  int bitshift = 0;
  uint32_t chan = 0;
  uint32_t cur_blocksize = blocksize;
  bool done = false;

  auto convert_sample = [&](int64_t v) -> int16_t {
    switch (ftype) {
      case TYPE_ULAW: case TYPE_AU1: case TYPE_AU2: case TYPE_AU3:
        return ulaw2linear((uint8_t)(v & 0xff));
      case TYPE_ALAW:
        return alaw2linear((uint8_t)(v & 0xff));
      case TYPE_U8:
        return (int16_t)(((int)(v & 0xff) - 128) << 8);
      case TYPE_S8:
        return (int16_t)((int8_t)(v & 0xff) << 8);
      case TYPE_U16HL: case TYPE_U16LH:
        return (int16_t)((int64_t)(v & 0xffff) - 0x8000);
      default:  // S16HL / S16LH: already linear 16-bit
        if (v > 32767) v = 32767;
        if (v < -32768) v = -32768;
        return (int16_t)v;
    }
  };

  // per-channel staging; interleave on the last channel of each row
  std::vector<std::vector<int16_t>> stage(nchan);

  while (!done) {
    uint32_t cmd = br.uvar(kFnSize);
    switch (cmd) {
      case FN_QUIT:
        done = true;
        break;
      case FN_BLOCKSIZE: {
        uint32_t nb = uint_get(0);
        if (nb == 0 || nb > blocksize)
          throw DecodeError("shorten: bad FN_BLOCKSIZE");
        cur_blocksize = nb;
        break;
      }
      case FN_BITSHIFT:
        bitshift = (int)br.uvar(kBitshiftSize);
        break;
      case FN_VERBATIM: {
        uint32_t n = br.uvar(kVerbatimCkSize);
        for (uint32_t i = 0; i < n; i++) br.uvar(kVerbatimByteSize);
        break;
      }
      case FN_ZERO: case FN_DIFF0: case FN_DIFF1: case FN_DIFF2:
      case FN_DIFF3: case FN_QLPC: {
        int64_t* cb = cbuf[chan].data() + nwrap;  // cb[-i] = history
        uint32_t bs = cur_blocksize;

        // block offset from running means
        int64_t coffset;
        if (nmean == 0) {
          coffset = offset[chan][0];
        } else {
          int64_t sum = (version < 2) ? 0 : nmean / 2;
          for (uint32_t i = 0; i < nmean; i++) sum += offset[chan][i];
          coffset = sum / (int64_t)nmean;
          if (version >= 2) coffset = rounded_shift_down(coffset, bitshift);
        }

        if (cmd == FN_ZERO) {
          for (uint32_t i = 0; i < bs; i++) cb[i] = 0;
        } else if (cmd == FN_QLPC) {
          int resn = (int)br.uvar(kEnergySize);
          uint32_t nlpc = br.uvar(kLpcQSize);
          if (nlpc > maxnlpc) throw DecodeError("shorten: nlpc > maxnlpc");
          for (uint32_t j = 0; j < nlpc; j++) qlpc[j] = br.var(kLpcQuant);
          if (version >= 2)
            for (uint32_t j = 1; j <= nlpc; j++) cb[-(int64_t)j] -= coffset;
          for (uint32_t i = 0; i < bs; i++) {
            int64_t sum = lpcqoffset;
            for (uint32_t j = 0; j < nlpc; j++)
              sum += (int64_t)qlpc[j] * cb[(int64_t)i - (int64_t)j - 1];
            cb[i] = br.var(resn) + (sum >> kLpcQuant);
          }
          if (version >= 2)
            for (uint32_t i = 0; i < bs; i++) cb[i] += coffset;
        } else {
          int resn = (int)br.uvar(kEnergySize);
          switch (cmd) {
            case FN_DIFF0:
              for (uint32_t i = 0; i < bs; i++)
                cb[i] = br.var(resn) + coffset;
              break;
            case FN_DIFF1:
              for (uint32_t i = 0; i < bs; i++)
                cb[i] = br.var(resn) + cb[(int64_t)i - 1];
              break;
            case FN_DIFF2:
              for (uint32_t i = 0; i < bs; i++)
                cb[i] = br.var(resn) + 2 * cb[(int64_t)i - 1]
                        - cb[(int64_t)i - 2];
              break;
            case FN_DIFF3:
              for (uint32_t i = 0; i < bs; i++)
                cb[i] = br.var(resn)
                        + 3 * (cb[(int64_t)i - 1] - cb[(int64_t)i - 2])
                        + cb[(int64_t)i - 3];
              break;
          }
        }

        // update running means
        if (nmean > 0) {
          int64_t sum = (version < 2) ? 0 : bs / 2;
          for (uint32_t i = 0; i < bs; i++) sum += cb[i];
          for (uint32_t i = 1; i < nmean; i++)
            offset[chan][i - 1] = offset[chan][i];
          int64_t m = sum / (int64_t)bs;
          offset[chan][nmean - 1] = (version < 2) ? m : (m << bitshift);
        }

        // wrap history for the next block
        for (int i = 1; i <= nwrap; i++)
          cbuf[chan][nwrap - i] = cb[(int64_t)bs - i];

        // apply bitshift and stage output
        stage[chan].reserve(stage[chan].size() + bs);
        for (uint32_t i = 0; i < bs; i++)
          stage[chan].push_back(convert_sample(cb[i] << bitshift));

        if (chan == nchan - 1) {
          size_t row = stage[0].size();
          for (uint32_t c = 1; c < nchan; c++)
            if (stage[c].size() != row)
              throw DecodeError("shorten: channel length mismatch");
          chan = 0;
        } else {
          chan++;
        }
        break;
      }
      default:
        throw DecodeError("shorten: unknown command " + std::to_string(cmd));
    }
  }

  // interleave channels
  size_t per_chan = stage[0].size();
  out.resize(per_chan * nchan);
  for (size_t i = 0; i < per_chan; i++)
    for (uint32_t c = 0; c < nchan; c++)
      out[i * nchan + c] = stage[c][i];
  *out_nchan = (int)nchan;
  return out;
}

// ---------------------------------------------------------------------------
// PCM / companded payload
// ---------------------------------------------------------------------------
std::vector<int16_t> decode_pcm(const SphereHeader& h, const uint8_t* data,
                                size_t size) {
  std::vector<int16_t> out;
  if (h.sample_n_bytes == 2) {
    size_t n = size / 2;
    out.resize(n);
    for (size_t i = 0; i < n; i++) {
      uint16_t v = h.big_endian
          ? (uint16_t)((data[2 * i] << 8) | data[2 * i + 1])
          : (uint16_t)(data[2 * i] | (data[2 * i + 1] << 8));
      out[i] = (int16_t)v;
    }
  } else if (h.sample_n_bytes == 1) {
    out.resize(size);
    bool is_ulaw = h.sample_coding.find("ulaw") != std::string::npos;
    bool is_alaw = h.sample_coding.find("alaw") != std::string::npos;
    for (size_t i = 0; i < size; i++) {
      if (is_ulaw) out[i] = ulaw2linear(data[i]);
      else if (is_alaw) out[i] = alaw2linear(data[i]);
      else out[i] = (int16_t)((int8_t)data[i] << 8);
    }
  } else {
    throw DecodeError("unsupported sample_n_bytes");
  }
  return out;
}

std::vector<uint8_t> read_file(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) throw DecodeError(std::string("cannot open ") + path);
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf((size_t)sz);
  if (sz > 0 && fread(buf.data(), 1, (size_t)sz, f) != (size_t)sz) {
    fclose(f);
    throw DecodeError(std::string("short read on ") + path);
  }
  fclose(f);
  return buf;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------
extern "C" {

int sphere_read(const char* path, int32_t* sample_rate, int32_t* channels,
                int64_t* n_samples, int16_t** samples,
                char* err, int errlen) {
  try {
    std::vector<uint8_t> buf = read_file(path);
    SphereHeader h = parse_header(buf.data(), buf.size());
    const uint8_t* payload = buf.data() + h.header_bytes;
    size_t payload_size = buf.size() - (size_t)h.header_bytes;

    std::vector<int16_t> pcm;
    int nchan = h.channel_count;
    if (h.sample_coding.find("embedded-shorten") != std::string::npos ||
        (payload_size >= 4 && std::memcmp(payload, "ajkg", 4) == 0)) {
      pcm = decode_shorten(payload, payload_size, &nchan);
    } else {
      pcm = decode_pcm(h, payload, payload_size);
    }
    if (h.sample_count > 0 &&
        (int64_t)pcm.size() > h.sample_count * nchan)
      pcm.resize((size_t)(h.sample_count * nchan));

    auto* mem = (int16_t*)malloc(pcm.size() * sizeof(int16_t));
    if (!mem) throw DecodeError("out of memory");
    std::memcpy(mem, pcm.data(), pcm.size() * sizeof(int16_t));
    *samples = mem;
    *n_samples = (int64_t)pcm.size() / nchan;
    *sample_rate = h.sample_rate;
    *channels = nchan;
    return 0;
  } catch (const DecodeError& e) {
    snprintf(err, errlen, "%s", e.msg.c_str());
    return 1;
  } catch (...) {
    snprintf(err, errlen, "unknown error");
    return 1;
  }
}

void sphere_free(int16_t* p) { free(p); }

// Thread-pooled batch decode: decodes n files concurrently (atomic work
// index over a fixed thread count).  Per-file outputs/err strings; returns
// the number of failures.  Used by the WSJ0 offline preprocessing pipeline
// (danet_tpu/data/WSJ0/process.py) where thousands of shorten-compressed
// .wv1 files dominate wall-clock.
int sphere_read_batch(const char** paths, int n, int n_threads,
                      int32_t* rates, int32_t* chans, int64_t* counts,
                      int16_t** buffers, char* errs, int errlen_each) {
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;

  auto run = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      char* err = errs + (size_t)i * errlen_each;
      err[0] = '\0';
      int rc = sphere_read(paths[i], &rates[i], &chans[i], &counts[i],
                           &buffers[i], err, errlen_each);
      if (rc != 0) {
        buffers[i] = nullptr;
        failures.fetch_add(1);
      }
    }
  };

  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; t++) pool.emplace_back(run);
  for (auto& t : pool) t.join();
  return failures.load();
}

}  // extern "C"
