// npz_loader — native paired-volume NPZ reader for the ldm3d_torch data path.
//
// The host-side IO and decompression engine of the training loaders: a C++
// thread pool parses the zip/npy containers and inflates and converts
// batches of NPZ volumes in-process, with no Python (and no GIL) in the
// decompression path. The port's own copy of the JAX package's
// native/npz_loader.cpp, unchanged in behaviour.
//
// Supports: zip entries stored (method 0) or deflated (method 8, via zlib),
// .npy payloads of dtype f4/f8/i2/u2/i4/u1 in C order, converted to float32.
// Exposes a C ABI consumed through ctypes (ldm3d_torch/data/native_loader.py).
//
// Build (done at first use by native_loader.py):
//   g++ -O3 -shared -fPIC -std=c++17 npz_loader.cpp -o libnpz_loader.so -lz -lpthread

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>
#include <thread>
#include <atomic>
#include <zlib.h>

namespace {

struct Buffer {
    std::vector<uint8_t> data;
};

bool read_file(const char* path, Buffer& out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    if (size < 0) { std::fclose(f); return false; }
    std::fseek(f, 0, SEEK_SET);
    out.data.resize(static_cast<size_t>(size));
    size_t got = std::fread(out.data.data(), 1, out.data.size(), f);
    std::fclose(f);
    return got == out.data.size();
}

uint16_t rd16(const uint8_t* p) { uint16_t v; std::memcpy(&v, p, 2); return v; }
uint32_t rd32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }
uint64_t rd64(const uint8_t* p) { uint64_t v; std::memcpy(&v, p, 8); return v; }

struct ZipEntry {
    std::string name;
    uint16_t method = 0;
    uint64_t comp_size = 0;
    uint64_t uncomp_size = 0;
    size_t data_offset = 0;
};

// Walk local file headers (sufficient for numpy-written archives, which are
// single-stream zips without zip64 for <4GB payloads).
bool parse_zip(const Buffer& buf, std::vector<ZipEntry>& entries) {
    const uint8_t* p = buf.data.data();
    size_t n = buf.data.size();
    size_t off = 0;
    while (off + 30 <= n) {
        uint32_t sig = rd32(p + off);
        if (sig != 0x04034b50) break;  // not a local file header
        ZipEntry e;
        e.method = rd16(p + off + 8);
        uint16_t flags = rd16(p + off + 6);
        e.comp_size = rd32(p + off + 18);
        e.uncomp_size = rd32(p + off + 22);
        uint16_t name_len = rd16(p + off + 26);
        uint16_t extra_len = rd16(p + off + 28);
        if (off + 30 + name_len + extra_len > n) return false;
        e.name.assign(reinterpret_cast<const char*>(p + off + 30), name_len);
        // zip64 (numpy writes 0xffffffff sizes with a 0x0001 extra record)
        if (e.comp_size == 0xffffffffu || e.uncomp_size == 0xffffffffu) {
            const uint8_t* x = p + off + 30 + name_len;
            size_t rem = extra_len;
            while (rem >= 4) {
                uint16_t id = rd16(x), sz = rd16(x + 2);
                // a record whose declared size exceeds the remaining bytes is
                // a corrupt/truncated extra field: bail instead of advancing
                // (an unsigned `rem -= 4 + sz` would wrap to ~SIZE_MAX and
                // walk off the buffer)
                if (static_cast<size_t>(4) + sz > rem) break;
                if (id == 0x0001 && sz >= 16) {
                    e.uncomp_size = rd64(x + 4);
                    e.comp_size = rd64(x + 12);
                    break;
                }
                x += 4 + sz;
                rem -= 4 + static_cast<size_t>(sz);
            }
        }
        e.data_offset = off + 30 + name_len + extra_len;
        if (flags & 0x8) {
            // data descriptor after payload: numpy doesn't write these; bail.
            return false;
        }
        if (e.data_offset + e.comp_size > n) return false;
        entries.push_back(e);
        off = e.data_offset + e.comp_size;
    }
    return !entries.empty();
}

bool inflate_raw(const uint8_t* src, size_t src_len, uint8_t* dst, size_t dst_len) {
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, -MAX_WBITS) != Z_OK) return false;  // raw deflate
    zs.next_in = const_cast<uint8_t*>(src);
    zs.avail_in = static_cast<uInt>(src_len);
    zs.next_out = dst;
    zs.avail_out = static_cast<uInt>(dst_len);
    int rc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    return rc == Z_STREAM_END && zs.total_out == dst_len;
}

// Minimal .npy header parse: version, header dict with descr/fortran/shape.
struct NpyInfo {
    char kind = 0;        // f, i, u
    int itemsize = 0;
    bool fortran = false;
    std::vector<int64_t> shape;
    size_t payload_offset = 0;
};

bool parse_npy(const uint8_t* p, size_t n, NpyInfo& info) {
    if (n < 10 || std::memcmp(p, "\x93NUMPY", 6) != 0) return false;
    int major = p[6];
    size_t header_len, header_off;
    if (major == 1) {
        header_len = rd16(p + 8);
        header_off = 10;
    } else {
        header_len = rd32(p + 8);
        header_off = 12;
    }
    if (header_off + header_len > n) return false;
    std::string h(reinterpret_cast<const char*>(p + header_off), header_len);
    info.payload_offset = header_off + header_len;

    auto find_val = [&](const char* key) -> std::string {
        size_t k = h.find(key);
        if (k == std::string::npos) return "";
        size_t c = h.find(':', k);
        return c == std::string::npos ? "" : h.substr(c + 1, 64);
    };
    std::string descr = find_val("'descr'");
    size_t q = descr.find('\'');
    if (q == std::string::npos) return false;
    std::string dt = descr.substr(q + 1, descr.find('\'', q + 1) - q - 1);
    if (dt.size() < 3) return false;
    char endian = dt[0];
    if (endian == '>') return false;  // big-endian unsupported
    info.kind = dt[1];
    info.itemsize = std::atoi(dt.c_str() + 2);
    info.fortran = find_val("'fortran_order'").find("True") != std::string::npos;

    size_t sp = h.find("'shape'");
    if (sp == std::string::npos) return false;
    size_t open = h.find('(', sp), close = h.find(')', sp);
    if (open == std::string::npos || close == std::string::npos) return false;
    std::string dims = h.substr(open + 1, close - open - 1);
    const char* s = dims.c_str();
    while (*s) {
        while (*s == ' ' || *s == ',') ++s;
        if (!*s) break;
        info.shape.push_back(std::strtoll(s, const_cast<char**>(&s), 10));
    }
    return !info.shape.empty();
}

template <typename T>
void convert_to_f32(const uint8_t* src, float* dst, size_t count) {
    const T* s = reinterpret_cast<const T*>(src);
    for (size_t i = 0; i < count; ++i) dst[i] = static_cast<float>(s[i]);
}

// Load one NPZ pair file into out (float32, 2*d*h*w). Returns 0 on success.
// When expect != nullptr ([2, d, h, w]), the file's shape is validated
// BEFORE anything is written to out: the batch API sizes each slot from the
// expected dims, so copying first and checking after would let one
// wrong-shaped file overflow the caller's buffer.
int load_pair_impl(const char* path, float* out, int64_t* dims /*[4]*/,
                   const int64_t* expect = nullptr) {
    Buffer buf;
    if (!read_file(path, buf)) return 1;
    std::vector<ZipEntry> entries;
    if (!parse_zip(buf, entries)) return 2;

    const ZipEntry* entry = nullptr;
    for (const auto& e : entries) {
        if (e.name == "arr0.npy" || e.name == "arr_0.npy") { entry = &e; break; }
    }
    if (!entry) entry = &entries[0];  // first-key fallback (reference parity)

    std::vector<uint8_t> raw;
    const uint8_t* npy = nullptr;
    size_t npy_len = 0;
    if (entry->method == 0) {
        npy = buf.data.data() + entry->data_offset;
        npy_len = entry->comp_size;
    } else if (entry->method == 8) {
        raw.resize(entry->uncomp_size);
        if (!inflate_raw(buf.data.data() + entry->data_offset, entry->comp_size,
                         raw.data(), raw.size()))
            return 3;
        npy = raw.data();
        npy_len = raw.size();
    } else {
        return 4;
    }

    NpyInfo info;
    if (!parse_npy(npy, npy_len, info)) return 5;
    if (info.fortran) return 6;
    // exactly (N>=2, D, H, W): trailing dims (e.g. an explicit channel axis)
    // would inflate pair_count past the caller's (2, D, H, W) buffer — an
    // ndim>=4 check alone would let them through to a heap overflow; such
    // files take the numpy fallback path instead
    if (info.shape.size() != 4 || info.shape[0] < 2) return 7;
    if (expect && (info.shape[1] != expect[1] || info.shape[2] != expect[2] ||
                   info.shape[3] != expect[3]))
        return 10;  // shape mismatch — reject before touching out

    size_t count = 1;
    for (auto d : info.shape) count *= static_cast<size_t>(d);
    size_t pair_count = 2 * count / static_cast<size_t>(info.shape[0]);
    const uint8_t* payload = npy + info.payload_offset;
    if (info.payload_offset + count * info.itemsize > npy_len) return 8;

    // copy only the first two "channels" (low, high) — reference parity
    size_t per_vol = count / static_cast<size_t>(info.shape[0]);
    if (info.kind == 'f' && info.itemsize == 4) {
        std::memcpy(out, payload, pair_count * sizeof(float));
    } else if (info.kind == 'f' && info.itemsize == 8) {
        convert_to_f32<double>(payload, out, pair_count);
    } else if (info.kind == 'i' && info.itemsize == 2) {
        convert_to_f32<int16_t>(payload, out, pair_count);
    } else if (info.kind == 'u' && info.itemsize == 2) {
        convert_to_f32<uint16_t>(payload, out, pair_count);
    } else if (info.kind == 'i' && info.itemsize == 4) {
        convert_to_f32<int32_t>(payload, out, pair_count);
    } else if (info.kind == 'u' && info.itemsize == 1) {
        convert_to_f32<uint8_t>(payload, out, pair_count);
    } else {
        return 9;
    }
    (void)per_vol;

    dims[0] = 2;
    dims[1] = info.shape[1];
    dims[2] = info.shape[2];
    dims[3] = info.shape[3];
    return 0;
}

}  // namespace

extern "C" {

// Probe a file's volume dims without loading the payload.
int npz_pair_dims(const char* path, int64_t* dims /*[4]*/) {
    Buffer buf;
    if (!read_file(path, buf)) return 1;
    std::vector<ZipEntry> entries;
    if (!parse_zip(buf, entries)) return 2;
    const ZipEntry* entry = nullptr;
    for (const auto& e : entries)
        if (e.name == "arr0.npy" || e.name == "arr_0.npy") { entry = &e; break; }
    if (!entry) entry = &entries[0];

    std::vector<uint8_t> head;
    const uint8_t* npy;
    size_t npy_len;
    if (entry->method == 0) {
        npy = buf.data.data() + entry->data_offset;
        npy_len = entry->comp_size;
    } else {
        // inflate just enough for the header (npy headers are <64KB)
        size_t want = entry->uncomp_size < 65536 ? entry->uncomp_size : 65536;
        head.resize(want);
        z_stream zs;
        std::memset(&zs, 0, sizeof(zs));
        if (inflateInit2(&zs, -MAX_WBITS) != Z_OK) return 3;
        zs.next_in = const_cast<uint8_t*>(buf.data.data() + entry->data_offset);
        zs.avail_in = entry->comp_size;
        zs.next_out = head.data();
        zs.avail_out = static_cast<uInt>(head.size());
        inflate(&zs, Z_SYNC_FLUSH);
        inflateEnd(&zs);
        npy = head.data();
        npy_len = head.size();
    }
    NpyInfo info;
    if (!parse_npy(npy, npy_len, info)) return 5;
    if (info.shape.size() != 4) return 7;  // see load_pair_impl: exactly (N, D, H, W)
    for (int i = 0; i < 4; ++i) dims[i] = info.shape[i];
    dims[0] = 2;
    return 0;
}

int npz_load_pair(const char* path, float* out, int64_t* dims) {
    // callers pass the probed dims in; treat nonzero spatial dims as the
    // expected shape so a file swapped between probe and load (TOCTOU)
    // can't overflow the buffer sized from the probe
    bool has_expect = dims[1] > 0 && dims[2] > 0 && dims[3] > 0;
    return load_pair_impl(path, out, dims, has_expect ? dims : nullptr);
}

// Load a batch of same-shaped NPZ pairs in parallel.
//   paths: array of n C strings;  out: n * 2*d*h*w floats (preallocated)
//   dims:  [2, d, h, w] expected per file (validated)
// Returns 0 on success, else 100 + index of the first failing file.
int npz_load_batch(const char** paths, int n, const int64_t* dims, float* out, int num_threads) {
    size_t per = static_cast<size_t>(2) * dims[1] * dims[2] * dims[3];
    std::atomic<int> next(0);
    std::atomic<int> err(-1);
    int workers = num_threads > 0 ? num_threads : static_cast<int>(std::thread::hardware_concurrency());
    if (workers > n) workers = n;
    if (workers < 1) workers = 1;

    auto work = [&]() {
        int64_t d[4];
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= n || err.load() >= 0) break;
            // dims passed as `expect`: the shape check happens BEFORE the
            // payload copy, so a wrong-shaped file can never overflow its
            // (expected-dims-sized) slot in out
            int rc = load_pair_impl(paths[i], out + static_cast<size_t>(i) * per, d, dims);
            if (rc != 0) {
                int expect_err = -1;
                err.compare_exchange_strong(expect_err, 100 + i);
                break;
            }
        }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < workers; ++t) pool.emplace_back(work);
    for (auto& th : pool) th.join();
    return err.load() >= 0 ? err.load() : 0;
}

}  // extern "C"
