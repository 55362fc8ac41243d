// Native IO for gp_compressor_jax: fast PCD point-cloud reader/writer.
//
// Role: the reference leans on PCL's native readers for its scan IO
// (pcl::io::loadPCDFile, reference src/test_compress.cpp:13); this library
// is the equivalent native data-loader for this framework — large
// binary scans parse here at memcpy speed and enter JAX as NumPy buffers.
// Exposed through a plain C ABI consumed via ctypes
// (gp_compressor_jax/io/native.py); gp_compressor_jax/io/pcd.py is the
// pure-NumPy fallback and the behavioural oracle for the tests.
//
// Build: native/build.sh (g++ -O3 -shared), cached as libgpio.so.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Header {
    std::vector<std::string> fields;
    std::vector<int> sizes;
    std::vector<char> types;
    std::vector<int> counts;
    long points = -1;
    std::string data;   // "ascii" | "binary"
    long header_end = 0;
};

bool parse_header(FILE* f, Header* h) {
    char line[4096];
    while (fgets(line, sizeof line, f)) {
        std::string s(line);
        if (!s.empty() && s[0] == '#') continue;
        auto sp = s.find(' ');
        std::string key = s.substr(0, sp);
        std::string rest = sp == std::string::npos ? "" : s.substr(sp + 1);
        auto split = [](const std::string& r) {
            std::vector<std::string> out;
            size_t i = 0;
            while (i < r.size()) {
                while (i < r.size() && std::isspace((unsigned char)r[i])) ++i;
                size_t j = i;
                while (j < r.size() && !std::isspace((unsigned char)r[j])) ++j;
                if (j > i) out.push_back(r.substr(i, j - i));
                i = j;
            }
            return out;
        };
        if (key == "FIELDS") h->fields = split(rest);
        else if (key == "SIZE") { for (auto& t : split(rest)) h->sizes.push_back(std::stoi(t)); }
        else if (key == "TYPE") { for (auto& t : split(rest)) h->types.push_back(t[0]); }
        else if (key == "COUNT") { for (auto& t : split(rest)) h->counts.push_back(std::stoi(t)); }
        else if (key == "POINTS") h->points = std::stol(rest);
        else if (key == "DATA") {
            auto v = split(rest);
            h->data = v.empty() ? "" : v[0];
            h->header_end = ftell(f);
            break;
        }
    }
    if (h->counts.empty()) h->counts.assign(h->fields.size(), 1);
    return h->points >= 0 && !h->fields.empty() && !h->data.empty()
        && h->fields.size() == h->sizes.size()
        && h->fields.size() == h->types.size()
        && h->fields.size() == h->counts.size();
}

double read_field_as_double(const unsigned char* p, char type, int size) {
    switch (type) {
        case 'F': return size == 4 ? (double)*(const float*)p
                                   : *(const double*)p;
        case 'U': switch (size) {
            case 1: return *(const uint8_t*)p;
            case 2: return *(const uint16_t*)p;
            default: return *(const uint32_t*)p;
        }
        case 'I': switch (size) {
            case 1: return *(const int8_t*)p;
            case 2: return *(const int16_t*)p;
            default: return *(const int32_t*)p;
        }
    }
    return 0.0;
}

}  // namespace

extern "C" {

// Returns 0 on success. n_points / has_rgb are outputs.
int gpio_pcd_info(const char* path, long* n_points, int* has_rgb) {
    FILE* f = fopen(path, "rb");
    if (!f) return 1;
    Header h;
    bool ok = parse_header(f, &h);
    fclose(f);
    if (!ok) return 2;
    *n_points = h.points;
    *has_rgb = 0;
    for (auto& fl : h.fields)
        if (fl == "rgb" || fl == "rgba") *has_rgb = 1;
    return 0;
}

// xyz: float32[n*3]; rgb: float32[n*3] (may be null). Returns 0 on success.
int gpio_pcd_read(const char* path, float* xyz, float* rgb) {
    FILE* f = fopen(path, "rb");
    if (!f) return 1;
    Header h;
    if (!parse_header(f, &h)) { fclose(f); return 2; }

    int xi = -1, yi = -1, zi = -1, ci = -1;
    std::vector<long> offsets(h.fields.size(), 0);
    long stride = 0;
    for (size_t i = 0; i < h.fields.size(); ++i) {
        offsets[i] = stride;
        stride += (long)h.sizes[i] * h.counts[i];
        if (h.fields[i] == "x") xi = (int)i;
        else if (h.fields[i] == "y") yi = (int)i;
        else if (h.fields[i] == "z") zi = (int)i;
        else if (h.fields[i] == "rgb" || h.fields[i] == "rgba") ci = (int)i;
    }
    if (xi < 0 || yi < 0 || zi < 0) { fclose(f); return 3; }

    long n = h.points;
    if (h.data == "binary") {
        std::vector<unsigned char> buf(stride * n);
        size_t got = fread(buf.data(), 1, buf.size(), f);
        fclose(f);
        if (got < buf.size()) return 4;
        for (long i = 0; i < n; ++i) {
            const unsigned char* row = buf.data() + i * stride;
            xyz[3 * i + 0] = (float)read_field_as_double(row + offsets[xi], h.types[xi], h.sizes[xi]);
            xyz[3 * i + 1] = (float)read_field_as_double(row + offsets[yi], h.types[yi], h.sizes[yi]);
            xyz[3 * i + 2] = (float)read_field_as_double(row + offsets[zi], h.types[zi], h.sizes[zi]);
            if (rgb && ci >= 0) {
                uint32_t packed;
                if (h.types[ci] == 'F') {
                    float pf = *(const float*)(row + offsets[ci]);
                    std::memcpy(&packed, &pf, 4);
                } else {
                    packed = *(const uint32_t*)(row + offsets[ci]);
                }
                rgb[3 * i + 0] = (float)((packed >> 16) & 0xFF);
                rgb[3 * i + 1] = (float)((packed >> 8) & 0xFF);
                rgb[3 * i + 2] = (float)(packed & 0xFF);
            }
        }
        return 0;
    }
    // ascii
    long ncols = 0;
    for (size_t i = 0; i < h.fields.size(); ++i) ncols += h.counts[i];
    std::vector<int> col_of_field(h.fields.size());
    {
        int c = 0;
        for (size_t i = 0; i < h.fields.size(); ++i) {
            col_of_field[i] = c;
            c += h.counts[i];
        }
    }
    std::vector<double> row(ncols);
    for (long i = 0; i < n; ++i) {
        for (long c = 0; c < ncols; ++c) {
            if (fscanf(f, "%lf", &row[c]) != 1) { fclose(f); return 4; }
        }
        xyz[3 * i + 0] = (float)row[col_of_field[xi]];
        xyz[3 * i + 1] = (float)row[col_of_field[yi]];
        xyz[3 * i + 2] = (float)row[col_of_field[zi]];
        if (rgb && ci >= 0) {
            float pf = (float)row[col_of_field[ci]];
            uint32_t packed;
            std::memcpy(&packed, &pf, 4);
            rgb[3 * i + 0] = (float)((packed >> 16) & 0xFF);
            rgb[3 * i + 1] = (float)((packed >> 8) & 0xFF);
            rgb[3 * i + 2] = (float)(packed & 0xFF);
        }
    }
    fclose(f);
    return 0;
}

// binary XYZRGB/XYZ writer mirroring io/pcd.py::write.
int gpio_pcd_write(const char* path, const float* xyz, const float* rgb,
                   long n, int binary) {
    FILE* f = fopen(path, "wb");
    if (!f) return 1;
    const char* fields = rgb ? "x y z rgb" : "x y z";
    const char* sizes = rgb ? "4 4 4 4" : "4 4 4";
    const char* types = rgb ? "F F F F" : "F F F";
    const char* counts = rgb ? "1 1 1 1" : "1 1 1";
    fprintf(f,
            "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
            "FIELDS %s\nSIZE %s\nTYPE %s\nCOUNT %s\nWIDTH %ld\nHEIGHT 1\n"
            "VIEWPOINT 0 0 0 1 0 0 0\nPOINTS %ld\nDATA %s\n",
            fields, sizes, types, counts, n, n,
            binary ? "binary" : "ascii");
    if (binary) {
        std::vector<float> row(rgb ? 4 : 3);
        for (long i = 0; i < n; ++i) {
            row[0] = xyz[3 * i];
            row[1] = xyz[3 * i + 1];
            row[2] = xyz[3 * i + 2];
            if (rgb) {
                uint32_t packed = ((uint32_t)(rgb[3 * i]) << 16)
                    | ((uint32_t)(rgb[3 * i + 1]) << 8)
                    | (uint32_t)(rgb[3 * i + 2]);
                std::memcpy(&row[3], &packed, 4);
            }
            fwrite(row.data(), 4, row.size(), f);
        }
    } else {
        for (long i = 0; i < n; ++i) {
            if (rgb) {
                uint32_t packed = ((uint32_t)(rgb[3 * i]) << 16)
                    | ((uint32_t)(rgb[3 * i + 1]) << 8)
                    | (uint32_t)(rgb[3 * i + 2]);
                float pf;
                std::memcpy(&pf, &packed, 4);
                fprintf(f, "%.9g %.9g %.9g %.9g\n", xyz[3 * i],
                        xyz[3 * i + 1], xyz[3 * i + 2], pf);
            } else {
                fprintf(f, "%.9g %.9g %.9g\n", xyz[3 * i], xyz[3 * i + 1],
                        xyz[3 * i + 2]);
            }
        }
    }
    fclose(f);
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// .pccode / .pcdict artifact codec (dictionary_representation format,
// reference src/dictionary_representation.cpp:48-138,173-248). The Python
// implementation in gp_compressor_jax/io/artifact.py is the oracle; this
// native path handles bulk artifacts at memcpy speed.
// ---------------------------------------------------------------------------

extern "C" {

int gpio_dict_write(const char* path, const float* data, long rows, long cols) {
    FILE* f = fopen(path, "wb");
    if (!f) return 1;
    int32_t c = (int32_t)cols, r = (int32_t)rows;
    fwrite(&c, 4, 1, f);
    fwrite(&r, 4, 1, f);
    // column-major like Eigen
    std::vector<float> colbuf(rows);
    for (long j = 0; j < cols; ++j) {
        for (long i = 0; i < rows; ++i) colbuf[i] = data[i * cols + j];
        fwrite(colbuf.data(), 4, rows, f);
    }
    fclose(f);
    return 0;
}

int gpio_dict_info(const char* path, long* rows, long* cols) {
    FILE* f = fopen(path, "rb");
    if (!f) return 1;
    int32_t c, r;
    if (fread(&c, 4, 1, f) != 1 || fread(&r, 4, 1, f) != 1) {
        fclose(f);
        return 2;
    }
    *rows = r;
    *cols = c;
    fclose(f);
    return 0;
}

int gpio_dict_read(const char* path, float* out) {
    FILE* f = fopen(path, "rb");
    if (!f) return 1;
    int32_t c, r;
    if (fread(&c, 4, 1, f) != 1 || fread(&r, 4, 1, f) != 1) {
        fclose(f);
        return 2;
    }
    std::vector<float> colbuf(r);
    for (long j = 0; j < c; ++j) {
        if (fread(colbuf.data(), 4, r, f) != (size_t)r) { fclose(f); return 3; }
        for (long i = 0; i < r; ++i) out[i * c + j] = colbuf[i];
    }
    fclose(f);
    return 0;
}

// Writes the .pccode body. All code arrays are row-major [n, kmax].
int gpio_pccode_write(const char* path, int32_t n, int32_t sz,
                      int32_t words_max, int32_t rgb_words_max,
                      int32_t dict_size, int32_t rgb_dict_size, float res,
                      const float* means, const float* quats,
                      const float* rgb_means,
                      const float* X, const int32_t* I, const int32_t* nw,
                      const float* RGB_X, const int32_t* RGB_I,
                      const int32_t* RGB_nw, const uint8_t* W) {
    FILE* f = fopen(path, "wb");
    if (!f) return 1;
    fwrite(&n, 4, 1, f);
    fwrite(&sz, 4, 1, f);
    fwrite(&words_max, 4, 1, f);
    fwrite(&rgb_words_max, 4, 1, f);
    fwrite(&dict_size, 4, 1, f);
    fwrite(&rgb_dict_size, 4, 1, f);
    fwrite(&res, 4, 1, f);
    fwrite(means, 4, 3L * n, f);
    fwrite(quats, 4, 4L * n, f);
    for (long i = 0; i < n; ++i) {
        uint8_t w = (uint8_t)nw[i];
        fwrite(&w, 1, 1, f);
        fwrite(X + i * words_max, 4, w, f);
    }
    for (long i = 0; i < n; ++i) {
        for (long k = 0; k < nw[i]; ++k) {
            uint16_t word = (uint16_t)I[i * words_max + k];
            fwrite(&word, 2, 1, f);
        }
    }
    fwrite(rgb_means, 4, 3L * n, f);
    for (long i = 0; i < 3L * n; ++i) {
        uint8_t w = (uint8_t)RGB_nw[i];
        fwrite(&w, 1, 1, f);
        fwrite(RGB_X + i * rgb_words_max, 4, w, f);
    }
    for (long i = 0; i < 3L * n; ++i) {
        for (long k = 0; k < RGB_nw[i]; ++k) {
            uint16_t word = (uint16_t)RGB_I[i * rgb_words_max + k];
            fwrite(&word, 2, 1, f);
        }
    }
    // LSB-first bit packing, final partial byte always flushed
    // (dictionary_representation::write_bool/close_write_bools)
    long nbits = (long)n * sz * sz;
    uint8_t buf = 0;
    int b = 0;
    for (long i = 0; i < nbits; ++i) {
        if (b == 8) { fwrite(&buf, 1, 1, f); buf = 0; b = 0; }
        buf |= (uint8_t)(W[i] ? 1 : 0) << b;
        ++b;
    }
    fwrite(&buf, 1, 1, f);
    fclose(f);
    return 0;
}

}  // extern "C"
