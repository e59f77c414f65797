// Native gzip inflate and deflate for the port's host I/O.
//
// The port's copy of oaprogressionmmf_tpu/native/fast_inflate.cpp. It
// inflates a .gz file directly into a caller-provided buffer (a numpy
// array): no PyBytes chunk list, no join copy, and the GIL is released for
// the whole call (ctypes), so the loader's decode threads scale across
// cores. It also gzip-compresses a buffer to a file in one call (the prep
// apps' NIfTI writes).
//
// When libdeflate is present at build time, the whole file is slurped and
// inflated with libdeflate's one-shot gzip decoder, and deflate is
// available; zlib's streaming inflate is the fallback build (deflate then
// returns -1 and the caller takes Python's codec).
//
// Built by oaprogressionmmf_torch/utils/native_io.py with g++ at first use
// into build/ (libdeflate probed, zlib otherwise); never at import.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <zlib.h>

#ifdef HAVE_LIBDEFLATE
#include <libdeflate.h>
#endif

namespace {

// zlib streaming path: inflate `path` into out[0..cap).
int64_t inflate_zlib(const char* path, uint8_t* out, int64_t cap) {
    gzFile f = gzopen(path, "rb");
    if (!f) return -1;
    gzbuffer(f, 1 << 20);
    int64_t total = 0;
    while (total < cap) {
        unsigned chunk = (unsigned)std::min<int64_t>(cap - total, 1 << 30);
        int n = gzread(f, out + total, chunk);
        if (n < 0) { gzclose(f); return -2; }
        if (n == 0) { gzclose(f); return total; }
        total += n;
    }
    // buffer full: check for trailing data
    uint8_t probe;
    int n = gzread(f, &probe, 1);
    gzclose(f);
    return (n > 0) ? -3 : total;
}

#ifdef HAVE_LIBDEFLATE
// One-shot path: slurp the compressed file, then decode gzip members
// back-to-back with libdeflate (handles concatenated members, which
// ISIZE undercounts — same -3 grow contract as the zlib path).
int64_t inflate_libdeflate(const char* path, uint8_t* out, int64_t cap) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    if (fseek(f, 0, SEEK_END) != 0) { fclose(f); return -1; }
    long fsize = ftell(f);
    if (fsize < 0 || fseek(f, 0, SEEK_SET) != 0) { fclose(f); return -1; }
    uint8_t* in = (uint8_t*)malloc((size_t)fsize);
    if (!in) { fclose(f); return -1; }
    if (fread(in, 1, (size_t)fsize, f) != (size_t)fsize) {
        free(in); fclose(f); return -1;
    }
    fclose(f);

    // RAII so the per-thread decompressor is freed on thread exit
    // (short-lived decode threads would otherwise leak one allocation
    // each; the persistent pool never noticed).
    struct DecHolder {
        libdeflate_decompressor* d = nullptr;
        ~DecHolder() { if (d) libdeflate_free_decompressor(d); }
    };
    static thread_local DecHolder dh;
    if (!dh.d) dh.d = libdeflate_alloc_decompressor();
    libdeflate_decompressor* dec = dh.d;
    if (!dec) { free(in); return -1; }

    int64_t in_pos = 0, out_pos = 0;
    while (in_pos < fsize) {
        size_t in_used = 0, out_used = 0;
        libdeflate_result r = libdeflate_gzip_decompress_ex(
            dec, in + in_pos, (size_t)(fsize - in_pos),
            out + out_pos, (size_t)(cap - out_pos), &in_used, &out_used);
        if (r == LIBDEFLATE_INSUFFICIENT_SPACE) { free(in); return -3; }
        if (r != LIBDEFLATE_SUCCESS) { free(in); return -2; }
        in_pos += (int64_t)in_used;
        out_pos += (int64_t)out_used;
        if (in_used == 0) break;  // no forward progress (trailing junk)
    }
    free(in);
    return out_pos;
}
#endif

}  // namespace

extern "C" {

// Inflate `path` into out[0..cap). Returns bytes written, or:
//   -1 open failed, -2 corrupt stream, -3 buffer too small (more data
//   remained — e.g. a multi-member gzip whose ISIZE undercounts).
int64_t fnifti_inflate(const char* path, uint8_t* out, int64_t cap) {
#ifdef HAVE_LIBDEFLATE
    return inflate_libdeflate(path, out, cap);
#else
    return inflate_zlib(path, out, cap);
#endif
}

// Gzip-compress data[0..n) to `path` (libdeflate one-shot; the prep
// apps' write hot loop — R4/R5 write thousands of volumes). Returns
// compressed bytes written, or -1 on error / when built without
// libdeflate (caller falls back to the Python codec).
int64_t fnifti_deflate(const uint8_t* data, int64_t n, const char* path,
                       int level) {
#ifdef HAVE_LIBDEFLATE
    struct CompHolder {  // freed on thread exit (see DecHolder note)
        libdeflate_compressor* c = nullptr;
        int level = -1;
        ~CompHolder() { if (c) libdeflate_free_compressor(c); }
    };
    static thread_local CompHolder ch;
    if (!ch.c || ch.level != level) {
        if (ch.c) libdeflate_free_compressor(ch.c);
        ch.c = libdeflate_alloc_compressor(level);
        ch.level = level;
    }
    libdeflate_compressor* comp = ch.c;
    if (!comp) return -1;
    size_t bound = libdeflate_gzip_compress_bound(comp, (size_t)n);
    uint8_t* out = (uint8_t*)malloc(bound);
    if (!out) return -1;
    size_t written = libdeflate_gzip_compress(comp, data, (size_t)n,
                                              out, bound);
    if (written == 0) { free(out); return -1; }
    FILE* f = fopen(path, "wb");
    if (!f) { free(out); return -1; }
    size_t ok = fwrite(out, 1, written, f);
    free(out);
    if (fclose(f) != 0 || ok != written) return -1;
    return (int64_t)written;
#else
    (void)data; (void)n; (void)path; (void)level;
    return -1;
#endif
}

// Uncompressed size of a single-member gzip (ISIZE field, mod 2^32);
// returns -1 on IO error.
int64_t fnifti_gz_isize(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    if (fseek(f, -4, SEEK_END) != 0) { fclose(f); return -1; }
    uint8_t b[4];
    if (fread(b, 1, 4, f) != 4) { fclose(f); return -1; }
    fclose(f);
    return (int64_t)b[0] | ((int64_t)b[1] << 8) | ((int64_t)b[2] << 16) |
           ((int64_t)b[3] << 24);
}

}  // extern "C"
