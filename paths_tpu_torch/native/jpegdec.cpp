// Native batched JPEG tile decoder for the preprocessing data path.
//
// WSI preprocessing is decode-bound on production hosts (the reference
// pipeline fans decode across 32 *processes* because Python/PIL per-tile
// decode can't keep a GPU fed). This kernel replaces that with a GIL-free
// OpenMP fan-out inside one process: a batch of compressed tiles decodes
// in parallel via libjpeg(-turbo), landing directly in one caller-owned
// contiguous uint8 buffer (no per-tile Python objects, no extra copies).
// One read_rect spanning 16 tiles then costs one native call.
//
// Build: python -m paths_tpu_torch.native.build   (g++ -O3 -fopenmp -ljpeg)
// ABI: plain C, consumed via ctypes (paths_tpu_torch/native/jpeg.py).

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>

#include <jpeglib.h>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// libjpeg's default error handler calls exit(); route errors through
// setjmp so one corrupt tile fails its slot instead of the process.
struct JmpErrorMgr {
    jpeg_error_mgr pub;
    std::jmp_buf setjmp_buffer;
};

void error_exit_jmp(j_common_ptr cinfo) {
    JmpErrorMgr* err = reinterpret_cast<JmpErrorMgr*>(cinfo->err);
    std::longjmp(err->setjmp_buffer, 1);
}

void emit_nothing(j_common_ptr, int) {}

// Decode one JPEG byte stream into out (row-major RGB, out_w*3 stride).
// Returns 0 on success; 1 on decode error / oversize image.
int decode_one(const uint8_t* buf, int64_t len, uint8_t* out,
               int64_t out_h, int64_t out_w, int32_t* dims) {
    jpeg_decompress_struct cinfo;
    JmpErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = error_exit_jmp;
    jerr.pub.emit_message = emit_nothing;
    if (setjmp(jerr.setjmp_buffer)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;  // grayscale/YCbCr sources -> RGB
    jpeg_start_decompress(&cinfo);
    const int64_t h = cinfo.output_height, w = cinfo.output_width;
    dims[0] = static_cast<int32_t>(h);
    dims[1] = static_cast<int32_t>(w);
    if (h > out_h || w > out_w || cinfo.output_components != 3) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW row = out + int64_t(cinfo.output_scanline) * out_w * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

}  // namespace

extern "C" {

// Decode n concatenated JPEG streams (stream i = blob[offsets[i] ..
// offsets[i+1])) into out (n, out_h, out_w, 3) uint8. Each image lands
// top-left in its slot; the rest of the slot is pre-filled with `pad`
// (WSI edge-tile contract: out-of-bounds pixels are white, see
// paths_tpu_torch/preprocess/wsi.py). Actual (h, w) per image goes to dims[2i], dims[2i+1]
// (-1, -1 on failure). Parallel over images. Returns the failure count;
// failed slots stay `pad`-filled.
int64_t jpeg_decode_batch(const uint8_t* blob, const int64_t* offsets,
                          int64_t n, uint8_t* out, int64_t out_h,
                          int64_t out_w, int32_t* dims, uint8_t pad) {
    const int64_t slot = out_h * out_w * 3;
    std::memset(out, pad, static_cast<size_t>(n * slot));
    int64_t failures = 0;
#pragma omp parallel for schedule(dynamic) reduction(+ : failures)
    for (int64_t i = 0; i < n; ++i) {
        const int64_t len = offsets[i + 1] - offsets[i];
        int rc = len > 0 ? decode_one(blob + offsets[i], len, out + i * slot,
                                      out_h, out_w, dims + 2 * i)
                         : 1;
        if (rc != 0) {
            dims[2 * i] = -1;
            dims[2 * i + 1] = -1;
            // a partial decode may have written rows before failing
            std::memset(out + i * slot, pad, static_cast<size_t>(slot));
            failures += 1;
        }
    }
    return failures;
}

// Header-only probe: dims[0]=h, dims[1]=w. Returns 0 ok, 1 on error.
int32_t jpeg_header_dims(const uint8_t* buf, int64_t len, int32_t* dims) {
    jpeg_decompress_struct cinfo;
    JmpErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = error_exit_jmp;
    jerr.pub.emit_message = emit_nothing;
    if (setjmp(jerr.setjmp_buffer)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
    jpeg_read_header(&cinfo, TRUE);
    dims[0] = static_cast<int32_t>(cinfo.image_height);
    dims[1] = static_cast<int32_t>(cinfo.image_width);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

int jpeg_omp_thread_count(void) {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
