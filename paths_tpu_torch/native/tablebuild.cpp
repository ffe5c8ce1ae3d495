// Native host kernels for the paths_tpu_torch data path (the port's own
// copy of the JAX package's table builder).
//
// The per-slide LevelTable build (scan an H*W*D feature grid for
// non-background rows, emit compacted rows + index grid — the native
// counterpart of paths_tpu_torch/engine/tables.py::build_level_table_numpy)
// runs once per (slide, level) when a slide's tables are first needed. The
// numpy implementation materializes several temporaries over tens-of-MB
// grids; this version is single-pass, cache-friendly, and OpenMP-parallel
// over rows.
//
// Build: python -m paths_tpu_torch.native.build   (g++ -O3 -fopenmp -shared)
// ABI: plain C, consumed via ctypes (paths_tpu_torch/native/__init__.py).

#include <atomic>
#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Scan: bg[i] = 1 iff row i sums to exactly zero (the background contract:
// the preprocessor writes background cells as zero rows). The row is summed
// in order; numpy sums pairwise, so the two can disagree only on a live row
// whose entries cancel to exactly 0. Returns non-bg count.
int64_t scan_background(const float* grid, int64_t cells, int64_t d,
                        uint8_t* bg) {
    int64_t count = 0;
#pragma omp parallel for schedule(static) reduction(+ : count)
    for (int64_t i = 0; i < cells; ++i) {
        const float* row = grid + i * d;
        float s = 0.0f;
        for (int64_t j = 0; j < d; ++j) s += row[j];
        const bool is_bg = (s == 0.0f);
        bg[i] = is_bg ? 1 : 0;
        if (!is_bg) count += 1;
    }
    return count;
}

// Build a single-slide level table from a dense (h, w, d) float32 grid.
//
//   fts_out   (m_rows, d)  zero-initialized by caller
//   locs_out  (m_rows, 2)  int32 (y, x), zero-initialized
//   index_out (h, w)       int32, filled with -1 here
//
// Rows [0, count) are non-background cells in row-major order; rows
// [count, count+extra) are background cells (row-major) up to m_rows —
// exactly the ordering the all-background fallback addresses
// (engine/tables.py docstring). Returns the non-background count.
int64_t build_level_table(const float* grid, int64_t h, int64_t w, int64_t d,
                          float* fts_out, int32_t* locs_out,
                          int32_t* index_out, int64_t m_rows) {
    const int64_t cells = h * w;

    // pass 1: background scan (parallel)
    uint8_t* bg = new uint8_t[cells];
    const int64_t count = scan_background(grid, cells, d, bg);

    // pass 2: sequential index assignment (row-major stable order), with
    // parallel row copies batched afterwards
    int64_t nz_written = 0;
    int64_t bg_written = 0;
    const int64_t bg_cap = m_rows > count ? m_rows - count : 0;
    int64_t* src_of_row = new int64_t[m_rows];
    for (int64_t i = 0; i < m_rows; ++i) src_of_row[i] = -1;

    for (int64_t i = 0; i < cells; ++i) {
        if (!bg[i]) {
            if (nz_written < m_rows) src_of_row[nz_written] = i;
            index_out[i] = static_cast<int32_t>(nz_written);
            ++nz_written;
        } else {
            index_out[i] = -1;
            if (bg_written < bg_cap) {
                src_of_row[count + bg_written] = i;
                ++bg_written;
            }
        }
    }

#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < m_rows; ++r) {
        const int64_t src = src_of_row[r];
        if (src < 0) continue;
        locs_out[2 * r] = static_cast<int32_t>(src / w);
        locs_out[2 * r + 1] = static_cast<int32_t>(src % w);
        if (r < count) {  // background rows keep zero features
            std::memcpy(fts_out + r * d, grid + src * d, sizeof(float) * d);
        }
    }

    delete[] src_of_row;
    delete[] bg;
    return count;
}

int omp_thread_count() {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
