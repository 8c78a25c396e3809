// Native legacy-VTK structured-grid writer.
//
// The reference keeps its postprocessing in C (postprocess.h:5-47: header,
// explicit point coordinates, POINT_DATA scalars). This is the framework's
// native IO component: same file layout, buffered formatting, loaded from
// Python via ctypes (utils/vtk.py). On multi-hundred-MB grids the Python
// fallback is an order of magnitude slower.
#include <cstdio>
#include <cstdlib>
#include <vector>

extern "C" {

// Writes an n^3 scalar field with spacing h as legacy ASCII VTK.
// Returns 0 on success, nonzero on IO failure.
int mg_write_vtk(const char* file_name, const double* grid, double h, int n) {
    FILE* fh = std::fopen(file_name, "w");
    if (!fh) return 1;
    // Large stdio buffer: the writer is fputs/fprintf-bound otherwise.
    std::vector<char> buf(1 << 20);
    std::setvbuf(fh, buf.data(), _IOFBF, buf.size());

    std::fprintf(fh, "# vtk DataFile Version 2.0\n");
    std::fprintf(fh, "Multigrid output data\n");
    std::fprintf(fh, "ASCII\n");
    std::fprintf(fh, "DATASET STRUCTURED_GRID\n");
    std::fprintf(fh, "DIMENSIONS %d %d %d\n", n, n, n);
    long total = (long)n * n * n;
    std::fprintf(fh, "POINTS %ld double\n", total);
    for (int i = 0; i < n; ++i) {
        double x = i * h;
        for (int j = 0; j < n; ++j) {
            double y = j * h;
            for (int k = 0; k < n; ++k) {
                std::fprintf(fh, "%.10g %.10g %.10g\n", x, y, k * h);
            }
        }
    }
    std::fprintf(fh, "POINT_DATA %ld\n", total);
    std::fprintf(fh, "SCALARS OutputData double 1\n");
    std::fprintf(fh, "LOOKUP_TABLE default\n");
    for (long p = 0; p < total; ++p) {
        std::fprintf(fh, "%.10g\n", grid[p]);
    }
    int rc = std::ferror(fh);
    std::fclose(fh);
    return rc ? 2 : 0;
}

}  // extern "C"
