// The state-log writer with a plain C interface (loaded with ctypes by
// runtime/native/__init__.py).
//
// The C++ counterpart of runtime/io.py's pure-Python log writer, which
// stays as its plain version: every logged number prints with "%g" (NaN
// as "nan", as Python prints it).
//
//   phd_textio_write(path, vals, lens, kinds, n_lines)
//       appends n_lines lines: lens[i] numbers of vals each followed by a
//       space, then a newline. kinds[i] 0: "%g", 1: integer ("%lld"),
//       2: "%g" with nothing but the newline when empty (a map line; an
//       empty line of kind 0 or 1 is " \n", as Python's join + " \n").
//       Returns 0, or errno when the file does not open.

#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <string>

extern "C" {

int phd_textio_write(const char* path, const double* vals,
                     const int64_t* lens, const int32_t* kinds,
                     int64_t n_lines) {
    FILE* fh = std::fopen(path, "a");
    if (!fh) return errno ? errno : EIO;
    std::string buf;
    char num[64];
    for (int64_t i = 0; i < n_lines; ++i) {
        const int64_t n = lens[i];
        if (n == 0 && kinds[i] != 2) buf += ' ';
        for (int64_t j = 0; j < n; ++j) {
            const double x = *vals++;
            int len;
            if (kinds[i] == 1)
                len = std::snprintf(num, sizeof(num), "%lld ",
                                    static_cast<long long>(x));
            else if (std::isnan(x))
                len = std::snprintf(num, sizeof(num), "nan ");
            else
                len = std::snprintf(num, sizeof(num), "%g ", x);
            buf.append(num, len);
        }
        buf += '\n';
    }
    const size_t wrote = std::fwrite(buf.data(), 1, buf.size(), fh);
    const int err = wrote == buf.size() ? 0 : (errno ? errno : EIO);
    return std::fclose(fh) != 0 && err == 0 ? (errno ? errno : EIO) : err;
}

}  // extern "C"
