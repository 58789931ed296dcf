// GIF's LZW (the image blocks; native/gif.py reads the rest of the file):
// variable-length codes from min_code_size + 1 up to 12 bits, least
// significant bit first, with clear and end-of-information codes, a table
// that stops growing at 4,096 entries until the next clear code, and the
// KwKwK case (a code one past the table).  No library beyond the C++
// standard one.
//
// C interface (extern "C"):
//   vd_gif_lzw(data, size, min_code_size, out, capacity, &count, err, err_len)
//     the colour indices of the concatenated sub-blocks `data` into `out`,
//     at most `capacity` of them; count is how many the data held (up to
//     the end-of-information code or the end of the data; codes after the
//     end code are not read).  0, or -1 with a message in err for a code
//     size out of range or a code past the table, as OpenCV's GIF decoder
//     refuses them.

#include <cstdint>
#include <cstdio>

extern "C" int vd_gif_lzw(const uint8_t* data, unsigned long size, int min_code_size, uint8_t* out,
                          unsigned long capacity, unsigned long* count, char* err, int err_len) {
  *count = 0;
  if (min_code_size < 2 || min_code_size > 11) {
    std::snprintf(err, err_len, "LZW minimum code size %d out of range", min_code_size);
    return -1;
  }
  static thread_local uint16_t prefix[4096];
  static thread_local uint8_t suffix[4096], first_of[4096], stack[4096];
  const int clear = 1 << min_code_size, end = clear + 1;
  for (int c = 0; c < clear; ++c) {
    suffix[c] = static_cast<uint8_t>(c);
    first_of[c] = static_cast<uint8_t>(c);
  }
  int code_size = min_code_size + 1, next = clear + 2, prev = -1;
  uint32_t buf = 0;
  int nbits = 0;
  size_t pos = 0;
  unsigned long n = 0;
  for (;;) {
    while (nbits < code_size && pos < size) {
      buf |= static_cast<uint32_t>(data[pos++]) << nbits;
      nbits += 8;
    }
    if (nbits < code_size) break;  // the data ends without an end code
    const int code = static_cast<int>(buf & ((1u << code_size) - 1));
    buf >>= code_size;
    nbits -= code_size;
    if (code == clear) {
      code_size = min_code_size + 1;
      next = clear + 2;
      prev = -1;
      continue;
    }
    if (code == end) break;
    int cur;
    uint8_t first;
    if (prev < 0) {
      if (code > clear) {
        std::snprintf(err, err_len, "LZW code %d is not a colour after a clear code", code);
        return -1;
      }
      cur = code;
      first = first_of[code];
    } else if (code < next) {
      cur = code;
      first = first_of[code];
    } else if (code == next && next < 4096) {
      cur = -1;  // KwKwK: the previous string and its own first index
      first = first_of[prev];
    } else {
      std::snprintf(err, err_len, "LZW code %d is past the table's %d entries", code, next);
      return -1;
    }
    if (prev >= 0 && next < 4096) {
      prefix[next] = static_cast<uint16_t>(prev);
      suffix[next] = first;
      first_of[next] = first_of[prev];
      ++next;
      if (next == (1 << code_size) && code_size < 12) ++code_size;
    }
    if (cur < 0) cur = next - 1;
    int depth = 0, c = cur;
    for (; c >= clear; c = prefix[c]) stack[depth++] = suffix[c];
    stack[depth++] = static_cast<uint8_t>(c);
    for (int k = depth - 1; k >= 0; --k) {
      if (n < capacity) out[n] = stack[k];
      ++n;
    }
    prev = cur;
  }
  *count = n;
  return 0;
}
