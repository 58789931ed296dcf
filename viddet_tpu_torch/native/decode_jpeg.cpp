// JPEG decoding for the port's datasets: the JPEG half of
// viddet_tpu/native/decode.cpp, at full scale.
//
// The JAX package reads dataset images with cv2.imread / cv2.imdecode.  The
// port imports no OpenCV, so it decodes through libjpeg the way OpenCV's
// JPEG reader does: no DCT-domain prescale (scale_num / scale_denom stay
// 1/1), no resize, libjpeg's own colour conversion to RGB (greyscale is
// replicated into three channels), and 4-component (CMYK / YCCK) images
// converted with OpenCV's formula.  The caller applies the EXIF
// orientation (viddet_tpu_torch/utils/image.py).
//
// A libjpeg error longjmps out through the error manager, as decode.cpp
// does.  Unlike OpenCV, a warning about corrupt data (a truncated file, a
// bad Huffman code) is an error too, since libjpeg would otherwise return
// a partly grey image; extraneous bytes before a marker, which lose no
// pixel, are allowed.
//
// C interface, called through ctypes (which releases the GIL):
//   vd_jpeg_header(data, size, &width, &height, err, err_len)
//   vd_jpeg_decode(data, size, out, width, height, err, err_len)
// Each returns 0, or -1 with a message in err.
//
// Build: g++ -O3 -shared -fPIC decode_jpeg.cpp -o libviddet_jpeg.so -ljpeg

#include <csetjmp>
#include <cstdio>

#include <jpeglib.h>
#include <jerror.h>

namespace {

struct ErrorManager {
  jpeg_error_mgr pub;
  std::jmp_buf jmp;
  char* err;
  int err_len;
};

void fail(j_common_ptr cinfo) {
  ErrorManager* mgr = reinterpret_cast<ErrorManager*>(cinfo->err);
  char msg[JMSG_LENGTH_MAX];
  (*cinfo->err->format_message)(cinfo, msg);
  std::snprintf(mgr->err, mgr->err_len, "%s", msg);
  std::longjmp(mgr->jmp, 1);
}

// msg_level -1 is a warning about corrupt data; higher levels are traces.
void on_message(j_common_ptr cinfo, int msg_level) {
  if (msg_level == -1 && cinfo->err->msg_code != JWRN_EXTRANEOUS_DATA) fail(cinfo);
}

// OpenCV's icvCvt_CMYK2BGR_8u_C4C3R, written to RGB order.
void cmyk_to_rgb(const JSAMPLE* cmyk, unsigned char* rgb, int width) {
  for (int x = 0; x < width; ++x, cmyk += 4, rgb += 3) {
    int k = cmyk[3];
    rgb[0] = static_cast<unsigned char>(k - ((255 - cmyk[0]) * k >> 8));
    rgb[1] = static_cast<unsigned char>(k - ((255 - cmyk[1]) * k >> 8));
    rgb[2] = static_cast<unsigned char>(k - ((255 - cmyk[2]) * k >> 8));
  }
}

// Decodes into out when it is not null (its size must be width x height);
// else reads the header only.
int decode(const unsigned char* data, unsigned long size, unsigned char* out,
           int* width, int* height, char* err, int err_len) {
  jpeg_decompress_struct cinfo;
  ErrorManager mgr;
  mgr.err = err;
  mgr.err_len = err_len;
  cinfo.err = jpeg_std_error(&mgr.pub);
  mgr.pub.error_exit = fail;
  mgr.pub.emit_message = on_message;
  jpeg_create_decompress(&cinfo);
  if (setjmp(mgr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data), size);
  jpeg_read_header(&cinfo, TRUE);
  if (out == nullptr) {
    *width = static_cast<int>(cinfo.image_width);
    *height = static_cast<int>(cinfo.image_height);
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  const bool four = cinfo.num_components == 4;
  cinfo.out_color_space = four ? JCS_CMYK : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_width) != *width ||
      static_cast<int>(cinfo.output_height) != *height) {
    std::snprintf(err, err_len, "decoded size %ux%u differs from the header's %dx%d",
                  cinfo.output_width, cinfo.output_height, *width, *height);
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  const size_t stride = static_cast<size_t>(*width) * 3;
  // libjpeg's image pool owns the CMYK row, so a longjmp leaks nothing.
  JSAMPARRAY row4 = four ? (*cinfo.mem->alloc_sarray)(reinterpret_cast<j_common_ptr>(&cinfo),
                                                       JPOOL_IMAGE, cinfo.output_width * 4, 1)
                         : nullptr;
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* dst = out + cinfo.output_scanline * stride;
    JSAMPROW row = four ? row4[0] : dst;
    jpeg_read_scanlines(&cinfo, &row, 1);
    if (four) cmyk_to_rgb(row4[0], dst, *width);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // namespace

extern "C" {

int vd_jpeg_header(const unsigned char* data, unsigned long size, int* width,
                   int* height, char* err, int err_len) {
  return decode(data, size, nullptr, width, height, err, err_len);
}

int vd_jpeg_decode(const unsigned char* data, unsigned long size, unsigned char* out,
                   int width, int height, char* err, int err_len) {
  return decode(data, size, out, &width, &height, err, err_len);
}

}  // extern "C"
