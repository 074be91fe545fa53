// Native data-path kernels for the host loader (CPython C API, no pybind11).
//
// The reference delegates its entire record pipeline to TF's C++ runtime
// (tf.data.TFRecordDataset + TFExampleDecoder, model/dataloader.py:176,38).
// This module supplies the equivalent native pieces under our numpy loader:
//
//   crc32c(bytes)           — slicing-by-8 Castagnoli CRC (record integrity)
//   masked_crc(bytes)       — TFRecord's rotated+masked variant
//   read_record_spans(path) — one pass over a tfrecord file returning
//                             (offset, length) pairs with CRC verification,
//                             so Python slices payloads zero-copy from an
//                             mmap/bytes object
//   scan_example(payload)   — protobuf wire scan of a tf.train.Example:
//                             returns {key: (field_no, offset, length)} of
//                             each Feature's inner list payload, letting
//                             Python decode only the fields it needs (e.g.
//                             slice JPEG bytes without touching token lists)
//   resize_bilinear_pad     — fused align-corners bilinear + crop + pad
//   decode_jpeg, encode_jpeg — libjpeg, when it is present at build time
//
// A copy of merlot_tpu/data/_native/native.cc with encode_jpeg added (the
// synthetic shard writer's encoder). Built at first use by
// merlot_tpu_torch.data._native (g++ -O3 -ffp-contract=off -shared -fPIC).

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

// ---------------------------------------------------------------------
// crc32c, slicing-by-8
// ---------------------------------------------------------------------
static uint32_t crc_table[8][256];
static int table_ready = 0;

static void init_tables(void) {
  const uint32_t poly = 0x82F63B78u;
  for (int i = 0; i < 256; i++) {
    uint32_t crc = (uint32_t)i;
    for (int j = 0; j < 8; j++)
      crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    crc_table[0][i] = crc;
  }
  for (int i = 0; i < 256; i++)
    for (int t = 1; t < 8; t++)
      crc_table[t][i] =
          (crc_table[t - 1][i] >> 8) ^ crc_table[0][crc_table[t - 1][i] & 0xFF];
  table_ready = 1;
}

static uint32_t crc32c_raw(const uint8_t *buf, Py_ssize_t len, uint32_t crc) {
  crc = ~crc;
  while (len >= 8) {
    uint64_t word;
    memcpy(&word, buf, 8);
    word ^= (uint64_t)crc;
    crc = crc_table[7][word & 0xFF] ^ crc_table[6][(word >> 8) & 0xFF] ^
          crc_table[5][(word >> 16) & 0xFF] ^ crc_table[4][(word >> 24) & 0xFF] ^
          crc_table[3][(word >> 32) & 0xFF] ^ crc_table[2][(word >> 40) & 0xFF] ^
          crc_table[1][(word >> 48) & 0xFF] ^ crc_table[0][(word >> 56) & 0xFF];
    buf += 8;
    len -= 8;
  }
  while (len--) crc = (crc >> 8) ^ crc_table[0][(crc ^ *buf++) & 0xFF];
  return ~crc;
}

static uint32_t masked(uint32_t crc) {
  return (((crc >> 15) | (crc << 17)) + 0xA282EAD8u);
}

static PyObject *py_crc32c(PyObject *self, PyObject *args) {
  Py_buffer view;
  if (!PyArg_ParseTuple(args, "y*", &view)) return NULL;
  uint32_t crc = crc32c_raw((const uint8_t *)view.buf, view.len, 0);
  PyBuffer_Release(&view);
  return PyLong_FromUnsignedLong(crc);
}

static PyObject *py_masked_crc(PyObject *self, PyObject *args) {
  Py_buffer view;
  if (!PyArg_ParseTuple(args, "y*", &view)) return NULL;
  uint32_t crc = masked(crc32c_raw((const uint8_t *)view.buf, view.len, 0));
  PyBuffer_Release(&view);
  return PyLong_FromUnsignedLong(crc);
}

// ---------------------------------------------------------------------
// tfrecord framing scan
// ---------------------------------------------------------------------
static PyObject *py_read_record_spans(PyObject *self, PyObject *args) {
  const char *path;
  int verify = 1;
  if (!PyArg_ParseTuple(args, "s|p", &path, &verify)) return NULL;

  FILE *f = fopen(path, "rb");
  if (!f) return PyErr_Format(PyExc_IOError, "cannot open %s", path);

  PyObject *spans = PyList_New(0);
  uint8_t header[12], tail[4];
  uint64_t offset = 0;
  while (1) {
    size_t got = fread(header, 1, 12, f);
    if (got == 0) break;
    if (got < 12) {
      fclose(f);
      Py_DECREF(spans);
      return PyErr_Format(PyExc_IOError, "truncated header in %s", path);
    }
    uint64_t len;
    memcpy(&len, header, 8);  // little-endian host assumed (x86/arm LE)
    if (verify) {
      uint32_t want;
      memcpy(&want, header + 8, 4);
      if (masked(crc32c_raw(header, 8, 0)) != want) {
        fclose(f);
        Py_DECREF(spans);
        return PyErr_Format(PyExc_IOError, "bad length crc in %s", path);
      }
    }
    uint64_t payload_off = offset + 12;
    if (fseek(f, (long)len, SEEK_CUR) != 0 || fread(tail, 1, 4, f) < 4) {
      fclose(f);
      Py_DECREF(spans);
      return PyErr_Format(PyExc_IOError, "truncated record in %s", path);
    }
    PyObject *tup = Py_BuildValue("(KK)", payload_off, len);
    PyList_Append(spans, tup);
    Py_DECREF(tup);
    offset = payload_off + len + 4;
  }
  fclose(f);
  return spans;
}

// ---------------------------------------------------------------------
// protobuf wire scan of tf.train.Example
// ---------------------------------------------------------------------
static int read_varint(const uint8_t *buf, Py_ssize_t len, Py_ssize_t *pos,
                       uint64_t *out) {
  uint64_t result = 0;
  int shift = 0;
  while (*pos < len && shift < 64) {
    uint8_t b = buf[(*pos)++];
    result |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = result;
      return 0;
    }
    shift += 7;
  }
  return -1;
}

static int skip_field(const uint8_t *buf, Py_ssize_t len, Py_ssize_t *pos,
                      int wire) {
  uint64_t v;
  switch (wire) {
    case 0: return read_varint(buf, len, pos, &v);
    case 1: *pos += 8; return *pos <= len ? 0 : -1;
    case 2:
      if (read_varint(buf, len, pos, &v)) return -1;
      *pos += (Py_ssize_t)v;
      return *pos <= len ? 0 : -1;
    case 5: *pos += 4; return *pos <= len ? 0 : -1;
    default: return -1;
  }
}

// Returns dict {key_bytes: (list_field_no, inner_offset, inner_len)}, where
// inner_offset/len delimit the repeated-value payload of the BytesList/
// FloatList/Int64List inside the original buffer.
static PyObject *py_scan_example(PyObject *self, PyObject *args) {
  Py_buffer view;
  if (!PyArg_ParseTuple(args, "y*", &view)) return NULL;
  const uint8_t *buf = (const uint8_t *)view.buf;
  Py_ssize_t len = view.len, pos = 0;
  PyObject *out = PyDict_New();

  while (pos < len) {
    uint64_t tag;
    if (read_varint(buf, len, &pos, &tag)) goto fail;
    if ((tag >> 3) != 1 || (tag & 7) != 2) {  // Example.features
      if (skip_field(buf, len, &pos, (int)(tag & 7))) goto fail;
      continue;
    }
    uint64_t flen;
    if (read_varint(buf, len, &pos, &flen)) goto fail;
    Py_ssize_t fend = pos + (Py_ssize_t)flen;

    while (pos < fend) {  // Features.feature map entries
      uint64_t etag;
      if (read_varint(buf, fend, &pos, &etag)) goto fail;
      if ((etag >> 3) != 1 || (etag & 7) != 2) {
        if (skip_field(buf, fend, &pos, (int)(etag & 7))) goto fail;
        continue;
      }
      uint64_t elen;
      if (read_varint(buf, fend, &pos, &elen)) goto fail;
      Py_ssize_t eend = pos + (Py_ssize_t)elen;

      const uint8_t *key = NULL;
      Py_ssize_t key_len = 0;
      long list_field = 0;
      Py_ssize_t in_off = 0, in_len = 0;

      while (pos < eend) {  // map entry: key=1, value(Feature)=2
        uint64_t mtag;
        if (read_varint(buf, eend, &pos, &mtag)) goto fail;
        int mf = (int)(mtag >> 3), mw = (int)(mtag & 7);
        if (mw != 2) {
          if (skip_field(buf, eend, &pos, mw)) goto fail;
          continue;
        }
        uint64_t mlen;
        if (read_varint(buf, eend, &pos, &mlen)) goto fail;
        if (mf == 1) {
          key = buf + pos;
          key_len = (Py_ssize_t)mlen;
        } else if (mf == 2) {
          // Feature: oneof bytes_list=1 / float_list=2 / int64_list=3,
          // each a message whose field 1 holds the values
          Py_ssize_t vpos = pos, vend = pos + (Py_ssize_t)mlen;
          while (vpos < vend) {
            uint64_t vtag;
            if (read_varint(buf, vend, &vpos, &vtag)) goto fail;
            if ((vtag & 7) != 2) {
              if (skip_field(buf, vend, &vpos, (int)(vtag & 7))) goto fail;
              continue;
            }
            uint64_t vlen;
            if (read_varint(buf, vend, &vpos, &vlen)) goto fail;
            list_field = (long)(vtag >> 3);
            in_off = vpos;
            in_len = (Py_ssize_t)vlen;
            vpos += (Py_ssize_t)vlen;
          }
        }
        pos += (Py_ssize_t)mlen;
      }
      if (key) {
        PyObject *k = PyBytes_FromStringAndSize((const char *)key, key_len);
        PyObject *v = Py_BuildValue("(lnn)", list_field, in_off, in_len);
        PyDict_SetItem(out, k, v);
        Py_DECREF(k);
        Py_DECREF(v);
      }
    }
  }
  PyBuffer_Release(&view);
  return out;
fail:
  PyBuffer_Release(&view);
  Py_DECREF(out);
  PyErr_SetString(PyExc_ValueError, "malformed Example proto");
  return NULL;
}

// ---------------------------------------------------------------------
// JPEG decode via the system libjpeg (the reference's decode runs inside
// TF's C++ DecodeJpegOp; this is our equivalent native path). Returns
// (height, width, rgb_bytes). The decompress loop runs without the GIL.
// ---------------------------------------------------------------------
#ifdef MERLOT_HAVE_JPEG
#include <csetjmp>
#include <cstdlib>
#include <jpeglib.h>

struct merlot_jpeg_err {
  struct jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

static void merlot_jpeg_error_exit(j_common_ptr cinfo) {
  merlot_jpeg_err *err = (merlot_jpeg_err *)cinfo->err;
  longjmp(err->setjmp_buffer, 1);
}

static PyObject *py_decode_jpeg(PyObject *self, PyObject *args) {
  Py_buffer view;
  if (!PyArg_ParseTuple(args, "y*", &view)) return NULL;

  struct jpeg_decompress_struct cinfo;
  merlot_jpeg_err jerr;
  // volatile: modified between setjmp and the longjmp from error_exit and
  // read after it — non-volatile locals are indeterminate then (C11
  // 7.13.2.1; libjpeg's example.c does the same)
  unsigned char *volatile out = NULL;
  volatile unsigned int h = 0, w = 0;
  volatile int ok = 0;

  Py_BEGIN_ALLOW_THREADS
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = merlot_jpeg_error_exit;
  if (!setjmp(jerr.setjmp_buffer)) {
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, (const unsigned char *)view.buf,
                 (unsigned long)view.len);
    if (jpeg_read_header(&cinfo, TRUE) == JPEG_HEADER_OK) {
      cinfo.out_color_space = JCS_RGB;
      jpeg_start_decompress(&cinfo);
      h = cinfo.output_height;
      w = cinfo.output_width;
      if (h > 0 && w > 0 && cinfo.output_components == 3) {
        out = (unsigned char *)malloc((size_t)h * w * 3);
        if (out) {
          size_t stride = (size_t)w * 3;
          while (cinfo.output_scanline < h) {
            unsigned char *row = out + (size_t)cinfo.output_scanline * stride;
            JSAMPROW rows[1] = {row};
            if (jpeg_read_scanlines(&cinfo, rows, 1) != 1) break;
          }
          ok = (cinfo.output_scanline == h);
          jpeg_finish_decompress(&cinfo);
        }
      }
    }
  }
  jpeg_destroy_decompress(&cinfo);
  Py_END_ALLOW_THREADS

  PyBuffer_Release(&view);
  if (!ok) {
    free(out);
    PyErr_SetString(PyExc_ValueError, "jpeg decode failed");
    return NULL;
  }
  PyObject *bytes = PyBytes_FromStringAndSize((const char *)out,
                                              (Py_ssize_t)h * w * 3);
  free(out);
  if (!bytes) return NULL;
  PyObject *result = Py_BuildValue("IIN", h, w, bytes);
  return result;
}
// ---------------------------------------------------------------------
// JPEG encode via the system libjpeg: (rgb_bytes, h, w, quality) -> bytes,
// 4:2:0 chroma (jpeg_set_defaults). Used by the synthetic shard writer.
// ---------------------------------------------------------------------
static PyObject *py_encode_jpeg(PyObject *self, PyObject *args) {
  Py_buffer view;
  unsigned int h, w;
  int quality;
  if (!PyArg_ParseTuple(args, "y*IIi", &view, &h, &w, &quality)) return NULL;
  if (h == 0 || w == 0 || (size_t)view.len != (size_t)h * w * 3 ||
      quality < 1 || quality > 100) {
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_ValueError, "bad encode_jpeg arguments");
    return NULL;
  }

  struct jpeg_compress_struct cinfo;
  merlot_jpeg_err jerr;
  unsigned char *volatile out = NULL;
  unsigned long out_len = 0;
  volatile int ok = 0;

  Py_BEGIN_ALLOW_THREADS
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = merlot_jpeg_error_exit;
  if (!setjmp(jerr.setjmp_buffer)) {
    jpeg_create_compress(&cinfo);
    unsigned char *buf = NULL;
    jpeg_mem_dest(&cinfo, &buf, &out_len);
    cinfo.image_width = w;
    cinfo.image_height = h;
    cinfo.input_components = 3;
    cinfo.in_color_space = JCS_RGB;
    jpeg_set_defaults(&cinfo);
    jpeg_set_quality(&cinfo, quality, TRUE);
    jpeg_start_compress(&cinfo, TRUE);
    size_t stride = (size_t)w * 3;
    while (cinfo.next_scanline < h) {
      JSAMPROW rows[1] = {(JSAMPROW)((const unsigned char *)view.buf +
                                     (size_t)cinfo.next_scanline * stride)};
      jpeg_write_scanlines(&cinfo, rows, 1);
    }
    jpeg_finish_compress(&cinfo);
    out = buf;
    ok = 1;
  }
  jpeg_destroy_compress(&cinfo);
  Py_END_ALLOW_THREADS

  PyBuffer_Release(&view);
  if (!ok) {
    free(out);
    PyErr_SetString(PyExc_ValueError, "jpeg encode failed");
    return NULL;
  }
  PyObject *bytes = PyBytes_FromStringAndSize((const char *)out, (Py_ssize_t)out_len);
  free(out);
  return bytes;
}
#endif  // MERLOT_HAVE_JPEG

// ---------------------------------------------------------------------
// Fused align-corners bilinear resize + crop + pad (+ uint8 dequant).
// The reference's resize runs inside TF's C++ ResizeBilinear kernel with
// align_corners=True (utils/model_utils.py:914-921); the Python fallback
// (image_ops.resize_bilinear_ac) is the bit-exactness oracle. One pass:
// source u8 or f32 HxWx3 -> float32 [out_h, out_w, 3] with the resized
// image cropped at (off_y, off_x) of the virtual [scaled_h, scaled_w]
// resize and zero-padded to the fixed output. GIL released.
// ---------------------------------------------------------------------
// u8 -> [0,1] via a table of the exact `(float)v / 255.0f` values
// (identical results to the per-pixel division, none of its cost).
// Filled once at module init — parse-pool threads run resize_rows_f32
// with the GIL released, so lazy in-function init would be a data race.
static float g_u8_lut[256];

static int resize_rows_f32(const float *src, const uint8_t *src8,
                           long in_h, long in_w, double sy_scale,
                           double sx_scale, long off_y, long off_x,
                           long copy_h, long copy_w, long out_w,
                           float *dst) {
  // per-column gather indices/weights, matching the numpy oracle:
  // coords in double, weights cast to f32 AFTER the subtraction
  long *x0 = (long *)malloc(sizeof(long) * (size_t)copy_w);
  long *x1 = (long *)malloc(sizeof(long) * (size_t)copy_w);
  float *wx = (float *)malloc(sizeof(float) * (size_t)copy_w);
  if (!x0 || !x1 || !wx) {
    free(x0); free(x1); free(wx);
    return -1;  // caller raises MemoryError (dst would stay all-zero)
  }
  for (long xx = 0; xx < copy_w; xx++) {
    double sx = (double)(off_x + xx) * sx_scale;
    long c0 = (long)sx;  // sx >= 0, truncation == floor
    if (c0 > in_w - 1) c0 = in_w - 1;
    long c1 = c0 + 1 < in_w ? c0 + 1 : in_w - 1;
    x0[xx] = c0 * 3;
    x1[xx] = c1 * 3;
    wx[xx] = (float)(sx - (double)c0);
  }
  for (long yy = 0; yy < copy_h; yy++) {
    double sy = (double)(off_y + yy) * sy_scale;
    long y0 = (long)sy;
    if (y0 > in_h - 1) y0 = in_h - 1;
    long y1 = y0 + 1 < in_h ? y0 + 1 : in_h - 1;
    float wy = (float)(sy - (double)y0);
    float *out_row = dst + (size_t)yy * out_w * 3;
    if (src8) {
      const uint8_t *r0 = src8 + (size_t)y0 * in_w * 3;
      const uint8_t *r1 = src8 + (size_t)y1 * in_w * 3;
      for (long xx = 0; xx < copy_w; xx++) {
        long c0 = x0[xx], c1 = x1[xx];
        float fx = wx[xx];
        for (int ch = 0; ch < 3; ch++) {
          float top = g_u8_lut[r0[c0 + ch]] * (1.0f - fx) +
                      g_u8_lut[r0[c1 + ch]] * fx;
          float bot = g_u8_lut[r1[c0 + ch]] * (1.0f - fx) +
                      g_u8_lut[r1[c1 + ch]] * fx;
          out_row[xx * 3 + ch] = top * (1.0f - wy) + bot * wy;
        }
      }
    } else {
      const float *r0 = src + (size_t)y0 * in_w * 3;
      const float *r1 = src + (size_t)y1 * in_w * 3;
      for (long xx = 0; xx < copy_w; xx++) {
        long c0 = x0[xx], c1 = x1[xx];
        float fx = wx[xx];
        for (int ch = 0; ch < 3; ch++) {
          float top = r0[c0 + ch] * (1.0f - fx) + r0[c1 + ch] * fx;
          float bot = r1[c0 + ch] * (1.0f - fx) + r1[c1 + ch] * fx;
          out_row[xx * 3 + ch] = top * (1.0f - wy) + bot * wy;
        }
      }
    }
  }
  free(x0); free(x1); free(wx);
  return 0;
}

static PyObject *py_resize_bilinear_pad(PyObject *self, PyObject *args) {
  Py_buffer dst_view, view;
  long in_h, in_w, is_u8, scaled_h, scaled_w, off_y, off_x, out_h, out_w;
  if (!PyArg_ParseTuple(args, "w*y*lllllllll", &dst_view, &view, &in_h,
                        &in_w, &is_u8, &scaled_h, &scaled_w, &off_y, &off_x,
                        &out_h, &out_w))
    return NULL;
  size_t need = (size_t)in_h * in_w * 3 * (is_u8 ? 1 : 4);
  if (in_h < 1 || in_w < 1 || scaled_h < 1 || scaled_w < 1 || out_h < 1 ||
      out_w < 1 || off_y < 0 || off_x < 0 || (size_t)view.len != need ||
      (size_t)dst_view.len != (size_t)out_h * out_w * 3 * 4) {
    PyBuffer_Release(&dst_view);
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_ValueError, "bad resize arguments");
    return NULL;
  }
  float *dst = (float *)dst_view.buf;

  long copy_h = scaled_h - off_y;
  if (copy_h > out_h) copy_h = out_h;
  if (copy_h < 0) copy_h = 0;
  long copy_w = scaled_w - off_x;
  if (copy_w > out_w) copy_w = out_w;
  if (copy_w < 0) copy_w = 0;
  double sy_scale =
      scaled_h > 1 ? (double)(in_h - 1) / (double)(scaled_h - 1) : 0.0;
  double sx_scale =
      scaled_w > 1 ? (double)(in_w - 1) / (double)(scaled_w - 1) : 0.0;

  int rc = 0;
  Py_BEGIN_ALLOW_THREADS
  // caller provides a zeroed float32 [out_h, out_w, 3] array (np.zeros —
  // calloc'd); only the resized crop window is written here
  if (copy_h > 0 && copy_w > 0)
    rc = resize_rows_f32(is_u8 ? NULL : (const float *)view.buf,
                         is_u8 ? (const uint8_t *)view.buf : NULL, in_h,
                         in_w, sy_scale, sx_scale, off_y, off_x, copy_h,
                         copy_w, out_w, dst);
  Py_END_ALLOW_THREADS

  PyBuffer_Release(&dst_view);
  PyBuffer_Release(&view);
  if (rc != 0)
    return PyErr_NoMemory();  // never hand back a silently-black image
  Py_RETURN_NONE;
}

static PyMethodDef Methods[] = {
    {"crc32c", py_crc32c, METH_VARARGS, "crc32c (Castagnoli) of bytes"},
    {"masked_crc", py_masked_crc, METH_VARARGS, "TFRecord masked crc32c"},
    {"read_record_spans", py_read_record_spans, METH_VARARGS,
     "tfrecord file -> [(payload_offset, length)] with CRC verification"},
    {"scan_example", py_scan_example, METH_VARARGS,
     "Example payload -> {key: (list_field, inner_off, inner_len)}"},
    {"resize_bilinear_pad", py_resize_bilinear_pad, METH_VARARGS,
     "(dst_f32, src, in_h, in_w, is_u8, scaled_h, scaled_w, off_y, off_x, "
     "out_h, out_w); fused align-corners bilinear + crop into zeroed dst"},
#ifdef MERLOT_HAVE_JPEG
    {"decode_jpeg", py_decode_jpeg, METH_VARARGS,
     "jpeg bytes -> (h, w, rgb bytes); libjpeg, GIL released"},
    {"encode_jpeg", py_encode_jpeg, METH_VARARGS,
     "(rgb bytes, h, w, quality) -> jpeg bytes; libjpeg, GIL released"},
#endif
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef module = {PyModuleDef_HEAD_INIT, "_merlot_native",
                                    NULL, -1, Methods};

PyMODINIT_FUNC PyInit__merlot_native(void) {
  init_tables();
  // module init runs single-threaded; the GIL-released resize threads
  // only ever read this table
  for (int i = 0; i < 256; i++) g_u8_lut[i] = (float)i / 255.0f;
  return PyModule_Create(&module);
}
