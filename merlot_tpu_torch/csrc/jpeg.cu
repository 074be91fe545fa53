// JPEG decode and encode through nvJPEG (the CUDA toolkit's library): the
// data path's JPEG route that callers ask for by name, and the default only
// where neither libjpeg's header nor PIL is there
// (merlot_tpu_torch/data/_native). Plain C interface, loaded with ctypes;
// built by _build.py with -lnvjpeg.
//
//   merlot_jpeg_info(data, len, &h, &w)           size of the first component
//                                                 (1 or 3 components only)
//   merlot_jpeg_decode(data, len, out, h, w)      RGB interleaved into host out
//   merlot_jpeg_encode(rgb, h, w, q, out, cap, &n) 4:2:0 baseline JPEG
//   merlot_jpeg_error()                           the calling thread's last error
//
// Every calling thread (the loader's parse threads) gets its own handle,
// decode state, encoder, non-blocking stream and device buffer, so threads
// never share nvJPEG state and never wait on the training step's stream.
// All return 0 on success.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

struct Ctx {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  nvjpegEncoderState_t enc_state = nullptr;
  nvjpegEncoderParams_t enc_params = nullptr;
  cudaStream_t stream = nullptr;
  unsigned char *dbuf = nullptr;
  size_t cap = 0;
  bool ready = false;

  ~Ctx() {
    if (enc_params) nvjpegEncoderParamsDestroy(enc_params);
    if (enc_state) nvjpegEncoderStateDestroy(enc_state);
    if (state) nvjpegJpegStateDestroy(state);
    if (handle) nvjpegDestroy(handle);
    if (dbuf) cudaFree(dbuf);
    if (stream) cudaStreamDestroy(stream);
  }
};

thread_local Ctx ctx;
thread_local char last_error[256] = "";

int fail(const char *what, int code) {
  snprintf(last_error, sizeof(last_error), "%s failed with status %d", what, code);
  return code ? code : -1;
}

#define NVJ(call)                                        \
  do {                                                   \
    nvjpegStatus_t s_ = (call);                          \
    if (s_ != NVJPEG_STATUS_SUCCESS) return fail(#call, (int)s_); \
  } while (0)
#define CU(call)                                         \
  do {                                                   \
    cudaError_t e_ = (call);                             \
    if (e_ != cudaSuccess) return fail(#call, (int)e_);  \
  } while (0)

int ensure_ready() {
  if (ctx.ready) return 0;
  CU(cudaStreamCreateWithFlags(&ctx.stream, cudaStreamNonBlocking));
  NVJ(nvjpegCreateSimple(&ctx.handle));
  NVJ(nvjpegJpegStateCreate(ctx.handle, &ctx.state));
  NVJ(nvjpegEncoderStateCreate(ctx.handle, &ctx.enc_state, ctx.stream));
  NVJ(nvjpegEncoderParamsCreate(ctx.handle, &ctx.enc_params, ctx.stream));
  ctx.ready = true;
  return 0;
}

// grows the thread's device buffer (cudaMalloc synchronizes the device, so
// it happens only when a larger image than any before arrives)
int ensure_capacity(size_t bytes) {
  if (bytes <= ctx.cap) return 0;
  if (ctx.dbuf) CU(cudaFree(ctx.dbuf));
  ctx.dbuf = nullptr;
  ctx.cap = 0;
  CU(cudaMalloc(&ctx.dbuf, bytes));
  ctx.cap = bytes;
  return 0;
}

}  // namespace

extern "C" {

const char *merlot_jpeg_error() { return last_error; }

int merlot_jpeg_info(const unsigned char *data, size_t len, int *h, int *w) {
  if (int rc = ensure_ready()) return rc;
  int ncomp = 0;
  nvjpegChromaSubsampling_t sub;
  int widths[NVJPEG_MAX_COMPONENT] = {0}, heights[NVJPEG_MAX_COMPONENT] = {0};
  NVJ(nvjpegGetImageInfo(ctx.handle, data, len, &ncomp, &sub, widths, heights));
  // grayscale or YCbCr; the caller decodes anything else (CMYK) with PIL
  if (ncomp != 1 && ncomp != 3) return fail("merlot_jpeg_info: not 1 or 3 components", -3);
  *h = heights[0];
  *w = widths[0];
  return 0;
}

int merlot_jpeg_decode(const unsigned char *data, size_t len, unsigned char *out,
                       int h, int w) {
  if (int rc = ensure_ready()) return rc;
  size_t bytes = (size_t)h * w * 3;
  if (int rc = ensure_capacity(bytes)) return rc;
  nvjpegImage_t img;
  memset(&img, 0, sizeof(img));
  img.channel[0] = ctx.dbuf;
  img.pitch[0] = (size_t)w * 3;
  NVJ(nvjpegDecode(ctx.handle, ctx.state, data, len, NVJPEG_OUTPUT_RGBI, &img,
                   ctx.stream));
  CU(cudaMemcpyAsync(out, ctx.dbuf, bytes, cudaMemcpyDeviceToHost, ctx.stream));
  CU(cudaStreamSynchronize(ctx.stream));
  return 0;
}

int merlot_jpeg_encode(const unsigned char *rgb, int h, int w, int quality,
                       unsigned char *out, size_t cap, size_t *n) {
  if (int rc = ensure_ready()) return rc;
  size_t bytes = (size_t)h * w * 3;
  if (int rc = ensure_capacity(bytes)) return rc;
  CU(cudaMemcpyAsync(ctx.dbuf, rgb, bytes, cudaMemcpyHostToDevice, ctx.stream));
  NVJ(nvjpegEncoderParamsSetQuality(ctx.enc_params, quality, ctx.stream));
  NVJ(nvjpegEncoderParamsSetSamplingFactors(ctx.enc_params, NVJPEG_CSS_420, ctx.stream));
  NVJ(nvjpegEncoderParamsSetOptimizedHuffman(ctx.enc_params, 0, ctx.stream));
  nvjpegImage_t img;
  memset(&img, 0, sizeof(img));
  img.channel[0] = ctx.dbuf;
  img.pitch[0] = (size_t)w * 3;
  NVJ(nvjpegEncodeImage(ctx.handle, ctx.enc_state, ctx.enc_params, &img,
                        NVJPEG_INPUT_RGBI, w, h, ctx.stream));
  size_t need = 0;
  NVJ(nvjpegEncodeRetrieveBitstream(ctx.handle, ctx.enc_state, nullptr, &need,
                                    ctx.stream));
  CU(cudaStreamSynchronize(ctx.stream));
  if (need > cap) {
    *n = need;
    return fail("merlot_jpeg_encode: output buffer too small", -2);
  }
  NVJ(nvjpegEncodeRetrieveBitstream(ctx.handle, ctx.enc_state, out, &need, ctx.stream));
  CU(cudaStreamSynchronize(ctx.stream));
  *n = need;
  return 0;
}

}  // extern "C"
