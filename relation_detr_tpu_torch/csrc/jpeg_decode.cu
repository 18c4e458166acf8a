// JPEG decode with nvJPEG (CUDA toolkit), for the port's data path.
//
// The counterpart of the JAX package's host decode: cv2.imdecode(...,
// IMREAD_COLOR) + BGR->RGB (relation_detr_tpu/data/coco.py:133-135), or
// libjpeg in csrc/dataplane.cpp. Not a TPU kernel port. nvJPEG's own kernels
// run the inverse DCT (the Huffman decode runs on the calling host thread
// with the default, hybrid backend, which is why the loader decodes in
// several threads). For YCbCr files at 4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1
// and 4:1:0, nvJPEG returns the planes and ycc_to_rgb_kernel below
// upsamples the chroma and converts to RGB as libjpeg-turbo does (cv2's
// decoder): its "fancy" triangle filter where it has one (jdsample.c
// h2v1/h2v2/h1v2_fancy_upsample, edges replicated), plain replication
// (int_upsample) for 4:1:1 and 4:1:0, and its fixed-point colour conversion
// (jdcolor.c ycc_rgb_convert). On a saturated 4:2:0 test image, mean
// |difference| from cv2 is 0.04 levels this way (what is left is the
// inverse DCT's rounding) against 4.78 with nvJPEG's own RGB output
// (measured on the H100). nvJPEG's 4:1:0V takes nvJPEG's RGB; grayscale its
// luma plane; a four-component file (CMYK, YCCK) its four planes as stored,
// which the caller converts on the host (data/image_io.py::cmyk_to_rgb).
//
// ycc_to_rgb_kernel: one thread per output pixel; it reads ~1 luma and 4
// chroma bytes and writes 3, so it is bound by bytes (a few microseconds
// at COCO sizes); the chroma reads of neighbouring threads overlap and
// stay in L1.
//
// One library handle serves every thread (nvJPEG's handle is thread-safe).
// A state (nvJPEG's per-decode state and a stream) is used by one thread at
// a time; the Python side keeps a pool of them. jpeg_decode decodes into the
// caller's device planes on the state's stream and does not wait: the
// caller launches ycc_to_rgb on that stream (through the one wrapper,
// data/image_io.py::ycc_to_rgb) and copies the result to the host there.
// EXIF orientation is applied by the caller: nvJPEG does not rotate.
//
// Built into its own library (librdetr_jpeg_*.so, linked with -lnvjpeg) so
// that the kernels' library does not need nvJPEG.
//
// Returns: 0; an nvjpegStatus_t (1..99); or 1000 + a cudaError_t.
#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstdint>
#include <cstring>
#include <new>

namespace {

constexpr int kCudaBase = 1000;

struct JpegState {
  int device = 0;
  nvjpegJpegState_t jpeg = nullptr;
  cudaStream_t stream = nullptr;
};

int cuda_code(cudaError_t err) { return err == cudaSuccess ? 0 : kCudaBase + (int)err; }

// libjpeg's fixed-point YCbCr -> RGB (jdcolor.c: SCALEBITS 16, FIX(x) =
// x * 65536 + 0.5, ONE_HALF folded into the Cb -> G term), clamped to 0..255.
__device__ __forceinline__ unsigned char clamp255(int v) {
  return (unsigned char)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// Chroma of output pixel (x, y) from a (ch, cw) plane upsampled by (hf, vf)
// = (1, 1), (2, 1), (2, 2), (1, 2), (4, 1) or (4, 2), as libjpeg-turbo's
// upsampling gives it.
__device__ __forceinline__ int fancy_chroma(const unsigned char *__restrict__ c, int ch,
                                            int cw, int hf, int vf, int x, int y) {
  if (hf == 1 && vf == 1) return c[(size_t)y * cw + x];
  if (hf == 4) return c[(size_t)(y / vf) * cw + (x >> 2)];  // int_upsample: replication
  if (hf == 1) {  // h1v2: 3/4 nearer + 1/4 further row (edge rows replicated)
    const int inrow = y >> 1;
    const int far = (y & 1) == 0 ? (inrow > 0 ? inrow - 1 : 0)
                                  : (inrow < ch - 1 ? inrow + 1 : ch - 1);
    const int sum = 3 * c[(size_t)inrow * cw + x] + c[(size_t)far * cw + x];
    return (sum + ((y & 1) == 0 ? 1 : 2)) >> 2;
  }
  if (vf == 1) {  // h2v1: 3/4 nearer + 1/4 further column, edges as is
    const unsigned char *row = c + (size_t)y * cw;
    const int col = x >> 1;
    const int v = 3 * row[col];
    if ((x & 1) == 0) return col == 0 ? row[0] : (v + row[col - 1] + 1) >> 2;
    return col == cw - 1 ? row[col] : (v + row[col + 1] + 2) >> 2;
  }
  // h2v2: column sums of 3/4 nearer + 1/4 further row (edge rows replicated),
  // then 3/4 nearer + 1/4 further column sum
  const int inrow = y >> 1;
  const int far = (y & 1) == 0 ? (inrow > 0 ? inrow - 1 : 0)
                                : (inrow < ch - 1 ? inrow + 1 : ch - 1);
  const unsigned char *r0 = c + (size_t)inrow * cw;
  const unsigned char *r1 = c + (size_t)far * cw;
  const int col = x >> 1;
  const int sum = 3 * r0[col] + r1[col];
  if ((x & 1) == 0) {
    if (col == 0) return (sum * 4 + 8) >> 4;
    return (sum * 3 + 3 * r0[col - 1] + r1[col - 1] + 8) >> 4;
  }
  if (col == cw - 1) return (sum * 4 + 7) >> 4;
  return (sum * 3 + 3 * r0[col + 1] + r1[col + 1] + 7) >> 4;
}

__global__ void ycc_to_rgb_kernel(const unsigned char *__restrict__ yp,
                                  const unsigned char *__restrict__ cbp,
                                  const unsigned char *__restrict__ crp,
                                  unsigned char *__restrict__ out, int h, int w, int ch, int cw,
                                  int hf, int vf) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w || y >= h) return;
  const int luma = yp[(size_t)y * w + x];
  const int cb = fancy_chroma(cbp, ch, cw, hf, vf, x, y) - 128;
  const int cr = fancy_chroma(crp, ch, cw, hf, vf, x, y) - 128;
  unsigned char *px = out + ((size_t)y * w + x) * 3;
  px[0] = clamp255(luma + ((91881 * cr + 32768) >> 16));
  px[1] = clamp255(luma + ((-22554 * cb + 32768 - 46802 * cr) >> 16));
  px[2] = clamp255(luma + ((116130 * cb + 32768) >> 16));
}

}  // namespace

extern "C" {

// The chroma upsampling and colour conversion, on device planes: Y (h, w),
// Cb and Cr (ch, cw), out (h, w, 3) uint8, on `stream`.
int ycc_to_rgb(const void *yp, const void *cbp, const void *crp, void *out, int64_t h,
               int64_t w, int64_t ch, int64_t cw, int64_t hf, int64_t vf, void *stream) {
  const int threads = 128;
  dim3 grid((unsigned)((w + threads - 1) / threads), (unsigned)h);
  ycc_to_rgb_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char *>(yp), static_cast<const unsigned char *>(cbp),
      static_cast<const unsigned char *>(crp), static_cast<unsigned char *>(out), (int)h,
      (int)w, (int)ch, (int)cw, (int)hf, (int)vf);
  return cuda_code(cudaGetLastError());
}

int jpeg_handle_create(void **handle) {
  nvjpegHandle_t h = nullptr;
  nvjpegStatus_t st = nvjpegCreateSimple(&h);
  if (st != NVJPEG_STATUS_SUCCESS) return (int)st;
  *handle = h;
  return 0;
}

int jpeg_handle_destroy(void *handle) {
  return (int)nvjpegDestroy(static_cast<nvjpegHandle_t>(handle));
}

int jpeg_state_create(void *handle, int64_t device, void **state) {
  JpegState *s = new (std::nothrow) JpegState();
  if (!s) return kCudaBase + (int)cudaErrorMemoryAllocation;
  s->device = (int)device;
  int code = cuda_code(cudaSetDevice(s->device));
  if (!code) code = cuda_code(cudaStreamCreateWithFlags(&s->stream, cudaStreamNonBlocking));
  if (!code) {
    nvjpegStatus_t st = nvjpegJpegStateCreate(static_cast<nvjpegHandle_t>(handle), &s->jpeg);
    code = (int)st;
  }
  if (code) {
    if (s->stream) cudaStreamDestroy(s->stream);
    delete s;
    return code;
  }
  *state = s;
  return 0;
}

int jpeg_state_destroy(void *state) {
  JpegState *s = static_cast<JpegState *>(state);
  cudaSetDevice(s->device);
  if (s->jpeg) nvjpegJpegStateDestroy(s->jpeg);
  if (s->stream) cudaStreamDestroy(s->stream);
  delete s;
  return 0;
}

// info: [components, chroma subsampling (nvjpegChromaSubsampling_t), then
//        the height and width of components 0, 1, 2 and 3 (0 where absent)]
int jpeg_image_info(void *handle, const unsigned char *data, int64_t length, int32_t *info) {
  int components = 0;
  nvjpegChromaSubsampling_t subsampling = NVJPEG_CSS_UNKNOWN;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  nvjpegStatus_t st = nvjpegGetImageInfo(static_cast<nvjpegHandle_t>(handle), data,
                                         (size_t)length, &components, &subsampling, widths,
                                         heights);
  if (st != NVJPEG_STATUS_SUCCESS) return (int)st;
  info[0] = components;
  info[1] = (int32_t)subsampling;
  for (int i = 0; i < NVJPEG_MAX_COMPONENT; ++i) {
    info[2 + 2 * i] = i < components ? heights[i] : 0;
    info[3 + 2 * i] = i < components ? widths[i] : 0;
  }
  return 0;
}

// The state's stream, for the caller's work on the decoded planes.
void *jpeg_state_stream(void *state) { return static_cast<JpegState *>(state)->stream; }

// Decodes into device planes on the state's stream, without waiting: format
// 0, nvJPEG's interleaved RGB into c0 (pitch p0); 1, luma into c0; 2, the Y,
// Cb and Cr planes into c0, c1, c2 (pitches p0, p1, p2); 3, every component
// as stored (NVJPEG_OUTPUT_UNCHANGED) into c0..c3.
int jpeg_decode(void *handle, void *state, const unsigned char *data, int64_t length,
                int64_t format, void *c0, int64_t p0, void *c1, int64_t p1, void *c2,
                int64_t p2, void *c3, int64_t p3) {
  JpegState *s = static_cast<JpegState *>(state);
  int code = cuda_code(cudaSetDevice(s->device));
  if (code) return code;
  const nvjpegOutputFormat_t formats[4] = {NVJPEG_OUTPUT_RGBI, NVJPEG_OUTPUT_Y,
                                           NVJPEG_OUTPUT_YUV, NVJPEG_OUTPUT_UNCHANGED};
  if (format < 0 || format > 3) return (int)NVJPEG_STATUS_INVALID_PARAMETER;
  nvjpegImage_t image;
  std::memset(&image, 0, sizeof(image));
  image.channel[0] = static_cast<unsigned char *>(c0);
  image.pitch[0] = (size_t)p0;
  image.channel[1] = static_cast<unsigned char *>(c1);
  image.pitch[1] = (size_t)p1;
  image.channel[2] = static_cast<unsigned char *>(c2);
  image.pitch[2] = (size_t)p2;
  image.channel[3] = static_cast<unsigned char *>(c3);
  image.pitch[3] = (size_t)p3;
  return (int)nvjpegDecode(static_cast<nvjpegHandle_t>(handle), s->jpeg, data, (size_t)length,
                           formats[format], &image, s->stream);
}

const char *jpeg_error_string(int code) {
  if (code >= kCudaBase) return cudaGetErrorString((cudaError_t)(code - kCudaBase));
  switch (code) {
    case NVJPEG_STATUS_SUCCESS: return "success";
    case NVJPEG_STATUS_NOT_INITIALIZED: return "nvJPEG not initialized";
    case NVJPEG_STATUS_INVALID_PARAMETER: return "nvJPEG invalid parameter";
    case NVJPEG_STATUS_BAD_JPEG: return "nvJPEG bad JPEG";
    case NVJPEG_STATUS_JPEG_NOT_SUPPORTED: return "nvJPEG JPEG not supported";
    case NVJPEG_STATUS_ALLOCATOR_FAILURE: return "nvJPEG allocator failure";
    case NVJPEG_STATUS_EXECUTION_FAILED: return "nvJPEG execution failed";
    case NVJPEG_STATUS_ARCH_MISMATCH: return "nvJPEG arch mismatch";
    case NVJPEG_STATUS_INTERNAL_ERROR: return "nvJPEG internal error";
    case NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED: return "nvJPEG implementation not supported";
    default: return "nvJPEG error";
  }
}

}  // extern "C"
