/* The host image decoders', resamplers' and letterbox's C interface (ctypes: native/preproc.py).
 * Each function returns 0, or -1 with a message in err; no function
 * keeps state between calls. */
#ifndef YOLO_TPU_TORCH_NATIVE_H
#define YOLO_TPU_TORCH_NATIVE_H

#include <stddef.h>
#include <stdint.h>

/* JPEG bytes -> *out, a malloc'd (*h, *w, channels) uint8 image (RGB or
 * gray) that the caller frees with yolo_native_free. */
int yolo_jpeg_decode(const uint8_t *data, size_t len, int channels,
                     uint8_t **out, int *h, int *w, char *err,
                     size_t errlen);

/* A TIFF strip or tile's JPEG stream, its colour space not read from
 * the file: 3 components converted from YCbCr (_ycc) or kept as they
 * are (_raw), as libtiff sets libjpeg's; no EXIF orientation. */
int yolo_jpeg_decode_ycc(const uint8_t *data, size_t len, int channels,
                         uint8_t **out, int *h, int *w, char *err,
                         size_t errlen);
int yolo_jpeg_decode_raw(const uint8_t *data, size_t len, int channels,
                         uint8_t **out, int *h, int *w, char *err,
                         size_t errlen);

/* TIFF LZW (tif_lzw.c) and PackBits data -> out, outlen bytes; returns
 * outlen, or -1 with a message (tiff.c). */
long yolo_tiff_lzw_decode(const uint8_t *in, size_t inlen, uint8_t *out,
                          size_t outlen, char *err, size_t errlen);
long yolo_tiff_packbits_decode(const uint8_t *in, size_t inlen, uint8_t *out,
                               size_t outlen, char *err, size_t errlen);

/* One TIFF strip -> out, its LZW stream as libtiff 4's encoder writes
 * it (outcap >= 2 * inlen + 16); returns the bytes written, or -1 with
 * a message (tiff.c). */
long yolo_tiff_lzw_encode(const uint8_t *in, size_t inlen, uint8_t *out,
                          size_t outcap, char *err, size_t errlen);

/* A WebP file's VP8L chunk -> *out, (h, w, 4) RGBA, alpha not
 * premultiplied; channels must be 4 (webp_lossless.c). */
int yolo_webp_decode_vp8l(const uint8_t *data, size_t len, int channels,
                          uint8_t **out, int *h, int *w, char *err,
                          size_t errlen);

/* (h, w, 3) RGB -> *out, a malloc'd "VP8L" chunk payload of *outlen
 * bytes, lossless; mode -1 chooses each tile's predictor, 0..13 forces
 * one (webp_lossless_enc.c). */
int yolo_webp_encode_vp8l(const uint8_t *rgb, int w, int h, int mode,
                          uint8_t **out, size_t *outlen, char *err,
                          size_t errlen);

/* A WebP file's "VP8 " chunk -> *out, (h, w, 3) RGB through libwebp's
 * fancy upsampling; channels must be 3 (webp_lossy.c). */
int yolo_webp_decode_vp8(const uint8_t *data, size_t len, int channels,
                         uint8_t **out, int *h, int *w, char *err,
                         size_t errlen);

/* Radiance RGBE pixel data (after the header) of a w x h image -> rgb,
 * (h, w, 3) uint8 as cv2 converts them, in the file's channel order
 * (hdr.c). */
int yolo_hdr_decode_pixels(const uint8_t *data, size_t len, int w, int h,
                           uint8_t *rgb, char *err, size_t errlen);

/* (h, w, 3) uint8 -> out, the RGBE pixel data cv2.imwrite writes
 * (outcap >= 5 * w * h + 4 * h + 16); returns the bytes written, or -1
 * with a message (hdr.c). */
long yolo_hdr_encode_pixels(const uint8_t *rgb, int w, int h, uint8_t *out,
                            size_t outcap, char *err, size_t errlen);

/* The joined sub-block data of one GIF image -> out, its n colour
 * indices in stored row order; 0, -1 with a message where cv2 gives no
 * image, -2 where cv2's result is not reproduced (gif.c). */
int yolo_gif_lzw_decode(const uint8_t *data, size_t len, int min_code_size,
                        uint8_t *out, size_t n, char *err, size_t errlen);

/* (h, w, 3) RGB -> *out, a malloc'd GIF image data block (the LZW
 * minimum code size, the sub-blocks, the terminator) of *outlen bytes,
 * as cv2.imwrite writes it: OpenCV 5's fixed 3-3-2 palette and its
 * Floyd-Steinberg diffusion (gif_enc.c). */
int yolo_gif_encode(const uint8_t *rgb, int h, int w, uint8_t **out,
                    size_t *outlen, char *err, size_t errlen);

/* A JPEG 2000 codestream (FF4F FF51 ...) -> *out, a malloc'd int32 array
 * of every component's samples in turn, as OpenJPEG 2.5 decodes them
 * (level-shifted and clamped to their precision); info receives [ncomp,
 * x0, y0, x1, y1] and per component [prec, sgnd, dx, dy, x0, y0, w, h]
 * (5 + 8 * maxcomps ints). Fails, with a message, beyond maxcomps
 * components (j2k.c). */
int yolo_j2k_decode(const uint8_t *data, size_t len, int32_t **out,
                    int32_t *info, int maxcomps, char *err, size_t errlen);

/* An AVIF item's AV1 OBUs (one key frame, profile 0, 8-bit 4:2:0) ->
 * *out, a malloc'd block of the cropped Y (w * h), U and V (cw * ch
 * each) planes libaom 3.14.1 decodes; info receives [w, h, cw, ch,
 * colour_description_present, primaries, transfer, matrix, full_range]
 * (9 ints). What the decoder leaves out fails naming it (av1_obu.c). */
int yolo_av1_decode(const uint8_t *data, size_t len, uint8_t **out,
                    int32_t *info, char *err, size_t errlen);

/* 8-bit 4:2:0 planes (y w * h, u and v ((w + 1) / 2) * ((h + 1) / 2)) ->
 * rgb (h, w, 3) as libavif 1.4.2 converts them through libyuv (BT.601 at
 * full range); other matrices and limited range fail (av1_filter.c). */
int yolo_avif_yuv_to_rgb(const uint8_t *y, const uint8_t *u,
                         const uint8_t *v, int w, int h, int matrix,
                         int full_range, uint8_t *rgb, char *err,
                         size_t errlen);

/* BMP bytes -> *out, as yolo_jpeg_decode (bmp.c). */
int yolo_bmp_decode(const uint8_t *data, size_t len, int channels,
                    uint8_t **out, int *h, int *w, char *err, size_t errlen);

/* PNG rows after inflate (h rows of a filter byte + stride bytes) ->
 * out, h * stride unfiltered bytes; bpp is the filter's byte distance. */
int yolo_png_unfilter(const uint8_t *raw, int h, size_t stride, int bpp,
                      uint8_t *out, char *err, size_t errlen);

/* Inflated PNG rows of an h x w image of the given bit depth and colour
 * type -> out, (h, w, channels) uint8 as cv2.imread gives them; palette:
 * 256 RGB entries, zero past the PLTE chunk's; gamma: the file's gamma
 * in libpng's fixed point (100000 = 1.0), 0 for none, which a colour
 * image's gray is computed through. */
int yolo_png_decode_rows(const uint8_t *raw, size_t rawlen, int h, int w,
                         int depth, int color, const uint8_t *palette,
                         int channels, int gamma, uint8_t *out, char *err,
                         size_t errlen);

/* cv2.GaussianBlur(src, (ksize, ksize), 0) of an (h, w, c) uint8 image,
 * c = 1 or 3, ksize odd, BORDER_REFLECT_101 -> dst (h, w, c). */
int yolo_gaussian_blur_u8(const uint8_t *src, int h, int w, int c,
                          int ksize, uint8_t *dst, char *err,
                          size_t errlen);

/* cv2.warpAffine(src, m, (dw, dh), INTER_LINEAR | WARP_INVERSE_MAP,
 * BORDER_REPLICATE) of an (sh, sw, c) uint8 image, m 6 doubles (row
 * major 2x3) -> dst (dh, dw, c). */
int yolo_warp_affine_u8(const uint8_t *src, int sh, int sw, int c,
                        const double *m, int dh, int dw, uint8_t *dst,
                        char *err, size_t errlen);

/* cv2.cvtColor(src, COLOR_HSV2RGB) of an (h, w, 3) uint8 image, hue range
 * 180 -> dst (h, w, 3) RGB, as OpenCV 5's AVX2 build gives it. */
int yolo_hsv2rgb_u8(const uint8_t *src, int h, int w, uint8_t *dst,
                    char *err, size_t errlen);

/* The letterbox of (batch, src_h, src_w, c) uint8 images, c = 1 or 3,
 * onto a gray (0.5) (net_h, net_w) canvas -> dst (batch, net_h, net_w, c)
 * float32 in [0, 1], on min(n_threads, batch) threads (letterbox.c). */
int yolo_letterbox_batch(const uint8_t *src, int batch, int src_h,
                         int src_w, int c, float *dst, int net_h, int net_w,
                         int n_threads, char *err, size_t errlen);

/* The stretch of one (src_h, src_w, c) uint8 image to (net_h, net_w),
 * aspect ratio not kept -> dst (net_h, net_w, c) float32 in [0, 1]:
 * cv2.resize INTER_LINEAR of image / 255 as OpenCV's Intel IPP path
 * computes it (letterbox.c). */
int yolo_stretch(const uint8_t *src, int src_h, int src_w, int c,
                 float *dst, int net_h, int net_w, char *err,
                 size_t errlen);

/* The standard Huffman tables of Annex K.3 (jpeg_enc.c): code counts of
 * lengths 1..16, then the symbols. */
extern const uint8_t kDcLumaBits[16], kDcChromaBits[16], kDcVals[12];
extern const uint8_t kAcLumaBits[16], kAcLumaVals[162];
extern const uint8_t kAcChromaBits[16], kAcChromaVals[162];

void yolo_native_free(void *p);

#endif
