/* Encode raw 8-bit RGB with libjpeg at sampling factors Pillow's encoder
 * does not offer (4:4:0, 4:1:1, chroma above luma), or arithmetic-coded,
 * for tests/make_torch_jpeg_fixtures.py:
 *
 *   jpeg_sampling_encoder in.rgb width height out.jpg quality
 *       h0 v0 h1 v1 h2 v2 progressive arithmetic
 *
 * Build: gcc -O2 -o jpeg_sampling_encoder jpeg_sampling_encoder.c -ljpeg
 */
#include <stdio.h>
#include <stdlib.h>
#include <jpeglib.h>

int main(int argc, char **argv) {
  if (argc != 14) {
    fprintf(stderr, "usage: %s in.rgb width height out.jpg quality "
            "h0 v0 h1 v1 h2 v2 progressive arithmetic\n", argv[0]);
    return 2;
  }
  int w = atoi(argv[2]), h = atoi(argv[3]);
  size_t n = (size_t)w * h * 3;
  unsigned char *buf = malloc(n);
  FILE *fi = fopen(argv[1], "rb");
  if (!buf || !fi || fread(buf, 1, n, fi) != n) {
    fprintf(stderr, "cannot read %s\n", argv[1]);
    return 1;
  }
  fclose(fi);
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  FILE *fo = fopen(argv[4], "wb");
  if (!fo) return 1;
  jpeg_stdio_dest(&c, fo);
  c.image_width = w;
  c.image_height = h;
  c.input_components = 3;
  c.in_color_space = JCS_RGB;
  jpeg_set_defaults(&c);
  jpeg_set_quality(&c, atoi(argv[5]), TRUE);
  for (int i = 0; i < 3; i++) {
    c.comp_info[i].h_samp_factor = atoi(argv[6 + 2 * i]);
    c.comp_info[i].v_samp_factor = atoi(argv[7 + 2 * i]);
  }
  if (atoi(argv[12])) jpeg_simple_progression(&c);
  c.arith_code = atoi(argv[13]) ? TRUE : FALSE;
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = buf + (size_t)c.next_scanline * w * 3;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  fclose(fo);
  jpeg_destroy_compress(&c);
  free(buf);
  return 0;
}
