#define LUT(a,b,c,d,e) asm("lop3.b32 %0, %1, %2, %3, "#e";" : "=r"(a): "r"(b), "r"(c), "r"(d));
typedef int bit_t;
typedef struct {
  bit_t b0;
  bit_t b1;
  bit_t b2;
  bit_t b3;
  bit_t b4;
  bit_t b5;
} bits;
__device__ __forceinline__ bit_t s0(bits in) {
  bit_t var6; LUT(var6, in.b0, in.b3, in.b5, 0x2c);
  bit_t var7; LUT(var7, in.b0, in.b3, in.b5, 0x5e);
  bit_t var8; LUT(var8, in.b2, var6, var7, 0xac);
  bit_t var9; LUT(var9, in.b2, in.b5, var8, 0x2c);
  bit_t var10; LUT(var10, var9, in.b0, in.b3, 0xb4);
  bit_t var11; LUT(var11, in.b4, var8, var10, 0xac);
  bit_t var12; LUT(var12, in.b0, in.b2, var8, 0x27);
  bit_t var13; LUT(var13, var6, var10, var11, 0x7c);
  bit_t var14; LUT(var14, var12, var13, in.b4, 0x36);
  bit_t out0; LUT(out0, in.b1, var11, var14, 0xac);
  return out0;
}
