typedef unsigned long long int bit_t;
typedef struct {
  bit_t b0;
  bit_t b1;
  bit_t b2;
  bit_t b3;
  bit_t b4;
  bit_t b5;
} bits;
bit_t s0(bits in) {
  bit_t var6 = in.b0 & in.b2;
  bit_t var7 = var6 ^ in.b5;
  bit_t var8 = in.b0 | in.b2;
  bit_t var9 = var8 & in.b4;
  bit_t var10 = var7 ^ var9;
  bit_t var11 = in.b2 ^ var7;
  bit_t var12 = var11 & var9;
  bit_t var13 = var12 | in.b3;
  bit_t var14 = var10 ^ var13;
  bit_t var15 = var14 | var6;
  bit_t var16 = var15 & ~in.b4;
  bit_t var17 = var16 ^ in.b0;
  bit_t var18 = var17 & ~var11;
  bit_t var19 = var18 | in.b3;
  bit_t var20 = var17 ^ var19;
  bit_t var21 = var20 | in.b1;
  bit_t out0 = var14 ^ var21;
  return out0;
}
