/* Batched f32 products summed in a fixed order (models/cpu_math.py):
 *
 *   out[g, m, n] = sum_k a[g, m, k] * b[g, k, n]
 *
 * with K cut into blocks of kc; a block's sum is `lanes` chains over
 * k = j mod lanes, each starting from its first product and then one
 * fused multiply-add a step, the chains added by adjacent pairs; the
 * blocks' sums are added in order.  Build with -ffp-contract=off: every
 * other multiply and add rounds on its own.  The loops over n are
 * independent outputs (the order of each output's sum is the k loop's). */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

int cpu_dot(const float *a, const float *b, float *out, int64_t g_n,
            int64_t m_n, int64_t k_n, int64_t n_n, int64_t lanes,
            int64_t kc)
{
    float *parts = malloc(sizeof(float) * (size_t)(lanes * n_n));
    if (!parts)
        return 1;
    for (int64_t g = 0; g < g_n; ++g) {
        const float *bg = b + g * k_n * n_n;
        for (int64_t m = 0; m < m_n; ++m) {
            const float *x = a + (g * m_n + m) * k_n;
            float *o = out + (g * m_n + m) * n_n;
            for (int64_t s = 0; s < k_n; s += kc) {
                int64_t e = s + kc < k_n ? s + kc : k_n;
                int64_t nl = lanes < e - s ? lanes : e - s;
                for (int64_t j = 0; j < nl; ++j) {
                    float *p = parts + j * n_n;
                    const float *row = bg + (s + j) * n_n;
                    float xv = x[s + j];
                    for (int64_t n = 0; n < n_n; ++n)
                        p[n] = xv * row[n];
                    for (int64_t i = s + j + lanes; i < e; i += lanes) {
                        row = bg + i * n_n;
                        xv = x[i];
                        for (int64_t n = 0; n < n_n; ++n)
                            p[n] = fmaf(xv, row[n], p[n]);
                    }
                }
                int64_t len = nl;
                while (len > 1) {
                    int64_t half = len / 2;
                    for (int64_t i = 0; i < half; ++i) {
                        float *d = parts + i * n_n;
                        const float *l = parts + 2 * i * n_n;
                        const float *r = parts + (2 * i + 1) * n_n;
                        for (int64_t n = 0; n < n_n; ++n)
                            d[n] = l[n] + r[n];
                    }
                    if (len % 2)
                        memmove(parts + half * n_n, parts + (len - 1) * n_n,
                                sizeof(float) * (size_t)n_n);
                    len = half + len % 2;
                }
                if (s == 0)
                    memcpy(o, parts, sizeof(float) * (size_t)n_n);
                else
                    for (int64_t n = 0; n < n_n; ++n)
                        o[n] = o[n] + parts[n];
            }
        }
    }
    free(parts);
    return 0;
}
