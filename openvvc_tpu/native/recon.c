/* Native host reconstruction of a parsed entry.
 *
 * Consumes the SoA IR emitted by parse.c (ov_parse_entry) and writes the
 * picture planes and deblocking maps directly, removing Python from the
 * per-CU path. Supported toolset = the native-parse subset minus
 * {MIP, MRL, CCLM, LFNST, MTS-explicit/TS/BDPCM, LMCS}; implicit MTS is
 * handled. ov_recon_entry scans the IR first and returns -1 (untouched
 * output) when an unsupported feature appears, so the caller can fall
 * back to the Python reconstruction path.
 *
 * Behavior parity is with this repo's oracle-validated numpy references:
 * rcn/ref_intra.py (H.266 8.4.5.2), rcn/ref_mc.py (8.5.6.3),
 * rcn/ref_transform.py (8.7.3/8.7.4), decoder.py recon drivers, and
 * rcn/ref_dbf.py DbfMaps fills. Reference-decoder anchors:
 * /root/reference/libovvc/rcn_intra.c:484, rcn_mc.c:380-1360,
 * rcn_transform.c, rcn_inter.c:430-530, rcn_df.c map preprocessing.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#ifdef __AVX2__
#include <immintrin.h>
#endif

#include "ov_shared.h"
#include "gpm_inl.h"
#include "tables.h"

/* ---- stage profiling (ov_prof_read from Python; thread-safe adds) ---- */
enum { PROF_INTRA, PROF_INTER, PROF_RESID, PROF_DBFMAP, PROF_MCL, PROF_MCC, PROF_WR, PROF_N };
static int64_t ov_prof_ns[PROF_N];
static inline int64_t prof_now(void)
{
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec * 1000000000LL + ts.tv_nsec;
}
static inline void prof_add(int idx, int64_t t0)
{
    __atomic_fetch_add(&ov_prof_ns[idx], prof_now() - t0, __ATOMIC_RELAXED);
}
int64_t ov_prof_read(int idx) { return idx < PROF_N ? ov_prof_ns[idx] : 0; }
void ov_prof_reset(void) { memset(ov_prof_ns, 0, sizeof ov_prof_ns); }

#define OVINTRA_DIA_ 34
#define TR_DCT2 0
#define TR_DST7 1
#define TR_DCT8 2

static inline int imin(int a, int b) { return a < b ? a : b; }
static inline int imax(int a, int b) { return a > b ? a : b; }
static inline int iclamp(int v, int lo, int hi)
{
    return v < lo ? lo : (v > hi ? hi : v);
}
static inline int bdclip(int v, int bd_max)
{
    return v < 0 ? 0 : (v > bd_max ? bd_max : v);
}

/* ---- parameter blocks handed over from Python (ctypes mirrors) ------ */

typedef struct {
    int32_t dbf_enabled;
    int32_t csign;   /* -1 if ph_joint_cbcr_sign_flag else +1 */
    int32_t nb_refs; /* active L0 references */
    int32_t nb_refs1;
    int32_t poc0[16], poc1[16]; /* ref POCs (identical-motion check) */
} ReconParams;

typedef struct {
    const EntryParams *ep;
    const ReconParams *rp;
    const int32_t *tu_buf;
    const int32_t *coef_buf;
    const int8_t *cqp_tab;
    int32_t *fy, *fcb, *fcr; /* picture planes, stride = pic_w (/2) */
    const int32_t *const *ref_y;
    const int32_t *const *ref_cb;
    const int32_t *const *ref_cr;
    const int32_t *const *ref1_y;
    const int32_t *const *ref1_cb;
    const int32_t *const *ref1_cr;
    const int32_t *dist0;
    const int32_t *dist1;
    const DbfBufs *dbf;
    int uw, uh;       /* picture 4x4-unit grid (DBF maps) */
    int bd_max;
    /* per-tile availability (4-sample luma / 2-sample chroma units) */
    uint8_t *avail_l; /* ((tile_h+3)/4, (tile_w+3)/4) */
    uint8_t *avail_c;
    int al_w, al_h, ac_w, ac_h;
    /* affine/SbTMVP per-unit motion exported by the parse (tile units,
     * al_w x al_h): dirs + (x, y) per list */
    const uint8_t *sub_dir0, *sub_dir1;
    const int32_t *sub_mv; /* [al_h][al_w][2][2] */
    int32_t *tmv0, *tmv1;  /* writable TMVP export (DMVR field override) */
} Rc;

static void sub_unit_motion(const Rc *r, int x, int y, int *d0, int *d1,
                            int *m0x, int *m0y, int *m1x, int *m1y);
static void bdof_from_pos_c(const Rc *r,
                            const int32_t *pl0, int W0, int H0, int st0,
                            int x0i, int y0i, int fx0, int fy0,
                            const int32_t *pl1, int W1, int H1, int st1,
                            int x1i, int y1i, int fx1, int fy1,
                            int w, int h, int hpel, int32_t *dst,
                            int dstride);
static void recon_dmvr_cu(Rc *r, const int32_t *cu, int32_t *tmv0,
                          int32_t *tmv1, int apply_bdof);

/* ---- availability (decoder.py ReconCtx parity) ----------------------- */

static int luma_avail(const Rc *r, int x, int y)
{
    const EntryParams *e = r->ep;
    if (x < e->tile_x0 || x >= e->tile_x0 + e->tile_w ||
        y < e->tile_y0 || y >= e->tile_y0 + e->tile_h)
        return 0;
    return r->avail_l[((y - e->tile_y0) >> 2) * r->al_w + ((x - e->tile_x0) >> 2)];
}

static int chroma_avail(const Rc *r, int cx, int cy)
{
    const EntryParams *e = r->ep;
    int tx = e->tile_x0 >> 1, ty = e->tile_y0 >> 1;
    if (cx < tx || cx >= tx + (e->tile_w >> 1) ||
        cy < ty || cy >= ty + (e->tile_h >> 1))
        return 0;
    return r->avail_c[((cy - ty) >> 1) * r->ac_w + ((cx - tx) >> 1)];
}

static void mark_luma(Rc *r, int x0, int y0, int l2w, int l2h)
{
    const EntryParams *e = r->ep;
    int ux = (x0 - e->tile_x0) >> 2, uy = (y0 - e->tile_y0) >> 2;
    int nw = imax(1, (1 << l2w) >> 2), nh = imax(1, (1 << l2h) >> 2);
    for (int j = 0; j < nh && uy + j < r->al_h; j++)
        memset(r->avail_l + (uy + j) * r->al_w + ux, 1, imin(nw, r->al_w - ux));
}

static void mark_chroma(Rc *r, int cx0, int cy0, int l2w, int l2h)
{
    const EntryParams *e = r->ep;
    int ux = (cx0 - (e->tile_x0 >> 1)) >> 1, uy = (cy0 - (e->tile_y0 >> 1)) >> 1;
    int nw = imax(1, (1 << l2w) >> 1), nh = imax(1, (1 << l2h) >> 1);
    for (int j = 0; j < nh && uy + j < r->ac_h; j++)
        memset(r->avail_c + (uy + j) * r->ac_w + ux, 1, imin(nw, r->ac_w - ux));
}

/* ---- intra reference construction (rcn/ref_intra.py parity) ---------- */

/* RefArrays: buf[OFF + i], i in [-(max_side+8), 2*max_side + ...]. Blocks
 * are <= 64 so max_side = 2*64 = 128; OFF covers negative projections. */
#define ROFF 136
typedef struct { int32_t b[448]; } RefArr;

typedef int (*avail_fn_t)(const Rc *, int, int);

static void fill_side_refs(const Rc *r, const int32_t *plane, int stride,
                           int x0, int y0, int l2w, int l2h, int is_luma,
                           RefArr *ra, RefArr *rl)
{
    int w = 1 << l2w, h = 1 << l2h;
    int unit = is_luma ? 4 : 2;
    int avg = 1 << (r->ep->bitdepth - 1);
    int len_a = 2 * w, len_l = 2 * h;
    avail_fn_t av = is_luma ? luma_avail : chroma_avail;

    int corner_ok = av(r, x0 - 1, y0 - 1);
    int above_ok = av(r, x0, y0 - 1);
    int left_ok = av(r, x0 - 1, y0);

    memset(ra->b, 0, sizeof(ra->b));
    memset(rl->b, 0, sizeof(rl->b));

    if (left_ok) {
        rl->b[ROFF + 0] = corner_ok ? plane[(y0 - 1) * stride + x0 - 1]
                                    : plane[y0 * stride + x0 - 1];
        int nb_units = (len_l + unit - 1) / unit;
        int nav = 0;
        while (nav < nb_units && av(r, x0 - 1, y0 + nav * unit))
            nav++;
        int n_avail = nav * unit;
        for (int i = 0; i < n_avail; i++)
            rl->b[ROFF + 1 + i] = plane[(y0 + i) * stride + x0 - 1];
        int pad = n_avail ? rl->b[ROFF + n_avail] : rl->b[ROFF];
        for (int i = n_avail; i < len_l; i++)
            rl->b[ROFF + 1 + i] = pad;
    } else if (above_ok) {
        int v = plane[(y0 - 1) * stride + x0];
        for (int i = 0; i <= len_l; i++)
            rl->b[ROFF + i] = v;
    } else {
        for (int i = 0; i <= len_l; i++)
            rl->b[ROFF + i] = avg;
    }

    if (above_ok) {
        ra->b[ROFF + 0] = corner_ok ? plane[(y0 - 1) * stride + x0 - 1]
                                    : plane[(y0 - 1) * stride + x0];
        int nb_units = (len_a + unit - 1) / unit;
        int nav = 0;
        while (nav < nb_units && av(r, x0 + nav * unit, y0 - 1))
            nav++;
        int n_avail = nav * unit;
        for (int i = 0; i < n_avail; i++)
            ra->b[ROFF + 1 + i] = plane[(y0 - 1) * stride + x0 + i];
        int pad = n_avail ? ra->b[ROFF + n_avail] : ra->b[ROFF];
        for (int i = n_avail; i < len_a; i++)
            ra->b[ROFF + 1 + i] = pad;
    } else if (left_ok) {
        int v = plane[y0 * stride + x0 - 1];
        for (int i = 0; i <= len_a; i++)
            ra->b[ROFF + i] = v;
    } else {
        for (int i = 0; i <= len_a; i++)
            ra->b[ROFF + i] = avg;
    }

    for (int i = 1; i <= 8; i++) {
        rl->b[ROFF + len_l + i] = rl->b[ROFF + len_l];
        ra->b[ROFF + len_a + i] = ra->b[ROFF + len_a];
    }
}

/* [1 2 1] smoothing (filter_ref_array parity) */
static void filter_ref_array(const RefArr *ref, const RefArr *other,
                             int length, RefArr *out)
{
    memset(out->b, 0, sizeof(out->b));
    for (int i = 1; i < length; i++)
        out->b[ROFF + i] = (ref->b[ROFF + i - 1] + 2 * ref->b[ROFF + i]
                            + ref->b[ROFF + i + 1] + 2) >> 2;
    out->b[ROFF + 0] = (other->b[ROFF + 1] + 2 * ref->b[ROFF + 0]
                        + ref->b[ROFF + 1] + 2) >> 2;
    out->b[ROFF + length] = ref->b[ROFF + length];
    for (int i = 1; i <= 7; i++)
        out->b[ROFF + length + i] = ref->b[ROFF + length + i];
}

static void project_negative(RefArr *rm, const RefArr *rs, int n_proj,
                             int inv_angle, int side_len)
{
    int s = 256;
    for (int k = -1; k >= -n_proj; k--) {
        s += inv_angle;
        rm->b[ROFF + k] = rs->b[ROFF + imin(s >> 9, side_len)];
    }
}

static int pdpc_w(int scale, int pos)
{
    int sh = imin(31, (pos << 1) >> scale);
    return sh < 6 ? 32 >> imin(sh, 5) : 0;
}

static int derive_wide_mode(int l2w, int l2h, int mode)
{
    static const int shift_tab[6] = {0, 6, 10, 12, 14, 15};
    int shift = shift_tab[abs(l2w - l2h)];
    if (l2w > l2h && mode < 2 + shift)
        mode += OV_VDIA - 1;
    else if (l2h > l2w && mode > OV_VDIA - shift)
        mode -= OV_VDIA - 1;
    return mode;
}

static int floor_log2(int v)
{
    int r = 0;
    while (v > 1) { v >>= 1; r++; }
    return r;
}

/* intra_angular_core parity: pred [n_lines][line_len], filt:
 * 0=copy 1=linear 2=cubic 3=gauss */
static void angular_core(const RefArr *rm, int angle_val, int n_lines,
                         int line_len, int filt, int bd_max, int32_t *pred)
{
    int delta = 0;
    for (int j = 0; j < n_lines; j++) {
        delta += angle_val;
        int d_int = delta >> 5;
        int d_frac = delta & 0x1F;
        const int32_t *base = rm->b + ROFF + d_int;
        int32_t *row = pred + j * line_len;
        if (filt == 0) {
            for (int x = 0; x < line_len; x++)
                row[x] = base[1 + x];
        } else if (filt == 1) {
            for (int x = 0; x < line_len; x++) {
                int a = base[1 + x], b = base[2 + x];
                row[x] = a + ((d_frac * (b - a) + 16) >> 5);
            }
        } else {
            int t0, t1, t2, t3;
            if (filt == 3) {
                int half = d_frac >> 1;
                t0 = 16 - half; t1 = 32 - half; t2 = 16 + half; t3 = half;
            } else {
                t0 = g_cubic_filter[d_frac][0];
                t1 = g_cubic_filter[d_frac][1];
                t2 = g_cubic_filter[d_frac][2];
                t3 = g_cubic_filter[d_frac][3];
            }
            for (int x = 0; x < line_len; x++) {
                int acc = t0 * base[x] + t1 * base[x + 1]
                        + t2 * base[x + 2] + t3 * base[x + 3];
                int v = (acc + 32) >> 6;
                row[x] = filt == 2 ? bdclip(v, bd_max) : v;
            }
        }
    }
}

/* _pdpc_angular parity */
static void pdpc_angular(int32_t *pred, const RefArr *rs, int inv_angle,
                         int scale, int n_lines, int line_len, int bd_max)
{
    int lim = imin(3 << scale, line_len);
    for (int j = 0; j < n_lines; j++) {
        int inv_sum = 256 + inv_angle;
        int32_t *row = pred + j * line_len;
        for (int x = 0; x < lim; x++) {
            int wl = pdpc_w(scale, x);
            int p = rs->b[ROFF + j + (inv_sum >> 9) + 1];
            row[x] = bdclip(row[x] + ((wl * (p - row[x]) + 32) >> 6), bd_max);
            inv_sum += inv_angle;
        }
    }
}

/* predict_intra parity: writes pred [h][w] (already oriented). */


/* ---- CCLM / MDLM (rcn/ref_cclm.py parity; rcn_intra_cclm.c:71-520) -- */

static const int8_t g_cclm_div[16] = {0,7,6,5,5,4,4,3,3,2,2,1,1,1,1,0};

static int flog2_c(int v) { return 31 - __builtin_clz(v > 0 ? v : 1); }

static void cclm_lm_params(int avg_min_l, int avg_min_c, int avg_max_c,
                           int v, int log2_rng_l, int *pa, int *pb,
                           int *psh)
{
    int range_c = avg_max_c - avg_min_c;
    int lr = range_c ? flog2_c(range_c < 0 ? -range_c : range_c) + 1 : 0;
    int add = (1 << lr) >> 1;
    int a = (range_c * v + add) >> lr;
    int shift = 3 + log2_rng_l - lr;
    if (shift < 1) {
        shift = 1;
        a = a == 0 ? 0 : (a < 0 ? -15 : 15);
    }
    *pa = a;
    *pb = avg_min_c - ((a * avg_min_l) >> shift);
    *psh = shift;
}

/* one chroma plane (comp 1 or 2) of a CCLM PB */
static void predict_cclm_c(const Rc *r, const int32_t *cplane, int cs,
                           int cx0, int cy0, int l2w, int l2h, int mode,
                           int32_t *pred)
{
    const EntryParams *e = r->ep;
    const int32_t *luma = r->fy;
    int ls = e->pic_w;
    int pb_w = 1 << l2w, pb_h = 1 << l2h;
    int bd_max = r->bd_max;
    int colloc = e->cclm_colloc;
    int abv_avail = chroma_avail(r, cx0, cy0 - 1);
    int lft_avail = chroma_avail(r, cx0 - 1, cy0);
    int first_line = ((cy0 << 1) % (1 << e->log2_ctb)) == 0;
    int avg = 1 << (e->bitdepth - 1);

#define LY(lx, ly) luma[(2 * cy0 + (ly)) * ls + 2 * cx0 + (lx)]
#define CV(cx, cy) cplane[(cy0 + (cy)) * cs + cx0 + (cx)]

    int smp_y[4], smp_c[4], nsmp = 0;

    /* boundary subsample helpers (above row 0 / above / left) */
#define SUB_ABV0(step, n) do { \
    int start = (step) >> 1; \
    for (int i = 0; i < (n) && nsmp < 4; i++) { \
        int lx = (start + i * (step)) << 1; \
        int pl = (start == 0 && i == 0 && !lft_avail) ? 0 : 1; \
        smp_y[nsmp] = (2 + LY(lx - pl, -1) + 2 * LY(lx, -1) \
                       + LY(lx + 1, -1)) >> 2; \
        smp_c[nsmp] = CV(start + i * (step), -1); \
        nsmp++; } } while (0)
#define SUB_ABV(step, n) do { \
    int start = (step) >> 1; \
    for (int i = 0; i < (n) && nsmp < 4; i++) { \
        int lx = (start + i * (step)) << 1; \
        int pl = (start == 0 && i == 0 && !lft_avail) ? 0 : 1; \
        int s; \
        if (colloc) \
            s = 4 + LY(lx, -3) + LY(lx - pl, -2) + 4 * LY(lx, -2) \
                + LY(lx + 1, -2) + LY(lx, -1); \
        else \
            s = 4 + LY(lx - pl, -2) + 2 * LY(lx, -2) + LY(lx + 1, -2) \
                + LY(lx - pl, -1) + 2 * LY(lx, -1) + LY(lx + 1, -1); \
        smp_y[nsmp] = s >> 3; \
        smp_c[nsmp] = CV(start + i * (step), -1); \
        nsmp++; } } while (0)
#define SUB_LFT(step, n) do { \
    int start = (step) >> 1; \
    for (int i = 0; i < (n) && nsmp < 4; i++) { \
        int ly = (start + i * (step)) << 1; \
        int s; \
        if (colloc) { \
            int pa = (start == 0 && i == 0 && !abv_avail) ? 0 : 1; \
            s = 4 + LY(-2, ly - pa) + 4 * LY(-2, ly) + LY(-3, ly) \
                + LY(-1, ly) + LY(-2, ly + 1); \
        } else \
            s = 4 + 2 * LY(-2, ly) + LY(-1, ly) + LY(-3, ly) \
                + 2 * LY(-2, ly + 1) + LY(-1, ly + 1) + LY(-3, ly + 1); \
        smp_y[nsmp] = s >> 3; \
        smp_c[nsmp] = CV(-1, start + i * (step)); \
        nsmp++; } } while (0)

    if (mode == INTRA_LT_CCLM) {
        if (abv_avail || lft_avail) {
            int l2_abv = (abv_avail ? 1 : 0) + (lft_avail ? 0 : 1);
            int l2_lft = (lft_avail ? 1 : 0) + (abv_avail ? 0 : 1);
            if (abv_avail) {
                int n_abv = imin(pb_w, l2_abv << 1);
                int step = imax(1, pb_w >> l2_abv);
                if (first_line) SUB_ABV0(step, n_abv);
                else SUB_ABV(step, n_abv);
            }
            if (lft_avail) {
                int n_lft = imin(pb_h, l2_lft << 1);
                int step = imax(1, pb_h >> l2_lft);
                SUB_LFT(step, n_lft);
            }
        }
    } else if (mode == INTRA_T_CCLM) {
        if (abv_avail) {
            int nb_ref = (pb_w + imin(pb_w, pb_h)) >> 1;
            int nav = 0;
            while (nav < nb_ref && chroma_avail(r, cx0 + 2 * nav, cy0 - 1))
                nav++;
            int alen = nav << 1;
            int n_abv = imin(alen, 4);
            int step = imax(1, alen >> 2);
            if (first_line) SUB_ABV0(step, n_abv);
            else SUB_ABV(step, n_abv);
        }
    } else { /* INTRA_L_CCLM */
        if (lft_avail) {
            int nb_ref = (pb_h + imin(pb_w, pb_h)) >> 1;
            int nav = 0;
            while (nav < nb_ref && chroma_avail(r, cx0 - 1, cy0 + 2 * nav))
                nav++;
            int alen = nav << 1;
            int n_lft = imin(alen, 4);
            int step = imax(1, alen >> 2);
            SUB_LFT(step, n_lft);
        }
    }

    int a = 0, b = avg, sh = 0;
    if (nsmp) {
        int mn_l, mx_l, mn_c, mx_c;
        if (nsmp == 2) {
            int mi = smp_y[0] >= smp_y[1];
            mn_l = smp_y[mi]; mx_l = smp_y[1 - mi];
            mn_c = smp_c[mi]; mx_c = smp_c[1 - mi];
        } else {
            int lo[2] = {0, 2}, hi[2] = {1, 3}, t;
            if (smp_y[0] > smp_y[2]) { lo[0] = 2; lo[1] = 0; }
            if (smp_y[1] > smp_y[3]) { hi[0] = 3; hi[1] = 1; }
            if (smp_y[lo[0]] > smp_y[hi[1]]) {
                t = lo[0]; lo[0] = hi[0]; hi[0] = t;
                t = lo[1]; lo[1] = hi[1]; hi[1] = t;
            }
            if (smp_y[lo[1]] > smp_y[hi[0]]) {
                t = lo[1]; lo[1] = hi[0]; hi[0] = t;
            }
            mn_l = (smp_y[lo[0]] + smp_y[lo[1]] + 1) >> 1;
            mx_l = (smp_y[hi[0]] + smp_y[hi[1]] + 1) >> 1;
            mn_c = (smp_c[lo[0]] + smp_c[lo[1]] + 1) >> 1;
            mx_c = (smp_c[hi[0]] + smp_c[hi[1]] + 1) >> 1;
        }
        int range_l = mx_l - mn_l;
        if (range_l) {
            int lrl = flog2_c(range_l);
            int norm = ((range_l << 4) >> lrl) & 0xF;
            int v = g_cclm_div[norm] | 8;
            lrl += norm != 0;
            cclm_lm_params(mn_l, mn_c, mx_c, v, lrl, &a, &b, &sh);
        } else {
            a = 0; b = mn_c; sh = 0;
        }
    }

    for (int j = 0; j < pb_h; j++)
        for (int i = 0; i < pb_w; i++) {
            int pl = (i == 0 && !lft_avail) ? 0 : 1;
            int v;
            if (colloc) {
                int pa = (j == 0 && !abv_avail) ? 0 : 1;
                v = (4 + LY(2 * i, 2 * j - pa) + 4 * LY(2 * i, 2 * j)
                     + LY(2 * i - pl, 2 * j) + LY(2 * i + 1, 2 * j)
                     + LY(2 * i, 2 * j + 1)) >> 3;
            } else {
                v = (4 + LY(2 * i + 1, 2 * j) + LY(2 * i - pl, 2 * j)
                     + 2 * LY(2 * i, 2 * j) + 2 * LY(2 * i, 2 * j + 1)
                     + LY(2 * i + 1, 2 * j + 1)
                     + LY(2 * i - pl, 2 * j + 1)) >> 3;
            }
            pred[j * pb_w + i] = bdclip(((v * a) >> sh) + b, bd_max);
        }
#undef LY
#undef CV
#undef SUB_ABV0
#undef SUB_ABV
#undef SUB_LFT
}

/* ---- MIP (rcn/ref_mip.py parity; reference rcn_intra_mip.c:63-330) --- */

static void predict_mip_c(const Rc *r, const int32_t *plane, int stride,
                          int x0, int y0, int l2w, int l2h, int mode,
                          int transpose, int32_t *pred)
{
    int w = 1 << l2w, h = 1 << l2h;
    int bd = r->ep->bitdepth, bd_max = r->bd_max;
    RefArr ra, rl;
    fill_side_refs(r, plane, stride, x0, y0, l2w, l2h, 1, &ra, &rl);

    int log2_bndy = (l2w > 2 || l2h > 2) ? 2 : 1;
    int n_bndy = 1 << log2_bndy;
    int64_t a_avg[4], l_avg[4];
    int seg_a = w / n_bndy, sh_a = 0;
    while ((1 << (sh_a + 1)) <= seg_a) sh_a++;
    int seg_l = h / n_bndy, sh_l = 0;
    while ((1 << (sh_l + 1)) <= seg_l) sh_l++;
    for (int i = 0; i < n_bndy; i++) {
        int64_t s = 0;
        for (int k = 0; k < seg_a; k++)
            s += ra.b[ROFF + 1 + i * seg_a + k];
        a_avg[i] = (s + (seg_a >> 1)) >> sh_a;
        s = 0;
        for (int k = 0; k < seg_l; k++)
            s += rl.b[ROFF + 1 + i * seg_l + k];
        l_avg[i] = (s + (seg_l >> 1)) >> sh_l;
    }

    int64_t bndy[8];
    for (int i = 0; i < n_bndy; i++) {
        bndy[i] = transpose ? l_avg[i] : a_avg[i];
        bndy[n_bndy + i] = transpose ? a_avg[i] : l_avg[i];
    }
    int n_in = 2 * n_bndy;
    int64_t input_offset = bndy[0];
    int size_cls = (l2w == 2 && l2h == 2) ? 0
        : ((l2w == 2 || l2h == 2 || (l2w <= 3 && l2h <= 3)) ? 1 : 2);
    if (size_cls < 2)
        bndy[0] = 1 << (bd - 1);
    int64_t bsum = 0;
    for (int i = 0; i < n_in; i++) {
        bndy[i] -= input_offset;
        bsum += bndy[i];
    }
    int64_t rnd_mip = 32 - 32 * bsum;

    int log2_red = size_cls < 2 ? 2 : 3;
    int n_red = 1 << log2_red;
    int n_out = n_red * n_red;
    int32_t red[64];
    for (int i = 0; i < n_out; i++) {
        int64_t acc = 0;
        for (int k = 0; k < n_in; k++) {
            int wgt = size_cls == 0 ? g_mip_w4[mode][i][k]
                : size_cls == 1 ? g_mip_w8[mode][i][k]
                : g_mip_w16[mode][i][k];
            acc += (int64_t)wgt * bndy[k];
        }
        int v = (int)(((acc + rnd_mip) >> 6) + input_offset);
        red[i] = bdclip(v, bd_max);
    }
    int32_t redm[64];
    for (int j = 0; j < n_red; j++)
        for (int i = 0; i < n_red; i++)
            redm[j * n_red + i] = transpose ? red[i * n_red + j]
                                            : red[j * n_red + i];

    int scale_x = l2w - log2_red;
    int scale_y = l2h - log2_red;
    if (!scale_x && !scale_y) {
        for (int i = 0; i < w * h; i++)
            pred[i] = redm[i];
        return;
    }

    /* horizontal upsample of each reduced row against the left sample of
     * the final row that reduced row lands on */
    int32_t rows[8 * 64];
    int rw = n_red << scale_x;
    for (int j = 0; j < n_red; j++) {
        int64_t before = rl.b[ROFF + ((j + 1) << scale_y)];
        if (!scale_x) {
            for (int i = 0; i < n_red; i++)
                rows[j * rw + i] = redm[j * n_red + i];
            continue;
        }
        int s = scale_x, n = 1 << s;
        for (int i = 0; i < n_red; i++) {
            int64_t cur = redm[j * n_red + i];
            for (int p = 1; p <= n; p++)
                rows[j * rw + (i << s) + p - 1] =
                    (int32_t)((before * (n - p) + cur * p + (n >> 1)) >> s);
            before = cur;
        }
    }
    if (!scale_y) {
        for (int i = 0; i < w * h; i++)
            pred[i] = rows[i];
        return;
    }
    int s = scale_y, n = 1 << s;
    for (int c = 0; c < rw; c++) {
        int64_t before = ra.b[ROFF + 1 + c];
        for (int j = 0; j < n_red; j++) {
            int64_t cur = rows[j * rw + c];
            for (int p = 1; p <= n; p++)
                pred[((j << s) + p - 1) * w + c] =
                    (int32_t)((before * (n - p) + cur * p + (n >> 1)) >> s);
            before = cur;
        }
    }
}

static void predict_intra_c(const Rc *r, const int32_t *plane, int stride,
                            int x0, int y0, int l2w, int l2h, int mode,
                            int is_luma, int32_t *pred)
{
    int w = 1 << l2w, h = 1 << l2h;
    int bd_max = r->bd_max;
    RefArr ra, rl, fa, fl;
    fill_side_refs(r, plane, stride, x0, y0, l2w, l2h, is_luma, &ra, &rl);

    int pdpc_flat_ok = is_luma || (l2w > 1 && l2h > 1);

    if (mode == INTRA_PLANAR || mode == INTRA_DC) {
        RefArr *pa = &ra, *pl = &rl;
        if (mode == INTRA_PLANAR && is_luma && (l2w + l2h) > 5) {
            filter_ref_array(&ra, &rl, w + 4, &fa);
            filter_ref_array(&rl, &ra, h + 4, &fl);
            pa = &fa; pl = &fl;
        }
        if (mode == INTRA_PLANAR) {
            int tr = pa->b[ROFF + w + 1], bl = pl->b[ROFF + h + 1];
            for (int y = 0; y < h; y++) {
                int left = pl->b[ROFF + 1 + y];
                for (int x = 0; x < w; x++) {
                    int top = pa->b[ROFF + 1 + x];
                    int hor = (left << l2w) + (x + 1) * (tr - left);
                    int ver = (top << l2h) + (y + 1) * (bl - top);
                    pred[y * w + x] = ((hor << l2h) + (ver << l2w)
                                       + (1 << (l2w + l2h))) >> (1 + l2w + l2h);
                }
            }
        } else {
            int shift = imax(l2w, l2h) + (l2w == l2h ? 1 : 0);
            int dc = 0;
            if (l2w >= l2h)
                for (int i = 1; i <= w; i++) dc += pa->b[ROFF + i];
            if (l2w <= l2h)
                for (int i = 1; i <= h; i++) dc += pl->b[ROFF + i];
            dc = (dc + ((1 << shift) >> 1)) >> shift;
            for (int i = 0; i < w * h; i++) pred[i] = dc;
        }
        if (pdpc_flat_ok) {
            int scale = (l2w + l2h - 2) >> 2;
            for (int y = 0; y < h; y++) {
                int wy = pdpc_w(scale, y);
                int left = pl->b[ROFF + 1 + y];
                for (int x = 0; x < w; x++) {
                    int wx = pdpc_w(scale, x);
                    int top = pa->b[ROFF + 1 + x];
                    int v = (wx * left + wy * top
                             + (64 - wx - wy) * pred[y * w + x] + 32) >> 6;
                    pred[y * w + x] = bdclip(v, bd_max);
                }
            }
        }
        return;
    }

    int pm = derive_wide_mode(l2w, l2h, mode);
    int vertical = pm >= OVINTRA_DIA_ ? 1 : 0;
    int mode_idx, n_lines, line_len;
    RefArr *rm, *rs;
    if (vertical) {
        mode_idx = pm - OV_VER;
        rm = &ra; rs = &rl;
        n_lines = h; line_len = w;
    } else {
        mode_idx = -(pm - OV_HOR);
        rm = &rl; rs = &ra;
        n_lines = w; line_len = h;
    }

    int pdpc_dim_ok = is_luma ? (l2h > 1) : (l2h > 1 && l2w > 1);
    int use_gauss = 0;
    if (is_luma)
        use_gauss = (l2w + l2h) > 5 &&
                    abs(mode_idx) > g_intra_filter_thr[(l2w + l2h) >> 1];

    int32_t tmp[64 * 64];
    int32_t *out = vertical ? pred : tmp;

    if (mode_idx == 0) {
        for (int j = 0; j < n_lines; j++)
            for (int x = 0; x < line_len; x++)
                out[j * line_len + x] = rm->b[ROFF + 1 + x];
        if (pdpc_dim_ok) {
            /* _pdpc_pure writes in (h, w) orientation directly */
            int scale = (l2w + l2h - 2) >> 2;
            int tl = ra.b[ROFF + 0];
            for (int y = 0; y < h; y++) {
                for (int x = 0; x < w; x++) {
                    int left = rl.b[ROFF + 1 + y], top = ra.b[ROFF + 1 + x];
                    int v;
                    if (vertical) {
                        int wx = pdpc_w(scale, x);
                        v = (wx * (left - tl) + (top << 6) + 32) >> 6;
                    } else {
                        int wy = pdpc_w(scale, y);
                        v = (wy * (top - tl) + (left << 6) + 32) >> 6;
                    }
                    pred[y * w + x] = bdclip(v, bd_max);
                }
            }
            return;
        }
        goto orient;
    }

    if (mode_idx == 16) {
        RefArr *am = rm, *as = rs;
        if (use_gauss) {
            filter_ref_array(rm, rs, 2 * line_len, &fa);
            filter_ref_array(rs, rm, 2 * n_lines, &fl);
            am = &fa; as = &fl;
        }
        angular_core(am, 32, n_lines, line_len, 0, bd_max, out);
        if (pdpc_dim_ok || use_gauss) {
            int scale = imin(2, (vertical ? l2h : l2w) - 2);
            pdpc_angular(out, as, 512, scale, n_lines, line_len, bd_max);
        }
        goto orient;
    }

    {
        int abs_angle = g_angle_table[abs(mode_idx)];
        int inv_angle = g_inv_angle_table[abs(mode_idx)];
        int req_frac = abs_angle & 0x1F;
        int n_proj = 1 << (vertical ? l2h : l2w);
        int pdpc_scale = imin(2, (vertical ? l2h : l2w)
                                 - (floor_log2(3 * inv_angle - 2) - 8));

        if (use_gauss && !req_frac) {
            if (mode_idx < 0) {
                filter_ref_array(rm, rs, 2 * line_len, &fa);
                filter_ref_array(rs, rm, 2 * n_lines, &fl);
                project_negative(&fa, &fl, n_proj, inv_angle, n_proj);
                angular_core(&fa, -abs_angle, n_lines, line_len, 0, bd_max, out);
            } else if (pdpc_scale < 0) {
                filter_ref_array(rm, rs, 2 * line_len, &fa);
                angular_core(&fa, abs_angle, n_lines, line_len, 0, bd_max, out);
            } else {
                filter_ref_array(rm, rs, 2 * line_len, &fa);
                filter_ref_array(rs, rm, 2 * n_lines, &fl);
                angular_core(&fa, abs_angle, n_lines, line_len, 0, bd_max, out);
                pdpc_angular(out, &fl, inv_angle, pdpc_scale, n_lines,
                             line_len, bd_max);
            }
            goto orient;
        }

        int filt;
        if (use_gauss)
            filt = 3;
        else if (!req_frac)
            filt = 0;
        else
            filt = is_luma ? 2 : 1;

        if (mode_idx < 0) {
            project_negative(rm, rs, n_proj, inv_angle, n_proj);
            angular_core(rm, -abs_angle, n_lines, line_len, filt, bd_max, out);
            goto orient;
        }

        angular_core(rm, abs_angle, n_lines, line_len, filt, bd_max, out);
        if (pdpc_scale >= 0 && (use_gauss ? 1 : pdpc_dim_ok))
            pdpc_angular(out, rs, inv_angle, pdpc_scale, n_lines, line_len,
                         bd_max);
    }

orient:
    if (!vertical) {
        /* out = tmp [w][h] -> pred [h][w] transposed */
        for (int j = 0; j < n_lines; j++)
            for (int x = 0; x < line_len; x++)
                pred[x * w + j] = tmp[j * line_len + x];
    }
}

/* ---- dequant + inverse transform (rcn/ref_transform.py parity) ------- */

static const int16_t IQ_SCALE[2][6] = {
    {40, 45, 51, 57, 64, 72}, {57, 64, 72, 80, 90, 102},
};

static void dequant_c(const int32_t *lv, int n, int qp, int l2w, int l2h,
                      int dep_quant, int bitdepth, int32_t *out)
{
    int log2_s = l2w + l2h;
    int shift, scale;
    if (dep_quant) {
        shift = 6 + 1 - (15 - bitdepth) - ((qp + 1) / 6)
                + (log2_s >> 1) + (log2_s & 1);
        scale = IQ_SCALE[log2_s & 1][(qp + 1) % 6];
    } else {
        shift = 6 - (15 - bitdepth) - (qp / 6) + (log2_s >> 1) + (log2_s & 1);
        scale = IQ_SCALE[log2_s & 1][qp % 6];
    }
    if (shift >= 0) {
        int64_t add = ((int64_t)1 << shift) >> 1;
        for (int i = 0; i < n; i++) {
            if (!lv[i]) { out[i] = 0; continue; }
            int64_t v = ((int64_t)lv[i] * scale + add) >> shift;
            out[i] = iclamp((int)v, -32767, 32767);
        }
    } else {
        int64_t s2 = (int64_t)scale << -shift;
        for (int i = 0; i < n; i++) {
            if (!lv[i]) { out[i] = 0; continue; }
            int64_t v = (int64_t)lv[i] * s2;
            out[i] = v < -32767 ? -32767 : (v > 32767 ? 32767 : (int32_t)v);
        }
    }
}

/* (tr_h, tr_v) selection (transform_pair parity; LFNST/TS pre-excluded) */
static void transform_pair_c(const EntryParams *ep, const int32_t *t,
                             int intra, int *tr_h, int *tr_v)
{
    int luma = t[TU_F_COMP] == 0;
    int mts_idx = luma ? t[TU_F_MTS] : 0;
    if (luma && mts_idx == 0 && ep->mts_implicit && intra &&
        (t[TU_F_LOG2W] <= 4 || t[TU_F_LOG2H] <= 4)) {
        *tr_h = (t[TU_F_LOG2W] >= 2 && t[TU_F_LOG2W] <= 4) ? TR_DST7 : TR_DCT2;
        *tr_v = (t[TU_F_LOG2H] >= 2 && t[TU_F_LOG2H] <= 4) ? TR_DST7 : TR_DCT2;
        return;
    }
    if (mts_idx) {
        int sym = mts_idx - 1;
        *tr_h = (sym & 1) ? TR_DCT8 : TR_DST7;
        *tr_v = (sym >> 1) ? TR_DCT8 : TR_DST7;
        return;
    }
    *tr_h = TR_DCT2;
    *tr_v = TR_DCT2;
}

/* inverse_transform_2d parity. Loop bounds come from the 4x4-subblock
 * significance map (bit = sbx + 8*sby): coefficients outside the map's
 * bounding box are zero, so restricting the k sums to it is exact (the
 * raster coords of the LAST position are NOT a valid bound — diagonal
 * scan places nonzero coeffs past them). */
static void inv_transform_2d(const int32_t *d, int l2w, int l2h, int tr_h,
                             int tr_v, int bitdepth, uint64_t sig_sb_map,
                             int32_t *out)
{
    int w = 1 << l2w, h = 1 << l2h;
    int shift1 = 7, shift2 = 20 - bitdepth;
    int add1 = 1 << (shift1 - 1), add2 = 1 << (shift2 - 1);
    const int16_t *mv = g_tr_mat[tr_v][l2h];
    const int16_t *mh = g_tr_mat[tr_h][l2w];
    int32_t tmp[64 * 64]; /* [x][y] */

    int kx_max = w - 1, ky_max = h - 1;
    if (w >= 4 && h >= 4 && sig_sb_map) {
        int sbx_max = 0, sby_max = 0;
        for (uint64_t m = sig_sb_map; m; m &= m - 1) {
            int b = __builtin_ctzll(m);
            int sx = b & 7, sy = b >> 3;
            if (sx > sbx_max) sbx_max = sx;
            if (sy > sby_max) sby_max = sy;
        }
        kx_max = imin(4 * sbx_max + 3, w - 1);
        ky_max = imin(4 * sby_max + 3, h - 1);
    }
    /* Pass 1 (vertical) as rank-1 updates: for each nonzero input
     * coefficient d[k][x], add d*column(mv,k) into acc[x][.]. The inner
     * loop is contiguous over y (autovectorizes) and zero coefficients —
     * the common case for sparse residuals — are skipped entirely. */
    int nx = kx_max + 1;
    memset(tmp, 0, (size_t)nx * h * sizeof(*tmp));
    for (int k = 0; k <= ky_max; k++) {
        const int16_t *restrict mvk = mv + k * h;
        const int32_t *restrict dk = d + k * w;
        for (int x = 0; x < nx; x++) {
            int32_t c = dk[x];
            if (!c)
                continue;
            int32_t *restrict a = tmp + x * h;
            for (int y = 0; y < h; y++)
                a[y] += c * mvk[y];
        }
    }
    for (int i = 0; i < nx * h; i++)
        tmp[i] = iclamp((tmp[i] + add1) >> shift1, -32768, 32767);

    /* Pass 2 (horizontal), same shape: out[y][.] += tmp[kx][y]*row(mh,kx) */
    int32_t acc2[64 * 64];
    memset(acc2, 0, (size_t)h * w * sizeof(*acc2));
    for (int kx = 0; kx < nx; kx++) {
        const int16_t *restrict mhk = mh + kx * w;
        const int32_t *restrict tk = tmp + kx * h;
        for (int y = 0; y < h; y++) {
            int32_t c = tk[y];
            if (!c)
                continue;
            int32_t *restrict o = acc2 + y * w;
            for (int x = 0; x < w; x++)
                o[x] += c * mhk[x];
        }
    }
    for (int i = 0; i < h * w; i++)
        out[i] = iclamp((acc2[i] + add2) >> shift2, -32768, 32767);
}


/* ---- LFNST (rcn/ref_transform.py apply_lfnst parity; reference
 * rcn_lfnst.c:41-163 + drv_lfnst.c mode map) ------------------------- */

static const uint8_t g_lfnst_diag4[16][2] = {
    /* (x, y) of the top-left 4x4 in up-right diagonal scan order */
    {0,0},{0,1},{1,0},{0,2},{1,1},{2,0},{0,3},{1,2},
    {2,1},{3,0},{1,3},{2,2},{3,1},{2,3},{3,2},{3,3}
};

static int lfnst_intra_mode_c(int l2w, int l2h, int mode)
{
    static const int shift_lut[6] = {0, 6, 10, 12, 14, 15};
    if (mode > 1) {
        int shift = shift_lut[l2w > l2h ? l2w - l2h : l2h - l2w];
        if (l2w > l2h && mode < 2 + shift)
            mode += 66 - 1;
        else if (l2h > l2w && mode > 66 - shift)
            mode -= 66 + 1;
    }
    if (mode < 0)
        mode += 14 + 67;
    else if (mode >= 67)
        mode += 14;
    return mode;
}

static void apply_lfnst_c(int32_t *dq, int l2w, int l2h, int lfnst_idx,
                          int mode_l)
{
    int w = 1 << l2w, h = 1 << l2h;
    int transpose = (mode_l > 34 && mode_l < 67) || mode_l >= 67 + 14;
    int mode_set = g_lfnst_mode_map[mode_l];
    int is_8x8 = l2w >= 3 && l2h >= 3;
    int64_t tmp[16];
    for (int i = 0; i < 16; i++)
        tmp[i] = dq[g_lfnst_diag4[i][1] * w + g_lfnst_diag4[i][0]];
    int32_t out[64 * 64];
    memset(out, 0, (size_t)w * h * sizeof(*out));
    if (!is_8x8) {
        const int8_t *mat = g_lfnst_4[mode_set][lfnst_idx - 1];
        int n_in = (l2w == l2h) ? 8 : 16;
        for (int i = 0; i < 16; i++) {
            int64_t acc = 0;
            for (int k = 0; k < n_in; k++)
                acc += tmp[k] * mat[i + 16 * k];
            int32_t v = (int32_t)((acc + 64) >> 7);
            if (v < -(1 << 15)) v = -(1 << 15);
            if (v > (1 << 15)) v = 1 << 15;
            int x = transpose ? (i >> 2) : (i & 3);
            int y = transpose ? (i & 3) : (i >> 2);
            out[y * w + x] = v;
        }
    } else {
        const int8_t *mat = g_lfnst_8[mode_set][lfnst_idx - 1];
        for (int i = 0; i < 48; i++) {
            int64_t acc = 0;
            for (int k = 0; k < 16; k++)
                acc += tmp[k] * mat[i + 48 * k];
            int32_t v = (int32_t)((acc + 64) >> 7);
            if (v < -(1 << 15)) v = -(1 << 15);
            if (v > (1 << 15)) v = 1 << 15;
            int x, y;
            if (i < 32) { x = i & 7; y = i >> 3; }
            else { x = i & 3; y = 4 + ((i - 32) >> 2); }
            if (transpose) { int t_ = x; x = y; y = t_; }
            out[y * w + x] = v;
        }
    }
    memcpy(dq, out, (size_t)w * h * sizeof(*dq));
}

static void recon_tu_residual_c(const Rc *r, const int32_t *t,
                                const int32_t *cu, int intra,
                                int32_t *res)
{
    int l2w = t[TU_F_LOG2W], l2h = t[TU_F_LOG2H];
    int n = 1 << (l2w + l2h);
    int64_t pt0 = prof_now();
    if (t[TU_F_TS]) {
        /* transform-skip: dequant only, no transform shift
         * (rcn/ref_transform.py dequant_ts; derive_dequant_ts :139) */
        int qp = t[TU_F_QP];
        int shift = 6 - qp / 6;
        int scale = IQ_SCALE[0][qp % 6];
        const int32_t *lv = r->coef_buf + t[TU_F_COEF];
        int32_t acc[32 * 32];
        if (t[TU_F_BDPCM]) {
            /* directional accumulation with int16 clip BEFORE dequant
             * (rcn/ref_transform.py reconstruct_bdpcm; rcn_transform_tree
             * apply_bdpcm_1/2 :631-663) */
            int w = 1 << l2w, h = 1 << l2h;
            int dir = t[TU_F_BDPCM] >> 1;
            if (dir) { /* vertical */
                for (int x = 0; x < w; x++) acc[x] = lv[x];
                for (int y = 1; y < h; y++)
                    for (int x = 0; x < w; x++)
                        acc[y * w + x] = iclamp(acc[(y - 1) * w + x]
                                                + lv[y * w + x],
                                                -32768, 32767);
            } else {
                for (int y = 0; y < h; y++) {
                    acc[y * w] = lv[y * w];
                    for (int x = 1; x < w; x++)
                        acc[y * w + x] = iclamp(acc[y * w + x - 1]
                                                + lv[y * w + x],
                                                -32768, 32767);
                }
            }
            lv = acc;
        }
        if (shift >= 0) {
            int64_t add = ((int64_t)1 << shift) >> 1;
            for (int i = 0; i < n; i++) {
                int64_t v = ((int64_t)lv[i] * scale + add) >> shift;
                res[i] = iclamp((int)v, -32767, 32767);
            }
        } else {
            int64_t s2 = (int64_t)scale << -shift;
            for (int i = 0; i < n; i++) {
                int64_t v = (int64_t)lv[i] * s2;
                res[i] = v < -32767 ? -32767
                                    : (v > 32767 ? 32767 : (int32_t)v);
            }
        }
        prof_add(PROF_RESID, pt0);
        return;
    }
    int32_t dq[64 * 64];
    dequant_c(r->coef_buf + t[TU_F_COEF], n, t[TU_F_QP], l2w, l2h,
              r->ep->dep_quant, r->ep->bitdepth, dq);
    int tr_h, tr_v;
    uint64_t sig = ((uint64_t)(uint32_t)t[TU_F_SIGHI] << 32)
                   | (uint32_t)t[TU_F_SIGLO];
    if (t[TU_F_LFNST]) {
        /* secondary transform before DCT2/DCT2; after it coefficients
         * occupy the top-left 4x4 (or 8x8) region regardless of sig */
        int base;
        if (t[TU_F_COMP] == 0)
            base = cu[CU_F_MIP_FLAG] ? 0 : cu[CU_F_INTRA_L];
        else {
            base = cu[CU_F_INTRA_C];
            if (base >= 81 && base <= 83) /* CCLM -> collocated luma */
                base = cu[CU_F_COL_MODE];
        }
        int cl2w = imin(5, l2w), cl2h = imin(5, l2h);
        int ml = lfnst_intra_mode_c(cl2w, cl2h, base);
        apply_lfnst_c(dq, cl2w, cl2h, t[TU_F_LFNST], ml);
        sig = (l2w >= 3 && l2h >= 3) ? 0x303u : 0x1u;
        tr_h = tr_v = 0; /* DCT2 */
    } else {
        transform_pair_c(r->ep, t, intra, &tr_h, &tr_v);
    }
    inv_transform_2d(dq, l2w, l2h, tr_h, tr_v, r->ep->bitdepth, sig, res);
    prof_add(PROF_RESID, pt0);
}

/* ---- motion compensation (rcn/ref_mc.py parity) ---------------------- */

/* out14: write the 14-bit intermediate (put_vvc_*_bi_* parity) instead
 * of the rounded/clipped uni output */
#ifdef __AVX2__
/* One separable-FIR pass over int32 sample lanes (interior blocks only —
 * no per-sample clamping). Taps step by `tapstep` elements: 1 for a
 * horizontal pass, the source stride for a vertical pass. sh_pre is the
 * unconditional post-accumulate shift (bitdepth-8 for a first pass, 6 for
 * the second pass of an hv pair); when out14 is 0 the (acc+round)>>shift
 * clip to [0, bd_max] follows, matching the scalar loops below bit for
 * bit. Widths: 8-lane main loop, 4-lane then scalar tails (chroma w==2).
 * Value ranges: |sample| < 2^14, |coef| <= 88, 8 taps -> |acc| < 2^24,
 * so 32-bit vpmulld/vpaddd are exact. */
static void fir_avx2(const int32_t *src, int sstride, int tapstep,
                     int32_t *dst, int dstride, int w, int h,
                     const int16_t *f, int taps, int sh_pre,
                     int out14, int shift, int round, int bd_max)
{
    __m256i vf[8];
    for (int k = 0; k < taps; k++)
        vf[k] = _mm256_set1_epi32(f[k]);
    const __m256i vround = _mm256_set1_epi32(round);
    const __m256i vmax = _mm256_set1_epi32(bd_max);
    const __m256i vzero = _mm256_setzero_si256();
    for (int j = 0; j < h; j++) {
        const int32_t *restrict row = src + (int64_t)j * sstride;
        int32_t *restrict o = dst + (int64_t)j * dstride;
        int i = 0;
        for (; i + 8 <= w; i += 8) {
            __m256i acc = _mm256_mullo_epi32(
                _mm256_loadu_si256((const __m256i *)(row + i)), vf[0]);
            for (int k = 1; k < taps; k++)
                acc = _mm256_add_epi32(acc, _mm256_mullo_epi32(
                    _mm256_loadu_si256(
                        (const __m256i *)(row + i + k * tapstep)), vf[k]));
            acc = _mm256_srai_epi32(acc, sh_pre);
            if (!out14) {
                acc = _mm256_srai_epi32(_mm256_add_epi32(acc, vround),
                                        shift);
                acc = _mm256_min_epi32(_mm256_max_epi32(acc, vzero), vmax);
            }
            _mm256_storeu_si256((__m256i *)(o + i), acc);
        }
        if (i + 4 <= w) {
            __m128i acc = _mm_mullo_epi32(
                _mm_loadu_si128((const __m128i *)(row + i)),
                _mm256_castsi256_si128(vf[0]));
            for (int k = 1; k < taps; k++)
                acc = _mm_add_epi32(acc, _mm_mullo_epi32(
                    _mm_loadu_si128((const __m128i *)(row + i + k * tapstep)),
                    _mm256_castsi256_si128(vf[k])));
            acc = _mm_srai_epi32(acc, sh_pre);
            if (!out14) {
                acc = _mm_srai_epi32(
                    _mm_add_epi32(acc, _mm256_castsi256_si128(vround)),
                    shift);
                acc = _mm_min_epi32(_mm_max_epi32(acc, _mm_setzero_si128()),
                                    _mm256_castsi256_si128(vmax));
            }
            _mm_storeu_si128((__m128i *)(o + i), acc);
            i += 4;
        }
        for (; i < w; i++) {
            int32_t a = 0;
            for (int k = 0; k < taps; k++)
                a += f[k] * row[i + k * tapstep];
            a >>= sh_pre;
            o[i] = out14 ? a : bdclip((a + round) >> shift, bd_max);
        }
    }
}
#endif

static void mc_block_c(const int32_t *plane, int W, int H, int stride,
                       int32_t *dst, int dstride, int x0, int y0, int fx,
                       int fy, int w, int h, int bitdepth, int is_luma,
                       int hpel, int bd_max, int out14)
{
    int sh1 = bitdepth - 8;
    if (!fx && !fy) {
        int sh14 = 14 - bitdepth;
        if (x0 >= 0 && y0 >= 0 && x0 + w <= W && y0 + h <= H) {
            const int32_t *src = plane + (int64_t)y0 * stride + x0;
            for (int j = 0; j < h; j++) {
                const int32_t *restrict s = src + (int64_t)j * stride;
                int32_t *restrict o = dst + (int64_t)j * dstride;
                if (out14)
                    for (int i = 0; i < w; i++)
                        o[i] = s[i] << sh14;
                else
                    memcpy(o, s, (size_t)w * sizeof *o);
            }
            return;
        }
        for (int j = 0; j < h; j++) {
            int yy = iclamp(y0 + j, 0, H - 1);
            for (int i = 0; i < w; i++) {
                int v = plane[yy * stride + iclamp(x0 + i, 0, W - 1)];
                dst[j * dstride + i] = out14 ? v << sh14 : v;
            }
        }
        return;
    }
    int taps, before;
    const int16_t *fh = 0, *fv = 0;
    int is4 = is_luma && w == 4 && h == 4;
    if (is_luma) {
        taps = 8; before = 3;
        if (fx) fh = (hpel && fx == 8) ? g_mc_filters_l[15]
                     : (is4 ? g_mc_filters_4[fx - 1] : g_mc_filters_l[fx - 1]);
        if (fy) fv = (hpel && fy == 8) ? g_mc_filters_l[15]
                     : (is4 ? g_mc_filters_4[fy - 1] : g_mc_filters_l[fy - 1]);
    } else {
        taps = 4; before = 1;
        if (fx) fh = g_mc_filters_c[fx - 1];
        if (fy) fv = g_mc_filters_c[fy - 1];
    }
    int shift = 14 - bitdepth;
    int round = 1 << (shift - 1);

    /* Interior fast paths: when the full filter support lies inside the
     * picture, run clean contiguous loops (no per-sample clamping) that
     * the compiler vectorizes. Border blocks use the clamped path below. */
    int ix = fh ? (x0 - before >= 0 && x0 - before + w + taps - 1 <= W)
                : (x0 >= 0 && x0 + w <= W);
    int iy = fv ? (y0 - before >= 0 && y0 - before + h + taps - 1 <= H)
                : (y0 >= 0 && y0 + h <= H);
    if (ix && iy) {
#ifdef __AVX2__
        if (fv == 0) {
            fir_avx2(plane + (int64_t)y0 * stride + x0 - before, stride, 1,
                     dst, dstride, w, h, fh, taps, sh1, out14, shift, round,
                     bd_max);
            return;
        }
        if (fh == 0) {
            fir_avx2(plane + (int64_t)(y0 - before) * stride + x0, stride,
                     stride, dst, dstride, w, h, fv, taps, sh1, out14,
                     shift, round, bd_max);
            return;
        }
        {
            /* hv separable: horizontal into an int32 scratch (the scalar
             * path's int16 intermediate always fits int16, so widening it
             * is value-identical), then vertical */
            int32_t tmp32[(64 + 8) * 64];
            int th = h + taps - 1;
            fir_avx2(plane + (int64_t)(y0 - before) * stride + x0 - before,
                     stride, 1, tmp32, w, w, th, fh, taps, sh1, 1, 0, 0, 0);
            fir_avx2(tmp32, w, w, dst, dstride, w, h, fv, taps, 6, out14,
                     shift, round, bd_max);
            return;
        }
#endif
        if (fv == 0) { /* copy handled above; here fh != 0 */
            const int32_t *src = plane + (int64_t)y0 * stride + x0 - before;
#define H_ROW(T)                                                           \
            for (int j = 0; j < h; j++) {                                  \
                const int32_t *restrict row = src + (int64_t)j * stride;   \
                int32_t *restrict o = dst + (int64_t)j * dstride;          \
                for (int i = 0; i < w; i++) {                              \
                    int32_t acc = 0;                                       \
                    for (int k = 0; k < (T); k++)                          \
                        acc += fh[k] * row[i + k];                         \
                    acc >>= sh1;                                           \
                    o[i] = out14 ? acc                                     \
                                 : bdclip((acc + round) >> shift, bd_max); \
                }                                                          \
            }
            if (taps == 8) { H_ROW(8) } else { H_ROW(4) }
#undef H_ROW
            return;
        }
        if (fh == 0) {
            const int32_t *src = plane + (int64_t)(y0 - before) * stride + x0;
#define V_ROW(T)                                                           \
            for (int j = 0; j < h; j++) {                                  \
                const int32_t *restrict row = src + (int64_t)j * stride;   \
                int32_t *restrict o = dst + (int64_t)j * dstride;          \
                for (int i = 0; i < w; i++) {                              \
                    int32_t acc = 0;                                       \
                    for (int k = 0; k < (T); k++)                          \
                        acc += fv[k] * row[(int64_t)k * stride + i];       \
                    acc >>= sh1;                                           \
                    o[i] = out14 ? acc                                     \
                                 : bdclip((acc + round) >> shift, bd_max); \
                }                                                          \
            }
            if (taps == 8) { V_ROW(8) } else { V_ROW(4) }
#undef V_ROW
            return;
        }
        /* hv separable */
        int16_t tmp[(64 + 8) * 64];
        int th = h + taps - 1;
        const int32_t *src =
            plane + (int64_t)(y0 - before) * stride + x0 - before;
#define HV_H(T)                                                            \
        for (int j = 0; j < th; j++) {                                    \
            const int32_t *restrict row = src + (int64_t)j * stride;      \
            int16_t *restrict o = tmp + j * w;                            \
            for (int i = 0; i < w; i++) {                                 \
                int32_t acc = 0;                                          \
                for (int k = 0; k < (T); k++)                             \
                    acc += fh[k] * row[i + k];                            \
                o[i] = (int16_t)(acc >> sh1);                             \
            }                                                             \
        }
        if (taps == 8) { HV_H(8) } else { HV_H(4) }
#undef HV_H
#define HV_V(T)                                                            \
        for (int j = 0; j < h; j++) {                                     \
            const int16_t *restrict ti = tmp + j * w;                     \
            int32_t *restrict o = dst + (int64_t)j * dstride;             \
            for (int i = 0; i < w; i++) {                                 \
                int32_t acc = 0;                                          \
                for (int k = 0; k < (T); k++)                             \
                    acc += fv[k] * ti[k * w + i];                         \
                acc >>= 6;                                                \
                o[i] = out14 ? acc                                        \
                             : bdclip((acc + round) >> shift, bd_max);    \
            }                                                             \
        }
        if (taps == 8) { HV_V(8) } else { HV_V(4) }
#undef HV_V
        return;
    }

    if (fv == 0) {
        for (int j = 0; j < h; j++) {
            int yy = iclamp(y0 + j, 0, H - 1);
            const int32_t *row = plane + yy * stride;
            for (int i = 0; i < w; i++) {
                int32_t acc = 0;
                for (int k = 0; k < taps; k++)
                    acc += fh[k] * row[iclamp(x0 - before + i + k, 0, W - 1)];
                acc >>= sh1;
                dst[j * dstride + i] =
                    out14 ? acc : bdclip((acc + round) >> shift, bd_max);
            }
        }
        return;
    }
    if (fh == 0) {
        for (int j = 0; j < h; j++) {
            for (int i = 0; i < w; i++) {
                int xx = iclamp(x0 + i, 0, W - 1);
                int32_t acc = 0;
                for (int k = 0; k < taps; k++)
                    acc += fv[k] * plane[iclamp(y0 - before + j + k, 0, H - 1)
                                         * stride + xx];
                acc >>= sh1;
                dst[j * dstride + i] =
                    out14 ? acc : bdclip((acc + round) >> shift, bd_max);
            }
        }
        return;
    }
    /* hv: horizontal into an int16 intermediate, then vertical */
    int16_t tmp[(64 + 8) * 64];
    int th = h + taps - 1;
    for (int j = 0; j < th; j++) {
        int yy = iclamp(y0 - before + j, 0, H - 1);
        const int32_t *row = plane + yy * stride;
        for (int i = 0; i < w; i++) {
            int32_t acc = 0;
            for (int k = 0; k < taps; k++)
                acc += fh[k] * row[iclamp(x0 - before + i + k, 0, W - 1)];
            tmp[j * w + i] = (int16_t)(acc >> sh1);
        }
    }
    for (int j = 0; j < h; j++) {
        for (int i = 0; i < w; i++) {
            int32_t acc = 0;
            for (int k = 0; k < taps; k++)
                acc += fv[k] * tmp[(j + k) * w + i];
            acc >>= 6;
            dst[j * dstride + i] =
                out14 ? acc : bdclip((acc + round) >> shift, bd_max);
        }
    }
}


/* rcn_inter.c clip_mv parity (:97) */
static void clip_mv_c(int pos_x, int pos_y, int pic_w, int pic_h, int pb_w,
                      int pb_h, int mvx, int mvy, int *ox, int *oy)
{
    int x_max = (pic_w + 2 - pos_x) << 4;
    int y_max = (pic_h + 2 - pos_y) << 4;
    int x_min = -((pb_w + 3 + pos_x) << 4);
    int y_min = -((pb_h + 3 + pos_y) << 4);
    *ox = imax(x_min, imin(x_max, mvx));
    *oy = imax(y_min, imin(y_max, mvy));
}

/* ---- DBF map fills (rcn/ref_dbf.py DbfMaps parity) -------------------- */

static void dbf_rect(int x0, int y0, int w, int h, int *xu, int *yu, int *wu,
                     int *hu)
{
    *xu = x0 >> 2; *yu = y0 >> 2;
    *wu = imax(1, w >> 2); *hu = imax(1, h >> 2);
}

static void set_col(uint8_t *m, int mw, int yu, int hu, int col)
{
    for (int j = 0; j < hu; j++)
        m[(yu + j) * mw + col] = 1;
}

static void set_row(uint8_t *m, int mw, int row, int xu, int wu)
{
    memset(m + row * mw + xu, 1, wu);
}

static void dbf_add_cu_luma(const Rc *r, int x0, int y0, int w, int h, int qp,
                            int intra)
{
    const DbfBufs *d = r->dbf;
    int mw = r->uw + 1;
    int xu, yu, wu, hu;
    dbf_rect(x0, y0, w, h, &xu, &yu, &wu, &hu);
    set_col(d->edge_ver, mw, yu, hu, xu);
    set_col(d->edge_ver, mw, yu, hu, xu + wu);
    set_row(d->edge_hor, mw, yu, xu, wu);
    set_row(d->edge_hor, mw, yu + hu, xu, wu);
    set_col(d->cu_edge_ver, mw, yu, hu, xu);
    set_col(d->cu_edge_ver, mw, yu, hu, xu + wu);
    set_row(d->cu_edge_hor, mw, yu, xu, wu);
    set_row(d->cu_edge_hor, mw, yu + hu, xu, wu);
    if (intra) {
        set_col(d->bs2_ver, mw, yu, hu, xu);
        set_col(d->bs2_ver, mw, yu, hu, xu + wu);
        set_row(d->bs2_hor, mw, yu, xu, wu);
        set_row(d->bs2_hor, mw, yu + hu, xu, wu);
    }
    for (int j = 0; j < hu; j++)
        for (int i = 0; i < wu; i++)
            d->qp_l[(yu + j) * r->uw + xu + i] = qp;
}

static void dbf_add_tb_luma(const Rc *r, int x0, int y0, int w, int h)
{
    const DbfBufs *d = r->dbf;
    int mw = r->uw + 1;
    int xu, yu, wu, hu;
    dbf_rect(x0, y0, w, h, &xu, &yu, &wu, &hu);
    set_col(d->edge_ver, mw, yu, hu, xu);
    set_col(d->bs1_ver, mw, yu, hu, xu);
    set_col(d->edge_ver, mw, yu, hu, xu + wu);
    set_col(d->bs1_ver, mw, yu, hu, xu + wu);
    set_row(d->edge_hor, mw, yu, xu, wu);
    set_row(d->bs1_hor, mw, yu, xu, wu);
    set_row(d->edge_hor, mw, yu + hu, xu, wu);
    set_row(d->bs1_hor, mw, yu + hu, xu, wu);
}

static void dbf_add_cu_chroma(const Rc *r, int cx0, int cy0, int cw, int ch,
                              int qp_cb, int qp_cr, int intra)
{
    const DbfBufs *d = r->dbf;
    int mw = r->uw + 1;
    int xu = cx0 >> 1, yu = cy0 >> 1;
    int wu = imax(1, cw >> 1), hu = imax(1, ch >> 1);
    set_col(d->cedge_ver, mw, yu, hu, xu);
    set_col(d->cedge_ver, mw, yu, hu, xu + wu);
    set_row(d->cedge_hor, mw, yu, xu, wu);
    set_row(d->cedge_hor, mw, yu + hu, xu, wu);
    if (intra) {
        set_col(d->cbs2_ver, mw, yu, hu, xu);
        set_col(d->cbs2_ver, mw, yu, hu, xu + wu);
        set_row(d->cbs2_hor, mw, yu, xu, wu);
        set_row(d->cbs2_hor, mw, yu + hu, xu, wu);
    }
    for (int j = 0; j < hu; j++)
        for (int i = 0; i < wu; i++) {
            d->qp_cb[(yu + j) * r->uw + xu + i] = qp_cb;
            d->qp_cr[(yu + j) * r->uw + xu + i] = qp_cr;
        }
}

static void dbf_add_tb_chroma(const Rc *r, int comp, int cx0, int cy0, int cw,
                              int ch)
{
    const DbfBufs *d = r->dbf;
    int mw = r->uw + 1;
    int xu = cx0 >> 1, yu = cy0 >> 1;
    int wu = imax(1, cw >> 1), hu = imax(1, ch >> 1);
    uint8_t *bs1v = comp != 2 ? d->cbs1_cb_ver : d->cbs1_cr_ver;
    uint8_t *bs1h = comp != 2 ? d->cbs1_cb_hor : d->cbs1_cr_hor;
    set_col(d->cedge_ver, mw, yu, hu, xu);
    set_col(bs1v, mw, yu, hu, xu);
    set_col(d->cedge_ver, mw, yu, hu, xu + wu);
    set_col(bs1v, mw, yu, hu, xu + wu);
    set_row(d->cedge_hor, mw, yu, xu, wu);
    set_row(bs1h, mw, yu, xu, wu);
    set_row(d->cedge_hor, mw, yu + hu, xu, wu);
    set_row(bs1h, mw, yu + hu, xu, wu);
}

static void dbf_add_cu_motion(const Rc *r, int x0, int y0, int w, int h,
                              int inter_dir, int m0x, int m0y, int dist0,
                              int m1x, int m1y, int dist1)
{
    const DbfBufs *d = r->dbf;
    int xu, yu, wu, hu;
    dbf_rect(x0, y0, w, h, &xu, &yu, &wu, &hu);
    for (int j = 0; j < hu; j++)
        for (int i = 0; i < wu; i++) {
            int u = (yu + j) * r->uw + xu + i;
            d->mv_dir[u] = (uint8_t)inter_dir;
            if (inter_dir & 1) {
                d->mv_vals[u * 4 + 0] = m0x;
                d->mv_vals[u * 4 + 1] = m0y;
                d->mv_dist[u * 2 + 0] = dist0;
            }
            if (inter_dir & 2) {
                d->mv_vals[u * 4 + 2] = m1x;
                d->mv_vals[u * 4 + 3] = m1y;
                d->mv_dist[u * 2 + 1] = dist1;
            }
        }
}

/* chroma QP for DBF maps (parse.c chroma_qp parity, minus qp_bd) */
static int dbf_chroma_qp(const Rc *r, int comp, int qp_y)
{
    const EntryParams *e = r->ep;
    int qp_bd = e->qp_bd_offset;
    int base = iclamp(qp_y, 0, 63);
    int mapped = r->cqp_tab[(comp - 1) * e->cqp_tab_len + base + qp_bd];
    int off = comp == 1 ? e->cb_qp_off : e->cr_qp_off;
    int v = iclamp(mapped + off, -qp_bd, 63);
    return v; /* + qp_bd - qp_bd */
}

/* ---- TU lookup and residual application ------------------------------ */

/* one CU's contribution to the deblocking maps (shared by the recon and
 * IR-builder drivers; parity: decoder.py reconstruct_cu DBF fills) */
static void fill_dbf_cu(const Rc *r, const int32_t *c)
{
    const EntryParams *ep = r->ep;
    int x0 = c[CU_F_X0], y0 = c[CU_F_Y0];
    int w = 1 << c[CU_F_LOG2W], h = 1 << c[CU_F_LOG2H];
    /* CIIP counts as intra for the bs2 edges (decoder.py :189-191) but
     * still contributes its motion to the bs1 MV maps. Luma bs2 covers
     * BDPCM too (drv_intra_cu fills the CU rect, drv_intra.c:369);
     * chroma bs2 skips BDPCM (rcn_tu_c, rcn_transform_tree.c:1368) */
    int intra = c[CU_F_PRED] == MODE_INTRA || c[CU_F_CIIP_WT] != 0;
    dbf_add_cu_luma(r, x0, y0, w, h, c[CU_F_QP], intra);
    if (c[CU_F_PRED] != MODE_INTRA && c[CU_F_SB_FLAG]) {
        /* affine/SbTMVP: 8x8 sub-block edges + aff map + per-4x4 motion
         * from the exported unit maps (decoder.py :216-219,
         * _dbf_sb_motion) */
        int xu, yu, wu, hu;
        dbf_rect(x0, y0, w, h, &xu, &yu, &wu, &hu);
        const DbfBufs *d = r->dbf;
        int mw = r->uw + 1;
        for (int i = 2; i < wu; i += 2)
            for (int j = 0; j < hu; j++)
                d->sb_edge_ver[(int64_t)(yu + j) * mw + xu + i] = 1;
        for (int i = 2; i < hu; i += 2)
            for (int j = 0; j < wu; j++)
                d->sb_edge_hor[(int64_t)(yu + i) * mw + xu + j] = 1;
        for (int j = 0; j < hu; j++)
            for (int i = 0; i < wu; i++)
                d->aff_unit[(int64_t)(yu + j) * r->uw + xu + i] = 1;
        int flag = c[CU_F_SB_FLAG];
        int cu_dir = c[CU_F_INTER_DIR];
        int ref0 = c[CU_F_MV0REF], ref1 = c[CU_F_MV1REF];
        for (int j = 0; j < hu; j++)
            for (int i = 0; i < wu; i++) {
                int px = x0 + 4 * i, py = y0 + 4 * j;
                int d0, d1, m0x, m0y, m1x, m1y;
                sub_unit_motion(r, px, py, &d0, &d1, &m0x, &m0y, &m1x,
                                   &m1y);
                int udir, r0e, r1e;
                if (flag == 1) {
                    udir = cu_dir;
                    r0e = ref0;
                    r1e = ref1;
                } else {
                    udir = (d0 ? 1 : 0) | (d1 ? 2 : 0);
                    r0e = 0;
                    r1e = 0;
                }
                dbf_add_cu_motion(r, px, py, 4, 4, udir, m0x, m0y,
                                  (udir & 1) ? r->dist0[r0e] : 0,
                                  m1x, m1y,
                                  (udir & 2) ? r->dist1[r1e] : 0);
            }
    } else if (c[CU_F_PRED] != MODE_INTRA && c[CU_F_GPM_DIRS]) {
        /* GPM: per-4x4 motion with the geometric storage mix
         * (decoder.py :201-206 via cu.gpm_units) */
        int gpm = c[CU_F_GPM_DIRS];
        int d0 = 1 + ((gpm - 1) & 1), d1 = 1 + ((gpm - 1) >> 1);
        int m0x = c[CU_F_MV0X], m0y = c[CU_F_MV0Y], ref0 = c[CU_F_MV0REF];
        int m1x = c[CU_F_MV1X], m1y = c[CU_F_MV1Y], ref1 = c[CU_F_MV1REF];
        int idir = d0 | d1;
        struct { int dir, l0x, l0y, l0r, l1x, l1y, l1r; } cls[3];
        memset(cls, 0, sizeof(cls));
        cls[0].dir = d0;
        if (d0 == 1) { cls[0].l0x = m0x; cls[0].l0y = m0y; cls[0].l0r = ref0; }
        else { cls[0].l1x = m0x; cls[0].l1y = m0y; cls[0].l1r = ref0; }
        cls[1].dir = d1;
        if (d1 == 1) { cls[1].l0x = m1x; cls[1].l0y = m1y; cls[1].l0r = ref1; }
        else { cls[1].l1x = m1x; cls[1].l1y = m1y; cls[1].l1r = ref1; }
        cls[2].dir = idir;
        if (idir == 1) {
            cls[2].l0x = m1x; cls[2].l0y = m1y; cls[2].l0r = ref1;
        } else if (idir == 2) {
            cls[2].l1x = m1x; cls[2].l1y = m1y; cls[2].l1r = ref1;
        } else if (d0 == 1) {
            cls[2].l0x = m0x; cls[2].l0y = m0y; cls[2].l0r = ref0;
            cls[2].l1x = m1x; cls[2].l1y = m1y; cls[2].l1r = ref1;
        } else {
            cls[2].l0x = m1x; cls[2].l0y = m1y; cls[2].l0r = ref1;
            cls[2].l1x = m0x; cls[2].l1y = m0y; cls[2].l1r = ref0;
        }
        int nw = w >> 2, nh = h >> 2, sd = c[CU_F_GPM_SPLIT];
        for (int uy = 0; uy < nh; uy++)
            for (int ux = 0; ux < nw; ux++) {
                int msk = gpm_unit_msk(sd, nw, nh, ux, uy);
                dbf_add_cu_motion(r, x0 + 4 * ux, y0 + 4 * uy, 4, 4,
                                  cls[msk].dir, cls[msk].l0x, cls[msk].l0y,
                                  (cls[msk].dir & 1)
                                      ? r->dist0[cls[msk].l0r] : 0,
                                  cls[msk].l1x, cls[msk].l1y,
                                  (cls[msk].dir & 2)
                                      ? r->dist1[cls[msk].l1r] : 0);
            }
    } else if (c[CU_F_PRED] != MODE_INTRA) {
        int idir = c[CU_F_MV1REF] >= 0 ? c[CU_F_INTER_DIR] : 1;
        dbf_add_cu_motion(r, x0, y0, w, h, idir,
                          c[CU_F_MV0X], c[CU_F_MV0Y],
                          (idir & 1) ? r->dist0[c[CU_F_MV0REF]] : 0,
                          c[CU_F_MV1X], c[CU_F_MV1Y],
                          (idir & 2) ? r->dist1[c[CU_F_MV1REF]] : 0);
    }
    int tu0 = c[CU_F_TU0], ntu_cu = c[CU_F_NTU];
    for (int k = 0; k < ntu_cu; k++) {
        const int32_t *t = r->tu_buf + (int64_t)(tu0 + k) * TU_NFIELDS;
        if (t[TU_F_COMP] == 0)
            dbf_add_tb_luma(r, t[TU_F_X0], t[TU_F_Y0],
                            1 << t[TU_F_LOG2W], 1 << t[TU_F_LOG2H]);
    }
    if (ep->chroma_enabled) {
        int qcb = dbf_chroma_qp(r, 1, c[CU_F_QP]);
        int qcr = dbf_chroma_qp(r, 2, c[CU_F_QP]);
        int intra_c = (c[CU_F_PRED] == MODE_INTRA && !(c[CU_F_BDPCM] & 4))
                      || c[CU_F_CIIP_WT] != 0;
        dbf_add_cu_chroma(r, x0 >> 1, y0 >> 1, w >> 1, h >> 1, qcb, qcr,
                          intra_c);
        for (int k = 0; k < ntu_cu; k++) {
            const int32_t *t = r->tu_buf + (int64_t)(tu0 + k) * TU_NFIELDS;
            int comp = t[TU_F_COMP];
            if (comp == 0)
                continue;
            /* BDPCM-chroma TBs raise neither bs1 nor bs2
             * (rcn_transform_tree.c:755/789/836) */
            if (c[CU_F_BDPCM] & 4)
                continue;
            int tw = 1 << t[TU_F_LOG2W], th = 1 << t[TU_F_LOG2H];
            if (comp == 3) {
                dbf_add_tb_chroma(r, 1, t[TU_F_X0], t[TU_F_Y0], tw, th);
                dbf_add_tb_chroma(r, 2, t[TU_F_X0], t[TU_F_Y0], tw, th);
            } else {
                dbf_add_tb_chroma(r, comp, t[TU_F_X0], t[TU_F_Y0], tw, th);
            }
        }
    }
}

static const int32_t *find_tu_c(const Rc *r, const int32_t *cu, int comp,
                                int x, int y)
{
    int tu0 = cu[CU_F_TU0], ntu = cu[CU_F_NTU];
    for (int i = 0; i < ntu; i++) {
        const int32_t *t = r->tu_buf + (int64_t)(tu0 + i) * TU_NFIELDS;
        if (t[TU_F_COMP] == comp && t[TU_F_X0] == x && t[TU_F_Y0] == y)
            return t;
    }
    return 0;
}

/* recursive TU-unit geometry (_tu_units parity) */
typedef struct { int x, y, l2w, l2h; } TuUnit;

static int tu_units(int x0, int y0, int l2w, int l2h, int max_tb, TuUnit *out,
                    int n)
{
    int split_v = l2w > max_tb, split_h = l2h > max_tb;
    if (!split_v && !split_h) {
        out[n] = (TuUnit){x0, y0, l2w, l2h};
        return n + 1;
    }
    int nl2w = l2w - (split_v ? 1 : 0);
    int nl2h = l2h - (split_h ? 1 : 0);
    n = tu_units(x0, y0, nl2w, nl2h, max_tb, out, n);
    if (split_v)
        n = tu_units(x0 + (1 << nl2w), y0, nl2w, nl2h, max_tb, out, n);
    if (split_h)
        n = tu_units(x0, y0 + (1 << nl2h), nl2w, nl2h, max_tb, out, n);
    if (split_v && split_h)
        n = tu_units(x0 + (1 << nl2w), y0 + (1 << nl2h), nl2w, nl2h, max_tb,
                     out, n);
    return n;
}

/* ---- per-CU reconstruction ------------------------------------------- */

/* BDPCM prediction: pure horizontal/vertical copy from unfiltered refs,
 * no PDPC (rcn/ref_intra.py predict_bdpcm; rcn_intra.c :513-523) */
static void predict_bdpcm_c(const Rc *r, const int32_t *plane, int stride,
                            int x0, int y0, int l2w, int l2h, int dir,
                            int is_luma, int32_t *pred)
{
    int w = 1 << l2w, h = 1 << l2h;
    RefArr ra, rl;
    fill_side_refs(r, plane, stride, x0, y0, l2w, l2h, is_luma, &ra, &rl);
    if (dir) { /* vertical: each row copies the above reference row */
        for (int y = 0; y < h; y++)
            for (int x = 0; x < w; x++)
                pred[y * w + x] = ra.b[ROFF + 1 + x];
    } else {   /* horizontal: each column copies the left reference */
        for (int y = 0; y < h; y++) {
            int v = rl.b[ROFF + 1 + y];
            for (int x = 0; x < w; x++)
                pred[y * w + x] = v;
        }
    }
}

static void recon_intra_cu(Rc *r, const int32_t *cu)
{
    const EntryParams *e = r->ep;
    int bd_max = r->bd_max;
    int x0 = cu[CU_F_X0], y0 = cu[CU_F_Y0];
    int l2w = cu[CU_F_LOG2W], l2h = cu[CU_F_LOG2H];
    int32_t pred[64 * 64], res[64 * 64];
    TuUnit units[16];

    int nu = tu_units(x0, y0, l2w, l2h, e->l_max_tb, units, 0);
    for (int u = 0; u < nu; u++) {
        TuUnit *tu = &units[u];
        int w = 1 << tu->l2w, h = 1 << tu->l2h;
        if (cu[CU_F_BDPCM] & 1)
            predict_bdpcm_c(r, r->fy, e->pic_w, tu->x, tu->y, tu->l2w,
                            tu->l2h, (cu[CU_F_BDPCM] >> 1) & 1, 1, pred);
        else if (cu[CU_F_MIP_FLAG])
            predict_mip_c(r, r->fy, e->pic_w, tu->x, tu->y, tu->l2w,
                          tu->l2h, cu[CU_F_MIP_MODE], cu[CU_F_MIP_T], pred);
        else
            predict_intra_c(r, r->fy, e->pic_w, tu->x, tu->y, tu->l2w,
                            tu->l2h, cu[CU_F_INTRA_L], 1, pred);
        const int32_t *t = find_tu_c(r, cu, 0, tu->x, tu->y);
        if (t) {
            recon_tu_residual_c(r, t, cu, 1, res);
            for (int i = 0; i < w * h; i++)
                pred[i] += res[i];
        }
        for (int j = 0; j < h; j++)
            for (int i = 0; i < w; i++)
                r->fy[(tu->y + j) * e->pic_w + tu->x + i] =
                    bdclip(pred[j * w + i], bd_max);
        mark_luma(r, tu->x, tu->y, tu->l2w, tu->l2h);
    }

    if (!e->chroma_enabled)
        return;

    int cs = e->pic_w >> 1;
    int cx0 = x0 >> 1, cy0 = y0 >> 1;
    int cl2w = l2w - 1, cl2h = l2h - 1;
    int mode = cu[CU_F_INTRA_C];
    int csign = r->rp->csign;
    int32_t rcb[32 * 32], rcr[32 * 32];

    nu = tu_units(cx0, cy0, cl2w, cl2h, e->l_max_tb - 1, units, 0);
    for (int u = 0; u < nu; u++) {
        TuUnit *tu = &units[u];
        int w = 1 << tu->l2w, h = 1 << tu->l2h;
        int have_cb = 0, have_cr = 0;
        const int32_t *jt = find_tu_c(r, cu, 3, tu->x, tu->y);
        if (jt) {
            recon_tu_residual_c(r, jt, cu, 1, res);
            int jc = jt[TU_F_JCBCR];
            for (int i = 0; i < w * h; i++) {
                int v = res[i];
                if (jc == 3) { rcb[i] = v; rcr[i] = csign * v; }
                else if (jc == 2) { rcb[i] = v; rcr[i] = (csign * v) >> 1; }
                else { rcr[i] = v; rcb[i] = (csign * v) >> 1; }
            }
            have_cb = have_cr = 1;
        } else {
            const int32_t *tb = find_tu_c(r, cu, 1, tu->x, tu->y);
            const int32_t *tr = find_tu_c(r, cu, 2, tu->x, tu->y);
            if (tb) { recon_tu_residual_c(r, tb, cu, 1, rcb); have_cb = 1; }
            if (tr) { recon_tu_residual_c(r, tr, cu, 1, rcr); have_cr = 1; }
        }
        for (int comp = 1; comp <= 2; comp++) {
            int32_t *plane = comp == 1 ? r->fcb : r->fcr;
            const int32_t *rr = comp == 1 ? rcb : rcr;
            int have = comp == 1 ? have_cb : have_cr;
            if (cu[CU_F_BDPCM] & 4)
                predict_bdpcm_c(r, plane, cs, tu->x, tu->y, tu->l2w,
                                tu->l2h, (cu[CU_F_BDPCM] >> 3) & 1, 0,
                                pred);
            else if (mode >= INTRA_LT_CCLM && mode <= INTRA_T_CCLM)
                predict_cclm_c(r, plane, cs, tu->x, tu->y, tu->l2w,
                               tu->l2h, mode == INTRA_L_CCLM
                               ? INTRA_L_CCLM : mode, pred);
            else
                predict_intra_c(r, plane, cs, tu->x, tu->y, tu->l2w,
                                tu->l2h, mode, 0, pred);
            for (int j = 0; j < h; j++)
                for (int i = 0; i < w; i++) {
                    int v = pred[j * w + i] + (have ? rr[j * w + i] : 0);
                    plane[(tu->y + j) * cs + tu->x + i] = bdclip(v, bd_max);
                }
        }
        mark_chroma(r, tu->x, tu->y, tu->l2w, tu->l2h);
    }
}

/* bi average of two 14-bit blocks (ref_mc.mc_bi) */
static void mc_bi_c(const int32_t *p0, const int32_t *p1, int w, int h,
                    int bd, int bd_max, int32_t *out, int ostride)
{
    int shift = 15 - bd;
    int off = 1 << (shift - 1);
    for (int j = 0; j < h; j++) {
        const int32_t *restrict a = p0 + (int64_t)j * w;
        const int32_t *restrict b = p1 + (int64_t)j * w;
        int32_t *restrict o = out + (int64_t)j * ostride;
        for (int i = 0; i < w; i++)
            o[i] = bdclip((a[i] + b[i] + off) >> shift, bd_max);
    }
}

/* _add_luma_residuals parity (shared by the plain-inter, GPM and
 * sub-block reconstruction paths) */
static void add_luma_residuals_c(Rc *r, const int32_t *cu)
{
    const EntryParams *e = r->ep;
    int bd_max = r->bd_max;
    int32_t res[64 * 64];
    int tu0 = cu[CU_F_TU0], ntu = cu[CU_F_NTU];
    for (int i = 0; i < ntu; i++) {
        const int32_t *t = r->tu_buf + (int64_t)(tu0 + i) * TU_NFIELDS;
        if (t[TU_F_COMP] != 0)
            continue;
        recon_tu_residual_c(r, t, cu, 0, res);
        int tw = 1 << t[TU_F_LOG2W], th = 1 << t[TU_F_LOG2H];
        int tx = t[TU_F_X0], ty = t[TU_F_Y0];
        for (int j = 0; j < th; j++)
            for (int k = 0; k < tw; k++) {
                int32_t *px = r->fy + (ty + j) * e->pic_w + tx + k;
                *px = bdclip(*px + res[j * tw + k], bd_max);
            }
    }
}

/* _add_chroma_residuals parity */
static void add_chroma_residuals_c(Rc *r, const int32_t *cu)
{
    const EntryParams *e = r->ep;
    int bd_max = r->bd_max;
    int cs = e->pic_w >> 1;
    int csign = r->rp->csign;
    int32_t res[64 * 64], rc2[32 * 32];
    int tu0 = cu[CU_F_TU0], ntu = cu[CU_F_NTU];
    for (int i = 0; i < ntu; i++) {
        const int32_t *t = r->tu_buf + (int64_t)(tu0 + i) * TU_NFIELDS;
        int comp = t[TU_F_COMP];
        if (comp == 0)
            continue;
        recon_tu_residual_c(r, t, cu, 0, res);
        int tw = 1 << t[TU_F_LOG2W], th = 1 << t[TU_F_LOG2H];
        int tx = t[TU_F_X0], ty = t[TU_F_Y0];
        int n = tw * th;
        int32_t *planes[2] = {0, 0};
        const int32_t *rs[2] = {0, 0};
        if (comp == 3) {
            int jc = t[TU_F_JCBCR];
            for (int k = 0; k < n; k++) {
                int v = res[k];
                rc2[k] = jc == 3 ? csign * v : (csign * v) >> 1;
            }
            if (jc >= 2) {
                planes[0] = r->fcb; rs[0] = res;
                planes[1] = r->fcr; rs[1] = rc2;
            } else {
                planes[0] = r->fcr; rs[0] = res;
                planes[1] = r->fcb; rs[1] = rc2;
            }
        } else {
            planes[0] = comp == 1 ? r->fcb : r->fcr;
            rs[0] = res;
        }
        for (int pp = 0; pp < 2; pp++) {
            if (!planes[pp])
                continue;
            for (int j = 0; j < th; j++)
                for (int k = 0; k < tw; k++) {
                    int32_t *px = planes[pp] + (ty + j) * cs + tx + k;
                    *px = bdclip(*px + rs[pp][j * tw + k], bd_max);
                }
        }
    }
}

/* BCW weighted bi combine (ref_mc.mc_bi_weighted, denom=3, w0+w1=8;
 * reference put_weighted_*_bi_* rcn_inter.c:1481) */
static void mc_bi_w_c(const int32_t *p0, const int32_t *p1, int w, int h,
                      int bd, int bd_max, int w0, int w1, int32_t *out,
                      int ostride)
{
    int shift = 14 - bd + 3;
    int off = 1 << (shift - 1);
    for (int j = 0; j < h; j++) {
        const int32_t *restrict a = p0 + (int64_t)j * w;
        const int32_t *restrict b = p1 + (int64_t)j * w;
        int32_t *restrict o = out + (int64_t)j * ostride;
        for (int i = 0; i < w; i++)
            o[i] = bdclip((a[i] * w0 + b[i] * w1 + off) >> shift, bd_max);
    }
}

static int c0_unused(const int32_t *cu)
{
    /* tool gates shared with the Python lane: CIIP / GPM / sub-block CUs
     * never run BDOF or DMVR */
    return cu[CU_F_PRED] != MODE_INTER || cu[CU_F_CIIP_WT]
           || cu[CU_F_GPM_DIRS] || cu[CU_F_SB_FLAG];
}

/* decoder.inter_tool_flags parity (single source of truth for the BDOF /
 * DMVR enable rules) */
static void inter_tool_flags_c(const Rc *r, const int32_t *cu,
                               int *bdof_en, int *dmvr_en)
{
    const EntryParams *e = r->ep;
    *bdof_en = 0;
    *dmvr_en = 0;
    if (c0_unused(cu))
        return;
    int pdir = cu[CU_F_MV1REF] >= 0 ? cu[CU_F_INTER_DIR] : 1;
    if (pdir != 3)
        return;
    int l2w = cu[CU_F_LOG2W], l2h = cu[CU_F_LOG2H];
    int size_ok = l2w >= 3 && l2h >= 3 && l2w + l2h >= 7;
    int bcw_w = cu[CU_F_MV0BCW] != 0 && cu[CU_F_MV0BCW] != 3;
    int dist_sym =
        r->dist0[cu[CU_F_MV0REF]] == -r->dist1[cu[CU_F_MV1REF]];
    if (!size_ok || bcw_w || !dist_sym)
        return;
    *bdof_en = e->bdof_on && !cu[CU_F_SMVD];
    *dmvr_en = e->dmvr_on && cu[CU_F_MERGE_FLAG] && !cu[CU_F_MMVD];
}

static void recon_inter_cu(Rc *r, const int32_t *cu)
{
    const EntryParams *e = r->ep;
    int bd_max = r->bd_max;
    int bd = e->bitdepth;
    int x0 = cu[CU_F_X0], y0 = cu[CU_F_Y0];
    int l2w = cu[CU_F_LOG2W], l2h = cu[CU_F_LOG2H];
    int w = 1 << l2w, h = 1 << l2h;
    int hpel = cu[CU_F_PREC_EFF] == PREC_HALF;
    int inter_dir = cu[CU_F_MV1REF] >= 0 ? cu[CU_F_INTER_DIR] : 1;

    /* identical-motion reduction to list-1 uni (check_identical_motion,
     * rcn_inter.c:255-267: equal ref POC + equal MV) */
    if (inter_dir == 3 &&
        r->rp->poc0[cu[CU_F_MV0REF]] == r->rp->poc1[cu[CU_F_MV1REF]] &&
        cu[CU_F_MV0X] == cu[CU_F_MV1X] && cu[CU_F_MV0Y] == cu[CU_F_MV1Y])
        inter_dir = 2;

    /* BCW weighted combine (decoder._mcp_block: weighted only when the
     * CU stayed bi after the reduction) */
    static const int8_t BCW_W1[5] = {-2, 3, 4, 5, 10};
    int bcw = cu[CU_F_MV0BCW];
    int wgt = inter_dir == 3 && bcw != 0 && bcw != 3;
    int w1b = wgt ? BCW_W1[bcw - 1] : 4;

    int bdof_en, dmvr_unused;
    inter_tool_flags_c(r, cu, &bdof_en, &dmvr_unused);

    int32_t pred[64 * 64], res[64 * 64], tmp1[64 * 64];

    int lst = inter_dir == 2 ? 1 : 0;
    int ref0 = lst ? cu[CU_F_MV1REF] : cu[CU_F_MV0REF];
    int ref1 = cu[CU_F_MV1REF];
    int m0x, m0y, m1x = 0, m1y = 0;
    clip_mv_c(x0, y0, e->pic_w, e->pic_h, w, h,
              lst ? cu[CU_F_MV1X] : cu[CU_F_MV0X],
              lst ? cu[CU_F_MV1Y] : cu[CU_F_MV0Y], &m0x, &m0y);
    if (inter_dir == 3)
        clip_mv_c(x0, y0, e->pic_w, e->pic_h, w, h, cu[CU_F_MV1X],
                  cu[CU_F_MV1Y], &m1x, &m1y);
    const int32_t *const *py0 = lst ? r->ref1_y : r->ref_y;
    const int32_t *const *pcb0 = lst ? r->ref1_cb : r->ref_cb;
    const int32_t *const *pcr0 = lst ? r->ref1_cr : r->ref_cr;

    /* GPM: two uni 14-bit predictions blended with the geometric weight
     * ramp (decoder._reconstruct_gpm; rcn_inter.c :2560-2615), then the
     * shared residual path below */
    int gpm = cu[CU_F_GPM_DIRS];
    int gd0 = 0, gd1 = 0, g0x = 0, g0y = 0, g1x = 0, g1y = 0;
    if (gpm) {
        gd0 = 1 + ((gpm - 1) & 1);
        gd1 = 1 + ((gpm - 1) >> 1);
        clip_mv_c(x0, y0, e->pic_w, e->pic_h, w, h, cu[CU_F_MV0X],
                  cu[CU_F_MV0Y], &g0x, &g0y);
        clip_mv_c(x0, y0, e->pic_w, e->pic_h, w, h, cu[CU_F_MV1X],
                  cu[CU_F_MV1Y], &g1x, &g1y);
    }

    /* luma — prediction written straight into the frame plane (the
     * residual add below reads/writes the plane in place) */
    int64_t mt0 = prof_now();
    int32_t *fdst = r->fy + (int64_t)y0 * e->pic_w + x0;
    if (gpm) {
        const int32_t *const *pa = gd0 == 1 ? r->ref_y : r->ref1_y;
        const int32_t *const *pb = gd1 == 1 ? r->ref_y : r->ref1_y;
        mc_block_c(pa[cu[CU_F_MV0REF]], e->pic_w, e->pic_h, e->pic_w, pred,
                   w, x0 + (g0x >> 4), y0 + (g0y >> 4), g0x & 15, g0y & 15,
                   w, h, bd, 1, 0, bd_max, 1);
        mc_block_c(pb[cu[CU_F_MV1REF]], e->pic_w, e->pic_h, e->pic_w, tmp1,
                   w, x0 + (g1x >> 4), y0 + (g1y >> 4), g1x & 15, g1y & 15,
                   w, h, bd, 1, 0, bd_max, 1);
        int sg = 14 - bd + 3, og = 1 << (sg - 1);
        int sd = cu[CU_F_GPM_SPLIT];
        for (int j = 0; j < h; j++) {
            int32_t *o = fdst + (int64_t)j * e->pic_w;
            for (int i = 0; i < w; i++) {
                int w0s = gpm_weight_at(sd, l2w, l2h, i, j);
                o[i] = bdclip((tmp1[j * w + i] * (8 - w0s)
                               + pred[j * w + i] * w0s + og) >> sg, bd_max);
            }
        }
    } else if (inter_dir == 3 && bdof_en) {
        /* BDOF luma: per <=16x16 sub-block with per-sub-block MV clips
         * (decoder.py :942-950, bdof_block) */
        int sb_w = imin(16, w), sb_h = imin(16, h);
        for (int sy = 0; sy < h; sy += sb_h)
            for (int sx = 0; sx < w; sx += sb_w) {
                int px = x0 + sx, py = y0 + sy;
                int c0x, c0y, c1x, c1y;
                clip_mv_c(px, py, e->pic_w, e->pic_h, sb_w, sb_h,
                          cu[CU_F_MV0X], cu[CU_F_MV0Y], &c0x, &c0y);
                clip_mv_c(px, py, e->pic_w, e->pic_h, sb_w, sb_h,
                          cu[CU_F_MV1X], cu[CU_F_MV1Y], &c1x, &c1y);
                bdof_from_pos_c(r,
                                py0[ref0], e->pic_w, e->pic_h, e->pic_w,
                                px + (c0x >> 4), py + (c0y >> 4),
                                c0x & 15, c0y & 15,
                                r->ref1_y[ref1], e->pic_w, e->pic_h,
                                e->pic_w, px + (c1x >> 4),
                                py + (c1y >> 4), c1x & 15, c1y & 15,
                                sb_w, sb_h, hpel,
                                r->fy + (int64_t)py * e->pic_w + px,
                                e->pic_w);
            }
    } else if (inter_dir == 3) {
        mc_block_c(py0[ref0], e->pic_w, e->pic_h, e->pic_w, pred, w,
                   x0 + (m0x >> 4), y0 + (m0y >> 4), m0x & 15, m0y & 15,
                   w, h, bd, 1, hpel, bd_max, 1);
        mc_block_c(r->ref1_y[ref1], e->pic_w, e->pic_h, e->pic_w, tmp1, w,
                   x0 + (m1x >> 4), y0 + (m1y >> 4), m1x & 15, m1y & 15,
                   w, h, bd, 1, hpel, bd_max, 1);
        if (wgt)
            mc_bi_w_c(pred, tmp1, w, h, bd, bd_max, 8 - w1b, w1b, fdst,
                      e->pic_w);
        else
            mc_bi_c(pred, tmp1, w, h, bd, bd_max, fdst, e->pic_w);
    } else {
        mc_block_c(py0[ref0], e->pic_w, e->pic_h, e->pic_w, fdst, e->pic_w,
                   x0 + (m0x >> 4), y0 + (m0y >> 4), m0x & 15, m0y & 15,
                   w, h, bd, 1, hpel, bd_max, 0);
    }
    prof_add(PROF_MCL, mt0);

    /* CIIP: blend the planar intra prediction into the MC result before
     * the residual add (decoder.py :981-984; rcn_inter.c ciip blend) */
    int ciip_wt = cu[CU_F_CIIP_WT];
    if (ciip_wt) {
        int32_t ip[64 * 64];
        predict_intra_c(r, r->fy, e->pic_w, x0, y0, l2w, l2h, INTRA_PLANAR,
                        1, ip);
        for (int j = 0; j < h; j++) {
            int32_t *o = fdst + (int64_t)j * e->pic_w;
            const int32_t *s = ip + (int64_t)j * w;
            for (int i = 0; i < w; i++)
                o[i] = bdclip((s[i] * ciip_wt + o[i] * (4 - ciip_wt) + 2)
                              >> 2, bd_max);
        }
    }

    /* luma residuals (_add_luma_residuals parity) */
    int tu0 = cu[CU_F_TU0], ntu = cu[CU_F_NTU];
    for (int i = 0; i < ntu; i++) {
        const int32_t *t = r->tu_buf + (int64_t)(tu0 + i) * TU_NFIELDS;
        if (t[TU_F_COMP] != 0)
            continue;
        recon_tu_residual_c(r, t, cu, 0, res);
        int tw = 1 << t[TU_F_LOG2W], th = 1 << t[TU_F_LOG2H];
        int tx = t[TU_F_X0], ty = t[TU_F_Y0];
        for (int j = 0; j < th; j++)
            for (int k = 0; k < tw; k++) {
                int32_t *px = r->fy + (ty + j) * e->pic_w + tx + k;
                *px = bdclip(*px + res[j * tw + k], bd_max);
            }
    }
    mark_luma(r, x0, y0, l2w, l2h);

    if (!e->chroma_enabled)
        return;

    int cs = e->pic_w >> 1;
    int cx0 = x0 >> 1, cy0 = y0 >> 1;
    int cw = w >> 1, ch = h >> 1;
    mt0 = prof_now();
    for (int comp = 1; comp <= 2; comp++) {
        const int32_t *rpl = (comp == 1 ? pcb0 : pcr0)[ref0];
        int32_t *dst = (comp == 1 ? r->fcb : r->fcr)
                       + (int64_t)cy0 * cs + cx0;
        if (gpm) {
            const int32_t *const *pa =
                gd0 == 1 ? (comp == 1 ? r->ref_cb : r->ref_cr)
                         : (comp == 1 ? r->ref1_cb : r->ref1_cr);
            const int32_t *const *pb =
                gd1 == 1 ? (comp == 1 ? r->ref_cb : r->ref_cr)
                         : (comp == 1 ? r->ref1_cb : r->ref1_cr);
            mc_block_c(pa[cu[CU_F_MV0REF]], e->pic_w >> 1, e->pic_h >> 1,
                       cs, pred, cw, cx0 + (g0x >> 5), cy0 + (g0y >> 5),
                       g0x & 31, g0y & 31, cw, ch, bd, 0, 0, bd_max, 1);
            mc_block_c(pb[cu[CU_F_MV1REF]], e->pic_w >> 1, e->pic_h >> 1,
                       cs, tmp1, cw, cx0 + (g1x >> 5), cy0 + (g1y >> 5),
                       g1x & 31, g1y & 31, cw, ch, bd, 0, 0, bd_max, 1);
            int sg = 14 - bd + 3, og = 1 << (sg - 1);
            int sd = cu[CU_F_GPM_SPLIT];
            for (int j = 0; j < ch; j++) {
                int32_t *o = dst + (int64_t)j * cs;
                for (int i = 0; i < cw; i++) {
                    int w0s = gpm_weight_at(sd, l2w, l2h, 2 * i, 2 * j);
                    o[i] = bdclip((tmp1[j * cw + i] * (8 - w0s)
                                   + pred[j * cw + i] * w0s + og) >> sg,
                                  bd_max);
                }
            }
        } else if (inter_dir == 3) {
            const int32_t *rpl1 =
                (comp == 1 ? r->ref1_cb : r->ref1_cr)[ref1];
            mc_block_c(rpl, e->pic_w >> 1, e->pic_h >> 1, cs, pred, cw,
                       cx0 + (m0x >> 5), cy0 + (m0y >> 5), m0x & 31,
                       m0y & 31, cw, ch, bd, 0, 0, bd_max, 1);
            mc_block_c(rpl1, e->pic_w >> 1, e->pic_h >> 1, cs, tmp1, cw,
                       cx0 + (m1x >> 5), cy0 + (m1y >> 5), m1x & 31,
                       m1y & 31, cw, ch, bd, 0, 0, bd_max, 1);
            if (wgt)
                mc_bi_w_c(pred, tmp1, cw, ch, bd, bd_max, 8 - w1b, w1b,
                          dst, cs);
            else
                mc_bi_c(pred, tmp1, cw, ch, bd, bd_max, dst, cs);
        } else {
            mc_block_c(rpl, e->pic_w >> 1, e->pic_h >> 1, cs, dst, cs,
                       cx0 + (m0x >> 5), cy0 + (m0y >> 5), m0x & 31,
                       m0y & 31, cw, ch, bd, 0, 0, bd_max, 0);
        }
        if (ciip_wt && l2w > 2) {
            /* chroma CIIP blend (decoder.py :1044-1050; skipped for 4-wide
             * luma CUs whose chroma is 2 wide) */
            int32_t ip[32 * 32];
            predict_intra_c(r, comp == 1 ? r->fcb : r->fcr, cs, cx0, cy0,
                            l2w - 1, l2h - 1, INTRA_PLANAR, 0, ip);
            for (int j = 0; j < ch; j++) {
                int32_t *o = dst + (int64_t)j * cs;
                const int32_t *s = ip + (int64_t)j * cw;
                for (int i = 0; i < cw; i++)
                    o[i] = bdclip((s[i] * ciip_wt + o[i] * (4 - ciip_wt)
                                   + 2) >> 2, bd_max);
            }
        }
    }
    prof_add(PROF_MCC, mt0);

    /* chroma residuals (_add_chroma_residuals parity) */
    int csign = r->rp->csign;
    for (int i = 0; i < ntu; i++) {
        const int32_t *t = r->tu_buf + (int64_t)(tu0 + i) * TU_NFIELDS;
        int comp = t[TU_F_COMP];
        if (comp == 0)
            continue;
        recon_tu_residual_c(r, t, cu, 0, res);
        int tw = 1 << t[TU_F_LOG2W], th = 1 << t[TU_F_LOG2H];
        int tx = t[TU_F_X0], ty = t[TU_F_Y0];
        int n = tw * th;
        int32_t rc2[32 * 32];
        int32_t *planes[2] = {0, 0};
        const int32_t *rs[2] = {0, 0};
        if (comp == 3) {
            int jc = t[TU_F_JCBCR];
            for (int k = 0; k < n; k++) {
                int v = res[k];
                if (jc == 3) rc2[k] = csign * v;
                else if (jc == 2) rc2[k] = (csign * v) >> 1;
                else rc2[k] = (csign * v) >> 1;
            }
            if (jc >= 2) {
                planes[0] = r->fcb; rs[0] = res;
                planes[1] = r->fcr; rs[1] = rc2;
            } else {
                planes[0] = r->fcr; rs[0] = res;
                planes[1] = r->fcb; rs[1] = rc2;
            }
        } else {
            planes[0] = comp == 1 ? r->fcb : r->fcr;
            rs[0] = res;
        }
        for (int p = 0; p < 2; p++) {
            if (!planes[p])
                continue;
            for (int j = 0; j < th; j++)
                for (int k = 0; k < tw; k++) {
                    int32_t *px = planes[p] + (ty + j) * cs + tx + k;
                    *px = bdclip(*px + rs[p][j * tw + k], bd_max);
                }
        }
    }
    mark_chroma(r, cx0, cy0, l2w - 1, l2h - 1);
}

/* =====================================================================
 * BDOF + DMVR (rcn/ref_bdof.py parity; reference rcn_prof_bdof.c
 * rcn_bdof :423, derive_bdof_weights :350; rcn_inter.c
 * rcn_dmvr_mv_refine :900, dmvr SAD :616, div_for_maxq7 :759,
 * padd_dmvr :354)
 * ===================================================================== */

#define BDOF_RND (1 << 13)
#define AMV_MAX_R ((1 << 17) - 1)
#define AMV_MIN_R (-(1 << 17))

static int32_t wrap16_c(int32_t v) { return (int16_t)(v & 0xFFFF); }

static int32_t clamp_px(const int32_t *pl, int W, int H, int stride, int x,
                        int y)
{
    x = imax(0, imin(W - 1, x));
    y = imax(0, imin(H - 1, y));
    return pl[(int64_t)y * stride + x];
}

/* _padded_14bit: 14-bit prediction + 1-sample integer ring; p is
 * (h+2) x (w+2) */
static void bdof_padded_14(const Rc *r, const int32_t *pl, int W, int H,
                           int stride, int ref_x, int ref_y, int fx,
                           int fy, int w, int h, int bd, int hpel,
                           int32_t *p)
{
    int pw = w + 2;
    int32_t q[16 * 16];
    mc_block_c(pl, W, H, stride, q, w, ref_x, ref_y, fx, fy, w, h, bd, 1,
               hpel, r->bd_max, 1);
    for (int j = 0; j < h; j++)
        for (int i = 0; i < w; i++)
            p[(j + 1) * pw + i + 1] = q[j * w + i];
    int ex = (fx >> 3) ? 1 : 0;
    int ey = (fy >> 3) ? 1 : 0;
    int sh = 14 - bd;
    for (int i = 0; i < pw; i++) {
        p[i] = clamp_px(pl, W, H, stride, ref_x - 1 + ex + i,
                        ref_y - 1 + ey) << sh;
        p[(h + 1) * pw + i] = clamp_px(pl, W, H, stride,
                                       ref_x - 1 + ex + i,
                                       ref_y - 1 + ey + h + 1) << sh;
    }
    for (int j = 1; j <= h; j++) {
        p[j * pw] = clamp_px(pl, W, H, stride, ref_x - 1 + ex,
                             ref_y - 1 + ey + j) << sh;
        p[j * pw + w + 1] = clamp_px(pl, W, H, stride,
                                     ref_x - 1 + ex + w + 1,
                                     ref_y - 1 + ey + j) << sh;
    }
}

static void bdof_replicate_ring(int32_t *a, int w, int h)
{
    int pw = w + 2;
    for (int j = 1; j <= h; j++) {
        a[j * pw] = a[j * pw + 1];
        a[j * pw + w + 1] = a[j * pw + w];
    }
    for (int i = 0; i < pw; i++) {
        a[i] = a[pw + i];
        a[(h + 1) * pw + i] = a[h * pw + i];
    }
}

static void bdof_grads(const int32_t *p, int w, int h, int32_t *gx,
                       int32_t *gy)
{
    int pw = w + 2;
    for (int j = 1; j <= h; j++)
        for (int i = 1; i <= w; i++) {
            int32_t sR = wrap16_c(p[j * pw + i + 1]);
            int32_t sL = wrap16_c(p[j * pw + i - 1]);
            int32_t sD = wrap16_c(p[(j + 1) * pw + i]);
            int32_t sU = wrap16_c(p[(j - 1) * pw + i]);
            gx[j * pw + i] = ((sR - BDOF_RND) >> 6) - ((sL - BDOF_RND) >> 6);
            gy[j * pw + i] = ((sD - BDOF_RND) >> 6) - ((sU - BDOF_RND) >> 6);
        }
    bdof_replicate_ring(gx, w, h);
    bdof_replicate_ring(gy, w, h);
}

static void bdof_weights_c(const int32_t *p0, const int32_t *p1,
                           const int32_t *gx0, const int32_t *gx1,
                           const int32_t *gy0, const int32_t *gy1,
                           int pw, int sy, int sx, int *wx_o, int *wy_o)
{
    int sum_ax = 0, sum_ay = 0, sum_xy = 0, sum_dx = 0, sum_dy = 0;
    for (int j = 0; j < 6; j++)
        for (int i = 0; i < 6; i++) {
            int idx = (sy + j) * pw + sx + i;
            int ax = (gx0[idx] + gx1[idx]) >> 1;
            int ay = (gy0[idx] + gy1[idx]) >> 1;
            int delta = ((p1[idx] - BDOF_RND) >> 4)
                        - ((p0[idx] - BDOF_RND) >> 4);
            int sgx = ax > 0 ? 1 : (ax < 0 ? -1 : 0);
            int sgy = ay > 0 ? 1 : (ay < 0 ? -1 : 0);
            sum_ax += ax < 0 ? -ax : ax;
            sum_ay += ay < 0 ? -ay : ay;
            sum_xy += sgy * ax;
            sum_dx += sgx * delta;
            sum_dy += sgy * delta;
        }
    int wx = 0, wy = 0;
    if (sum_ax) {
        wx = (sum_dx << 2) >> flog2_c(sum_ax);
        wx = imax(-15, imin(15, wx));
    }
    if (sum_ay) {
        int x_off = 0;
        if (wx) {
            int high = sum_xy >> 12;
            int low = sum_xy & 4095;
            x_off = (((wx * high) << 12) + wx * low) >> 1;
        }
        wy = ((sum_dy << 2) - x_off) >> flog2_c(sum_ay);
        wy = imax(-15, imin(15, wy));
    }
    *wx_o = wx;
    *wy_o = wy;
}

/* bdof_from_positions: writes bd-domain samples into dst (dstride) */
static void bdof_from_pos_c(const Rc *r,
                            const int32_t *pl0, int W0, int H0, int st0,
                            int x0i, int y0i, int fx0, int fy0,
                            const int32_t *pl1, int W1, int H1, int st1,
                            int x1i, int y1i, int fx1, int fy1,
                            int w, int h, int hpel, int32_t *dst,
                            int dstride)
{
    const EntryParams *e = r->ep;
    int bd = e->bitdepth;
    int shift = 14 + 1 - bd;
    int off = 1 << (shift - 1);
    int pw = w + 2;
    int32_t p0[18 * 18], p1[18 * 18];
    int32_t gx0[18 * 18], gy0[18 * 18], gx1[18 * 18], gy1[18 * 18];
    bdof_padded_14(r, pl0, W0, H0, st0, x0i, y0i, fx0, fy0, w, h, bd, hpel,
                   p0);
    bdof_padded_14(r, pl1, W1, H1, st1, x1i, y1i, fx1, fy1, w, h, bd, hpel,
                   p1);
    bdof_grads(p0, w, h, gx0, gy0);
    bdof_grads(p1, w, h, gx1, gy1);
    bdof_replicate_ring(p0, w, h);
    bdof_replicate_ring(p1, w, h);
    for (int sy = 0; sy < h; sy += 4)
        for (int sx = 0; sx < w; sx += 4) {
            int wx, wy;
            bdof_weights_c(p0, p1, gx0, gx1, gy0, gy1, pw, sy, sx, &wx,
                           &wy);
            for (int j = 0; j < 4; j++)
                for (int i = 0; i < 4; i++) {
                    int idx = (sy + 1 + j) * pw + sx + 1 + i;
                    int b = wx * (gx0[idx] - gx1[idx])
                            + wy * (gy0[idx] - gy1[idx]);
                    int v = wrap16_c((p0[idx] + p1[idx] + b + off)
                                     >> shift);
                    dst[(int64_t)(sy + j) * dstride + sx + i] =
                        bdclip(v, r->bd_max);
                }
        }
}

/* ---- DMVR ------------------------------------------------------------ */

static const int8_t DMVR_MX[25] = {-2, -1, 0, 1, 2, -2, -1, 0, 1, 2,
                                   -2, -1, 0, 1, 2, -2, -1, 0, 1, 2,
                                   -2, -1, 0, 1, 2};
static const int8_t DMVR_MY[25] = {-2, -2, -2, -2, -2, -1, -1, -1, -1, -1,
                                   0, 0, 0, 0, 0, 1, 1, 1, 1, 1,
                                   2, 2, 2, 2, 2};

/* dmvr_bilinear: 10-bit-domain 2-tap search predictor (out stride = w) */
static void dmvr_bilinear_c(const int32_t *pl, int W, int H, int stride,
                            int x0, int y0, int fx, int fy, int w, int h,
                            int bd, int32_t *out)
{
    int shift1 = 4 - (10 - bd);
    int off1 = 1 << (shift1 - 1);
    if (!fx && !fy) {
        for (int j = 0; j < h; j++)
            for (int i = 0; i < w; i++)
                out[j * w + i] = clamp_px(pl, W, H, stride, x0 + i, y0 + j)
                                 << (10 - bd);
        return;
    }
    int fhx0 = 16 - fx, fhx1 = fx;
    int fvy0 = 16 - fy, fvy1 = fy;
    if (!fy) {
        for (int j = 0; j < h; j++)
            for (int i = 0; i < w; i++) {
                int a = clamp_px(pl, W, H, stride, x0 + i, y0 + j);
                int b = clamp_px(pl, W, H, stride, x0 + i + 1, y0 + j);
                out[j * w + i] = (fhx0 * a + fhx1 * b + off1) >> shift1;
            }
        return;
    }
    if (!fx) {
        for (int j = 0; j < h; j++)
            for (int i = 0; i < w; i++) {
                int a = clamp_px(pl, W, H, stride, x0 + i, y0 + j);
                int b = clamp_px(pl, W, H, stride, x0 + i, y0 + j + 1);
                out[j * w + i] = (fvy0 * a + fvy1 * b + off1) >> shift1;
            }
        return;
    }
    /* hv: h pass then v pass with intermediate rounding */
    int32_t tmp[21 * 21];
    for (int j = 0; j < h + 1; j++)
        for (int i = 0; i < w; i++) {
            int a = clamp_px(pl, W, H, stride, x0 + i, y0 + j);
            int b = clamp_px(pl, W, H, stride, x0 + i + 1, y0 + j);
            tmp[j * w + i] = (fhx0 * a + fhx1 * b + off1) >> shift1;
        }
    for (int j = 0; j < h; j++)
        for (int i = 0; i < w; i++)
            out[j * w + i] = (fvy0 * tmp[j * w + i]
                              + fvy1 * tmp[(j + 1) * w + i] + 8) >> 4;
}

static int64_t dmvr_sad_c(const int32_t *a, const int32_t *b, int as,
                          int bs, int w, int h)
{
    int64_t s = 0;
    for (int j = 0; j < h; j += 2)
        for (int i = 0; i < w; i++) {
            int d = a[(int64_t)j * as + i] - b[(int64_t)j * bs + i];
            s += d < 0 ? -d : d;
        }
    return s;
}

static int div_for_maxq7_c(int64_t num, int64_t den)
{
    int sign = num < 0;
    if (sign)
        num = -num;
    int q = 0;
    den <<= 3;
    if (num >= den) { num -= den; q++; }
    q <<= 1;
    den >>= 1;
    if (num >= den) { num -= den; q++; }
    q <<= 1;
    if (num >= (den >> 1)) q++;
    return sign ? -q : q;
}

/* padd_dmvr: QPEL margins around the integer origin, then a 2-sample
 * REPLICATED ring (NOT picture data).  out (w+11) x (h+11), origin maps
 * picture (ref_x-5, ref_y-5) to patch (0, 0). */
static void dmvr_padd_c(const int32_t *pl, int W, int H, int stride,
                        int ref_x, int ref_y, int w, int h, int32_t *out)
{
    int cw = w + 7, chh = h + 7;
    int ow = w + 11;
    for (int j = 0; j < chh; j++)
        for (int i = 0; i < cw; i++)
            out[(j + 2) * ow + i + 2] =
                clamp_px(pl, W, H, stride, ref_x - 3 + i, ref_y - 3 + j);
    for (int j = 2; j < chh + 2; j++) {
        int32_t l = out[j * ow + 2], rr = out[j * ow + cw + 1];
        out[j * ow] = l; out[j * ow + 1] = l;
        out[j * ow + cw + 2] = rr; out[j * ow + cw + 3] = rr;
    }
    for (int i = 0; i < ow; i++) {
        int32_t t = out[2 * ow + i], bb = out[(chh + 1) * ow + i];
        out[i] = t; out[ow + i] = t;
        out[(chh + 2) * ow + i] = bb; out[(chh + 3) * ow + i] = bb;
    }
}

/* chroma patch: EPEL margins (1 before, 2 after) + 2 replicated */
static void dmvr_cpatch_c(const int32_t *pl, int W, int H, int stride,
                          int ref_x, int ref_y, int w, int h, int32_t *out)
{
    int cw = w + 3, chh = h + 3;
    int ow = w + 7;
    for (int j = 0; j < chh; j++)
        for (int i = 0; i < cw; i++)
            out[(j + 2) * ow + i + 2] =
                clamp_px(pl, W, H, stride, ref_x - 1 + i, ref_y - 1 + j);
    for (int j = 2; j < chh + 2; j++) {
        int32_t l = out[j * ow + 2], rr = out[j * ow + cw + 1];
        out[j * ow] = l; out[j * ow + 1] = l;
        out[j * ow + cw + 2] = rr; out[j * ow + cw + 3] = rr;
    }
    for (int i = 0; i < ow; i++) {
        int32_t t = out[2 * ow + i], bb = out[(chh + 1) * ow + i];
        out[i] = t; out[ow + i] = t;
        out[(chh + 2) * ow + i] = bb; out[(chh + 3) * ow + i] = bb;
    }
}

/* _reconstruct_dmvr parity: per-sub-PU search + refined MC + TMVP-field
 * override into the exported tile planes */
static void recon_dmvr_cu(Rc *r, const int32_t *cu, int32_t *tmv0,
                          int32_t *tmv1, int apply_bdof)
{
    const EntryParams *e = r->ep;
    int bd = e->bitdepth, bd_max = r->bd_max;
    int x0 = cu[CU_F_X0], y0 = cu[CU_F_Y0];
    int l2w = cu[CU_F_LOG2W], l2h = cu[CU_F_LOG2H];
    int w = 1 << l2w, h = 1 << l2h;
    int sb_w = imin(16, w), sb_h = imin(16, h);
    int ref0 = cu[CU_F_MV0REF], ref1 = cu[CU_F_MV1REF];
    int hpel = cu[CU_F_PREC_EFF] == PREC_HALF;
    int uw8 = ((((e->tile_w + 3) >> 2) + 1) >> 1);
    int uh8 = ((((e->tile_h + 3) >> 2) + 1) >> 1);

    for (int sy = 0; sy < h; sy += sb_h)
        for (int sx = 0; sx < w; sx += sb_w) {
            int pos_x = x0 + sx, pos_y = y0 + sy;
            int mvx0, mvy0, mvx1, mvy1;
            clip_mv_c(pos_x, pos_y, e->pic_w, e->pic_h, sb_w, sb_h,
                      cu[CU_F_MV0X], cu[CU_F_MV0Y], &mvx0, &mvy0);
            clip_mv_c(pos_x, pos_y, e->pic_w, e->pic_h, sb_w, sb_h,
                      cu[CU_F_MV1X], cu[CU_F_MV1Y], &mvx1, &mvy1);

            /* bilinear search grids over (w+4) x (h+4) */
            int32_t b0[20 * 20], b1[20 * 20];
            dmvr_bilinear_c(r->ref_y[ref0], e->pic_w, e->pic_h, e->pic_w,
                            pos_x + (mvx0 >> 4) - 2,
                            pos_y + (mvy0 >> 4) - 2, mvx0 & 15, mvy0 & 15,
                            sb_w + 4, sb_h + 4, bd, b0);
            dmvr_bilinear_c(r->ref1_y[ref1], e->pic_w, e->pic_h, e->pic_w,
                            pos_x + (mvx1 >> 4) - 2,
                            pos_y + (mvy1 >> 4) - 2, mvx1 & 15, mvy1 & 15,
                            sb_w + 4, sb_h + 4, bd, b1);
            int bs = sb_w + 4;
            int64_t sad_c = dmvr_sad_c(b0 + 2 * bs + 2, b1 + 2 * bs + 2,
                                       bs, bs, sb_w, sb_h);
            int64_t min_cost = sad_c - (sad_c >> 2);
            int dx = 0, dy = 0;
            if (min_cost >= sb_w * sb_h) {
                int64_t sad[25];
                sad[12] = min_cost;
                for (int idx = 0; idx < 25; idx++) {
                    if (idx == 12)
                        continue;
                    int ox = DMVR_MX[idx], oy = DMVR_MY[idx];
                    sad[idx] = dmvr_sad_c(
                        b0 + (2 + oy) * bs + 2 + ox,
                        b1 + (2 - oy) * bs + 2 - ox, bs, bs, sb_w, sb_h);
                }
                int best = 12;
                int64_t best_cost = ((int64_t)1) << 62;
                for (int idx = 0; idx < 25; idx++)
                    if (sad[idx] < best_cost
                        || (idx == 12 && sad[idx] <= best_cost)) {
                        best_cost = sad[idx];
                        best = idx;
                    }
                int delta_h = DMVR_MX[best] << 4;
                int delta_v = DMVR_MY[best] << 4;
                min_cost = sad[best];
                if (delta_h != 32 && delta_h != -32 && delta_v != 32
                    && delta_v != -32) {
                    int bx = best % 5, by = best / 5;
                    int64_t s0 = sad[best];
                    int64_t sl = bx > 0 ? sad[best - 1] : 0;
                    int64_t sr = bx < 4 ? sad[best + 1] : 0;
                    int64_t st = by > 0 ? sad[best - 5] : 0;
                    int64_t sb_ = by < 4 ? sad[best + 5] : 0;
                    int64_t den_h = sl + sr - (s0 << 1);
                    int64_t den_v = st + sb_ - (s0 << 1);
                    if (den_h != 0) {
                        if (sl != s0 && sr != s0)
                            delta_h += div_for_maxq7_c((sl - sr) << 4,
                                                       den_h);
                        else
                            delta_h += sl == s0 ? -8 : 8;
                    }
                    if (den_v != 0) {
                        if (st != s0 && sb_ != s0)
                            delta_v += div_for_maxq7_c((st - sb_) << 4,
                                                       den_v);
                        else
                            delta_v += st == s0 ? -8 : 8;
                    }
                }
                dx = delta_h;
                dy = delta_v;
            }
            int n0x = imax(AMV_MIN_R, imin(AMV_MAX_R, cu[CU_F_MV0X] + dx));
            int n0y = imax(AMV_MIN_R, imin(AMV_MAX_R, cu[CU_F_MV0Y] + dy));
            int n1x = imax(AMV_MIN_R, imin(AMV_MAX_R, cu[CU_F_MV1X] - dx));
            int n1y = imax(AMV_MIN_R, imin(AMV_MAX_R, cu[CU_F_MV1Y] - dy));

            /* TMVP field override on the tile 8x8 grid */
            int gx = ((pos_x + 7) >> 3) - (e->tile_x0 >> 3);
            int gy = ((pos_y + 7) >> 3) - (e->tile_y0 >> 3);
            for (int oy = 0; oy < (sb_h > 8 ? 2 : 1); oy++)
                for (int ox = 0; ox < (sb_w > 8 ? 2 : 1); ox++) {
                    int cx = gx + ox, cy = gy + oy;
                    if (cx < 0 || cy < 0 || cx >= uw8 || cy >= uh8)
                        continue;
                    if (tmv0) {
                        int32_t *cell = tmv0 + ((int64_t)cy * uw8 + cx) * 3;
                        cell[0] = n0x; cell[1] = n0y; cell[2] = ref0;
                    }
                    if (tmv1) {
                        int32_t *cell = tmv1 + ((int64_t)cy * uw8 + cx) * 3;
                        cell[0] = n1x; cell[1] = n1y; cell[2] = ref1;
                    }
                }

            /* final MC from original-position padded patches */
            int32_t p0p[27 * 27], p1p[27 * 27];
            dmvr_padd_c(r->ref_y[ref0], e->pic_w, e->pic_h, e->pic_w,
                        pos_x + (mvx0 >> 4), pos_y + (mvy0 >> 4), sb_w,
                        sb_h, p0p);
            dmvr_padd_c(r->ref1_y[ref1], e->pic_w, e->pic_h, e->pic_w,
                        pos_x + (mvx1 >> 4), pos_y + (mvy1 >> 4), sb_w,
                        sb_h, p1p);
            int pw = sb_w + 11, ph_ = sb_h + 11;
            int px0 = 5 + ((n0x >> 4) - (mvx0 >> 4));
            int py0 = 5 + ((n0y >> 4) - (mvy0 >> 4));
            int px1 = 5 + ((n1x >> 4) - (mvx1 >> 4));
            int py1 = 5 + ((n1y >> 4) - (mvy1 >> 4));
            int f0x = n0x & 15, f0y = n0y & 15;
            int f1x = n1x & 15, f1y = n1y & 15;
            if (hpel) {
                f0x += f0x == 8 ? 8 : 0;
                f0y += f0y == 8 ? 8 : 0;
                f1x += f1x == 8 ? 8 : 0;
                f1y += f1y == 8 ? 8 : 0;
            }
            int32_t *fdst = r->fy + (int64_t)pos_y * e->pic_w + pos_x;
            int disable_bdof =
                apply_bdof ? (min_cost < 2 * sb_w * sb_h) : 1;
            if (disable_bdof) {
                int32_t q0[16 * 16], q1[16 * 16];
                mc_block_c(p0p, pw, ph_, pw, q0, sb_w, px0, py0, f0x, f0y,
                           sb_w, sb_h, bd, 1, 0, bd_max, 1);
                mc_block_c(p1p, pw, ph_, pw, q1, sb_w, px1, py1, f1x, f1y,
                           sb_w, sb_h, bd, 1, 0, bd_max, 1);
                mc_bi_c(q0, q1, sb_w, sb_h, bd, bd_max, fdst, e->pic_w);
            } else {
                bdof_from_pos_c(r, p0p, pw, ph_, pw, px0, py0, f0x, f0y,
                                p1p, pw, ph_, pw, px1, py1, f1x, f1y,
                                sb_w, sb_h, 0, fdst, e->pic_w);
            }

            /* chroma: original-position patches, refined frac + delta */
            if (e->chroma_enabled) {
                int cs = e->pic_w >> 1;
                int cxp = pos_x >> 1, cyp = pos_y >> 1;
                int cw = sb_w >> 1, chh = sb_h >> 1;
                int cpw = cw + 7, cph = chh + 7;
                for (int comp = 1; comp <= 2; comp++) {
                    const int32_t *pl0 =
                        (comp == 1 ? r->ref_cb : r->ref_cr)[ref0];
                    const int32_t *pl1 =
                        (comp == 1 ? r->ref1_cb : r->ref1_cr)[ref1];
                    int32_t pat0[15 * 15], pat1[15 * 15];
                    dmvr_cpatch_c(pl0, e->pic_w >> 1, e->pic_h >> 1, cs,
                                  cxp + (mvx0 >> 5), cyp + (mvy0 >> 5),
                                  cw, chh, pat0);
                    dmvr_cpatch_c(pl1, e->pic_w >> 1, e->pic_h >> 1, cs,
                                  cxp + (mvx1 >> 5), cyp + (mvy1 >> 5),
                                  cw, chh, pat1);
                    int dc0x = (n0x >> 5) - (mvx0 >> 5);
                    int dc0y = (n0y >> 5) - (mvy0 >> 5);
                    int dc1x = (n1x >> 5) - (mvx1 >> 5);
                    int dc1y = (n1y >> 5) - (mvy1 >> 5);
                    int32_t q0[8 * 8], q1[8 * 8];
                    mc_block_c(pat0, cpw, cph, cpw, q0, cw, 3 + dc0x,
                               3 + dc0y, n0x & 31, n0y & 31, cw, chh, bd,
                               0, 0, bd_max, 1);
                    mc_block_c(pat1, cpw, cph, cpw, q1, cw, 3 + dc1x,
                               3 + dc1y, n1x & 31, n1y & 31, cw, chh, bd,
                               0, 0, bd_max, 1);
                    int32_t *dst = (comp == 1 ? r->fcb : r->fcr)
                                   + (int64_t)cyp * cs + cxp;
                    mc_bi_c(q0, q1, cw, chh, bd, bd_max, dst, cs);
                }
            }
        }
    add_luma_residuals_c(r, cu);
    mark_luma(r, x0, y0, l2w, l2h);
    if (e->chroma_enabled) {
        add_chroma_residuals_c(r, cu);
        mark_chroma(r, x0 >> 1, y0 >> 1, l2w - 1, l2h - 1);
    }
}

/* =====================================================================
 * Affine / SbTMVP sub-block reconstruction (decoder._reconstruct_sb;
 * reference rcn_affine_mcp_b_l :3265, rcn_affine_prof_mcp_b_l :3314,
 * rcn_affine_mcp_b_c :3368, rcn_prof_bdof.c rcn_prof :228)
 * ===================================================================== */

static const int8_t SB_BCW_W1[5] = {-2, 3, 4, 5, 10};

/* per-unit exported motion (tile units) */
static void sub_unit_motion(const Rc *r, int x, int y, int *d0, int *d1,
                            int *m0x, int *m0y, int *m1x, int *m1y)
{
    const EntryParams *e = r->ep;
    int64_t u = ((int64_t)((y - e->tile_y0) >> 2)) * r->al_w
                + ((x - e->tile_x0) >> 2);
    *d0 = r->sub_dir0 ? r->sub_dir0[u] : 0;
    *d1 = r->sub_dir1 ? r->sub_dir1[u] : 0;
    const int32_t *c = r->sub_mv + u * 4;
    *m0x = c[0]; *m0y = c[1]; *m1x = c[2]; *m1y = c[3];
}

/* _mcp_block parity: plain MC of one rect from raw (unclipped) MVs,
 * identical-motion reduction + BCW weighting included */
static void mc_rect_c(Rc *r, int x0, int y0, int w, int h, int inter_dir,
                      int m0x_, int m0y_, int ref0, int m1x_, int m1y_,
                      int ref1, int bcw_p1, int do_luma, int do_chroma)
{
    const EntryParams *e = r->ep;
    int bd = e->bitdepth, bd_max = r->bd_max;
    if (inter_dir == 3 && r->rp->poc0[ref0] == r->rp->poc1[ref1]
        && m0x_ == m1x_ && m0y_ == m1y_)
        inter_dir = 2;
    int wgt = inter_dir == 3 && bcw_p1 != 0 && bcw_p1 != 3;
    int w1b = wgt ? SB_BCW_W1[bcw_p1 - 1] : 4;

    int m0x = 0, m0y = 0, m1x = 0, m1y = 0;
    if (inter_dir & 1)
        clip_mv_c(x0, y0, e->pic_w, e->pic_h, w, h, m0x_, m0y_, &m0x, &m0y);
    if (inter_dir & 2)
        clip_mv_c(x0, y0, e->pic_w, e->pic_h, w, h, m1x_, m1y_, &m1x, &m1y);

    int32_t pred[64 * 64], tmp1[64 * 64];
    if (do_luma) {
        int32_t *fdst = r->fy + (int64_t)y0 * e->pic_w + x0;
        if (inter_dir == 3) {
            mc_block_c(r->ref_y[ref0], e->pic_w, e->pic_h, e->pic_w, pred,
                       w, x0 + (m0x >> 4), y0 + (m0y >> 4), m0x & 15,
                       m0y & 15, w, h, bd, 1, 0, bd_max, 1);
            mc_block_c(r->ref1_y[ref1], e->pic_w, e->pic_h, e->pic_w, tmp1,
                       w, x0 + (m1x >> 4), y0 + (m1y >> 4), m1x & 15,
                       m1y & 15, w, h, bd, 1, 0, bd_max, 1);
            if (wgt)
                mc_bi_w_c(pred, tmp1, w, h, bd, bd_max, 8 - w1b, w1b, fdst,
                          e->pic_w);
            else
                mc_bi_c(pred, tmp1, w, h, bd, bd_max, fdst, e->pic_w);
        } else {
            int lst = inter_dir == 2;
            const int32_t *const *py_ = lst ? r->ref1_y : r->ref_y;
            int rr = lst ? ref1 : ref0;
            int mx = lst ? m1x : m0x, my = lst ? m1y : m0y;
            mc_block_c(py_[rr], e->pic_w, e->pic_h, e->pic_w, fdst,
                       e->pic_w, x0 + (mx >> 4), y0 + (my >> 4), mx & 15,
                       my & 15, w, h, bd, 1, 0, bd_max, 0);
        }
    }
    if (do_chroma && e->chroma_enabled) {
        int cs = e->pic_w >> 1;
        int cx0 = x0 >> 1, cy0 = y0 >> 1;
        int cw = w >> 1, ch = h >> 1;
        for (int comp = 1; comp <= 2; comp++) {
            int32_t *dst = (comp == 1 ? r->fcb : r->fcr)
                           + (int64_t)cy0 * cs + cx0;
            if (inter_dir == 3) {
                const int32_t *p0 =
                    (comp == 1 ? r->ref_cb : r->ref_cr)[ref0];
                const int32_t *p1 =
                    (comp == 1 ? r->ref1_cb : r->ref1_cr)[ref1];
                mc_block_c(p0, e->pic_w >> 1, e->pic_h >> 1, cs, pred, cw,
                           cx0 + (m0x >> 5), cy0 + (m0y >> 5), m0x & 31,
                           m0y & 31, cw, ch, bd, 0, 0, bd_max, 1);
                mc_block_c(p1, e->pic_w >> 1, e->pic_h >> 1, cs, tmp1, cw,
                           cx0 + (m1x >> 5), cy0 + (m1y >> 5), m1x & 31,
                           m1y & 31, cw, ch, bd, 0, 0, bd_max, 1);
                if (wgt)
                    mc_bi_w_c(pred, tmp1, cw, ch, bd, bd_max, 8 - w1b,
                              w1b, dst, cs);
                else
                    mc_bi_c(pred, tmp1, cw, ch, bd, bd_max, dst, cs);
            } else {
                int lst = inter_dir == 2;
                const int32_t *pl = lst
                    ? (comp == 1 ? r->ref1_cb : r->ref1_cr)[ref1]
                    : (comp == 1 ? r->ref_cb : r->ref_cr)[ref0];
                int mx = lst ? m1x : m0x, my = lst ? m1y : m0y;
                mc_block_c(pl, e->pic_w >> 1, e->pic_h >> 1, cs, dst, cs,
                           cx0 + (mx >> 5), cy0 + (my >> 5), mx & 31,
                           my & 31, cw, ch, bd, 0, 0, bd_max, 0);
            }
        }
    }
}

/* compute_prof_dmv_scale parity (drv/affine.py :562) */
static void prof_dmv_scale_c(int hx, int hy, int vx, int vy,
                             int32_t dh[16], int32_t dv[16])
{
    const int LIM = 31;
    int qhx = hx << 2, qhy = hy << 2, qvx = vx << 2, qvy = vy << 2;
    int32_t ht[16], vt[16];
    ht[0] = ((hx + vx) << 1) - ((qhx + qvx) << 1);
    vt[0] = ((hy + vy) << 1) - ((qhy + qvy) << 1);
    for (int x = 1; x < 4; x++) {
        ht[x] = ht[x - 1] + qhx;
        vt[x] = vt[x - 1] + qhy;
    }
    for (int y = 1; y < 4; y++)
        for (int x = 0; x < 4; x++) {
            ht[y * 4 + x] = ht[(y - 1) * 4 + x] + qvx;
            vt[y * 4 + x] = vt[(y - 1) * 4 + x] + qvy;
        }
    for (int i = 0; i < 16; i++) {
        int dx = (ht[i] + 128 - (ht[i] >= 0 ? 1 : 0)) >> 8;
        int dy = (vt[i] + 128 - (vt[i] >= 0 ? 1 : 0)) >> 8;
        dh[i] = imax(-LIM, imin(LIM, dx));
        dv[i] = imax(-LIM, imin(LIM, dy));
    }
}

/* one 4x4 PROF sub-block (ref_prof.prof_sb): returns the 14-bit block
 * (bidir) or writes nothing; out[16] */
static void prof_sb_c(const Rc *r, const int32_t *plane, int ref_x,
                      int ref_y, int fx, int fy, const int32_t *dh,
                      const int32_t *dv, int bidir, int32_t out[16])
{
    const EntryParams *e = r->ep;
    int bd = e->bitdepth;
    int32_t q[16];
    mc_block_c(plane, e->pic_w, e->pic_h, e->pic_w, q, 4, ref_x, ref_y,
               fx, fy, 4, 4, bd, 1, 0, r->bd_max, 1);
    int ex = fx >> 3, ey = fy >> 3;
    /* 6x6 clamped border patch in the 14-bit domain */
    int16_t buf[6][6];
    for (int j = 0; j < 6; j++) {
        int sy = imax(0, imin(e->pic_h - 1, ref_y - 1 + ey + j));
        for (int i = 0; i < 6; i++) {
            int sx = imax(0, imin(e->pic_w - 1, ref_x - 1 + ex + i));
            buf[j][i] = (int16_t)(plane[(int64_t)sy * e->pic_w + sx]
                                  << (14 - bd));
        }
    }
    for (int j = 0; j < 4; j++)
        for (int i = 0; i < 4; i++)
            buf[1 + j][1 + i] = (int16_t)q[j * 4 + i];
    const int rnd = 1 << 13;
    for (int j = 0; j < 4; j++)
        for (int i = 0; i < 4; i++) {
            int gx = (((int32_t)buf[1 + j][2 + i] - rnd) >> 6)
                     - (((int32_t)buf[1 + j][0 + i] - rnd) >> 6);
            int gy = (((int32_t)buf[2 + j][1 + i] - rnd) >> 6)
                     - (((int32_t)buf[0 + j][1 + i] - rnd) >> 6);
            gx = (int16_t)gx;
            gy = (int16_t)gy;
            int add = dh[j * 4 + i] * gx + dv[j * 4 + i] * gy;
            add = imax(-(1 << 13), imin((1 << 13) - 1, add));
            out[j * 4 + i] = (int16_t)(q[j * 4 + i] + add);
        }
    if (!bidir) {
        for (int i = 0; i < 16; i++) {
            int v = (out[i] + (1 << (13 - bd))) >> (14 - bd);
            out[i] = bdclip(v, r->bd_max);
        }
    }
}

static void recon_sb_cu(Rc *r, const int32_t *cu)
{
    const EntryParams *e = r->ep;
    int bd = e->bitdepth, bd_max = r->bd_max;
    int x0 = cu[CU_F_X0], y0 = cu[CU_F_Y0];
    int l2w = cu[CU_F_LOG2W], l2h = cu[CU_F_LOG2H];
    int w = 1 << l2w, h = 1 << l2h;
    int flag = cu[CU_F_SB_FLAG];
    int nw = w >> 2, nh = h >> 2;

    if (flag == 3) {
        /* SbTMVP zero fallback: whole-CU MC with zero MVs */
        mc_rect_c(r, x0, y0, w, h, cu[CU_F_INTER_DIR], 0, 0, 0, 0, 0, 0,
                  0, 1, 1);
    } else if (flag == 2) {
        /* SbTMVP: per-8x8 (or whole-CU when one sub-block) groups */
        int sb_w = nw <= 2 ? w : 8;
        int sb_h = nh <= 2 ? h : 8;
        for (int gy = 0; gy < h; gy += sb_h)
            for (int gx = 0; gx < w; gx += sb_w) {
                int d0, d1, m0x, m0y, m1x, m1y;
                sub_unit_motion(r, x0 + gx, y0 + gy, &d0, &d1, &m0x, &m0y,
                                &m1x, &m1y);
                int idir = (d0 ? 1 : 0) | (d1 ? 2 : 0);
                mc_rect_c(r, x0 + gx, y0 + gy, sb_w, sb_h, idir, m0x, m0y,
                          0, m1x, m1y, 0, 0, 1, 1);
            }
    } else {
        /* affine: per-4x4 luma (PROF-refined when flagged), per-8x8
         * chroma with diagonally-averaged MVs */
        int inter_dir = cu[CU_F_INTER_DIR];
        int ref0 = cu[CU_F_MV0REF], ref1 = cu[CU_F_MV1REF];
        int bcw_p1 = cu[CU_F_MV0BCW];
        int prof_dir = cu[CU_F_PROF_DIR];
        int32_t dh0[16], dv0[16], dh1[16], dv1[16];
        if (prof_dir & 1)
            prof_dmv_scale_c(cu[CU_F_DMV0HX], cu[CU_F_DMV0HY],
                             cu[CU_F_DMV0VX], cu[CU_F_DMV0VY], dh0, dv0);
        if (prof_dir & 2)
            prof_dmv_scale_c(cu[CU_F_DMV1HX], cu[CU_F_DMV1HY],
                             cu[CU_F_DMV1VX], cu[CU_F_DMV1VY], dh1, dv1);

        for (int i = 0; i < nh; i++)
            for (int j = 0; j < nw; j++) {
                int px = x0 + 4 * j, py = y0 + 4 * i;
                int d0, d1, m0x, m0y, m1x, m1y;
                sub_unit_motion(r, px, py, &d0, &d1, &m0x, &m0y, &m1x,
                                &m1y);
                if (!prof_dir) {
                    mc_rect_c(r, px, py, 4, 4, inter_dir, m0x, m0y, ref0,
                              m1x, m1y, ref1, bcw_p1, 1, 0);
                    continue;
                }
                int32_t v0[16], v1[16];
                int c0x = 0, c0y = 0, c1x = 0, c1y = 0;
                if (inter_dir & 1)
                    clip_mv_c(px, py, e->pic_w, e->pic_h, 4, 4, m0x, m0y,
                              &c0x, &c0y);
                if (inter_dir & 2)
                    clip_mv_c(px, py, e->pic_w, e->pic_h, 4, 4, m1x, m1y,
                              &c1x, &c1y);
                if (inter_dir == 3) {
                    if (prof_dir & 1)
                        prof_sb_c(r, r->ref_y[ref0], px + (c0x >> 4),
                                  py + (c0y >> 4), c0x & 15, c0y & 15,
                                  dh0, dv0, 1, v0);
                    else
                        mc_block_c(r->ref_y[ref0], e->pic_w, e->pic_h,
                                   e->pic_w, v0, 4, px + (c0x >> 4),
                                   py + (c0y >> 4), c0x & 15, c0y & 15,
                                   4, 4, bd, 1, 0, bd_max, 1);
                    if (prof_dir & 2)
                        prof_sb_c(r, r->ref1_y[ref1], px + (c1x >> 4),
                                  py + (c1y >> 4), c1x & 15, c1y & 15,
                                  dh1, dv1, 1, v1);
                    else
                        mc_block_c(r->ref1_y[ref1], e->pic_w, e->pic_h,
                                   e->pic_w, v1, 4, px + (c1x >> 4),
                                   py + (c1y >> 4), c1x & 15, c1y & 15,
                                   4, 4, bd, 1, 0, bd_max, 1);
                    int32_t *fdst = r->fy + (int64_t)py * e->pic_w + px;
                    if (bcw_p1 != 0 && bcw_p1 != 3) {
                        /* tmp_prof_mrg_w */
                        int w1b = SB_BCW_W1[bcw_p1 - 1];
                        int sh = 14 - bd + 3;
                        int off = (2 * (1 << (13 - bd))) << 2;
                        for (int k = 0; k < 4; k++)
                            for (int m = 0; m < 4; m++)
                                fdst[(int64_t)k * e->pic_w + m] = bdclip(
                                    (v0[k * 4 + m] * (8 - w1b)
                                     + v1[k * 4 + m] * w1b + off) >> sh,
                                    bd_max);
                    } else {
                        /* tmp_prof_mrg */
                        int sh = 15 - bd;
                        int off = 2 * (1 << (13 - bd));
                        for (int k = 0; k < 4; k++)
                            for (int m = 0; m < 4; m++)
                                fdst[(int64_t)k * e->pic_w + m] = bdclip(
                                    (v0[k * 4 + m] + v1[k * 4 + m] + off)
                                        >> sh, bd_max);
                    }
                } else {
                    int lst = inter_dir == 2;
                    int pf = lst ? (prof_dir & 2) : (prof_dir & 1);
                    const int32_t *pl =
                        lst ? r->ref1_y[ref1] : r->ref_y[ref0];
                    int cx = lst ? c1x : c0x, cy = lst ? c1y : c0y;
                    int32_t *fdst = r->fy + (int64_t)py * e->pic_w + px;
                    if (pf) {
                        int32_t vv[16];
                        prof_sb_c(r, pl, px + (cx >> 4), py + (cy >> 4),
                                  cx & 15, cy & 15, lst ? dh1 : dh0,
                                  lst ? dv1 : dv0, 0, vv);
                        for (int k = 0; k < 4; k++)
                            for (int m = 0; m < 4; m++)
                                fdst[(int64_t)k * e->pic_w + m] =
                                    vv[k * 4 + m];
                    } else {
                        mc_block_c(pl, e->pic_w, e->pic_h, e->pic_w, fdst,
                                   e->pic_w, px + (cx >> 4),
                                   py + (cy >> 4), cx & 15, cy & 15, 4, 4,
                                   bd, 1, 0, bd_max, 0);
                    }
                }
            }

        /* chroma: 2x2 sub-block MV average at 8x8 luma granularity */
        if (e->chroma_enabled)
            for (int i = 0; i < nh; i += 2)
                for (int j = 0; j < nw; j += 2) {
                    int d0a, d1a, ax0, ay0, ax1, ay1;
                    int d0b, d1b, bx0, by0, bx1, by1;
                    sub_unit_motion(r, x0 + 4 * j, y0 + 4 * i, &d0a, &d1a,
                                    &ax0, &ay0, &ax1, &ay1);
                    sub_unit_motion(r, x0 + 4 * (j + 1), y0 + 4 * (i + 1),
                                    &d0b, &d1b, &bx0, &by0, &bx1, &by1);
                    int m0x = 0, m0y = 0, m1x = 0, m1y = 0;
                    if (inter_dir & 1) {
                        m0x = ax0 + bx0;
                        m0y = ay0 + by0;
                        m0x += m0x < 0 ? 1 : 0;
                        m0y += m0y < 0 ? 1 : 0;
                        m0x >>= 1;
                        m0y >>= 1;
                    }
                    if (inter_dir & 2) {
                        m1x = ax1 + bx1;
                        m1y = ay1 + by1;
                        m1x += m1x < 0 ? 1 : 0;
                        m1y += m1y < 0 ? 1 : 0;
                        m1x >>= 1;
                        m1y >>= 1;
                    }
                    mc_rect_c(r, x0 + 4 * j, y0 + 4 * i, 8, 8, inter_dir,
                              m0x, m0y, ref0, m1x, m1y, ref1, bcw_p1, 0,
                              1);
                }
    }

    add_luma_residuals_c(r, cu);
    mark_luma(r, x0, y0, l2w, l2h);
    if (e->chroma_enabled) {
        add_chroma_residuals_c(r, cu);
        mark_chroma(r, x0 >> 1, y0 >> 1, l2w - 1, l2h - 1);
    }
}

/* ---- entry driver ----------------------------------------------------- */

int64_t ov_recon_entry(const EntryParams *ep, const ReconParams *rp,
                       const int32_t *cu_buf, int64_t ncu,
                       const int32_t *tu_buf, int64_t ntu,
                       const int32_t *coef_buf, const int8_t *cqp_tab,
                       int32_t *fy, int32_t *fcb, int32_t *fcr,
                       const int32_t *const *ref_y,
                       const int32_t *const *ref_cb,
                       const int32_t *const *ref_cr,
                       const int32_t *const *ref1_y,
                       const int32_t *const *ref1_cb,
                       const int32_t *const *ref1_cr,
                       const int32_t *dist0, const int32_t *dist1,
                       const uint8_t *sub_dir0, const uint8_t *sub_dir1,
                       const int32_t *sub_mv,
                       int32_t *tmvp_mv0, int32_t *tmvp_mv1,
                       const DbfBufs *dbf)
{
    /* support scan first: leave all outputs untouched on -1 */
    for (int64_t i = 0; i < ncu; i++) {
        const int32_t *c = cu_buf + i * CU_NFIELDS;
        if (c[CU_F_TREE] != TREE_SINGLE || c[CU_F_MRL] ||
            c[CU_F_PRED] > MODE_INTER)
            return -1;
        if (c[CU_F_MIP_FLAG] && (c[CU_F_LOG2W] > ep->l_max_tb ||
                                 c[CU_F_LOG2H] > ep->l_max_tb))
            return -1; /* MIP across a TU split: host fallback */
        if (c[CU_F_SB_FLAG]) {
            if (!sub_mv)
                return -1;
            int dir = c[CU_F_INTER_DIR];
            if ((dir & 1) &&
                (c[CU_F_MV0REF] < 0 || c[CU_F_MV0REF] >= rp->nb_refs))
                return -1;
            if ((dir & 2) &&
                (c[CU_F_MV1REF] < 0 || c[CU_F_MV1REF] >= rp->nb_refs1))
                return -1;
        } else if (c[CU_F_PRED] == MODE_INTER && c[CU_F_GPM_DIRS]) {
            int gpm = c[CU_F_GPM_DIRS];
            int n0 = (1 + ((gpm - 1) & 1)) == 1 ? rp->nb_refs : rp->nb_refs1;
            int n1 = (1 + ((gpm - 1) >> 1)) == 1 ? rp->nb_refs : rp->nb_refs1;
            if (c[CU_F_MV0REF] < 0 || c[CU_F_MV0REF] >= n0 ||
                c[CU_F_MV1REF] < 0 || c[CU_F_MV1REF] >= n1)
                return -1;
        } else if (c[CU_F_PRED] == MODE_INTER) {
            int dir = c[CU_F_MV1REF] >= 0 ? c[CU_F_INTER_DIR] : 1;
            if (dir & 1) {
                if (c[CU_F_MV0REF] < 0 || c[CU_F_MV0REF] >= rp->nb_refs)
                    return -1;
            }
            if (dir & 2) {
                if (c[CU_F_MV1REF] < 0 || c[CU_F_MV1REF] >= rp->nb_refs1)
                    return -1;
            }
        }
    }
    for (int64_t i = 0; i < ntu; i++) {
        const int32_t *t = tu_buf + i * TU_NFIELDS;
        if (t[TU_F_COEF] < 0)
            return -1;
    }

    Rc rc;
    memset(&rc, 0, sizeof(rc));
    rc.ep = ep;
    rc.rp = rp;
    rc.tu_buf = tu_buf;
    rc.coef_buf = coef_buf;
    rc.cqp_tab = cqp_tab;
    rc.fy = fy; rc.fcb = fcb; rc.fcr = fcr;
    rc.ref_y = ref_y; rc.ref_cb = ref_cb; rc.ref_cr = ref_cr;
    rc.ref1_y = ref1_y; rc.ref1_cb = ref1_cb; rc.ref1_cr = ref1_cr;
    rc.dist0 = dist0; rc.dist1 = dist1;
    rc.sub_dir0 = sub_dir0; rc.sub_dir1 = sub_dir1; rc.sub_mv = sub_mv;
    rc.tmv0 = tmvp_mv0; rc.tmv1 = tmvp_mv1;
    rc.dbf = dbf;
    rc.uw = (ep->pic_w + 3) >> 2;
    rc.uh = (ep->pic_h + 3) >> 2;
    rc.bd_max = (1 << ep->bitdepth) - 1;
    rc.al_w = (ep->tile_w + 3) / 4;
    rc.al_h = (ep->tile_h + 3) / 4;
    rc.ac_w = (ep->tile_w / 2 + 1) / 2 + 1;
    rc.ac_h = (ep->tile_h / 2 + 1) / 2 + 1;
    rc.avail_l = calloc((size_t)rc.al_w * rc.al_h, 1);
    rc.avail_c = calloc((size_t)rc.ac_w * rc.ac_h, 1);
    if (!rc.avail_l || !rc.avail_c) {
        free(rc.avail_l);
        free(rc.avail_c);
        return -2;
    }

    int dbf_on = rp->dbf_enabled && dbf;
    for (int64_t i = 0; i < ncu; i++) {
        const int32_t *c = cu_buf + i * CU_NFIELDS;
        int intra = c[CU_F_PRED] == MODE_INTRA;
        int64_t pt0 = prof_now();
        if (dbf_on)
            fill_dbf_cu(&rc, c);
        prof_add(PROF_DBFMAP, pt0);
        pt0 = prof_now();
        if (intra) {
            recon_intra_cu(&rc, c);
            prof_add(PROF_INTRA, pt0);
        } else if (c[CU_F_SB_FLAG]) {
            recon_sb_cu(&rc, c);
            prof_add(PROF_INTER, pt0);
        } else {
            int bdof_en, dmvr_en;
            inter_tool_flags_c(&rc, c, &bdof_en, &dmvr_en);
            if (dmvr_en)
                recon_dmvr_cu(&rc, c, rc.tmv0, rc.tmv1, bdof_en);
            else
                recon_inter_cu(&rc, c);
            prof_add(PROF_INTER, pt0);
        }
    }

    free(rc.avail_l);
    free(rc.avail_c);
    return 0;
}

/* ======================================================================
 * Device-IR builder: turn a parsed entry into the dense per-frame tensors
 * consumed by the device frame program (tpu/frame_program.py). Instead of
 * reconstructing samples, it emits
 *   - residual planes (dequant + inverse transform per TU),
 *   - per-4x4-unit inter motion grids (clipped MVs, refs, BCW weights),
 *   - wave-scheduled intra job records with decode-order availability,
 *   - the deblocking maps (shared fill_dbf_cu).
 * Same walk order as ov_recon_entry so availability/DBF parity holds.
 * Equivalent of the reference's per-CU dispatch state (rcn.c:147-300)
 * re-expressed as tensors (SURVEY.md §7.1 "CTU tensor IR").
 * ====================================================================== */

typedef struct {
    int16_t *res_y, *res_cb, *res_cr;
    int32_t ry_stride, rc_stride;
    uint8_t *gmask;
    int32_t *gmv;   /* (uh, uw, 2, 2) */
    int8_t *gref;   /* (uh, uw, 2) */
    int8_t *gw;     /* (uh, uw, 2) */
    uint8_t *ghpel; /* (uh, uw) */
    int8_t *glist;  /* (uh, uw, 2): ref list each MC slot resolves through */
    int8_t *gwp;    /* (uh*4, uw*4): per-sample w0 (GPM ramps; else w0) */
    int32_t g_stride;
    int32_t *jobs_l, *jobs_c;
    int64_t cap_l, cap_c, njl, njc;
    uint16_t *lvl_l, *lvl_c; /* per-tile wave level maps (avail grids) */
    int64_t max_lvl_l, max_lvl_c;
    int64_t has_gpm; /* any GPM CU: the MC combine needs the gwp plane */
    /* device-residual TU records: raw levels + resolved selectors shipped
     * to the frame program (dequant + LFNST + itx run on device); TBs that
     * do not emit a record fall back to the host res-plane path above */
    int32_t *dtu;       /* (dtu_cap, DTU_NFIELDS) */
    int32_t *dtu_coef;  /* flat levels, row-major per TB */
    int64_t dtu_cap, dtu_coef_cap, dtu_n, dtu_coef_n;
} IrOut;

static void ir_write_res(int16_t *dst, int stride, const int32_t *res,
                         int tx, int ty, int tw, int th)
{
    for (int j = 0; j < th; j++) {
        int16_t *o = dst + (int64_t)(ty + j) * stride + tx;
        const int32_t *s = res + (int64_t)j * tw;
        for (int k = 0; k < tw; k++)
            o[k] = (int16_t)s[k];
    }
}

/* Emit one device-residual TU record (levels + resolved selectors) so
 * dequant + LFNST + the inverse transform run inside the fused frame
 * program (rcn_dequant.c / rcn_transform.c host work moved on-device).
 * Returns 1 when emitted; 0 = caller keeps the host res-plane path. */
static int ir_emit_dtu(const Rc *r, IrOut *o, const int32_t *t,
                       const int32_t *cu, int intra)
{
    if (!o->dtu)
        return 0;
    int l2w = t[TU_F_LOG2W], l2h = t[TU_F_LOG2H];
    if (t[TU_F_TS])
        return 0; /* transform-skip residuals ride the host res planes */
    int lfnst = t[TU_F_LFNST];
    /* LFNST with a clamped region view (l2 > 5) keeps the host path so
     * the device never needs the stride-remapped corner case; < 4 px a
     * side cannot carry the 4x4 input region */
    if (lfnst && (l2w < 2 || l2h < 2 || l2w > 5 || l2h > 5))
        return 0;
    int64_t n = (int64_t)1 << (l2w + l2h);
    if (o->dtu_n >= o->dtu_cap || o->dtu_coef_n + n > o->dtu_coef_cap)
        return 0;
    int tr_h = 0, tr_v = 0;
    int lf_kind = 0, lf_mat = 0, lf_t = 0, lf_nin = 16;
    if (lfnst) {
        int base;
        if (t[TU_F_COMP] == 0)
            base = cu[CU_F_MIP_FLAG] ? 0 : cu[CU_F_INTRA_L];
        else {
            base = cu[CU_F_INTRA_C];
            if (base >= 81 && base <= 83)
                base = cu[CU_F_COL_MODE];
        }
        int ml = lfnst_intra_mode_c(l2w, l2h, base);
        lf_t = (ml > 34 && ml < 67) || ml >= 67 + 14;
        int is8 = l2w >= 3 && l2h >= 3;
        lf_kind = is8 ? 2 : 1;
        lf_mat = g_lfnst_mode_map[ml] * 2 + (lfnst - 1);
        lf_nin = (!is8 && l2w == l2h) ? 8 : 16;
    } else {
        transform_pair_c(r->ep, t, intra, &tr_h, &tr_v);
    }
    int32_t *rec = o->dtu + o->dtu_n * DTU_NFIELDS;
    rec[DTU_PLANE] = t[TU_F_COMP];
    rec[DTU_X] = t[TU_F_X0];
    rec[DTU_Y] = t[TU_F_Y0];
    rec[DTU_L2W] = l2w;
    rec[DTU_L2H] = l2h;
    rec[DTU_QP] = t[TU_F_QP];
    rec[DTU_TRH] = tr_h;
    rec[DTU_TRV] = tr_v;
    rec[DTU_LF_KIND] = lf_kind;
    rec[DTU_LF_MAT] = lf_mat;
    rec[DTU_LF_T] = lf_t;
    rec[DTU_LF_NIN] = lf_nin;
    rec[DTU_JC] = t[TU_F_JCBCR];
    rec[DTU_CSIGN] = r->rp->csign;
    rec[DTU_COEF] = (int32_t)o->dtu_coef_n;
    rec[DTU_DEPQ] = r->ep->dep_quant;
    memcpy(o->dtu_coef + o->dtu_coef_n, r->coef_buf + t[TU_F_COEF],
           (size_t)n * sizeof(int32_t));
    o->dtu_n++;
    o->dtu_coef_n += n;
    return 1;
}

/* decode-order availability extents (fill_side_refs parity, sample units) */
static void ir_avail(const Rc *r, int x0, int y0, int l2w, int l2h,
                     int is_luma, int *corner, int *above, int *left,
                     int *nava, int *navl)
{
    avail_fn_t av = is_luma ? luma_avail : chroma_avail;
    int unit = is_luma ? 4 : 2;
    int w = 1 << l2w, h = 1 << l2h;
    *corner = av(r, x0 - 1, y0 - 1);
    *above = av(r, x0, y0 - 1);
    *left = av(r, x0 - 1, y0);
    *nava = *navl = 0;
    if (*above) {
        int nb = (2 * w + unit - 1) / unit, nav = 0;
        while (nav < nb && av(r, x0 + nav * unit, y0 - 1))
            nav++;
        *nava = nav * unit;
    }
    if (*left) {
        int nb = (2 * h + unit - 1) / unit, nav = 0;
        while (nav < nb && av(r, x0 - 1, y0 + nav * unit))
            nav++;
        *navl = nav * unit;
    }
}

/* wave level = 1 + max level over the referenced neighbour units */
static int ir_level(const Rc *r, const uint16_t *lvl, int lw, int lh,
                    int x0, int y0, int nava, int navl, int is_luma)
{
    const EntryParams *e = r->ep;
    int sh = is_luma ? 2 : 1;
    int tx0 = is_luma ? e->tile_x0 : (e->tile_x0 >> 1);
    int ty0 = is_luma ? e->tile_y0 : (e->tile_y0 >> 1);
    int best = 0;
    int uy = (y0 - 1 - ty0) >> sh;
    if (uy >= 0 && uy < lh) { /* above row incl. corner */
        int ux_lo = (x0 - 1 - tx0) >> sh;
        int ux_hi = (x0 + nava - tx0) >> sh;
        if (ux_lo < 0) ux_lo = 0;
        if (ux_hi >= lw) ux_hi = lw - 1;
        const uint16_t *row = lvl + (int64_t)uy * lw;
        for (int ux = ux_lo; ux <= ux_hi; ux++)
            if (row[ux] > best) best = row[ux];
    }
    int ux = (x0 - 1 - tx0) >> sh;
    if (ux >= 0 && ux < lw) { /* left column */
        int uy_lo = (y0 - 1 - ty0) >> sh;
        int uy_hi = (y0 + navl - ty0) >> sh;
        if (uy_lo < 0) uy_lo = 0;
        if (uy_hi >= lh) uy_hi = lh - 1;
        for (int vy = uy_lo; vy <= uy_hi; vy++) {
            int v = lvl[(int64_t)vy * lw + ux];
            if (v > best) best = v;
        }
    }
    return best + 1;
}

static void ir_set_level(const Rc *r, uint16_t *lvl, int lw, int lh,
                         int x0, int y0, int l2w, int l2h, int is_luma,
                         int level)
{
    const EntryParams *e = r->ep;
    int sh = is_luma ? 2 : 1;
    int tx0 = is_luma ? e->tile_x0 : (e->tile_x0 >> 1);
    int ty0 = is_luma ? e->tile_y0 : (e->tile_y0 >> 1);
    int ux = (x0 - tx0) >> sh, uy = (y0 - ty0) >> sh;
    int nw = imax(1, (1 << l2w) >> sh), nh = imax(1, (1 << l2h) >> sh);
    for (int j = 0; j < nh && uy + j < lh; j++) {
        uint16_t *row = lvl + (int64_t)(uy + j) * lw + ux;
        for (int k = 0; k < imin(nw, lw - ux); k++)
            row[k] = (uint16_t)level;
    }
}

static int ir_emit_job_kind(IrOut *o, int is_luma, int x0, int y0, int l2w,
                            int l2h, int mode, int level, int corner,
                            int above, int left, int nava, int navl,
                            int kind, int aux0, int aux1)
{
    int w = 1 << l2w, h = 1 << l2h;
    for (int oy = 0; oy < h; oy += IR_TILE)
        for (int ox = 0; ox < w; ox += IR_TILE) {
            int32_t *j;
            if (is_luma) {
                if (o->njl >= o->cap_l)
                    return -1;
                j = o->jobs_l + (o->njl++) * J_NFIELDS;
            } else {
                if (o->njc >= o->cap_c)
                    return -1;
                j = o->jobs_c + (o->njc++) * J_NFIELDS;
            }
            j[J_X0] = x0; j[J_Y0] = y0; j[J_L2W] = l2w; j[J_L2H] = l2h;
            j[J_OX] = ox; j[J_OY] = oy; j[J_MODE] = mode;
            j[J_CORNER] = corner; j[J_ABOVE] = above; j[J_LEFT] = left;
            j[J_NAVA] = nava; j[J_NAVL] = navl; j[J_LEVEL] = level;
            j[J_KIND] = kind; j[J_AUX0] = aux0; j[J_AUX1] = aux1;
        }
    return 0;
}

static int ir_emit_job(IrOut *o, int is_luma, int x0, int y0, int l2w,
                       int l2h, int mode, int level, int corner, int above,
                       int left, int nava, int navl)
{
    return ir_emit_job_kind(o, is_luma, x0, y0, l2w, l2h, mode, level,
                            corner, above, left, nava, navl,
                            JOB_KIND_INTRA, 0, 0);
}

static int ir_intra_cu(const Rc *r, IrOut *o, const int32_t *cu)
{
    const EntryParams *e = r->ep;
    int x0 = cu[CU_F_X0], y0 = cu[CU_F_Y0];
    int l2w = cu[CU_F_LOG2W], l2h = cu[CU_F_LOG2H];
    int32_t res[64 * 64];
    TuUnit units[16];

    int nu = tu_units(x0, y0, l2w, l2h, e->l_max_tb, units, 0);
    for (int u = 0; u < nu; u++) {
        TuUnit *tu = &units[u];
        int corner, above, left, nava, navl;
        ir_avail(r, tu->x, tu->y, tu->l2w, tu->l2h, 1, &corner, &above,
                 &left, &nava, &navl);
        int lvl = ir_level(r, o->lvl_l, r->al_w, r->al_h, tu->x, tu->y,
                           above ? nava : 0, left ? navl : 0, 1);
        if (lvl > o->max_lvl_l) o->max_lvl_l = lvl;
        int erc;
        if (cu[CU_F_MIP_FLAG])
            /* MIP predicts the whole CU (<= 32x32, scan-gated): one job,
             * mode 0 placeholder, aux = (mip_mode, transpose) */
            erc = ir_emit_job_kind(o, 1, tu->x, tu->y, tu->l2w, tu->l2h,
                                   0, lvl, corner, above, left, nava, navl,
                                   JOB_KIND_MIP, cu[CU_F_MIP_MODE],
                                   cu[CU_F_MIP_T]);
        else
            erc = ir_emit_job(o, 1, tu->x, tu->y, tu->l2w, tu->l2h,
                              cu[CU_F_INTRA_L], lvl, corner, above, left,
                              nava, navl);
        if (erc < 0)
            return -1;
        const int32_t *t = find_tu_c(r, cu, 0, tu->x, tu->y);
        if (t && !ir_emit_dtu(r, o, t, cu, 1)) {
            recon_tu_residual_c(r, t, cu, 1, res);
            ir_write_res(o->res_y, o->ry_stride, res, tu->x, tu->y,
                         1 << tu->l2w, 1 << tu->l2h);
        }
        ir_set_level(r, o->lvl_l, r->al_w, r->al_h, tu->x, tu->y, tu->l2w,
                     tu->l2h, 1, lvl);
        mark_luma((Rc *)r, tu->x, tu->y, tu->l2w, tu->l2h);
    }

    if (!e->chroma_enabled)
        return 0;

    int cx0 = x0 >> 1, cy0 = y0 >> 1;
    int mode = cu[CU_F_INTRA_C];
    int csign = r->rp->csign;
    int32_t rc2[32 * 32];

    nu = tu_units(cx0, cy0, l2w - 1, l2h - 1, e->l_max_tb - 1, units, 0);
    for (int u = 0; u < nu; u++) {
        TuUnit *tu = &units[u];
        int w = 1 << tu->l2w, h = 1 << tu->l2h;
        int corner, above, left, nava, navl;
        ir_avail(r, tu->x, tu->y, tu->l2w, tu->l2h, 0, &corner, &above,
                 &left, &nava, &navl);
        int lvl = ir_level(r, o->lvl_c, r->ac_w, r->ac_h, tu->x, tu->y,
                           above ? nava : 0, left ? navl : 0, 0);
        if (lvl > o->max_lvl_c) o->max_lvl_c = lvl;
        int erc2;
        if (mode >= INTRA_LT_CCLM && mode <= INTRA_T_CCLM) {
            /* chroma-from-luma: aux0 = mode, aux1 = probed available run
             * for the T/L variants (decode-order chroma availability) */
            int nav = 0;
            int pw = 1 << tu->l2w, ph_ = 1 << tu->l2h;
            if (mode == INTRA_T_CCLM) {
                int nb_ref = (pw + imin(pw, ph_)) >> 1;
                while (nav < nb_ref
                       && chroma_avail(r, tu->x + 2 * nav, tu->y - 1))
                    nav++;
            } else if (mode == INTRA_L_CCLM) {
                int nb_ref = (ph_ + imin(pw, ph_)) >> 1;
                while (nav < nb_ref
                       && chroma_avail(r, tu->x - 1, tu->y + 2 * nav))
                    nav++;
            }
            erc2 = ir_emit_job_kind(o, 0, tu->x, tu->y, tu->l2w, tu->l2h,
                                    0, lvl, corner, above, left, nava,
                                    navl, JOB_KIND_CCLM, mode, nav);
        } else {
            erc2 = ir_emit_job(o, 0, tu->x, tu->y, tu->l2w, tu->l2h, mode,
                               lvl, corner, above, left, nava, navl);
        }
        if (erc2 < 0)
            return -1;
        const int32_t *jt = find_tu_c(r, cu, 3, tu->x, tu->y);
        if (jt) {
            if (!ir_emit_dtu(r, o, jt, cu, 1)) {
                recon_tu_residual_c(r, jt, cu, 1, res);
                int jc = jt[TU_F_JCBCR];
                for (int i = 0; i < w * h; i++) {
                    int v = res[i];
                    if (jc == 3) rc2[i] = csign * v;
                    else rc2[i] = (csign * v) >> 1;
                }
                if (jc >= 2) {
                    ir_write_res(o->res_cb, o->rc_stride, res, tu->x, tu->y,
                                 w, h);
                    ir_write_res(o->res_cr, o->rc_stride, rc2, tu->x, tu->y,
                                 w, h);
                } else {
                    ir_write_res(o->res_cr, o->rc_stride, res, tu->x, tu->y,
                                 w, h);
                    ir_write_res(o->res_cb, o->rc_stride, rc2, tu->x, tu->y,
                                 w, h);
                }
            }
        } else {
            const int32_t *tb = find_tu_c(r, cu, 1, tu->x, tu->y);
            const int32_t *tr = find_tu_c(r, cu, 2, tu->x, tu->y);
            if (tb && !ir_emit_dtu(r, o, tb, cu, 1)) {
                recon_tu_residual_c(r, tb, cu, 1, res);
                ir_write_res(o->res_cb, o->rc_stride, res, tu->x, tu->y, w, h);
            }
            if (tr && !ir_emit_dtu(r, o, tr, cu, 1)) {
                recon_tu_residual_c(r, tr, cu, 1, res);
                ir_write_res(o->res_cr, o->rc_stride, res, tu->x, tu->y, w, h);
            }
        }
        ir_set_level(r, o->lvl_c, r->ac_w, r->ac_h, tu->x, tu->y, tu->l2w,
                     tu->l2h, 0, lvl);
        mark_chroma((Rc *)r, tu->x, tu->y, tu->l2w, tu->l2h);
    }
    return 0;
}

static const int8_t IR_BCW_W1[5] = {-2, 3, 4, 5, 10};

static int ir_inter_cu(const Rc *r, IrOut *o, const int32_t *cu)
{
    const EntryParams *e = r->ep;
    int x0 = cu[CU_F_X0], y0 = cu[CU_F_Y0];
    int l2w = cu[CU_F_LOG2W], l2h = cu[CU_F_LOG2H];
    int w = 1 << l2w, h = 1 << l2h;
    int gpm = cu[CU_F_GPM_DIRS];
    int dir = cu[CU_F_MV1REF] >= 0 ? cu[CU_F_INTER_DIR] : 1;
    int hpel = cu[CU_F_PREC_EFF] == PREC_HALF;
    int lst0 = 0, lst1 = 1;

    int m0x = 0, m0y = 0, m1x = 0, m1y = 0;
    int w0 = 8, w1 = 0;
    int ref0, ref1;
    if (gpm) {
        /* both partitions behave like a bi unit whose two MC slots
         * resolve through the partition lists; per-sample blend weights
         * ride the gwp plane (decoder._reconstruct_gpm order: blend then
         * residual — same as the normal combine-then-residual flow) */
        dir = 3;
        lst0 = ((gpm - 1) & 1);
        lst1 = ((gpm - 1) >> 1);
        clip_mv_c(x0, y0, e->pic_w, e->pic_h, w, h, cu[CU_F_MV0X],
                  cu[CU_F_MV0Y], &m0x, &m0y);
        clip_mv_c(x0, y0, e->pic_w, e->pic_h, w, h, cu[CU_F_MV1X],
                  cu[CU_F_MV1Y], &m1x, &m1y);
        w0 = 4; w1 = 4; /* unused: gwp carries the per-sample weights */
        hpel = 0;
        ref0 = cu[CU_F_MV0REF];
        ref1 = cu[CU_F_MV1REF];
        o->has_gpm = 1;
    } else {
        if (dir & 1)
            clip_mv_c(x0, y0, e->pic_w, e->pic_h, w, h, cu[CU_F_MV0X],
                      cu[CU_F_MV0Y], &m0x, &m0y);
        if (dir & 2)
            clip_mv_c(x0, y0, e->pic_w, e->pic_h, w, h, cu[CU_F_MV1X],
                      cu[CU_F_MV1Y], &m1x, &m1y);

        if (dir == 2) { w0 = 0; w1 = 8; }
        else if (dir == 3) {
            int bcw = cu[CU_F_MV0BCW];
            w1 = (bcw == 0 || bcw == 3) ? 4 : IR_BCW_W1[bcw - 1];
            w0 = 8 - w1;
        }
        ref0 = (dir & 1) ? cu[CU_F_MV0REF] : -1;
        ref1 = (dir & 2) ? cu[CU_F_MV1REF] : -1;
    }

    /* CIIP: the wave job blends the planar intra prediction into the MC
     * result BEFORE the residual add, so the MC stage must not add the
     * residual at these units (GMASK_DEFER_*); chroma blends only when
     * the chroma block is >= 4 wide (decoder.py :1044) */
    int ciip_wt = cu[CU_F_CIIP_WT];
    uint8_t gval = GMASK_MC;
    if (ciip_wt) {
        gval |= GMASK_DEFER_L;
        if (l2w > 2)
            gval |= GMASK_DEFER_C;
    }

    int ux0 = x0 >> 2, uy0 = y0 >> 2;
    int nuw = w >> 2, nuh = h >> 2;
    for (int j = 0; j < nuh; j++) {
        int64_t row = (int64_t)(uy0 + j) * o->g_stride;
        for (int k = 0; k < nuw; k++) {
            int64_t u = row + ux0 + k;
            o->gmask[u] = gval;
            int32_t *mv = o->gmv + u * 4;
            mv[0] = m0x; mv[1] = m0y; mv[2] = m1x; mv[3] = m1y;
            o->gref[u * 2] = (int8_t)ref0;
            o->gref[u * 2 + 1] = (int8_t)ref1;
            o->gw[u * 2] = (int8_t)w0;
            o->gw[u * 2 + 1] = (int8_t)w1;
            o->glist[u * 2] = (int8_t)lst0;
            o->glist[u * 2 + 1] = (int8_t)lst1;
            o->ghpel[u] = (uint8_t)hpel;
        }
    }
    /* per-sample weight plane: broadcast w0 (uni/bi/BCW) or the GPM ramp */
    {
        int64_t ws = (int64_t)o->g_stride * 4;
        int sd = cu[CU_F_GPM_SPLIT];
        for (int j = 0; j < h; j++) {
            int8_t *wr = o->gwp + ((int64_t)(y0 + j)) * ws + x0;
            if (gpm)
                for (int i = 0; i < w; i++)
                    wr[i] = (int8_t)gpm_weight_at(sd, l2w, l2h, i, j);
            else
                for (int i = 0; i < w; i++)
                    wr[i] = (int8_t)w0;
        }
    }

    if (ciip_wt) {
        /* one planar-blend wave job over the whole CU (subtiled by the
         * emitter); availability/level captured in decode order exactly
         * like intra jobs */
        int corner, above, left, nava, navl;
        ir_avail(r, x0, y0, l2w, l2h, 1, &corner, &above, &left, &nava,
                 &navl);
        int lvl = ir_level(r, o->lvl_l, r->al_w, r->al_h, x0, y0,
                           above ? nava : 0, left ? navl : 0, 1);
        if (lvl > o->max_lvl_l) o->max_lvl_l = lvl;
        if (ir_emit_job_kind(o, 1, x0, y0, l2w, l2h, INTRA_PLANAR, lvl,
                             corner, above, left, nava, navl,
                             JOB_KIND_CIIP, ciip_wt, 0) < 0)
            return -1;
        ir_set_level(r, o->lvl_l, r->al_w, r->al_h, x0, y0, l2w, l2h, 1,
                     lvl);
        if (e->chroma_enabled && l2w > 2) {
            int cx0 = x0 >> 1, cy0 = y0 >> 1;
            ir_avail(r, cx0, cy0, l2w - 1, l2h - 1, 0, &corner, &above,
                     &left, &nava, &navl);
            int clvl = ir_level(r, o->lvl_c, r->ac_w, r->ac_h, cx0, cy0,
                                above ? nava : 0, left ? navl : 0, 0);
            if (clvl > o->max_lvl_c) o->max_lvl_c = clvl;
            if (ir_emit_job_kind(o, 0, cx0, cy0, l2w - 1, l2h - 1,
                                 INTRA_PLANAR, clvl, corner, above, left,
                                 nava, navl, JOB_KIND_CIIP, ciip_wt, 0) < 0)
                return -1;
            ir_set_level(r, o->lvl_c, r->ac_w, r->ac_h, cx0, cy0, l2w - 1,
                         l2h - 1, 0, clvl);
        }
    }

    /* residuals */
    int32_t res[64 * 64], rc2[32 * 32];
    int tu0 = cu[CU_F_TU0], ntu = cu[CU_F_NTU];
    int csign = r->rp->csign;
    for (int i = 0; i < ntu; i++) {
        const int32_t *t = r->tu_buf + (int64_t)(tu0 + i) * TU_NFIELDS;
        int comp = t[TU_F_COMP];
        int tw = 1 << t[TU_F_LOG2W], th = 1 << t[TU_F_LOG2H];
        if (ir_emit_dtu(r, o, t, cu, 0))
            continue;
        recon_tu_residual_c(r, t, cu, 0, res);
        if (comp == 0) {
            ir_write_res(o->res_y, o->ry_stride, res, t[TU_F_X0], t[TU_F_Y0],
                         tw, th);
        } else if (comp == 3) {
            int jc = t[TU_F_JCBCR];
            for (int k = 0; k < tw * th; k++) {
                int v = res[k];
                rc2[k] = jc == 3 ? csign * v : (csign * v) >> 1;
            }
            if (jc >= 2) {
                ir_write_res(o->res_cb, o->rc_stride, res, t[TU_F_X0],
                             t[TU_F_Y0], tw, th);
                ir_write_res(o->res_cr, o->rc_stride, rc2, t[TU_F_X0],
                             t[TU_F_Y0], tw, th);
            } else {
                ir_write_res(o->res_cr, o->rc_stride, res, t[TU_F_X0],
                             t[TU_F_Y0], tw, th);
                ir_write_res(o->res_cb, o->rc_stride, rc2, t[TU_F_X0],
                             t[TU_F_Y0], tw, th);
            }
        } else {
            ir_write_res(comp == 1 ? o->res_cb : o->res_cr, o->rc_stride,
                         res, t[TU_F_X0], t[TU_F_Y0], tw, th);
        }
    }
    mark_luma((Rc *)r, x0, y0, l2w, l2h);
    if (e->chroma_enabled)
        mark_chroma((Rc *)r, x0 >> 1, y0 >> 1, l2w - 1, l2h - 1);
    return 0;
}

int64_t ov_build_ir(const EntryParams *ep, const ReconParams *rp,
                    const int32_t *cu_buf, int64_t ncu,
                    const int32_t *tu_buf, int64_t ntu,
                    const int32_t *coef_buf, const int8_t *cqp_tab,
                    int16_t *res_y, int16_t *res_cb, int16_t *res_cr,
                    int32_t ry_stride, int32_t rc_stride,
                    uint8_t *gmask, int32_t *gmv, int8_t *gref, int8_t *gw,
                    uint8_t *ghpel, int8_t *glist, int8_t *gwp,
                    int32_t g_stride,
                    int32_t *jobs_l, int64_t cap_l,
                    int32_t *jobs_c, int64_t cap_c,
                    const int32_t *dist0, const int32_t *dist1,
                    const DbfBufs *dbf,
                    int32_t *dtu, int64_t dtu_cap,
                    int32_t *dtu_coef, int64_t dtu_coef_cap,
                    int64_t *out_counts)
{
    /* support scan: same set as ov_recon_entry except BCW bi weights,
     * which the device weighted-combine handles exactly */
    for (int64_t i = 0; i < ncu; i++) {
        const int32_t *c = cu_buf + i * CU_NFIELDS;
        if (c[CU_F_MIP_FLAG] && (c[CU_F_LOG2W] > 5 || c[CU_F_LOG2H] > 5 ||
                                 c[CU_F_LOG2W] > ep->l_max_tb ||
                                 c[CU_F_LOG2H] > ep->l_max_tb))
            return -1; /* MIP beyond one wave tile / TU split */
        if (c[CU_F_TREE] != TREE_SINGLE || c[CU_F_MRL] ||
            c[CU_F_PRED] > MODE_INTER)
            return -1;
        if (c[CU_F_SB_FLAG])
            return -1; /* affine/SbTMVP: host C recon lane handles it */
        if (c[CU_F_BDPCM])
            return -1; /* BDPCM pure-copy intra: host C recon lane */
        if ((ep->bdof_on || ep->dmvr_on) && c[CU_F_PRED] == MODE_INTER
            && !c[CU_F_CIIP_WT] && !c[CU_F_GPM_DIRS]
            && c[CU_F_MV1REF] >= 0 && c[CU_F_INTER_DIR] == 3) {
            int l2w = c[CU_F_LOG2W], l2h = c[CU_F_LOG2H];
            int size_ok = l2w >= 3 && l2h >= 3 && l2w + l2h >= 7;
            int bcw_w = c[CU_F_MV0BCW] != 0 && c[CU_F_MV0BCW] != 3;
            int dist_sym = c[CU_F_MV0REF] < 16 && c[CU_F_MV1REF] < 16
                           && dist0[c[CU_F_MV0REF]]
                              == -dist1[c[CU_F_MV1REF]];
            if (size_ok && !bcw_w && dist_sym) {
                int bd_en = ep->bdof_on && !c[CU_F_SMVD];
                int dm_en = ep->dmvr_on && c[CU_F_MERGE_FLAG]
                            && !c[CU_F_MMVD];
                if (bd_en || dm_en)
                    return -1; /* BDOF/DMVR: host C recon lane */
            }
        }
        if (c[CU_F_PRED] == MODE_INTER && c[CU_F_GPM_DIRS]) {
            int gpm = c[CU_F_GPM_DIRS];
            int n0 = (1 + ((gpm - 1) & 1)) == 1 ? rp->nb_refs : rp->nb_refs1;
            int n1 = (1 + ((gpm - 1) >> 1)) == 1 ? rp->nb_refs : rp->nb_refs1;
            if (c[CU_F_MV0REF] < 0 || c[CU_F_MV0REF] >= n0 ||
                c[CU_F_MV1REF] < 0 || c[CU_F_MV1REF] >= n1)
                return -1;
        } else if (c[CU_F_PRED] == MODE_INTER) {
            int dir = c[CU_F_MV1REF] >= 0 ? c[CU_F_INTER_DIR] : 1;
            if ((dir & 1) &&
                (c[CU_F_MV0REF] < 0 || c[CU_F_MV0REF] >= rp->nb_refs))
                return -1;
            if ((dir & 2) &&
                (c[CU_F_MV1REF] < 0 || c[CU_F_MV1REF] >= rp->nb_refs1))
                return -1;
        }
    }
    for (int64_t i = 0; i < ntu; i++) {
        const int32_t *t = tu_buf + i * TU_NFIELDS;
        if (t[TU_F_BDPCM] || t[TU_F_COEF] < 0)
            return -1;
    }

    Rc rc;
    memset(&rc, 0, sizeof(rc));
    rc.ep = ep;
    rc.rp = rp;
    rc.tu_buf = tu_buf;
    rc.coef_buf = coef_buf;
    rc.cqp_tab = cqp_tab;
    rc.dist0 = dist0;
    rc.dist1 = dist1;
    rc.dbf = dbf;
    rc.uw = (ep->pic_w + 3) >> 2;
    rc.uh = (ep->pic_h + 3) >> 2;
    rc.bd_max = (1 << ep->bitdepth) - 1;
    rc.al_w = (ep->tile_w + 3) / 4;
    rc.al_h = (ep->tile_h + 3) / 4;
    rc.ac_w = (ep->tile_w / 2 + 1) / 2 + 1;
    rc.ac_h = (ep->tile_h / 2 + 1) / 2 + 1;
    rc.avail_l = calloc((size_t)rc.al_w * rc.al_h, 1);
    rc.avail_c = calloc((size_t)rc.ac_w * rc.ac_h, 1);

    IrOut o;
    memset(&o, 0, sizeof(o));
    o.res_y = res_y; o.res_cb = res_cb; o.res_cr = res_cr;
    o.ry_stride = ry_stride; o.rc_stride = rc_stride;
    o.gmask = gmask; o.gmv = gmv; o.gref = gref; o.gw = gw;
    o.ghpel = ghpel; o.glist = glist; o.gwp = gwp; o.g_stride = g_stride;
    o.jobs_l = jobs_l; o.jobs_c = jobs_c;
    o.cap_l = cap_l; o.cap_c = cap_c;
    o.dtu = dtu; o.dtu_cap = dtu_cap;
    o.dtu_coef = dtu_coef; o.dtu_coef_cap = dtu_coef_cap;
    o.lvl_l = calloc((size_t)rc.al_w * rc.al_h, 2);
    o.lvl_c = calloc((size_t)rc.ac_w * rc.ac_h, 2);
    if (!rc.avail_l || !rc.avail_c || !o.lvl_l || !o.lvl_c) {
        free(rc.avail_l); free(rc.avail_c);
        free(o.lvl_l); free(o.lvl_c);
        return -2;
    }

    int dbf_on = rp->dbf_enabled && dbf;
    int64_t rcode = 0;
    for (int64_t i = 0; i < ncu && rcode == 0; i++) {
        const int32_t *c = cu_buf + i * CU_NFIELDS;
        int64_t pt0 = prof_now();
        if (dbf_on)
            fill_dbf_cu(&rc, c);
        prof_add(PROF_DBFMAP, pt0);
        if (c[CU_F_PRED] == MODE_INTRA)
            rcode = ir_intra_cu(&rc, &o, c);
        else
            rcode = ir_inter_cu(&rc, &o, c);
    }

    out_counts[0] = o.njl;
    out_counts[1] = o.njc;
    out_counts[2] = o.max_lvl_l;
    out_counts[3] = o.max_lvl_c;
    out_counts[4] = o.has_gpm;
    out_counts[5] = o.dtu_n;
    out_counts[6] = o.dtu_coef_n;
    free(rc.avail_l); free(rc.avail_c);
    free(o.lvl_l); free(o.lvl_c);
    return rcode;
}
