/* Native wire-format parser for serialized MiMC-STARK proofs.
 *
 * C equivalent of the reference verifier's Rust deserializer
 * (src/deserializer.rs:16-144) -- a single linear scan over the byte
 * stream.  Two entry points:
 *
 *   svt_scan(buf, len, meta)  -- validate + extract group metadata
 *   svt_fill(buf, len, ...)   -- copy values/siblings/witnesses into
 *                                caller-allocated struct-of-arrays buffers
 *
 * The Python side (native/__init__.py, proofio/ingest.py) drives both via
 * ctypes: scan sizes the buffers, fill populates them.  Branch groups may
 * be RAGGED (per-branch value size and witness depth, like the reference
 * reads at deserializer.rs:104-119): scan reports the group maxima, fill
 * copies each branch into the max-strided buffers and records per-branch
 * sizes (past a short branch the buffer keeps what it held: the caller
 * zeroes it, or the per-branch sizes say which words count).
 *
 * A third, svt_pass_many, parses blobs in one pass each into the slots of a
 * layout the caller keeps (see there).
 *
 * Error codes: 0 ok; 1 truncated; 2 bad tag; 3 bad size field; 6 too many
 * levels; 7 meta buffer too small; 8 off the layout and 9 trailing bytes
 * (svt_pass_many only).  (code 4 "ragged" is retired -- ragged
 * groups parse; code 5 "trailing bytes" is retired -- the reference returns
 * a consumed count and ignores trailing garbage, deserializer.rs:142 +
 * main.rs:204, so scan reports consumed in meta and the Python wrapper
 * decides.)
 */

#include <stdint.h>
#include <string.h>
#include <stddef.h>

#define SVT_MAX_LEVELS 64

typedef struct {
    const uint8_t *p;
    size_t off, len;
} rdr;

static int rd_bytes(rdr *r, size_t n, const uint8_t **out) {
    if (r->off + n > r->len) return 1;
    *out = r->p + r->off;
    r->off += n;
    return 0;
}

static int rd_u32(rdr *r, uint32_t *out) {
    const uint8_t *b;
    if (rd_bytes(r, 4, &b)) return 1;
    *out = (uint32_t)b[0] | ((uint32_t)b[1] << 8)
         | ((uint32_t)b[2] << 16) | ((uint32_t)b[3] << 24);
    return 0;
}

/* Walk one MultiProof.  Scan pass (values == NULL): report n and group
 * maxima.  Fill pass: copy data padded to the vmax/dmax strides, recording
 * per-branch vsizes/depths. */
static int walk_group(rdr *r, uint32_t *n_out, uint32_t *vmax_out,
                      uint32_t *dmax_out,
                      uint8_t *values, uint8_t *siblings, uint8_t *wits,
                      uint32_t vmax, uint32_t dmax,
                      uint32_t *vsizes, uint32_t *depths) {
    uint32_t n, vm = 0, dm = 0;
    if (rd_u32(r, &n)) return 1;
    if (n == 0 || n > (1u << 20)) return 3;
    for (uint32_t i = 0; i < n; i++) {
        uint32_t vsize, wsize;
        const uint8_t *v, *s, *w;
        if (rd_u32(r, &vsize)) return 1;
        if (vsize == 0 || vsize % 32 || vsize > (1u << 16)) return 3;
        if (vsize > vm) vm = vsize;
        if (rd_bytes(r, vsize, &v)) return 1;
        if (rd_bytes(r, vsize, &s)) return 1;
        if (rd_u32(r, &wsize)) return 1;
        if (wsize % 32) return 3;
        uint32_t depth = wsize / 32;
        if (depth > 64) return 3;
        if (depth > dm) dm = depth;
        if (rd_bytes(r, wsize, &w)) return 1;
        if (values) {
            memcpy(values + (size_t)i * vmax, v, vsize);
            memcpy(siblings + (size_t)i * vmax, s, vsize);
            memcpy(wits + (size_t)i * dmax * 32, w, (size_t)depth * 32);
            vsizes[i] = vsize;
            depths[i] = depth;
        }
    }
    *n_out = n; *vmax_out = vm; *dmax_out = dm;
    return 0;
}

/* meta layout (int64): [0]=n_levels, [1]=n_points,
 * then per level: col_n, col_vmax, col_dmax, poly_n, poly_vmax, poly_dmax
 * then: main_n, main_vmax, main_dmax, lin_n, lin_vmax, lin_dmax
 * then: consumed byte count (trailing bytes after it are tolerated).
 * meta_cap = capacity in int64 entries. */
int svt_scan(const uint8_t *buf, size_t len, int64_t *meta, size_t meta_cap) {
    rdr r = {buf, 0, len};
    const uint8_t *tmp;
    uint32_t g[3];
    if (meta_cap < 2) return 7;
    if (rd_bytes(&r, 64, &tmp)) return 1;   /* roots */
    int64_t n_levels = 0, n_points = 0;
    size_t mi = 2;
    for (;;) {
        uint32_t tag;
        if (rd_u32(&r, &tag)) return 1;
        if (tag == 1) {
            if (n_levels >= SVT_MAX_LEVELS) return 6;
            if (mi + 6 > meta_cap) return 7;
            if (rd_bytes(&r, 32, &tmp)) return 1;   /* root2 */
            for (int k = 0; k < 2; k++) {
                int rc = walk_group(&r, &g[0], &g[1], &g[2], 0, 0, 0, 0, 0, 0, 0);
                if (rc) return rc;
                meta[mi++] = g[0]; meta[mi++] = g[1]; meta[mi++] = g[2];
            }
            n_levels++;
        } else if (tag == 2) {
            uint32_t psize;
            if (rd_u32(&r, &psize)) return 1;
            if (psize == 0 || psize % 32) return 3;
            if (rd_bytes(&r, psize, &tmp)) return 1;
            n_points = psize / 32;
            break;
        } else {
            return 2;
        }
    }
    if (mi + 7 > meta_cap) return 7;
    for (int k = 0; k < 2; k++) {
        int rc = walk_group(&r, &g[0], &g[1], &g[2], 0, 0, 0, 0, 0, 0, 0);
        if (rc) return rc;
        meta[mi++] = g[0]; meta[mi++] = g[1]; meta[mi++] = g[2];
    }
    meta[mi] = (int64_t)r.off;    /* consumed; trailing bytes tolerated */
    meta[0] = n_levels;
    meta[1] = n_points;
    return 0;
}

/* Fill pass.  Caller passes per-level buffer pointer tables (arrays of
 * pointers, one per level) plus flat buffers for roots/points/main/lincomb,
 * the group strides from svt_scan's meta, and per-branch size buffers. */
int svt_fill(const uint8_t *buf, size_t len,
             uint8_t *merkle_root, uint8_t *l_merkle_root,
             uint8_t **root2, /* [n_levels][32] */
             uint8_t **col_values, uint8_t **col_siblings, uint8_t **col_wits,
             uint32_t **col_vsizes, uint32_t **col_depths,
             uint8_t **poly_values, uint8_t **poly_siblings, uint8_t **poly_wits,
             uint32_t **poly_vsizes, uint32_t **poly_depths,
             const int64_t *meta,
             uint8_t *points,
             uint8_t *main_values, uint8_t *main_siblings, uint8_t *main_wits,
             uint32_t *main_vsizes, uint32_t *main_depths,
             uint8_t *lin_values, uint8_t *lin_siblings, uint8_t *lin_wits,
             uint32_t *lin_vsizes, uint32_t *lin_depths) {
    rdr r = {buf, 0, len};
    const uint8_t *tmp;
    uint32_t g[3];
    if (rd_bytes(&r, 32, &tmp)) return 1;
    memcpy(merkle_root, tmp, 32);
    if (rd_bytes(&r, 32, &tmp)) return 1;
    memcpy(l_merkle_root, tmp, 32);
    int64_t lvl = 0;
    for (;;) {
        uint32_t tag;
        if (rd_u32(&r, &tag)) return 1;
        if (tag == 1) {
            if (lvl >= SVT_MAX_LEVELS) return 6;
            if (rd_bytes(&r, 32, &tmp)) return 1;
            memcpy(root2[lvl], tmp, 32);
            const int64_t *lm = meta + 2 + 6 * lvl;
            int rc = walk_group(&r, &g[0], &g[1], &g[2],
                                col_values[lvl], col_siblings[lvl], col_wits[lvl],
                                (uint32_t)lm[1], (uint32_t)lm[2],
                                col_vsizes[lvl], col_depths[lvl]);
            if (rc) return rc;
            rc = walk_group(&r, &g[0], &g[1], &g[2],
                            poly_values[lvl], poly_siblings[lvl], poly_wits[lvl],
                            (uint32_t)lm[3 + 1], (uint32_t)lm[3 + 2],
                            poly_vsizes[lvl], poly_depths[lvl]);
            if (rc) return rc;
            lvl++;
        } else if (tag == 2) {
            uint32_t psize;
            if (rd_u32(&r, &psize)) return 1;
            if (rd_bytes(&r, psize, &tmp)) return 1;
            memcpy(points, tmp, psize);
            break;
        } else {
            return 2;
        }
    }
    const int64_t *tm = meta + 2 + 6 * lvl;
    int rc = walk_group(&r, &g[0], &g[1], &g[2],
                        main_values, main_siblings, main_wits,
                        (uint32_t)tm[1], (uint32_t)tm[2],
                        main_vsizes, main_depths);
    if (rc) return rc;
    rc = walk_group(&r, &g[0], &g[1], &g[2],
                    lin_values, lin_siblings, lin_wits,
                    (uint32_t)tm[3 + 1], (uint32_t)tm[3 + 2],
                    lin_vsizes, lin_depths);
    if (rc) return rc;
    return 0;    /* trailing bytes tolerated (see svt_scan) */
}

/* Batched entry points: one call scans, fills or packs a whole range of
 * blobs, so that a caller driving them from threads releases its
 * interpreter lock once a range instead of twice a blob.
 *
 * svt_scan_many: rcs[j] = svt_scan(bufs[j], lens[j], metas + j * meta_cap).
 * svt_fill_many: for k < n, j = rows[k]: rcs[k] = svt_fill(bufs[j],
 *   lens[j], <the SVT_SLOT_ARGS pointers of table row j>), the row holding
 *   svt_fill's arguments after `len` in order (per-level tables as pointers
 *   to arrays of level pointers).
 * svt_pack_many: out row j (words_per_row words) = the first
 *   4 * words_per_row bytes of bufs[j], zero-padded past its end (the
 *   wire's little-endian words, on a little-endian host). */
#define SVT_SLOT_ARGS 25

int svt_scan_many(const uint8_t *const *bufs, const uint64_t *lens,
                  int64_t n, int64_t *metas, int64_t meta_cap, int32_t *rcs) {
    for (int64_t j = 0; j < n; j++)
        rcs[j] = svt_scan(bufs[j], (size_t)lens[j],
                          metas + (size_t)j * (size_t)meta_cap,
                          (size_t)meta_cap);
    return 0;
}

int svt_fill_many(const uint8_t *const *bufs, const uint64_t *lens,
                  const int64_t *rows, int64_t n, void *const *table,
                  int32_t *rcs) {
    for (int64_t k = 0; k < n; k++) {
        int64_t j = rows[k];
        void *const *a = table + (size_t)j * SVT_SLOT_ARGS;
        rcs[k] = svt_fill(bufs[j], (size_t)lens[j],
                          (uint8_t *)a[0], (uint8_t *)a[1], (uint8_t **)a[2],
                          (uint8_t **)a[3], (uint8_t **)a[4], (uint8_t **)a[5],
                          (uint32_t **)a[6], (uint32_t **)a[7],
                          (uint8_t **)a[8], (uint8_t **)a[9], (uint8_t **)a[10],
                          (uint32_t **)a[11], (uint32_t **)a[12],
                          (const int64_t *)a[13], (uint8_t *)a[14],
                          (uint8_t *)a[15], (uint8_t *)a[16], (uint8_t *)a[17],
                          (uint32_t *)a[18], (uint32_t *)a[19],
                          (uint8_t *)a[20], (uint8_t *)a[21], (uint8_t *)a[22],
                          (uint32_t *)a[23], (uint32_t *)a[24]);
    }
    return 0;
}

/* One pass on a kept layout.  pass_one walks a blob once, as svt_fill
 * does, into the slot of table row `a` (svt_fill's arguments, as
 * svt_fill_many reads them), and holds it to the layout's meta a[13] as it
 * goes: the level count, each group's branch count, each branch's value size
 * and depth (both before the branch's copy, so nothing lands past the slot's
 * strides), each group's maxima at its end, the point count, and under
 * `strict` the consumed count.  It returns 0 exactly where svt_scan would
 * return 0 with a meta whose prefix (all but the consumed count) equals the
 * layout's, and consumed == len under strict; the slot then holds what
 * svt_fill writes there.  Otherwise it stops at the first deviation, with
 * svt_scan's code for a malformed blob (1, 2, 3), 8 where the blob's shape
 * is not the layout's, 9 for trailing bytes under strict, and leaves the
 * slot part written. */
#define SVT_OFF_LAYOUT 8
#define SVT_TRAILING 9

/* One group against its layout meta gm = {n, vmax, dmax}. */
static int pass_group(rdr *r, const int64_t *gm,
                      uint8_t *values, uint8_t *siblings, uint8_t *wits,
                      uint32_t *vsizes, uint32_t *depths) {
    uint32_t n, vm = 0, dm = 0;
    uint32_t vmax = (uint32_t)gm[1], dmax = (uint32_t)gm[2];
    if (rd_u32(r, &n)) return 1;
    if (n == 0 || n > (1u << 20)) return 3;
    if ((int64_t)n != gm[0]) return SVT_OFF_LAYOUT;
    for (uint32_t i = 0; i < n; i++) {
        uint32_t vsize, wsize;
        const uint8_t *v, *s, *w;
        if (rd_u32(r, &vsize)) return 1;
        if (vsize == 0 || vsize % 32 || vsize > (1u << 16)) return 3;
        if (vsize > vmax) return SVT_OFF_LAYOUT;
        if (vsize > vm) vm = vsize;
        if (rd_bytes(r, vsize, &v)) return 1;
        if (rd_bytes(r, vsize, &s)) return 1;
        if (rd_u32(r, &wsize)) return 1;
        if (wsize % 32) return 3;
        uint32_t depth = wsize / 32;
        if (depth > 64) return 3;
        if (depth > dmax) return SVT_OFF_LAYOUT;
        if (depth > dm) dm = depth;
        if (rd_bytes(r, wsize, &w)) return 1;
        memcpy(values + (size_t)i * vmax, v, vsize);
        memcpy(siblings + (size_t)i * vmax, s, vsize);
        memcpy(wits + (size_t)i * dmax * 32, w, (size_t)depth * 32);
        vsizes[i] = vsize;
        depths[i] = depth;
    }
    if (vm != vmax || dm != dmax) return SVT_OFF_LAYOUT;
    return 0;
}

/* Level lvl's pointer from the per-level table a[k]. */
static void *lv(void *const *a, int k, int64_t lvl) {
    return ((void *const *)a[k])[lvl];
}

static int pass_one(const uint8_t *buf, size_t len, void *const *a,
                    int32_t strict) {
    rdr r = {buf, 0, len};
    const uint8_t *tmp;
    const int64_t *meta = (const int64_t *)a[13];
    int64_t n_levels = meta[0], lvl = 0;
    int rc;
    if (rd_bytes(&r, 32, &tmp)) return 1;
    memcpy(a[0], tmp, 32);
    if (rd_bytes(&r, 32, &tmp)) return 1;
    memcpy(a[1], tmp, 32);
    for (;;) {
        uint32_t tag;
        if (rd_u32(&r, &tag)) return 1;
        if (tag == 1) {
            if (lvl >= n_levels) return SVT_OFF_LAYOUT;
            if (rd_bytes(&r, 32, &tmp)) return 1;
            memcpy(lv(a, 2, lvl), tmp, 32);
            const int64_t *lm = meta + 2 + 6 * lvl;
            rc = pass_group(&r, lm, lv(a, 3, lvl), lv(a, 4, lvl),
                            lv(a, 5, lvl), lv(a, 6, lvl), lv(a, 7, lvl));
            if (rc) return rc;
            rc = pass_group(&r, lm + 3, lv(a, 8, lvl), lv(a, 9, lvl),
                            lv(a, 10, lvl), lv(a, 11, lvl), lv(a, 12, lvl));
            if (rc) return rc;
            lvl++;
        } else if (tag == 2) {
            uint32_t psize;
            if (lvl != n_levels) return SVT_OFF_LAYOUT;
            if (rd_u32(&r, &psize)) return 1;
            if (psize == 0 || psize % 32) return 3;
            if ((int64_t)psize != 32 * meta[1]) return SVT_OFF_LAYOUT;
            if (rd_bytes(&r, psize, &tmp)) return 1;
            memcpy(a[14], tmp, psize);
            break;
        } else {
            return 2;
        }
    }
    const int64_t *tm = meta + 2 + 6 * n_levels;
    rc = pass_group(&r, tm, a[15], a[16], a[17], a[18], a[19]);
    if (rc) return rc;
    rc = pass_group(&r, tm + 3, a[20], a[21], a[22], a[23], a[24]);
    if (rc) return rc;
    if (strict && r.off != len) return SVT_TRAILING;
    return 0;
}

/* svt_pass_many: rcs[j] = pass_one(bufs[j], lens[j], table row j, strict)
 * for j < n: blob j into slot j. */
int svt_pass_many(const uint8_t *const *bufs, const uint64_t *lens,
                  int64_t n, void *const *table, int32_t strict,
                  int32_t *rcs) {
    for (int64_t j = 0; j < n; j++)
        rcs[j] = pass_one(bufs[j], (size_t)lens[j],
                          table + (size_t)j * SVT_SLOT_ARGS, strict);
    return 0;
}

int svt_pack_many(const uint8_t *const *bufs, const uint64_t *lens,
                  int64_t n, uint8_t *out, int64_t words_per_row) {
    size_t row = (size_t)words_per_row * 4;
    for (int64_t j = 0; j < n; j++) {
        size_t take = lens[j] < row ? (size_t)lens[j] : row;
        uint8_t *dst = out + (size_t)j * row;
        memcpy(dst, bufs[j], take);
        memset(dst + take, 0, row - take);
    }
    return 0;
}
