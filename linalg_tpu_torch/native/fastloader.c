/* fastloader.c — native data-path kernels for the host-side runtime.
 *
 * The device owns the math; the host side of the training loop (tokenizing a
 * corpus, gathering random batch windows) is plain memory movement, which
 * Python does slowly. These are the C equivalents, loaded via ctypes
 * (linalg_tpu_torch/native/loader.py) with a pure-Python fallback when no
 * compiler is available. This file is the PyTorch port's own copy of the
 * JAX package's source, so the port never imports that package.
 *
 * Capability notes: encode_ascii implements CharTokenizer.encode semantics
 * (lookup-table vocab, drop-unknown) for byte text; gather_windows
 * implements the reference's random-window batching (gpt.py:245-251).
 */

#include <stdint.h>
#include <stddef.h>

/* Map each byte of `text` through `lut` (256 entries, -1 = unknown).
 * drop_unknown != 0: skip unknowns; otherwise emit -1 sentinels.
 * Returns the number of ids written. */
int64_t encode_ascii(const unsigned char *text, int64_t n,
                     const int32_t *lut, int drop_unknown, int32_t *out) {
    int64_t w = 0;
    for (int64_t i = 0; i < n; i++) {
        int32_t id = lut[text[i]];
        if (id < 0) {
            if (drop_unknown) continue;
            out[w++] = -1;
        } else {
            out[w++] = id;
        }
    }
    return w;
}

/* Count vocabulary: set present[b] = 1 for every byte in text. */
void byte_histogram(const unsigned char *text, int64_t n, int64_t *counts) {
    for (int64_t i = 0; i < n; i++) counts[text[i]]++;
}

/* Gather B windows of length T (x) and their shift-by-one targets (y)
 * from ids[L], starting at starts[B]. Caller guarantees
 * starts[i] + T + 1 <= L. */
void gather_windows(const int32_t *ids, int64_t L, const int64_t *starts,
                    int64_t B, int64_t T, int32_t *x, int32_t *y) {
    (void)L;
    for (int64_t b = 0; b < B; b++) {
        const int32_t *src = ids + starts[b];
        int32_t *xb = x + b * T;
        int32_t *yb = y + b * T;
        for (int64_t t = 0; t < T; t++) {
            xb[t] = src[t];
            yb[t] = src[t + 1];
        }
    }
}

/* ---------------------------------------------------------------------------
 * Byte-level BPE (nn/tokenizers.py::BPETokenizer) — the two hot loops.
 *
 * Semantics mirror the Python exactly (tested against it):
 *  - train: each round counts adjacent pairs over the current id stream and
 *    merges the winner everywhere. Winner = max by (count, -first_element),
 *    remaining ties broken by FIRST APPEARANCE in the scan (Python's dict
 *    insertion order under max()).
 *  - encode: repeatedly merge every occurrence of the lowest-rank
 *    (earliest-learned) pair present, until none applies.
 * ------------------------------------------------------------------------- */

#include <stdlib.h>
#include <string.h>

typedef struct {
    int64_t key;   /* (a << 32) | b; -1 = empty */
    int64_t val;   /* entry index (train) or rank (encode) */
} pair_slot;

static inline uint64_t pair_hash(int64_t key) {
    uint64_t h = (uint64_t)key * 0x9E3779B97F4A7C15ull;
    return h ^ (h >> 29);
}

/* open addressing; cap is a power of two */
static inline int64_t slot_find(pair_slot *tab, int64_t cap, int64_t key) {
    uint64_t i = pair_hash(key) & (uint64_t)(cap - 1);
    while (tab[i].key != -1 && tab[i].key != key)
        i = (i + 1) & (uint64_t)(cap - 1);
    return (int64_t)i;
}

static int64_t merge_pair(int32_t *ids, int64_t m, int32_t a, int32_t b,
                          int32_t new_id) {
    int64_t w = 0, i = 0;
    while (i < m) {
        if (i + 1 < m && ids[i] == a && ids[i + 1] == b) {
            ids[w++] = new_id;
            i += 2;
        } else {
            ids[w++] = ids[i++];
        }
    }
    return w;
}

/* Learn up to vocab_size-256 merges from `text` (n bytes).
 * merges_out has room for 2*(vocab_size-256) int32s (a, b per merge).
 * Returns the number of merges learned, or -1 on allocation failure. */
int32_t bpe_train(const unsigned char *text, int64_t n, int32_t vocab_size,
                  int32_t *merges_out) {
    if (n <= 1 || vocab_size <= 256) return 0;
    int32_t *ids = (int32_t *)malloc((size_t)n * sizeof(int32_t));
    if (!ids) return -1;
    for (int64_t i = 0; i < n; i++) ids[i] = text[i];
    int64_t m = n;

    int64_t cap = 1;
    while (cap < 4 * n) cap <<= 1;   /* enough for <= n-1 distinct pairs */
    pair_slot *tab = (pair_slot *)malloc((size_t)cap * sizeof(pair_slot));
    int64_t *ekey = (int64_t *)malloc((size_t)n * sizeof(int64_t));
    int64_t *ecount = (int64_t *)malloc((size_t)n * sizeof(int64_t));
    if (!tab || !ekey || !ecount) {
        free(ids); free(tab); free(ekey); free(ecount);
        return -1;
    }

    int32_t n_merges = 0;
    int32_t next_id = 256;
    while (next_id < vocab_size && m > 1) {
        for (int64_t i = 0; i < cap; i++) tab[i].key = -1;
        int64_t n_entries = 0;
        for (int64_t i = 0; i + 1 < m; i++) {
            int64_t key = ((int64_t)ids[i] << 32) | (uint32_t)ids[i + 1];
            int64_t s = slot_find(tab, cap, key);
            if (tab[s].key == -1) {
                tab[s].key = key;
                tab[s].val = n_entries;
                ekey[n_entries] = key;
                ecount[n_entries] = 1;
                n_entries++;
            } else {
                ecount[tab[s].val]++;
            }
        }
        /* winner: max (count, -a), first-seen wins remaining ties */
        int64_t best = -1, best_count = 0;
        int32_t best_a = 0;
        for (int64_t e = 0; e < n_entries; e++) {
            int32_t a = (int32_t)(ekey[e] >> 32);
            if (best < 0 || ecount[e] > best_count ||
                (ecount[e] == best_count && a < best_a)) {
                best = e;
                best_count = ecount[e];
                best_a = a;
            }
        }
        if (best < 0 || best_count < 2) break;
        int32_t a = (int32_t)(ekey[best] >> 32);
        int32_t b = (int32_t)(ekey[best] & 0xffffffff);
        m = merge_pair(ids, m, a, b, next_id);
        merges_out[2 * n_merges] = a;
        merges_out[2 * n_merges + 1] = b;
        n_merges++;
        next_id++;
    }
    free(ids); free(tab); free(ekey); free(ecount);
    return n_merges;
}

/* Encode `text` (n bytes) with `n_merges` learned merges (a, b pairs in
 * rank order). `out` has room for n int32s. Returns the encoded length,
 * or -1 on allocation failure. */
int64_t bpe_encode(const unsigned char *text, int64_t n,
                   const int32_t *merges, int32_t n_merges, int32_t *out) {
    for (int64_t i = 0; i < n; i++) out[i] = text[i];
    int64_t m = n;
    if (m <= 1 || n_merges == 0) return m;

    int64_t cap = 1;
    while (cap < 4 * (int64_t)n_merges) cap <<= 1;
    pair_slot *tab = (pair_slot *)malloc((size_t)cap * sizeof(pair_slot));
    if (!tab) return -1;
    for (int64_t i = 0; i < cap; i++) tab[i].key = -1;
    for (int32_t r = 0; r < n_merges; r++) {
        int64_t key = ((int64_t)merges[2 * r] << 32)
                      | (uint32_t)merges[2 * r + 1];
        int64_t s = slot_find(tab, cap, key);
        /* duplicate pairs (a merge re-learned after its adjacency
         * reappears) take the LATER rank — dict-overwrite semantics of
         * the Python ranks map */
        tab[s].key = key;
        tab[s].val = 256 + r;
    }

    while (m > 1) {
        int64_t best_rank = -1, best_key = -1;
        for (int64_t i = 0; i + 1 < m; i++) {
            int64_t key = ((int64_t)out[i] << 32) | (uint32_t)out[i + 1];
            int64_t s = slot_find(tab, cap, key);
            if (tab[s].key == key &&
                (best_rank < 0 || tab[s].val < best_rank)) {
                best_rank = tab[s].val;
                best_key = key;
            }
        }
        if (best_rank < 0) break;
        m = merge_pair(out, m, (int32_t)(best_key >> 32),
                       (int32_t)(best_key & 0xffffffff),
                       (int32_t)best_rank);
    }
    free(tab);
    return m;
}
