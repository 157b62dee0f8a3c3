/* Bitstream parser of the PyTorch port's decoder and the host writer's bit
 * packer (host C, bound with ctypes by runtime/__init__.py).
 *
 * The bitstream's variable-length codes force a sequential parse; doing it
 * in Python costs minutes per 300-frame sequence, so the parse runs here and
 * hands fixed-shape symbol arrays to the batched inverse pipeline on the
 * device.  A copy of the JAX package's parser (icspcodec_tpu/runtime/
 * vlcparse.c, parse_frames and its helpers), with two changes:
 *
 *  - read_vlc rejects an exponent beyond 14.  The encoder's VLC domain is
 *    |v| < 2^15 (bitstream_device.vlc_encode_dev), so a longer prefix only
 *    comes from a corrupt or hostile stream; there `1 << exp` would be
 *    undefined from exp 31 on.  parse_frames returns -2 for such a code.
 *  - Every symbol therefore fits int16, and the outputs are narrow: int16
 *    coefficients and MV differences, int8 flags.  The values are the JAX
 *    parser's.
 *
 * pack_items, the packer behind the host writer (bitstream.py), is the JAX
 * package's unchanged.
 *
 * Syntax (reference intraBody/interBody, encoder source:4923-5236):
 *   intra MB: 4 x [ mpm(1) modebit(1) DC-VLC acflag(1) {63 zero bits | 63 AC-VLC} ]
 *             then Cb [DC acflag {...}] and Cr likewise
 *   inter MB: mvmode(1)=1, MVx-VLC, MVy-VLC, 4 x [DC acflag {...}], Cb, Cr
 * VLC: 13-category sign+offset code (DCentropy, encoder source:5417-5602).
 */
#include <stdint.h>
#include <stddef.h>

#define VLC_MAX_EXP 14   /* |v| < 2^15: the encoder's VLC domain */
#define ERR_TRUNCATED (-1)
#define ERR_BAD_CODE (-2)

typedef struct {
    const uint8_t *data;
    long nbits;
    long pos;
} BitReader;

static inline int get_bit(BitReader *br) {
    if (br->pos >= br->nbits) return -1;
    long p = br->pos++;
    return (br->data[p >> 3] >> (7 - (p & 7))) & 1;
}

static inline long read_vlc(BitReader *br, int16_t *out) {
    int b0 = get_bit(br);
    if (b0 < 0) return ERR_TRUNCATED;
    int exp, sign;
    if (b0 == 0) {
        int b1 = get_bit(br);
        if (b1 < 0) return ERR_TRUNCATED;
        if (b1 == 0) { *out = 0; return 0; }          /* 00 */
        int b2 = get_bit(br);
        if (b2 < 0) return ERR_TRUNCATED;
        if (b2 == 0) {                                 /* 010 s */
            sign = get_bit(br);
            if (sign < 0) return ERR_TRUNCATED;
            *out = sign ? 1 : -1;
            return 0;
        }
        exp = 1;                                       /* 011 */
    } else {
        int ones = 1, b;
        while ((b = get_bit(br)) == 1)
            if (++ones + 2 > VLC_MAX_EXP) return ERR_BAD_CODE;
        if (b < 0) return ERR_TRUNCATED;
        if (ones == 1) {                               /* 10x -> exp 2|3 */
            int b2 = get_bit(br);
            if (b2 < 0) return ERR_TRUNCATED;
            exp = 2 + b2;
        } else if (ones == 2) {                        /* 110 -> exp 4 */
            exp = 4;
        } else {                                       /* 1^(exp-2) 0 */
            exp = ones + 2;
        }
    }
    sign = get_bit(br);
    if (sign < 0) return ERR_TRUNCATED;
    int32_t payload = 0;
    for (int i = 0; i < exp; i++) {
        int b = get_bit(br);
        if (b < 0) return ERR_TRUNCATED;
        payload = (payload << 1) | b;
    }
    int32_t v = (1 << exp) + payload;                  /* < 2^15 */
    *out = (int16_t)(sign ? v : -v);
    return 0;
}

static long parse_coeff_block(BitReader *br, int16_t *scan, int8_t *acflag) {
    long err = read_vlc(br, &scan[0]);
    if (err < 0) return err;
    int f = get_bit(br);
    if (f < 0) return ERR_TRUNCATED;
    *acflag = (int8_t)f;
    if (f) {
        br->pos += 63;            /* 63 literal zero bits */
        if (br->pos > br->nbits) return ERR_TRUNCATED;
        for (int i = 1; i < 64; i++) scan[i] = 0;
    } else {
        for (int i = 1; i < 64; i++)
            if ((err = read_vlc(br, &scan[i])) < 0) return err;
    }
    return 0;
}

/* Returns bits consumed, ERR_TRUNCATED on truncation, or ERR_BAD_CODE on a
 * VLC outside the encoder's domain. */
long parse_frames(
    const uint8_t *data, long nbytes, int nframes, int mbh, int mbw, int period,
    int16_t *y_scan,    /* nframes * (2*mbh) * (2*mbw) * 64 */
    int8_t *y_acflag,   /* nframes * (2*mbh) * (2*mbw)      */
    int8_t *mpm,        /* idem                              */
    int8_t *mode_bit,   /* idem                              */
    int16_t *cb_scan,   /* nframes * mbh * mbw * 64          */
    int8_t *cb_acflag,  /* nframes * mbh * mbw               */
    int16_t *cr_scan,
    int8_t *cr_acflag,
    int16_t *mv_diff    /* nframes * mbh * mbw * 2           */
) {
    BitReader br = { data, nbytes * 8, 0 };
    int gw = 2 * mbw;
    long ystride = (long)(2 * mbh) * gw;
    long err;
    for (int n = 0; n < nframes; n++) {
        int is_intra = (period == 0) || (period >= 1 && n % period == 0);
        for (int mb = 0; mb < mbh * mbw; mb++) {
            int by = mb / mbw, bx = mb % mbw;
            if (!is_intra) {
                if (get_bit(&br) < 0) return ERR_TRUNCATED;   /* mv mode flag */
                int16_t *mv = mv_diff + ((long)n * mbh * mbw + mb) * 2;
                if ((err = read_vlc(&br, &mv[0])) < 0) return err;
                if ((err = read_vlc(&br, &mv[1])) < 0) return err;
            }
            for (int k = 0; k < 4; k++) {
                int gy = 2 * by + (k >> 1), gx = 2 * bx + (k & 1);
                long gidx = (long)n * ystride + (long)gy * gw + gx;
                if (is_intra) {
                    int f1 = get_bit(&br), f2 = get_bit(&br);
                    if (f1 < 0 || f2 < 0) return ERR_TRUNCATED;
                    mpm[gidx] = (int8_t)f1;
                    mode_bit[gidx] = (int8_t)f2;
                }
                if ((err = parse_coeff_block(&br, y_scan + gidx * 64, y_acflag + gidx)) < 0)
                    return err;
            }
            long cidx = (long)n * mbh * mbw + mb;
            if ((err = parse_coeff_block(&br, cb_scan + cidx * 64, cb_acflag + cidx)) < 0)
                return err;
            if ((err = parse_coeff_block(&br, cr_scan + cidx * 64, cr_acflag + cidx)) < 0)
                return err;
        }
    }
    return br.pos;
}

/* MSB-first bit packer: items are (code, length) pairs with right-aligned
 * code bits, each length at most 56.  Replicates the reference's tail
 * convention (makebitstream): the final partial byte keeps its bits in the
 * LOW positions and one extra zero byte is appended when the stream ends
 * byte-aligned.  Returns the number of bytes written into out (caller sizes
 * it as total_bits/8 + 1). */
long pack_items(const uint64_t *codes, const int64_t *lengths, long n,
                uint8_t *out) {
    uint64_t acc = 0;   /* bit accumulator, MSB-first in low `fill` bits */
    int fill = 0;
    long nbytes = 0;
    for (long i = 0; i < n; i++) {
        int len = (int)lengths[i];
        acc = (acc << len) | (codes[i] & ((len >= 64) ? ~0ULL : ((1ULL << len) - 1)));
        fill += len;
        while (fill >= 8) {
            out[nbytes++] = (uint8_t)(acc >> (fill - 8));
            fill -= 8;
        }
    }
    /* tail: remaining bits stay in the LOW positions of the last byte */
    out[nbytes++] = (uint8_t)(acc & ((fill >= 64) ? ~0ULL : ((1ULL << fill) - 1)));
    return nbytes;
}
