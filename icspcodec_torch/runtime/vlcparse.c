/* Bitstream parser of the PyTorch port's decoder and the host writer's bit
 * packer (host C, bound with ctypes by runtime/__init__.py).
 *
 * The bitstream's variable-length codes force a sequential parse; doing it
 * in Python costs minutes per 300-frame sequence, so the parse runs here and
 * hands fixed-shape symbol arrays to the batched inverse pipeline on the
 * device.  A copy of the JAX package's parser (icspcodec_tpu/runtime/
 * vlcparse.c, parse_frames and its helpers), with three changes:
 *
 *  - read_vlc rejects an exponent beyond 14.  The encoder's VLC domain is
 *    |v| < 2^15 (bitstream_device.vlc_encode_dev), so a longer prefix only
 *    comes from a corrupt or hostile stream; there `1 << exp` would be
 *    undefined from exp 31 on.  parse_frames returns -2 for such a code.
 *  - Every symbol therefore fits int16, and the outputs are narrow: int16
 *    coefficients and MV differences, int8 flags.
 *  - The final byte is read the way the writer writes it (pack_items below:
 *    its last r bits kept LOW), where the JAX parser reads it MSB-first and
 *    so can misread the last bits of any stream whose final byte is not
 *    zero.
 *    The end is checked: parse_frames returns -1 when no reading of that
 *    byte ends the parse at the stream's end (a stream cut short, extended,
 *    or parsed for another frame count), and -3 when two readings do with
 *    different symbols, which the format cannot tell apart.  On every other
 *    stream the values are the JAX parser's reading of the stream with its
 *    final byte's bits moved to the high end.
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
#include <stdlib.h>
#include <string.h>

#define VLC_MAX_EXP 14   /* |v| < 2^15: the encoder's VLC domain */
#define ERR_TRUNCATED (-1)
#define ERR_BAD_CODE (-2)
#define ERR_AMBIGUOUS (-3)
#define ERR_NO_MEMORY (-4)

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

/* The outputs of parse_frames, and one macroblock's symbols set aside while
 * the stream's last macroblock is read under each reading of the tail. */
typedef struct {
    int16_t *y_scan; int8_t *y_acflag, *mpm, *mode_bit;
    int16_t *cb_scan; int8_t *cb_acflag;
    int16_t *cr_scan; int8_t *cr_acflag;
    int16_t *mv_diff;
} Out;

typedef struct {
    int16_t y_scan[4][64]; int8_t y_acflag[4], mpm[4], mode_bit[4];
    int16_t cb_scan[64], cr_scan[64]; int8_t cb_acflag, cr_acflag;
    int16_t mv[2];
} MbSymbols;

/* Parse the stream's macroblocks first .. last-1, counted over the frames in
 * order (macroblock mb of frame n is n*mbh*mbw + mb), into the outputs.
 * Returns 0, or the first error. */
static long parse_mbs(BitReader *br, const Out *o, long first, long last, int mbh, int mbw,
                      int period) {
    int16_t *y_scan = o->y_scan, *cb_scan = o->cb_scan, *cr_scan = o->cr_scan;
    int16_t *mv_diff = o->mv_diff;
    int8_t *y_acflag = o->y_acflag, *mpm = o->mpm, *mode_bit = o->mode_bit;
    int8_t *cb_acflag = o->cb_acflag, *cr_acflag = o->cr_acflag;
    int gw = 2 * mbw;
    long nmb = (long)mbh * mbw, ystride = (long)(2 * mbh) * gw;
    long err, i = first;
    for (int n = (int)(first / nmb); i < last; n++) {
        int is_intra = (period == 0) || (period >= 1 && n % period == 0);
        for (int mb = (int)(i % nmb); mb < nmb && i < last; mb++, i++) {
            int by = mb / mbw, bx = mb % mbw;
            if (!is_intra) {
                if (get_bit(br) < 0) return ERR_TRUNCATED;   /* mv mode flag */
                int16_t *mv = mv_diff + ((long)n * nmb + mb) * 2;
                if ((err = read_vlc(br, &mv[0])) < 0) return err;
                if ((err = read_vlc(br, &mv[1])) < 0) return err;
            }
            for (int k = 0; k < 4; k++) {
                int gy = 2 * by + (k >> 1), gx = 2 * bx + (k & 1);
                long gidx = (long)n * ystride + (long)gy * gw + gx;
                if (is_intra) {
                    int f1 = get_bit(br), f2 = get_bit(br);
                    if (f1 < 0 || f2 < 0) return ERR_TRUNCATED;
                    mpm[gidx] = (int8_t)f1;
                    mode_bit[gidx] = (int8_t)f2;
                }
                if ((err = parse_coeff_block(br, y_scan + gidx * 64, y_acflag + gidx)) < 0)
                    return err;
            }
            long cidx = (long)n * nmb + mb;
            if ((err = parse_coeff_block(br, cb_scan + cidx * 64, cb_acflag + cidx)) < 0)
                return err;
            if ((err = parse_coeff_block(br, cr_scan + cidx * 64, cr_acflag + cidx)) < 0)
                return err;
        }
    }
    return 0;
}

/* Copy macroblock mb of frame n between the outputs and s (to_out: s into
 * the outputs). */
static void mb_symbols(const Out *o, int n, int mb, int mbh, int mbw, MbSymbols *s,
                       int to_out) {
    int by = mb / mbw, bx = mb % mbw, gw = 2 * mbw;
    long cidx = (long)n * mbh * mbw + mb;
    for (int k = 0; k < 4; k++) {
        long g = (long)n * (2 * mbh) * gw + (long)(2 * by + (k >> 1)) * gw + 2 * bx + (k & 1);
        if (to_out) {
            memcpy(o->y_scan + g * 64, s->y_scan[k], sizeof s->y_scan[k]);
            o->y_acflag[g] = s->y_acflag[k];
            o->mpm[g] = s->mpm[k];
            o->mode_bit[g] = s->mode_bit[k];
        } else {
            memcpy(s->y_scan[k], o->y_scan + g * 64, sizeof s->y_scan[k]);
            s->y_acflag[k] = o->y_acflag[g];
            s->mpm[k] = o->mpm[g];
            s->mode_bit[k] = o->mode_bit[g];
        }
    }
    if (to_out) {
        memcpy(o->cb_scan + cidx * 64, s->cb_scan, sizeof s->cb_scan);
        memcpy(o->cr_scan + cidx * 64, s->cr_scan, sizeof s->cr_scan);
        o->cb_acflag[cidx] = s->cb_acflag;
        o->cr_acflag[cidx] = s->cr_acflag;
        memcpy(o->mv_diff + cidx * 2, s->mv, sizeof s->mv);
    } else {
        memcpy(s->cb_scan, o->cb_scan + cidx * 64, sizeof s->cb_scan);
        memcpy(s->cr_scan, o->cr_scan + cidx * 64, sizeof s->cr_scan);
        s->cb_acflag = o->cb_acflag[cidx];
        s->cr_acflag = o->cr_acflag[cidx];
        memcpy(s->mv, o->mv_diff + cidx * 2, sizeof s->mv);
    }
}

/* Parse nframes frames of a stream written by the reference's convention
 * (pack_items below): the final byte t keeps the stream's last r bits, r in
 * 0..7, in its LOW positions, and r = 0 is the zero byte the writer appends
 * to a byte-aligned stream.  The stream carries no r, so every r with
 * t < 2^r is a reading; a reading is accepted when the stream, t moved to
 * its high end ((t << (8 - r)) & 0xFF), parses to exactly 8*(nbytes-1) + r
 * bits.
 *
 * Every macroblock but the last lies before the final byte (a macroblock
 * takes at least 6 x 66 bits), so those are parsed once on the bytes as they
 * are, limited to 8*(nbytes-1) bits; only the last macroblock is parsed once
 * a reading, from its saved bit position.
 *
 * Returns the bits of the accepted reading; ERR_TRUNCATED when no reading
 * is accepted (the stream ends inside its last macroblock or runs on past
 * it); ERR_BAD_CODE on a VLC outside the encoder's domain before the last
 * macroblock; ERR_AMBIGUOUS when accepted readings give different symbols.
 * *readings gets the mask of accepted r (bit r). */
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
    int16_t *mv_diff,   /* nframes * mbh * mbw * 2           */
    int *readings
) {
    Out o = { y_scan, y_acflag, mpm, mode_bit, cb_scan, cb_acflag, cr_scan, cr_acflag,
              mv_diff };
    long nmb = (long)mbh * mbw;
    *readings = 0;
    if (nbytes < 1) return ERR_TRUNCATED;
    if (nframes < 1 || nmb < 1) {       /* nothing to read: the writer's zero byte */
        if (nbytes != 1 || data[0] != 0) return ERR_TRUNCATED;
        *readings = 1;
        return 0;
    }
    long last = (long)nframes * nmb - 1;      /* the last macroblock */
    BitReader br = { data, (nbytes - 1) * 8, 0 };
    long err = parse_mbs(&br, &o, 0, last, mbh, mbw, period);
    if (err < 0) return err;
    /* the last macroblock, on a copy of the bytes from its first one */
    int n = nframes - 1, mb = (int)(nmb - 1);
    long first = br.pos >> 3, len = nbytes - first;
    uint8_t *tail = (uint8_t *)malloc((size_t)len);
    if (!tail) return ERR_NO_MEMORY;
    memcpy(tail, data + first, (size_t)len);
    uint8_t t = data[nbytes - 1];
    MbSymbols got, other;
    memset(&got, 0, sizeof got);        /* memcmp below: no byte left unset */
    memset(&other, 0, sizeof other);
    long used = ERR_TRUNCATED;
    int ambiguous = 0;
    for (int r = 0; r < 8; r++) {
        if (t >> r) continue;                           /* t < 2^r */
        tail[len - 1] = (uint8_t)((t << (8 - r)) & 0xFF);
        BitReader tb = { tail, (len - 1) * 8 + r, br.pos & 7 };
        if (parse_mbs(&tb, &o, last, last + 1, mbh, mbw, period) < 0 || tb.pos != tb.nbits)
            continue;
        *readings |= 1 << r;
        if (used < 0) {
            mb_symbols(&o, n, mb, mbh, mbw, &got, 0);
            used = (nbytes - 1) * 8 + r;
        } else {
            mb_symbols(&o, n, mb, mbh, mbw, &other, 0);
            ambiguous |= memcmp(&got, &other, sizeof got) != 0;
        }
    }
    free(tail);
    if (used >= 0) mb_symbols(&o, n, mb, mbh, mbw, &got, 1);
    return ambiguous ? ERR_AMBIGUOUS : used;
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
