// Host codec of the spill and page frames: LZ4 block compression and the
// page CRC32.
//
// A copy of presto_tpu/native/page_codec.cc, so that the port's frames
// (presto_tpu_torch/protocol/serde.py) are byte for byte the JAX
// package's. This is host code, not a device kernel.
//
// Exposed (extern "C", plain buffers, no Python API dependency):
//   pt_pack_nulls    bools -> MSB-first bitmap (EncoderUtil.encodeNullsAsBits)
//   pt_unpack_nulls  bitmap -> bools
//   pt_crc32         zlib-compatible CRC32 (the page checksum primitive)
//   pt_lz4_compress, pt_lz4_decompress, pt_lz4_compress_crc (below)
//
// Build: g++ -O3 -shared -fPIC page_codec.cc -o libpage_codec.so
// (presto_tpu_torch/native.py `codec()` compiles it at first use into
// presto_tpu_torch/_build/).

#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" {

// bools (one byte each, nonzero = null) -> MSB-first packed bits.
// `out` must hold (n + 7) / 8 bytes. Returns 1 if any null was set.
int pt_pack_nulls(const uint8_t* nulls, size_t n, uint8_t* out) {
    size_t nbytes = (n + 7) / 8;
    std::memset(out, 0, nbytes);
    int any = 0;
    for (size_t i = 0; i < n; i++) {
        if (nulls[i]) {
            out[i >> 3] |= (uint8_t)(0x80u >> (i & 7));
            any = 1;
        }
    }
    return any;
}

// MSB-first packed bits -> bools (one byte each).
void pt_unpack_nulls(const uint8_t* bits, size_t n, uint8_t* out) {
    for (size_t i = 0; i < n; i++) {
        out[i] = (bits[i >> 3] >> (7 - (i & 7))) & 1u;
    }
}

// zlib-compatible CRC32 (reflected, poly 0xEDB88320), slice-by-8 table
// variant — matches java.util.zip.CRC32 / Python zlib.crc32. Table
// built by a static initializer: dlopen runs it single-threaded before
// any pt_crc32 call, so there is no lazy-init data race.
struct CrcTable {
    uint32_t t[8][256];
    CrcTable() {
        for (uint32_t i = 0; i < 256; i++) {
            uint32_t c = i;
            for (int k = 0; k < 8; k++)
                c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : (c >> 1);
            t[0][i] = c;
        }
        for (uint32_t i = 0; i < 256; i++) {
            uint32_t c = t[0][i];
            for (int s = 1; s < 8; s++) {
                c = t[0][c & 0xFFu] ^ (c >> 8);
                t[s][i] = c;
            }
        }
    }
};
static const CrcTable crc_table;

uint32_t pt_crc32(const uint8_t* data, size_t n, uint32_t crc) {
    crc = ~crc;
    const uint32_t (*t)[256] = crc_table.t;
    while (n >= 8) {
        uint32_t lo, hi;
        std::memcpy(&lo, data, 4);
        std::memcpy(&hi, data + 4, 4);
        lo ^= crc;
        crc = t[7][lo & 0xFFu] ^ t[6][(lo >> 8) & 0xFFu]
            ^ t[5][(lo >> 16) & 0xFFu] ^ t[4][lo >> 24]
            ^ t[3][hi & 0xFFu] ^ t[2][(hi >> 8) & 0xFFu]
            ^ t[1][(hi >> 16) & 0xFFu] ^ t[0][hi >> 24];
        data += 8;
        n -= 8;
    }
    for (size_t i = 0; i < n; i++)
        crc = t[0][(crc ^ data[i]) & 0xFFu] ^ (crc >> 8);
    return ~crc;
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------------
// LZ4 block format (the reference's SerializedPage compression codec —
// presto-common/.../CompressionCodec.java LZ4, airlift aircompressor's
// Lz4RawCompressor; the block format spec is public domain). Implemented
// from the format specification: sequences of
//   token(1B: literalLen<<4 | matchLen-4) [litLen ext] literals
//   offset(2B LE) [matchLen ext]
// with the standard end conditions (last 5 bytes are literals, last
// match must start >= 12 bytes before the end).

static inline uint32_t lz4_hash(uint32_t v) {
    return (v * 2654435761u) >> 20;   // 12-bit hash table
}

// Compress src -> dst (worst case bound: n + n/255 + 16). Returns
// compressed size, or 0 if dst_cap is too small.
size_t pt_lz4_compress(const uint8_t* src, size_t n,
                       uint8_t* dst, size_t dst_cap) {
    const size_t MINMATCH = 4, MFLIMIT = 12, LASTLITERALS = 5;
    uint32_t table[1 << 12];
    std::memset(table, 0, sizeof(table));
    const uint8_t* ip = src;
    const uint8_t* const iend = src + n;
    const uint8_t* const mflimit =
        (n > MFLIMIT) ? iend - MFLIMIT : src;
    const uint8_t* anchor = src;
    uint8_t* op = dst;
    uint8_t* const oend = dst + dst_cap;

    auto write_literals = [&](const uint8_t* from, size_t len,
                              size_t match_len_code) -> bool {
        size_t tok_lit = len < 15 ? len : 15;
        if (op + 1 + len + (len / 255) + 2 > oend) return false;
        *op++ = (uint8_t)((tok_lit << 4) | match_len_code);
        if (len >= 15) {
            size_t rest = len - 15;
            while (rest >= 255) { *op++ = 255; rest -= 255; }
            *op++ = (uint8_t)rest;
        }
        std::memcpy(op, from, len);
        op += len;
        return true;
    };

    if (n >= MFLIMIT) {
        while (ip < mflimit) {
            uint32_t seq;
            std::memcpy(&seq, ip, 4);
            uint32_t h = lz4_hash(seq);
            const uint8_t* match = src + table[h];
            table[h] = (uint32_t)(ip - src);
            uint32_t mseq;
            std::memcpy(&mseq, match, 4);
            if (match + 0xFFFF < ip || mseq != seq || match >= ip) {
                ip++;
                continue;
            }
            // extend match
            const uint8_t* mp = match + MINMATCH;
            const uint8_t* p = ip + MINMATCH;
            const uint8_t* const matchlimit = iend - LASTLITERALS;
            while (p < matchlimit && *p == *mp) { p++; mp++; }
            size_t mlen = (size_t)(p - ip) - MINMATCH;
            size_t litlen = (size_t)(ip - anchor);
            size_t tok_m = mlen < 15 ? mlen : 15;
            if (!write_literals(anchor, litlen, tok_m)) return 0;
            uint16_t off = (uint16_t)(ip - match);
            if (op + 2 + (mlen / 255) + 1 > oend) return 0;
            *op++ = (uint8_t)(off & 0xFF);
            *op++ = (uint8_t)(off >> 8);
            if (mlen >= 15) {
                size_t rest = mlen - 15;
                while (rest >= 255) { *op++ = 255; rest -= 255; }
                *op++ = (uint8_t)rest;
            }
            ip = p;
            anchor = ip;
        }
    }
    // trailing literals (bound includes the length-extension terminator
    // byte written when lastlit >= 15)
    size_t lastlit = (size_t)(iend - anchor);
    size_t tok_lit = lastlit < 15 ? lastlit : 15;
    size_t ext = lastlit >= 15 ? 1 + (lastlit - 15) / 255 : 0;
    if (op + 1 + ext + lastlit > oend) return 0;
    *op++ = (uint8_t)(tok_lit << 4);
    if (lastlit >= 15) {
        size_t rest = lastlit - 15;
        while (rest >= 255) { *op++ = 255; rest -= 255; }
        *op++ = (uint8_t)rest;
    }
    std::memcpy(op, anchor, lastlit);
    op += lastlit;
    return (size_t)(op - dst);
}

// Fused block-LZ4 + frame-CRC fast path: compress src -> dst and CRC32
// the COMPRESSED output (the page checksum covers the payload as
// transmitted) in one native call, so the Python encode path pays one
// ctypes round trip instead of two. Returns the compressed size (0 if
// dst_cap is too small); *crc_out receives the CRC of dst[0..size).
size_t pt_lz4_compress_crc(const uint8_t* src, size_t n,
                           uint8_t* dst, size_t dst_cap,
                           uint32_t* crc_out) {
    size_t got = pt_lz4_compress(src, n, dst, dst_cap);
    if (crc_out) *crc_out = got ? pt_crc32(dst, got, 0u) : 0u;
    return got;
}

// Decompress src -> dst (dst_cap = exact uncompressed size). Returns
// bytes written, or 0 on malformed input.
size_t pt_lz4_decompress(const uint8_t* src, size_t n,
                         uint8_t* dst, size_t dst_cap) {
    const uint8_t* ip = src;
    const uint8_t* const iend = src + n;
    uint8_t* op = dst;
    uint8_t* const oend = dst + dst_cap;
    while (ip < iend) {
        uint8_t token = *ip++;
        size_t litlen = token >> 4;
        if (litlen == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return 0;
                b = *ip++;
                litlen += b;
            } while (b == 255);
        }
        if (ip + litlen > iend || op + litlen > oend) return 0;
        std::memcpy(op, ip, litlen);
        ip += litlen;
        op += litlen;
        if (ip >= iend) break;          // end of block after literals
        if (ip + 2 > iend) return 0;
        uint16_t off = (uint16_t)(ip[0] | (ip[1] << 8));
        ip += 2;
        if (off == 0 || op - dst < (ptrdiff_t)off) return 0;
        size_t mlen = (token & 0xF);
        if (mlen == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return 0;
                b = *ip++;
                mlen += b;
            } while (b == 255);
        }
        mlen += 4;
        if (op + mlen > oend) return 0;
        const uint8_t* mp = op - off;
        for (size_t i = 0; i < mlen; i++) op[i] = mp[i];  // overlapping
        op += mlen;
    }
    return (size_t)(op - dst);
}

}  // extern "C"
