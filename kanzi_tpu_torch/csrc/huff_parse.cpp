// Host parse of a Huffman block's chunk headers for the card's decode.
//
// HuffmanDecoder.decode hands every full 16 KiB chunk of a block to the
// huff_decode kernel (huffman.cu). Before the kernel can run, each
// chunk's header has to be read on the host: the alphabet, the code
// lengths as signed exp-Golomb deltas, the four fragment bit counts, and
// the fragments themselves, which sit at arbitrary bit offsets in the
// stream. This library does that for all full chunks of a block in one
// call, and writes what the kernel takes: the canonical code values and
// lengths of each chunk, and every fragment byte-aligned, back to back,
// with its byte offsets. A chunk of one symbol is filled here; it has no
// payload. The format is HuffmanEncoder.cpp / HuffmanDecoder.cpp of the
// reference (bitstream v6).
//
// Plain C interface, built with g++ by kanzi_tpu_torch/utils/native.py.

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

constexpr int MAX_SYMBOL_SIZE = 12;
constexpr int64_t CHUNK = 16384;
constexpr int64_t FRAG = CHUNK / 4;
// a fragment holds at most FRAG codes of MAX_SYMBOL_SIZE bits
constexpr int64_t FRAG_MAX_BYTES = MAX_SYMBOL_SIZE * FRAG / 8;

struct BitR {                      // MSB-first bounded reader
    const uint8_t* d;
    int64_t nbits;
    int64_t pos;
    bool err = false;
    int bit() {
        if (pos >= nbits) { err = true; return 0; }
        const int b = (d[pos >> 3] >> (7 - (pos & 7))) & 1;
        pos++;
        return b;
    }
    uint32_t bits(int n) {         // n <= 32
        if (n == 0) return 0;
        if (pos + n > nbits) { err = true; return 0; }
        uint32_t v = 0;
        for (int i = 0; i < n; i++, pos++)
            v = (v << 1) | ((d[pos >> 3] >> (7 - (pos & 7))) & 1);
        return v;
    }
};

// signed exp-Golomb byte (entropy/exp_golomb.py)
int eg_get(BitR& r) {
    if (r.bit() == 1) return 0;
    int log2 = 1;
    while (!r.err && r.bit() == 0) log2++;
    log2 &= 7;
    int res = int(r.bits(log2 + 1));
    const int sgn = res & 1;
    res = (res >> 1) + (1 << log2) - 1;
    return ((res - sgn) ^ -sgn) & 0xFF;
}

// entropy/utils.py read_varint; -1 on a malformed value
int64_t varint_get(BitR& r) {
    uint32_t value = r.bits(8);
    int64_t res = value & 0x7F;
    int shift = 7;
    while (value >= 128) {
        value = r.bits(8);
        if (r.err) return -1;
        if (shift == 28) {
            if (value >= 128 || (value & 0x70) != 0) return -1;
            return res | (int64_t(value & 0x0F) << shift);
        }
        res |= int64_t(value & 0x7F) << shift;
        shift += 7;
    }
    return res;
}

// entropy/huffman.py generate_canonical_codes; -1 on an over-long code
int canonical_codes(const int32_t* sizes, const int* syms, int count,
                    int32_t* codes) {
    uint32_t key[256];
    for (int i = 0; i < count; i++) {
        const int s = syms[i];
        if (sizes[s] > MAX_SYMBOL_SIZE) return -1;
        key[i] = (uint32_t(sizes[s] - 1) << 8) | uint32_t(s);
    }
    std::sort(key, key + count);
    int cur_len = sizes[key[0] & 0xFF];
    int32_t code = 0;
    for (int i = 0; i < count; i++) {
        const int s = int(key[i] & 0xFF);
        code <<= (sizes[s] - cur_len);
        cur_len = sizes[s];
        codes[s] = code++;
    }
    return 0;
}

// nb bits from bit `pos` of d (total_bytes long) into dst, byte-aligned,
// the bits past nb in the last byte 0 (HuffmanDecoder._read_fragments)
void copy_bits(const uint8_t* d, int64_t total_bytes, int64_t pos,
               int64_t nb, uint8_t* dst) {
    const int64_t b0 = pos >> 3;
    const int off = int(pos & 7);
    const int64_t nbytes = (nb + 7) >> 3;
    if (off == 0) {
        std::memcpy(dst, d + b0, size_t(nbytes));
    } else {
        for (int64_t i = 0; i < nbytes; i++) {
            const int64_t k = b0 + i;
            const uint8_t next = (k + 1 < total_bytes) ? d[k + 1] : 0;
            dst[i] = uint8_t((d[k] << off) | (next >> (8 - off)));
        }
    }
    if (nb & 7) dst[nbytes - 1] &= uint8_t(0xFF << (8 - (nb & 7)));
}

}  // namespace

extern "C" {

// Parse n_full full chunks of a Huffman block from bit `pos` of `buf`
// (nbits long). A chunk of one symbol is written to out[c*CHUNK..]; each
// other chunk is listed for the card: dev_chunk[k] its index in the
// block, codes/sizes[k*256..] its canonical codes and lengths (0: absent),
// its 4 fragments at pay[bounds[4k+f] : bounds[4k+f+1]] (pay holds at
// least 4 * n_full * FRAG_MAX_BYTES bytes). *n_dev is the number listed,
// *n_parsed the chunks read: fewer than n_full when an empty alphabet
// ended the block. Returns the new bit position, or: -2 read past the
// end, -3 bad varint, -4 bad code length, -6 over-long code, -7 fragment
// over FRAG_MAX_BYTES.
int64_t kz_huff_parse_block(const uint8_t* buf, int64_t nbits, int64_t pos,
                            int64_t n_full, uint8_t* out, int32_t* dev_chunk,
                            int32_t* codes, int32_t* sizes, uint8_t* pay,
                            int64_t* bounds, int64_t* n_dev,
                            int64_t* n_parsed) {
    BitR r{buf, nbits, pos};
    const int64_t total_bytes = (nbits + 7) >> 3;
    int64_t k = 0;
    int64_t off = 0;
    bounds[0] = 0;
    *n_dev = 0;
    *n_parsed = 0;
    for (int64_t c = 0; c < n_full; c++) {
        // entropy/utils.py decode_alphabet
        int alpha[256];
        int count = 0;
        if (r.bit() == 0) {                        // full alphabet
            if (r.bit() == 0) {                    // all 256 symbols
                count = 256;
                for (int i = 0; i < 256; i++) alpha[i] = i;
            }
        } else {
            const int last_mask = int(r.bits(5));
            for (int i = 0; i <= last_mask; i++) {
                const uint32_t m = r.bits(8);
                for (int j = 0; j < 8; j++)
                    if (m & (1u << j)) alpha[count++] = 8 * i + j;
            }
        }
        if (r.err) return -2;
        if (count == 0) break;                     // end of the block
        int32_t* sz = sizes + 256 * k;
        std::fill_n(sz, 256, 0);
        int cur = 2;
        for (int i = 0; i < count; i++) {
            const int delta = eg_get(r);
            if (r.err) return -2;
            cur += (delta < 128) ? delta : delta - 256;
            if (cur <= 0 || cur > MAX_SYMBOL_SIZE) return -4;
            sz[alpha[i]] = cur;
        }
        *n_parsed = c + 1;
        if (count == 1) {
            std::memset(out + c * CHUNK, alpha[0], size_t(CHUNK));
            continue;
        }
        int32_t* cd = codes + 256 * k;
        std::fill_n(cd, 256, 0);
        if (canonical_codes(sz, alpha, count, cd) != 0) return -6;
        int64_t frag_bits[4];
        for (int f = 0; f < 4; f++) {
            frag_bits[f] = varint_get(r);
            if (r.err) return -2;
            if (frag_bits[f] < 0) return -3;
            if (frag_bits[f] > 8 * FRAG_MAX_BYTES) return -7;
        }
        for (int f = 0; f < 4; f++) {
            const int64_t nb = frag_bits[f];
            if (r.pos + nb > nbits) return -2;
            copy_bits(buf, total_bytes, r.pos, nb, pay + off);
            r.pos += nb;
            off += (nb + 7) >> 3;
            bounds[4 * k + f + 1] = off;
        }
        dev_chunk[k++] = int32_t(c);
        *n_dev = k;
    }
    return r.pos;
}

}  // extern "C"
