"""TEXT (dictionary word-replacement) codec.

Reference: src/transform/TextCodec.cpp (1868 LoC). Two wire variants:
- TextCodec1: escape tokens 0x0F/0x0E + 1-3 byte indexes (5+7+7-bit)
- TextCodec2: self-terminating 10xxxxxx/110xxxxx/1111xxxx indexes with
  0x80 reserved for case-flip (chosen when a fast entropy backend
  follows: NONE/ANS0/HUFFMAN/RANGE — TransformFactory.hpp:228-243)
Static English dictionary of 1024 words + dynamic hashing of new words
(<= 31 chars); computeStats text/XML/CRLF detection gates the transform.
bsVersion 6 semantics (variant not recorded in the output byte).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from kanzi_tpu_torch.core import magic as magiclib
from kanzi_tpu_torch.core import stats
from kanzi_tpu_torch.transform.base import ByteTransform, as_u8
from kanzi_tpu_torch.transform.text_dict import DICT_EN_1024

ESCAPE_TOKEN1 = 0x0F
ESCAPE_TOKEN2 = 0x0E
HASH1 = 0x7FEB352D
HASH2 = 0x846CA68B
M32 = 0xFFFFFFFF
CR = 0x0D
LF = 0x0A
SP = 0x20
THRESHOLD1 = 128
THRESHOLD2 = THRESHOLD1 * THRESHOLD1
THRESHOLD3 = 64
THRESHOLD4 = THRESHOLD3 * 128
LOG_HASHES_SIZE = 24
MASK_NOT_TEXT = 0x80
MASK_CRLF = 0x40
MASK_XML_HTML = 0x20
MASK_DT = 0x0F
MASK_LENGTH = 0x0007FFFF
MAX_DICT_SIZE = 1 << 19
MAX_WORD_LENGTH = 31
MIN_BLOCK_SIZE = 1024
MAX_BLOCK_SIZE = 1 << 30


def _build_char_types():
    t = np.full(256, -1, dtype=np.int8)
    for i in range(256):
        if 0x20 <= i <= 0x2F or 0x3A <= i <= 0x3F or \
                i in (0x0A, 0x0D, 0x09, ord('_'), ord('|'), ord('{'),
                      ord('}'), ord('['), ord(']')):
            t[i] = 1
        elif ord('A') <= i <= ord('Z') or ord('a') <= i <= ord('z'):
            t[i] = 0
    return t


CHAR_TYPE = _build_char_types()


def _is_text(c: int) -> bool:
    return CHAR_TYPE[c] == 0


def _word_hash(word: bytes) -> int:
    h = HASH1
    for c in word:
        h = ((h * HASH1) ^ (c * HASH2)) & M32
    return h


# static dictionary entries: (word bytes, hash, index, length)
_STATIC_WORDS = [bytes(w) for w in DICT_EN_1024]
_STATIC_HASHES = [_word_hash(w) for w in _STATIC_WORDS]
STATIC_DICT_WORDS = len(_STATIC_WORDS)


def compute_stats(block: np.ndarray, strict: bool):
    """8-bit status detection (TextCodec::computeStats :217-340)."""
    count = len(block)
    if not strict and magiclib.get_type(block[:4].tobytes()) != magiclib.NO_MAGIC:
        return MASK_NOT_TEXT
    from kanzi_tpu_torch.utils import native
    if native.transforms_available():
        freqs0, freqs1 = native.hist_o01(block)
    else:
        freqs0 = np.bincount(block, minlength=256).astype(np.int64)
        prev = np.concatenate([[0], block[:-1]]).astype(np.int64)
        freqs1 = np.bincount(prev * 256 + block,
                             minlength=65536).astype(np.int64) \
            .reshape(256, 256)

    is_text_mask = CHAR_TYPE[:128] == 0
    nb_text = int(freqs0[CR] + freqs0[LF] + freqs0[:128][is_text_mask].sum())
    nb_ascii = int(freqs0[:128].sum())
    nb_bin = count - nb_ascii
    not_text = nb_bin > (count >> 2)
    if not not_text:
        not_text = nb_text < (count >> 2)
        if strict:
            not_text |= (int(freqs0[0]) >= count // 100) or ((nb_ascii // 95) < (count // 100))
        else:
            not_text |= int(freqs0[32]) < count // 50

    if not_text:
        return _detect_type(freqs0, freqs1, count)

    res = 0
    if nb_bin <= count - count // 10:
        f60 = int(freqs0[60])
        f62 = int(freqs0[62])
        f38 = int(freqs1[38, 97] + freqs1[38, 103] + freqs1[38, 108] + freqs1[38, 113])
        min_freq = max((count - nb_bin) >> 9, 2)
        if f60 >= min_freq and f62 >= min_freq and f38 > 0:
            if f60 < f62:
                if f60 >= f62 - f62 // 100:
                    res |= MASK_XML_HTML
            elif f62 < f60:
                if f62 >= f60 - f60 // 100:
                    res |= MASK_XML_HTML
            else:
                res |= MASK_XML_HTML

    if freqs0[CR] != 0 and freqs0[CR] == freqs0[LF]:
        res |= MASK_CRLF
        others_after_cr = int(freqs1[CR].sum() - freqs1[CR, LF])
        others_before_lf = int(freqs1[:, LF].sum() - freqs1[CR, LF])
        if others_after_cr != 0 or others_before_lf != 0:
            res &= ~MASK_CRLF
    return res


def _detect_type(freqs0, freqs1, count):
    dt = stats.detect_simple_type(count, freqs0)
    if dt != stats.UNDEFINED:
        return MASK_NOT_TEXT | dt
    # UTF-8 validation (same rules as UTFCodec)
    s = int(freqs0[0xC0] + freqs0[0xC1] + freqs0[0xF5:0x100].sum())
    if s != 0:
        return MASK_NOT_TEXT
    i = np.arange(256)
    out_cont = (i < 0x80) | (i > 0xBF)
    bad = 0
    bad += int(freqs1[0xE0][(i < 0xA0) | (i > 0xBF)].sum())
    bad += int(freqs1[0xED][(i < 0x80) | (i > 0x9F)].sum())
    bad += int(freqs1[0xF0][(i < 0x90) | (i > 0xBF)].sum())
    bad += int(freqs1[0xF4][(i < 0x80) | (i > 0x8F)].sum())
    for j in list(range(0xC2, 0xE0)) + list(range(0xE1, 0xED)) + \
            [0xF1, 0xF2, 0xF3, 0xEE, 0xEF]:
        bad += int(freqs1[j][out_cont].sum())
    if bad != 0:
        return MASK_NOT_TEXT
    sum2 = int(freqs0[0x80:0xC0].sum())
    if sum2 >= count // 8:
        return MASK_NOT_TEXT | stats.UTF8
    return MASK_NOT_TEXT


class _Entry:
    __slots__ = ("buf", "start", "hash", "data")

    def __init__(self, buf, start, h, idx, length):
        self.buf = buf          # bytes-like or None
        self.start = start
        self.hash = h
        self.data = (length << 24) | idx

    def length(self):
        return self.data >> 24

    def index(self):
        return self.data & MASK_LENGTH

    def word(self):
        return bytes(self.buf[self.start:self.start + self.length()])


class _Dict:
    """dictMap/dictList state machine shared by both variants."""

    def __init__(self, log_hash_size, dict_size, extra_escapes):
        self.hash_mask = (1 << log_hash_size) - 1
        self.dict_size = dict_size
        self.entries = []
        for i, w in enumerate(_STATIC_WORDS):
            self.entries.append(_Entry(w, 0, _STATIC_HASHES[i], i, len(w)))
        for esc in extra_escapes:  # TextCodec1 escape pseudo-words
            i = len(self.entries)
            self.entries.append(_Entry(bytes([esc]), 0, 0, i, 1))
        self.static_size = len(self.entries)
        for i in range(self.static_size, dict_size):
            self.entries.append(_Entry(None, 0, 0, i, 0))
        self.dmap = {}
        for i in range(self.static_size):
            self.dmap[self.entries[i].hash & self.hash_mask] = i

    def lookup(self, h):
        return self.dmap.get(h & self.hash_mask)

    def expand(self):
        if self.dict_size >= MAX_DICT_SIZE:
            return False
        for i in range(self.dict_size, self.dict_size * 2):
            self.entries.append(_Entry(None, 0, 0, i, 0))
        # reset map: every entry re-points its hash slot
        self.dmap = {}
        for i in range(self.dict_size):
            self.dmap[self.entries[i].hash & self.hash_mask] = i
        self.dict_size <<= 1
        return True

    def try_insert(self, words, h1, buf, start, length):
        """Candidate insertion (shared forward/inverse logic). Returns the
        updated `words` counter."""
        e = self.entries[words]
        if e.index() >= self.static_size:
            # reuse old entry (unconditionally clears the old hash slot)
            self.dmap[e.hash & self.hash_mask] = None
            e.buf = buf
            e.start = start
            e.hash = h1
            e.data = (length << 24) | words
        self.dmap[h1 & self.hash_mask] = words
        words += 1
        if words >= self.dict_size:
            if not self.expand():
                words = self.static_size
        return words


def _same_words(e: _Entry, buf, start, length):
    """Compare e.word()[1:length] with buf[start:start+length-1]."""
    return e.buf[e.start + 1:e.start + length] == bytes(buf[start:start + length - 1])


def _dict_log_params(ctx, variant):
    block_size = ctx.get_int("blockSize", 0)
    if variant == 1:
        log = max(min(stats.log2(block_size // 8), 26), 13) if block_size >= 8 else 13
    else:
        log = max(min(stats.log2(block_size // 32), 24), 13) if block_size >= 32 else 13
    if ctx.get_str("entropy", "") == "TPAQX":
        log += 1
    return log


def _reset_dict_size(count):
    log = 13 if count < 1024 else max(min(stats.log2(count // 128), 18), 13)
    return log


class TextCodec(ByteTransform):
    def __init__(self, ctx=None, variant: int = 1):
        super().__init__(ctx)
        self.variant = variant
        self.bs_version = self.ctx.get_int("bsVersion", 7)

    def max_encoded_length(self, src_len: int) -> int:
        return src_len

    # ---------------- forward ----------------
    def forward(self, src: np.ndarray) -> Optional[np.ndarray]:
        src = as_u8(src)
        count = len(src)
        if count == 0:
            return src.copy()
        if count < MIN_BLOCK_SIZE or count > MAX_BLOCK_SIZE:
            return None
        dt = self.ctx.get_int("dataType", stats.UNDEFINED)
        if dt not in (stats.UNDEFINED, stats.TEXT, stats.BIN):
            return None
        mode = compute_stats(src, strict=(self.variant == 1))
        if mode & MASK_NOT_TEXT:
            self.ctx.put("dataType", mode & MASK_DT)
            return None
        self.ctx.put("dataType", stats.TEXT)
        if self.capacity_for(count) < self.max_encoded_length(count):
            return None

        log_hash = _dict_log_params(self.ctx, self.variant)
        dict_size = max(STATIC_DICT_WORDS + (2 if self.variant == 1 else 0),
                        1 << _reset_dict_size(count))

        # native fast path (byte-identical C++ port, native/text.cpp)
        try:
            from kanzi_tpu_torch.utils import native
            if native.text_available():
                out = native.text_forward(src, self.variant, log_hash,
                                          dict_size, int(mode))
                return None if out is None else out
        except Exception:
            pass

        escapes = (ESCAPE_TOKEN2, ESCAPE_TOKEN1) if self.variant == 1 else ()
        d = _Dict(log_hash, dict_size, escapes)

        # the reference caps output at getMaxEncodedLength(count), not at
        # the buffer capacity (TextCodec1::forward :622)
        dst_end = self.max_encoded_length(count)
        dst_end_guard = dst_end - (4 if self.variant == 1 else 3)
        data = src.tolist()
        raw = src.tobytes()
        is_crlf = bool(mode & MASK_CRLF)
        dst = bytearray([mode])
        src_idx = 0
        emit_anchor = 0
        words = d.static_size
        ctype = CHAR_TYPE

        while src_idx < count and data[src_idx] == SP:
            dst.append(SP)
            src_idx += 1
            emit_anchor += 1

        delim_anchor = src_idx - 1 if (src_idx < count and _is_text(data[src_idx])) else src_idx
        h1 = HASH1
        h2 = HASH1
        res = True

        while src_idx < count:
            cur = data[src_idx]
            ct = ctype[cur]
            if ct == 0:
                if src_idx - delim_anchor == 1:
                    h1 = ((HASH1 * HASH1) ^ (cur * HASH2)) & M32
                    h2 = ((HASH1 * HASH1) ^ ((cur ^ 0x20) * HASH2)) & M32
                else:
                    h1 = ((h1 * HASH1) ^ (cur * HASH2)) & M32
                    h2 = ((h2 * HASH1) ^ (cur * HASH2)) & M32
                src_idx += 1
                continue

            if src_idx > delim_anchor + 2 and ct > 0:
                length = src_idx - delim_anchor - 1
                if length <= MAX_WORD_LENGTH:
                    pe = None
                    pe1_idx = d.lookup(h1)
                    pe1 = d.entries[pe1_idx] if pe1_idx is not None else None
                    if pe1 is not None and pe1.hash == h1 and pe1.length() == length:
                        pe = pe1
                    else:
                        pe2_idx = d.lookup(h2)
                        pe2 = d.entries[pe2_idx] if pe2_idx is not None else None
                        if pe2 is not None and pe2.hash == h2 and pe2.length() == length:
                            pe = pe2
                    if pe is not None and not _same_words(pe, data, delim_anchor + 2, length):
                        pe = None
                    if pe is None:
                        if ((length > 3) or (length == 3 and words < THRESHOLD2)) \
                                and pe1 is None:
                            words = d.try_insert(words, h1, raw, delim_anchor + 1, length)
                    else:
                        # word found: emit pending symbols then the index
                        if emit_anchor != delim_anchor or data[delim_anchor] != SP:
                            di = self._emit_symbols(
                                data, emit_anchor, delim_anchor + 1, dst,
                                dst_end, is_crlf, d)
                            if di < 0:
                                res = False
                                break
                        if len(dst) >= dst_end_guard:
                            res = False
                            break
                        if self.variant == 1:
                            dst.append(ESCAPE_TOKEN1 if pe is pe1 else ESCAPE_TOKEN2)
                            self._emit_word_index1(dst, pe.index())
                        else:
                            if pe is not pe1:
                                dst.append(0x80)  # case flip
                            self._emit_word_index2(dst, pe.index())
                        emit_anchor = delim_anchor + 1 + pe.length()
            delim_anchor = src_idx
            src_idx += 1

        if res:
            di = self._emit_symbols(data, emit_anchor, count, dst, dst_end,
                                    is_crlf, d)
            if di < 0 or src_idx != count:
                res = False
        if not res:
            return None
        return np.frombuffer(bytes(dst), dtype=np.uint8)

    def _emit_symbols(self, data, start, end, dst, dst_end, is_crlf, d):
        if self.variant == 1:
            for i in range(start, end):
                if len(dst) >= dst_end:
                    return -1
                cur = data[i]
                if cur in (ESCAPE_TOKEN1, ESCAPE_TOKEN2):
                    dst.append(ESCAPE_TOKEN1)
                    idx = d.static_size - 1 if cur == ESCAPE_TOKEN1 else d.static_size - 2
                    len_idx = 1
                    if idx >= THRESHOLD1:
                        len_idx = 3 if idx >= THRESHOLD2 else 2
                    if len(dst) + len_idx >= dst_end:
                        return -1
                    self._emit_word_index1(dst, idx)
                elif cur == CR:
                    if not is_crlf:
                        dst.append(cur)
                else:
                    dst.append(cur)
            return 0
        # variant 2
        for i in range(start, end):
            cur = data[i]
            if cur == ESCAPE_TOKEN1:
                if len(dst) >= dst_end - 1:
                    return -1
                dst.append(ESCAPE_TOKEN1)
                dst.append(ESCAPE_TOKEN1)
            elif cur == CR:
                if not is_crlf:
                    if len(dst) >= dst_end:
                        return -1
                    dst.append(cur)
            else:
                if cur >= 128:
                    if len(dst) >= dst_end:
                        return -1
                    dst.append(ESCAPE_TOKEN1)
                if len(dst) >= dst_end:
                    return -1
                dst.append(cur)
        return 0

    @staticmethod
    def _emit_word_index1(dst, val):
        if val >= THRESHOLD1:
            if val >= THRESHOLD2:
                dst.append(0xE0 | ((val >> 14) & 0xFF) & 0xFF)
                dst.append(0x80 | ((val >> 7) & 0x7F))
                dst.append(val & 0x7F)
            else:
                dst.append(0x80 | ((val >> 7) & 0x7F))
                dst.append(val & 0x7F)
        else:
            dst.append(val)

    @staticmethod
    def _emit_word_index2(dst, w_idx):
        w_idx += 1
        if w_idx >= THRESHOLD3:
            if w_idx >= THRESHOLD4:
                dst.append(0xF0 | ((w_idx >> 16) & 0x0F))
                dst.append((w_idx >> 8) & 0xFF)
                dst.append(w_idx & 0xFF)
            else:
                dst.append(0xC0 | ((w_idx >> 8) & 0x1F))
                dst.append(w_idx & 0xFF)
        else:
            dst.append(0x80 | w_idx)

    # ---------------- inverse ----------------
    def inverse_into(self, src: np.ndarray, out: np.ndarray):
        """Native inverse into `out` (exact-capacity, guarded emits).
        Returns the length or None (fallback; the allocating path then
        raises on genuinely invalid streams)."""
        src = as_u8(src)
        count = len(src)
        if count < 2 or count > MAX_BLOCK_SIZE:
            return None
        from kanzi_tpu_torch.utils import native
        if not native.text_available():
            return None
        cap = self.ctx.get_int("_decodeCapacity", 0)
        if cap <= 0:
            cap = max(self.ctx.get_int("blockSize", count), count)
        log_hash = _dict_log_params(self.ctx, self.variant)
        dict_size = max(STATIC_DICT_WORDS + (2 if self.variant == 1 else 0),
                        1 << _reset_dict_size(cap))
        return native.text_inverse(src, self.variant, log_hash,
                                   dict_size, int(max(cap, count)),
                                   out=out)

    def inverse(self, src: np.ndarray) -> np.ndarray:
        src = as_u8(src)
        count = len(src)
        if count == 0:
            return src.copy()
        if count < 2 or count > MAX_BLOCK_SIZE:
            raise ValueError("TextCodec: invalid block")
        # output buffer capacity drives the initial dictionary size
        cap = self.ctx.get_int("_decodeCapacity", 0)
        if cap <= 0:
            cap = max(self.ctx.get_int("blockSize", count), count)
        log_hash = _dict_log_params(self.ctx, self.variant)
        dict_size = max(STATIC_DICT_WORDS + (2 if self.variant == 1 else 0),
                        1 << _reset_dict_size(cap))

        # native fast path (byte-identical C++ port, native/text.cpp)
        try:
            from kanzi_tpu_torch.utils import native
            if native.text_available():
                out = native.text_inverse(src, self.variant, log_hash,
                                          dict_size, int(max(cap, count)))
                if out is None:
                    raise ValueError("TextCodec: invalid stream")
                return out
        except ValueError:
            raise
        except Exception:
            pass

        escapes = (ESCAPE_TOKEN2, ESCAPE_TOKEN1) if self.variant == 1 else ()
        d = _Dict(log_hash, dict_size, escapes)

        data = src.tolist()
        raw = src.tobytes()
        is_crlf = bool(data[0] & MASK_CRLF)
        src_idx = 1
        dst = bytearray()
        delim_anchor = src_idx - 1 if (src_idx < count and _is_text(data[src_idx])) else src_idx
        words = d.static_size
        word_run = False
        res = True
        v1 = self.variant == 1

        while src_idx < count:
            cur = data[src_idx]
            ct = CHAR_TYPE[cur]
            if ct == 0:
                dst.append(cur)
                src_idx += 1
                continue

            if src_idx > delim_anchor + 3 and ct > 0:
                length = src_idx - delim_anchor - 1
                if length <= MAX_WORD_LENGTH:
                    h1 = HASH1
                    for i in range(delim_anchor + 1, src_idx):
                        h1 = ((h1 * HASH1) ^ (data[i] * HASH2)) & M32
                    pe = None
                    pe1_idx = d.lookup(h1)
                    pe1 = d.entries[pe1_idx] if pe1_idx is not None else None
                    if pe1 is not None and pe1.hash == h1 and pe1.length() == length:
                        if _same_words(pe1, data, delim_anchor + 2, length):
                            pe = pe1
                    if pe is None:
                        if ((length > 3) or (words < THRESHOLD2)) and pe1 is None:
                            words = d.try_insert(words, h1, raw, delim_anchor + 1, length)

            src_idx += 1

            if v1 and cur in (ESCAPE_TOKEN1, ESCAPE_TOKEN2):
                # word reference
                idx = data[src_idx]
                src_idx += 1
                if idx >= 128:
                    idx2 = data[src_idx]
                    src_idx += 1
                    if idx2 >= 128:
                        idx = ((idx & 0x1F) << 14) | ((idx2 & 0x7F) << 7) | data[src_idx]
                        src_idx += 1
                    else:
                        idx = ((idx & 0x7F) << 7) | idx2
                    if idx >= d.dict_size:
                        res = False
                        break
                e = d.entries[idx]
                length = e.length() & 0xFF
                if length > 1:
                    if word_run:
                        dst.append(SP)
                    word_run = True
                    delim_anchor = src_idx
                else:
                    if length == 0:
                        res = False
                        break
                    word_run = False
                    delim_anchor = src_idx - 1
                w = e.buf[e.start:e.start + length]
                pos = len(dst)
                dst += bytes(w)
                if cur == ESCAPE_TOKEN2:
                    dst[pos] ^= 0x20
            elif not v1 and cur >= 0x80:
                flip = 0
                if cur == 0x80:
                    flip = 0x20
                    cur = data[src_idx]
                    src_idx += 1
                idx = cur & 0x7F
                if idx >= 64:
                    if idx >= 112:
                        idx = ((idx & 0x0F) << 16) | (data[src_idx] << 8) | data[src_idx + 1]
                        src_idx += 2
                    else:
                        idx = ((idx & 0x1F) << 8) | data[src_idx]
                        src_idx += 1
                    if idx > d.dict_size:
                        res = False
                        break
                elif idx == 0:
                    res = False
                    break
                idx -= 1
                e = d.entries[idx]
                length = e.length() & 0xFF
                if length > 1:
                    if word_run:
                        dst.append(SP)
                    word_run = True
                    delim_anchor = src_idx
                else:
                    if length == 0:
                        res = False
                        break
                    word_run = False
                    delim_anchor = src_idx - 1
                w = e.buf[e.start:e.start + length]
                pos = len(dst)
                dst += bytes(w)
                dst[pos] ^= flip
            else:
                if not v1 and cur == ESCAPE_TOKEN1:
                    dst.append(data[src_idx])
                    src_idx += 1
                else:
                    if is_crlf and cur == LF:
                        dst.append(CR)
                    dst.append(cur)
                word_run = False
                delim_anchor = src_idx - 1

        if not res or src_idx != count:
            raise ValueError("TextCodec: invalid stream")
        # the dictionary references slices of dst while it grows; python
        # bytearray slicing copies, so entries stay valid
        return np.frombuffer(bytes(dst), dtype=np.uint8)
