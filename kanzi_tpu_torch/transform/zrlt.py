"""Zero-run-length transform (src/transform/ZRLT.cpp:27-210).

Zero run of n -> binary digits of (n+1) minus its MSB, one byte (0/1) per
digit; literal v < 0xFE -> v+1; v >= 0xFE -> 0xFF, (v-0xFE). Used
post-BWT. Forward fails (skip) if output would not fit in src_len bytes.

Forward is fully vectorized (run detection + per-token scatter); inverse
is a scalar state machine kept exactly faithful to the reference,
including the trailing-run termination at source end.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from kanzi_tpu_torch.transform.base import ByteTransform, as_u8


class ZRLT(ByteTransform):
    def max_encoded_length(self, src_len: int) -> int:
        return src_len

    def forward(self, src: np.ndarray) -> Optional[np.ndarray]:
        src = as_u8(src)
        n = len(src)
        if n == 0:
            return src.copy()
        capacity = self.capacity_for(n)
        if capacity < n:  # initial getMaxEncodedLength check
            return None
        from kanzi_tpu_torch.utils import native
        if native.transforms_available():
            return native.zrlt_forward(src, capacity)
        # tokenize: zero runs and literals
        is_zero = src == 0
        # run starts / lengths
        padded = np.concatenate([[False], is_zero, [False]])
        d = np.diff(padded.astype(np.int8))
        run_starts = np.nonzero(d == 1)[0]
        run_ends = np.nonzero(d == -1)[0]
        run_lens = run_ends - run_starts  # zeros per run

        lit_pos = np.nonzero(~is_zero)[0]
        lit_vals = src[lit_pos].astype(np.int64)

        # output size per token
        rl1 = run_lens.astype(np.int64) + 1
        run_out = np.floor(np.log2(rl1)).astype(np.int64)  # bits below MSB
        lit_out = np.where(lit_vals >= 0xFE, 2, 1)
        total = int(run_out.sum() + lit_out.sum())
        if total > capacity:  # would not fit: transform "fails" => skipped
            return None

        # interleave tokens by source position: compute output offsets
        tok_pos = np.concatenate([run_starts, lit_pos])
        tok_len = np.concatenate([run_out, lit_out])
        order = np.argsort(tok_pos, kind="stable")
        tok_len_sorted = tok_len[order]
        tok_off = np.concatenate([[0], np.cumsum(tok_len_sorted)[:-1]])
        # map back: offsets for runs are where order points to run tokens
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        run_off = tok_off[inv[:len(run_starts)]]
        lit_off = tok_off[inv[len(run_starts):]]

        out = np.empty(total, dtype=np.uint8)
        # literals
        one = lit_out == 1
        out[lit_off[one]] = (lit_vals[one] + 1).astype(np.uint8)
        esc = ~one
        out[lit_off[esc]] = 0xFF
        out[lit_off[esc] + 1] = (lit_vals[esc] - 0xFE).astype(np.uint8)
        # run bits: for each run write run_out bits of (len+1), MSB excluded
        if len(run_lens):
            nb = run_out
            idx = np.repeat(np.arange(len(nb)), nb)
            ends = np.cumsum(nb)
            within = np.arange(int(nb.sum())) - np.repeat(ends - nb, nb)
            shift = (nb[idx] - 1 - within)
            bits = ((rl1[idx] >> shift) & 1).astype(np.uint8)
            out[np.repeat(run_off, nb) + within] = bits
        return out

    def output_limit(self, src_len: int) -> Optional[int]:
        """The most bytes the inverse may give in a block decode: 4 times
        the decode buffer's capacity (the block size, or the payload
        where larger; a valid block's stages before ZRLT add at most an
        eighth and 8 KiB each) and 1 MiB. Past it the run is corrupt: a
        run of k digits asks for 2^k bytes. None (no bound) for a
        transform outside a block decode, whose context has neither."""
        cap = max(self.ctx.get_int("_decodeCapacity", 0),
                  self.ctx.get_int("blockSize", 0))
        return 4 * max(cap, src_len) + (1 << 20) if cap else None

    def inverse(self, src: np.ndarray) -> np.ndarray:
        src = as_u8(src)
        n = len(src)
        if n == 0:
            return src.copy()
        limit = self.output_limit(n)
        from kanzi_tpu_torch.utils import native
        if native.transforms_available():
            return native.zrlt_inverse(src, limit)

        def zeros(run: int) -> bytes:
            if limit is not None and len(out) + run > limit:
                raise ValueError(f"ZRLT: malformed input (output past "
                                 f"{limit} bytes)")
            return bytes(run)
        out = bytearray()
        i = 0
        data = src.tolist()
        run_length = 0
        while True:
            val = data[i]
            if val <= 1:
                run_length = 1
                while val <= 1:
                    run_length += run_length + val
                    i += 1
                    if i >= n:
                        break
                    val = data[i]
                if i >= n:
                    break
                run_length -= 1
                if run_length > 0:
                    out += zeros(run_length)
                    run_length = 0
                    continue
            if val == 0xFF:
                i += 1
                if i >= n:
                    raise ValueError("ZRLT: malformed escape at end of input")
                out.append((0xFE + data[i]) & 0xFF)
            else:
                out.append(val - 1)
            i += 1
            if i >= n:
                run_length = 0
                break
        if run_length > 0:
            run_length -= 1
            if run_length > 0:
                out += zeros(run_length)
        return np.frombuffer(bytes(out), dtype=np.uint8)
