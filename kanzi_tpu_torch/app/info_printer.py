"""InfoPrinter: renders pipeline Events at verbosity 2-5.

Mirrors src/app/InfoPrinter.cpp:35-330: per-block events from concurrent
tasks are buffered and released in strict blockId order; verbosity >= 4
prints a per-block summary line, verbosity >= 5 prints every event (JSON)
plus BLOCK_INFO offsets/skipFlags; verbosity >= 3 renders the decoded
header; INFO mode (-y) prints the header table."""

from __future__ import annotations

import sys

from kanzi_tpu_torch.core.events import Event, EventType

COMPRESSION = 0
DECOMPRESSION = 1
INFO = 2


def _json(evt: Event) -> str:
    s = f'{{ "type":"{evt.type.name}"'
    if evt.block_id >= 0:
        s += f', "id":{evt.block_id}'
    s += f', "size":{evt.size}'
    if evt.type != EventType.BLOCK_INFO:
        s += f', "time":{evt.time_ns // 1_000_000}'
    if evt.checksum is not None and evt.hash_bits:
        w = evt.hash_bits // 4
        s += f', "hash":"{evt.checksum:0{w}X}"'
    if evt.type == EventType.BLOCK_INFO:
        if evt.offset is not None:
            s += f', "offset":{evt.offset}'
        if evt.skip_flags is not None:
            s += f', "skipFlags":"{evt.skip_flags:08b}"'
    return s + " }"


class InfoPrinter:
    def __init__(self, level: int, ptype: int = COMPRESSION, out=None):
        from kanzi_tpu_torch.utils.printer import Printer
        self.level = level
        self.ptype = ptype
        self.out = out if out is not None else sys.stderr
        self._printer = Printer(self.out)  # thread-safe across workers
        if ptype == COMPRESSION:
            self.thresholds = (EventType.COMPRESSION_START,
                               EventType.BEFORE_TRANSFORM,
                               EventType.AFTER_TRANSFORM,
                               EventType.BEFORE_ENTROPY,
                               EventType.AFTER_ENTROPY,
                               EventType.COMPRESSION_END)
        else:
            self.thresholds = (EventType.DECOMPRESSION_START,
                               EventType.BEFORE_ENTROPY,
                               EventType.AFTER_ENTROPY,
                               EventType.BEFORE_TRANSFORM,
                               EventType.AFTER_TRANSFORM,
                               EventType.DECOMPRESSION_END)
        self._pending: dict = {}      # blockId -> [events]
        self._next_block = 1
        self._blocks: dict = {}       # blockId -> [t1, t2, t3, s0, s1]
        self._header_count = 0

    # --- listener entry point ---
    def __call__(self, evt: Event) -> None:
        if self.ptype == INFO:
            if evt.type == EventType.AFTER_HEADER_DECODING:
                self._print_header_table(evt)
            return
        if evt.type in (EventType.BEFORE_TRANSFORM,
                        EventType.AFTER_TRANSFORM,
                        EventType.BEFORE_ENTROPY,
                        EventType.AFTER_ENTROPY):
            self._block_event_ordered(evt)
            return
        self._render(evt)

    def _block_event_ordered(self, evt: Event) -> None:
        """Buffer concurrent block events; release whole blocks in strict
        blockId order (InfoPrinter::processBlockEventOrdered)."""
        done_type = (EventType.AFTER_ENTROPY if self.ptype == COMPRESSION
                     else EventType.AFTER_TRANSFORM)
        self._pending.setdefault(evt.block_id, []).append(evt)
        if evt.type != done_type:
            return
        while True:
            evts = self._pending.get(self._next_block)
            if not evts or not any(e.type == done_type for e in evts):
                return
            del self._pending[self._next_block]
            self._next_block += 1
            for e in evts:
                self._render(e)

    def _render(self, evt: Event) -> None:
        t = evt.type
        bid = evt.block_id
        msg = ""
        if t == self.thresholds[1]:
            self._blocks[bid] = [evt.time_ns, 0, 0, evt.size, 0]
            if self.level >= 5:
                msg = _json(evt)
        elif t == self.thresholds[2]:
            bi = self._blocks.get(bid)
            if bi is None:
                return
            bi[1] = evt.time_ns
            if self.level >= 5:
                ms = (bi[1] - bi[0]) // 1_000_000
                msg = f"{_json(evt)} [{ms} ms]"
        elif t == self.thresholds[3]:
            bi = self._blocks.get(bid)
            if bi is None:
                return
            bi[2] = evt.time_ns
            bi[4] = evt.size
            if self.level >= 5:
                msg = _json(evt)
        elif t == self.thresholds[4]:
            bi = self._blocks.pop(bid, None)
            if bi is None:
                return
            parts = []
            if self.level >= 5:
                parts.append(_json(evt))
            if self.level >= 4:
                ms1 = (bi[1] - bi[0]) // 1_000_000
                ms2 = (evt.time_ns - bi[2]) // 1_000_000
                line = (f"Block {bid}: {bi[3]} => {bi[4]} [{ms1} ms] "
                        f"=> {evt.size} [{ms2} ms]")
                if self.ptype == COMPRESSION and bi[3]:
                    line += f" ({int(evt.size * 100 / bi[3])}%)"
                if evt.checksum:
                    line += f" [{evt.checksum:X}]"
                parts.append(line)
            msg = "\n".join(parts)
        elif t == EventType.AFTER_HEADER_DECODING and self.level >= 3:
            msg = (_json(evt) if self.level >= 5
                   else self._header_text(evt))
        elif self.level >= 5:
            msg = _json(evt)
        if msg:
            self._printer.println(msg)

    # --- header rendering (decode -v3+, and the -y INFO table) ---
    @staticmethod
    def _header_text(evt: Event) -> str:
        h = getattr(evt, "header_info", None) or {}
        ck = {0: "NONE", 32: "32 bits", 64: "64 bits"}.get(
            h.get("checksum", 0), "NONE")
        ent = h.get("entropy", "NONE")
        trf = h.get("transform", "NONE")
        lines = [f"Bitstream version: {h.get('bsVersion', '?')}",
                 f"Block checksum: {ck}",
                 f"Block size: {h.get('blockSize', '?')} bytes",
                 f"Using {'no' if ent == 'NONE' else ent} entropy codec "
                 f"(stage 1)",
                 f"Using {'no' if trf == 'NONE' else trf} transform "
                 f"(stage 2)"]
        if h.get("originalSize"):
            lines.append(f"Original size: {h['originalSize']} byte(s)")
        return "\n".join(lines)

    def _print_header_table(self, evt: Event) -> None:
        h = getattr(evt, "header_info", None) or {}
        if self._header_count == 0:
            hdr = ("|     File Name      |Ver|Check|Block Size|  File Size "
                   "| Orig. Size | Ratio ")
            if self.level >= 4:
                hdr += "| Entropy|        Transforms        "
            print("\n" + hdr + "|", file=self.out)
        self._header_count += 1
        name = h.get("inputName", "")
        name = name.rsplit("/", 1)[-1]
        if len(name) > 20:
            name = name[:18] + ".."
        fs = h.get("fileSize")
        osz = h.get("originalSize")
        ratio = (f"{fs / osz:7.4f}" if fs and osz else "    n/a")
        line = (f"|{name:<20}|{h.get('bsVersion', 0):>3}"
                f"|{h.get('checksum', 0):>5}|{h.get('blockSize', 0):>10}"
                f"|{fs if fs is not None else 'n/a':>12}"
                f"|{osz if osz else 'n/a':>12}|{ratio}")
        if self.level >= 4:
            line += (f"|{h.get('entropy', ''):>8}"
                     f"|{h.get('transform', ''):<26}")
        print(line + "|", file=self.out, flush=True)
