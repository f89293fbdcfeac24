"""kanzi-compatible command line interface.

Mirrors src/app/Kanzi.cpp: modes -c/-d/-y(info); flags -i -o -b -t -e -j
-v(0..5) -l(0..9) -s(skip incompressible) -x/-x32/-x64 -f --rm --from/--to
--skip-links --skip-dot-files --no-file-reorder, plus --device (the torch
device of the entropy kernels; default: the CUDA device). Level table:
BlockCompressor::getTransformAndCodec (src/app/BlockCompressor.cpp:
556-613); default block sizes 4 MiB (l1-5) / 8 (l6) / 16 (l7-8) / 32 (l9)
(:120-139); auto block = fileSize/jobs clamped [1 KiB, 1 GiB] 64-aligned
(:334-339).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from kanzi_tpu_torch import __version__
from kanzi_tpu_torch.core.context import Context
from kanzi_tpu_torch.core.errors import Error, KanziError
from kanzi_tpu_torch.io.compressed_stream import (CompressedReader, CompressedWriter,
                                            MAX_BLOCK_SIZE, MIN_BLOCK_SIZE)
from kanzi_tpu_torch.io import ioutil

DEFAULT_BLOCK_SIZE = 4 * 1024 * 1024

LEVEL_TABLE = {
    0: ("NONE", "NONE"),
    1: ("LZX", "NONE"),
    2: ("DNA+LZ", "HUFFMAN"),
    3: ("TEXT+UTF+PACK+MM+LZX", "HUFFMAN"),
    4: ("TEXT+UTF+EXE+PACK+MM+ROLZ", "NONE"),
    5: ("TEXT+UTF+BWT+RANK+ZRLT", "ANS0"),
    6: ("TEXT+UTF+BWT+SRT+ZRLT", "FPAQ"),
    7: ("LZP+TEXT+UTF+BWT+LZP", "CM"),
    8: ("EXE+RLT+TEXT+UTF+DNA", "TPAQ"),
    9: ("EXE+RLT+TEXT+UTF+DNA", "TPAQX"),
}

LEVEL_BLOCK_SIZE = {6: 2 * DEFAULT_BLOCK_SIZE, 7: 4 * DEFAULT_BLOCK_SIZE,
                    8: 4 * DEFAULT_BLOCK_SIZE, 9: 8 * DEFAULT_BLOCK_SIZE}


def parse_block_size(s: str) -> int:
    s = s.strip().upper()
    mult = 1
    if s.endswith("K"):
        mult, s = 1024, s[:-1]
    elif s.endswith("M"):
        mult, s = 1024 * 1024, s[:-1]
    elif s.endswith("G"):
        mult, s = 1 << 30, s[:-1]
    return int(float(s) * mult)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kanzi-tpu-torch",
        description="Kanzi-TPU-Torch %s — lossless data compression on "
                    "CUDA (bitstream-compatible with kanzi)" % __version__,
        add_help=True)
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("-c", "--compress", action="store_true")
    mode.add_argument("-d", "--decompress", action="store_true")
    mode.add_argument("-y", "--info", action="store_true",
                      help="display headers of compressed files")
    p.add_argument("-i", "--input", action="append", default=[])
    p.add_argument("-o", "--output", default="")
    p.add_argument("-b", "--block", default=None,
                   help="block size (e.g. 4m, 16k, auto)")
    p.add_argument("-t", "--transform", default=None,
                   help="transform chain, e.g. BWT+RANK+ZRLT")
    p.add_argument("-e", "--entropy", default=None,
                   help="entropy codec: NONE|HUFFMAN|ANS0|ANS1|RANGE|FPAQ|CM|TPAQ|TPAQX")
    p.add_argument("-l", "--level", type=int, default=None,
                   help="compression level 0..9")
    p.add_argument("-j", "--jobs", type=int, default=1)
    p.add_argument("-v", "--verbose", type=int, default=1)
    p.add_argument("-s", "--skip", action="store_true",
                   help="skip incompressible blocks")
    p.add_argument("-x", "--checksum", nargs="?", const="32", default=None,
                   help="block checksum (32 or 64 bits)")
    p.add_argument("-f", "--force", action="store_true",
                   help="overwrite output")
    p.add_argument("--rm", action="store_true", help="remove input after success")
    p.add_argument("--from", dest="from_block", type=int, default=None)
    p.add_argument("--to", dest="to_block", type=int, default=None)
    p.add_argument("--skip-links", action="store_true")
    p.add_argument("--skip-dot-files", action="store_true")
    p.add_argument("--no-file-reorder", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device of the entropy kernels "
                        "(default: the CUDA device)")
    p.add_argument("--version", action="version",
                   version=f"Kanzi-TPU-Torch {__version__} (bitstream v6)")
    return p


def _resolve_codec(args):
    level = args.level
    if level is not None:
        if not 0 <= level <= 9:
            raise KanziError(f"Invalid compression level: {level}",
                             Error.ERR_INVALID_PARAM)
        transform, entropy = LEVEL_TABLE[level]
        if args.transform or args.entropy:
            raise KanziError("Cannot provide both a compression level and "
                             "transform/entropy", Error.ERR_INVALID_PARAM)
    else:
        transform = args.transform
        entropy = args.entropy
        if transform is None and entropy is None:
            transform, entropy = LEVEL_TABLE[3]
            level = 3
        transform = transform or "NONE"
        entropy = entropy or "NONE"
    return level, transform, entropy


def _block_size_for(args, level, file_size=None):
    if args.block and args.block.lower() == "auto":
        if file_size is not None and args.jobs > 0:
            bl = file_size // max(args.jobs, 1)
            return max(min((bl + 63) & ~63, MAX_BLOCK_SIZE), MIN_BLOCK_SIZE)
        return DEFAULT_BLOCK_SIZE
    if args.block:
        bs = parse_block_size(args.block)
        if bs < MIN_BLOCK_SIZE:
            raise KanziError(f"Minimum block size is 1 KiB, got {bs}",
                             Error.ERR_BLOCK_SIZE)
        if bs > MAX_BLOCK_SIZE:
            raise KanziError(f"Maximum block size is 1 GiB, got {bs}",
                             Error.ERR_BLOCK_SIZE)
        return bs & -16
    if level is not None:
        return LEVEL_BLOCK_SIZE.get(level, DEFAULT_BLOCK_SIZE)
    return DEFAULT_BLOCK_SIZE


def _checksum_bits(args) -> int:
    if args.checksum is None:
        return 0
    if args.checksum in ("32", ""):
        return 32
    if args.checksum == "64":
        return 64
    raise KanziError(f"Invalid checksum size: {args.checksum}",
                     Error.ERR_INVALID_PARAM)


def compress_file(in_path, out_path, args, level, transform, entropy,
                  verbose=1):
    file_size = None if in_path == "-" else os.path.getsize(in_path)
    block_size = _block_size_for(args, level, file_size)
    ctx = Context()
    if args.skip:
        ctx.put("skipBlocks", 1)
    ctx.put("verbosity", args.verbose)
    if file_size is not None:
        ctx.put("fileSize", file_size)
    t0 = time.time()
    src = sys.stdin.buffer if in_path == "-" else open(in_path, "rb")
    dst = sys.stdout.buffer if out_path == "-" else open(out_path, "wb")
    read = 0
    try:
        w = CompressedWriter(dst, transform=transform, entropy=entropy,
                             block_size=block_size,
                             checksum_bits=_checksum_bits(args),
                             original_size=file_size or 0, jobs=args.jobs,
                             ctx=ctx, device=args.device)
        if verbose > 2:
            from kanzi_tpu_torch.app.info_printer import COMPRESSION, InfoPrinter
            w.listeners.add(InfoPrinter(verbose, COMPRESSION))
        while True:
            chunk = src.read(65536)
            if not chunk:
                break
            read += len(chunk)
            w.write(chunk)
        w.close()
    finally:
        if in_path != "-":
            src.close()
        if out_path != "-":
            dst.close()
    dt = time.time() - t0
    out_size = None if out_path == "-" else os.path.getsize(out_path)
    if verbose >= 1 and out_size is not None:
        ratio = out_size / read if read else 0
        print(f"Compressed {in_path}:  {read} => {out_size} "
              f"({100 * ratio:.2f}%) in {1000 * dt:.0f} ms", file=sys.stderr)
    if verbose >= 2 and out_size is not None and dt > 0:
        print(f"Throughput (KiB/s): {read / 1024 / dt:.0f}",
              file=sys.stderr)
    if args.rm and in_path != "-":
        os.remove(in_path)
    return read, out_size


def decompress_file(in_path, out_path, args, verbose=1):
    """Streaming decode: the compressed input is read incrementally and
    each decoded block is written out as it completes (peak memory is
    O(block size), CompressedInputStream.cpp:336-508)."""
    t0 = time.time()
    in_size = None if in_path == "-" else os.path.getsize(in_path)
    src = sys.stdin.buffer if in_path == "-" else open(in_path, "rb")
    dst = sys.stdout.buffer if out_path == "-" else open(out_path, "wb")
    ctx = Context({"verbosity": args.verbose, "inputName": in_path,
                   "fileSize": in_size or 0})
    written = 0
    try:
        r = CompressedReader(src, jobs=args.jobs, ctx=ctx,
                             device=args.device)
        if verbose > 2:
            from kanzi_tpu_torch.app.info_printer import (DECOMPRESSION,
                                                    InfoPrinter)
            r.listeners.add(InfoPrinter(verbose, DECOMPRESSION))
            r.emit_header_event()
        kwargs = {}
        if args.from_block is not None:
            kwargs["from_block"] = args.from_block
        if args.to_block is not None:
            kwargs["to_block"] = args.to_block
        for block in r.read_blocks_np(**kwargs):
            dst.write(block)
            written += len(block)
        # Full-range decode with a size-bearing header: the decoded byte
        # count must match (BlockDecompressor.cpp:816-826, ERR_INVALID_FILE)
        if (not kwargs and r.output_size
                and written != r.output_size):
            raise KanziError(
                f"Corrupted bitstream: invalid output size (expected "
                f"{r.output_size}, got {written})", Error.ERR_INVALID_FILE)
    finally:
        if in_path != "-":
            src.close()
        if out_path != "-":
            dst.close()
    dt = time.time() - t0
    if verbose >= 1:
        print(f"Decompressed {in_path}:  "
              f"{in_size if in_size is not None else '?'} => {written} "
              f"in {1000 * dt:.0f} ms", file=sys.stderr)
    if verbose >= 2 and dt > 0:
        print(f"Throughput (KiB/s): {written / 1024 / dt:.0f}",
              file=sys.stderr)
    if args.rm and in_path != "-":
        os.remove(in_path)
    return in_size, written


def info_file(in_path, args, printer):
    """-y: header table + first-block validation (the reference runs a
    decompression of block 1 with a NULL sink and an INFO printer,
    src/app/BlockDecompressor.cpp:78-115). printer: the run's INFO
    printer, one for all its files."""
    data = open(in_path, "rb").read()
    ctx = Context({"verbosity": args.verbose, "inputName": in_path,
                   "fileSize": len(data)})
    r = CompressedReader(data, ctx=ctx, device=args.device)
    r.listeners.add(printer)
    r.emit_header_event()
    try:
        r.read_all(from_block=1, to_block=2)   # decode block 1 (validation)
    except Exception as e:
        print(f"Warning: block 1 failed to decode: {e}", file=sys.stderr)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    verbose = args.verbose
    if verbose >= 1:
        print(f"Kanzi-TPU-Torch {__version__} (c) 2026", file=sys.stderr)
    try:
        if not (args.compress or args.decompress or args.info):
            raise KanziError("Missing mode: use -c, -d or -y",
                             Error.ERR_MISSING_PARAM)
        if not args.input:
            args.input = ["-"]

        # expand inputs (files/dirs)
        files = []
        for inp in args.input:
            if inp == "-" or inp.upper() == "STDIN":
                files.append(("-", 0))
            else:
                files.extend(ioutil.create_file_list(
                    inp, ignore_links=args.skip_links,
                    ignore_dot_files=args.skip_dot_files))
        if not args.no_file_reorder and len(files) > 1:
            files = ioutil.sort_files_by_path_and_size(files, by_size_first=True)

        if args.info:
            # one printer a run, on the stdout of this call (a printer
            # kept for the process would write to the first caller's)
            from kanzi_tpu_torch.app.info_printer import INFO, InfoPrinter
            printer = InfoPrinter(max(args.verbose, 1), INFO, out=sys.stdout)
            for f, _sz in files:
                info_file(f, args, printer)
            return 0

        level, transform, entropy = (None, None, None)
        if args.compress:
            level, transform, entropy = _resolve_codec(args)

        multi = len(files) > 1
        if multi and args.output:
            raise KanziError("Cannot use -o with multiple input files",
                             Error.ERR_INVALID_PARAM)
        if multi and verbose > 1:
            # concurrent multi-file output would interleave; the reference
            # reduces verbosity the same way (Kanzi.cpp:211-220)
            verbose = 1

        def one(f):
            if args.compress:
                out = args.output or (f + ".knz" if f != "-" else "-")
                if out != "-" and os.path.exists(out) and not args.force:
                    raise KanziError(
                        f"The output file '{out}' exists (use -f to "
                        "overwrite)", Error.ERR_OVERWRITE_FILE)
                compress_file(f, out, args, level, transform, entropy,
                              verbose)
            else:
                if args.output:
                    out = args.output
                elif f.endswith(".knz"):
                    out = f[:-4]
                elif f == "-":
                    out = "-"
                else:
                    out = f + ".out"
                if out != "-" and os.path.exists(out) and not args.force:
                    raise KanziError(
                        f"The output file '{out}' exists (use -f to "
                        "overwrite)", Error.ERR_OVERWRITE_FILE)
                decompress_file(f, out, args, verbose)

        if multi and args.jobs > 1:
            # inter-file data parallelism: a pool of file workers (the
            # reference's FileCompressWorker + BoundedConcurrentQueue,
            # src/app/BlockCompressor.cpp:362-494). The native stages
            # release the GIL, so file workers overlap on real cores.
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(min(args.jobs, len(files))) as pool:
                for res in pool.map(one, [f for f, _sz in files]):
                    pass
        else:
            for f, _sz in files:
                one(f)
        return 0
    except KanziError as e:
        print(str(e) + f". Error code: {int(e.code)}", file=sys.stderr)
        return int(e.code)
    except Exception as e:  # robust decode requirement: no crashes
        print(f"Error: {e}. Error code: {int(Error.ERR_UNKNOWN)}",
              file=sys.stderr)
        return int(Error.ERR_UNKNOWN)


if __name__ == "__main__":
    sys.exit(main())
