#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (kanzi_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):

1. print the card (nvidia-smi name and power limit), CUDA and torch;
2. build the kernels (kanzi_tpu_torch/csrc/*.cu, one nvcc per source,
   all at once);
3. build a 64 MiB mixed corpus from a fixed seed (source text, ELF
   binaries, English-like text, random, sparse alphabet, zeros, runs);
4. run each kernel and its plain PyTorch version on the card and
   require bit-identical results; time both (median of CUDA-event
   times), the one PyTorch call that computes the same function where
   there is one (library_ms), and compute each kernel's bound from the
   bytes and operations of these inputs (D's and F's as one function
   each, split between their two kernels). Kernels A-E at the main
   path's shape (4096 chunks of 16 KiB; A's time also per dependent
   step; B's GB/s and its share of the bound; C also held and timed at
   one 4 MiB block's 256 chunks, the main path's other launch, with ns
   and cycles a step at both sizes, and its step as ptxas scheduled it
   (sass_step) with its chain floor), D's code-table prologue and its
   pack timed apart; E on the
   3840 of them that the card codes and, held and timed apart, on one
   4 MiB block's first 256 (the container's launch), each with ns a
   step, and E's step as ptxas scheduled it (sass_step) with its chain
   floor at the SM clock read during a queue of launches; D's
   prologue also on 512 geometric chunks, whose codes run past 12 bits
   (the length limit and its slow path on the card), every chunk of
   more than one symbol required ok. F (order-1 ANS: F1 the gather, F2
   the chain, timed apart) and G (FPAQ) are held against their plain
   versions on the
   card, timed once, at shapes those finish in seconds (F: 16 chunks of
   64 KiB; G: 64 streams of 8 KiB with 2 KiB FPAQ chunks); against
   their plain versions run on the
   host's CPU, in worker processes of this script started after phase 3
   and read before phase 10, at the container's launch shape of F
   (one 4 MiB chunk) and at the main path's 16 streams and 4 MiB FPAQ
   chunks for G, cut to their first 256 KiB (a plain run over 4 MiB is 32M
   bit steps, about an hour); and they are timed at the main path's
   shape (the corpus as 16 chunks, resp. 16 streams, of 4 MiB), where
   their output is held against the port's native host coders
   (native.ans1_enc_block, the native FPAQ coder, which is timed too:
   the crossover stream count of the container's FPAQ gate). H (the
   FPAQ decode, fpaq_decode) against its plain version on the card at
   G's SMALL_FPAQ streams (bytes, words consumed and end state), and,
   in a worker started in this phase, on the host's CPU at the main
   path's 16 streams of 4 MiB that G encodes, each cut to its first 256
   KiB on the same payload (bytes, words consumed and the state there);
   then timed at those whole streams, its output held against the
   input, with ns a bit step, its step as ptxas scheduled it
   (sass_step) and its chain floor, and the native host decoder timed
   on the same streams. I and J (the CM encode and decode, cm_encode
   and cm_decode) against their plain versions on the card at 16
   streams of 4 KiB (words, counts, bytes, words consumed and end
   state, counters included), and in two workers started in this phase
   on the host's CPU at the main path's 16 streams of 4 MiB cut to their
   first 32 KiB (J on I's whole payload); then each timed at those
   whole streams, I's bytes held against the native CM coder's and J's
   output against the input, with ns a bit step, its byte loop as ptxas
   scheduled it (sass_loop) and its chain floor, the native coder and
   decoder timed on the same streams. The SBRT
   kernels (the forward's sbrt_occ and sbrt_entry, whose entry states
   are held against segment_states_plain, and sbrt_fwd; the inverse's
   sbrt_inv) the same way: against their plain versions on the card at
   16 blocks of 16 KiB with ragged lengths and the forward cut into 1
   KiB segments, in all three modes, both ways; in a worker at
   the level-5 chain's RANK input (the corpus's 16 blocks of 4 MiB
   through the device BWT and its header) cut to 256 KiB a block, RANK
   both ways; and timed at that whole input, each kernel apart, the
   forward whole and the inverse (ns per step of a segment's chain and
   of the inverse's, the share of ranks below 8 and 32), against
   native.sbrt. K (the LZ match pass: each digit pass's lz_count,
   lz_scan and lz_scatter, then lz_lcp) against its plain versions on
   the card, each kernel fed the same inputs as its plain version, at
   one 4 MiB block of the corpus and a 4 MiB block in one bucket (all
   zeros), at hash_log 16 and 19, and on edge inputs (a block of 1 byte,
   one below 8, a repeated byte, a zero tail, random, three tiles' worth
   of text), where lz_match_pass must also equal the numpy model; K's
   device part timed as one CUDA-event span (a caller's pass, and passes
   queued back to back) with each kernel's time beside it (its launches
   of one pass, queued), the plain versions, torch.sort of the keys
   (the step the old design sorted with), and the whole pass with its
   host steps (median of 5 on the host's clock) beside
   native.lzx_forward's parse of the block;
5. the four container paths, each with the launch counters reset just
   before and read just after: the corpus through kanzi_tpu_torch's
   container with -e ANS0, -e HUFFMAN, -e ANS1 and -e FPAQ (-t NONE,
   4 MiB blocks); require a round trip,
   output byte-identical with the host path (the same container with
   kanzi_tpu_torch.ops disabled: the port's native C++ coders), and
   every kernel of the path launched (F once for the 16 ANS1 blocks,
   no compaction B and no chunk coded on the host, huff_host_chunks,
   for Huffman, and E once a block that has a chunk of more than one
   symbol); then one run of each ANS0 and Huffman direction and of the
   ANS1 and FPAQ encodes under torch.profiler (device time by kernel
   and op, the copies' sums by kind, the device's idle share) and under
   cProfile (host self time);
6. round-trip 1 MiB of it through the port at every level 0-9;
7. compress and decompress 16 MiB of it at level 5, at the default level
   (3, no -l) and at level 6 with 256 KiB blocks (64 FPAQ blocks of
   one writer batch, enough for the card's FPAQ gate; level 6's own 8
   MiB blocks make 2, which the gate leaves on the host) through the
   CLI's entry point (kanzi_tpu_torch.app.cli.main, in this process, the
   counters reset just before and read just after), on the card and
   then on the host path: the outputs byte-identical, every kernel of
   the level's path launched (at the default level K's four too, where
   the LZ transform's gate holds at its 4 MiB blocks), both rates
   printed side by side; and the default level's decompress 5 more
   times on each path, in turns, with the medians;
8. the device level-5 chain (kanzi_tpu_torch.parallel.pipeline): the
   corpus through compress_l5_mesh and decompress_l5_mesh at 4 MiB
   blocks, the counters reset before and read after each; require the
   container byte-identical with the host writer's (the same chain with
   kanzi_tpu_torch.ops disabled), both decodes to return the input, the
   SBRT kernels launched both ways (sbrt_occ, sbrt_entry and sbrt_fwd
   on encode, sbrt_inv on decode), A, B and C launched and at least one
   block through the device chain; the device BWT of one block held
   against native.bwt_forward; both rates beside the host path's, and
   one torch.profiler / cProfile breakdown of each direction; then the
   fused chain of kanzi_tpu's bench (pipeline.l5_chain: BWT, RANK, ZRLT
   and the ANS0 encode of 16 blocks of 1 MiB on the card), in MiB/s;
9. the level-2, 3, 6 and 7 mesh chains (compress_l2_mesh,
   compress_l3_mesh, compress_l6_mesh, compress_l7_mesh and their
   decompress_*_mesh): the corpus at 4 MiB blocks and back, the
   counters reset before and read after each call; require the
   container byte-identical with the host writer's, the mesh decode and
   the host reader to return the input, D and E launched for levels 2
   and 3 (E once, every full chunk of the file in one launch, and no
   chunk coded on the host), K and the hinted parse once an LZ block
   where the LZ transform's gate holds (level 3's LZX) and not where it
   does not (level 2's LZ), G and H for level 6 (H once) with all 16
   blocks decoded on the card (l6_decode_device_blocks), I and J once
   each for level 7 with all 16 blocks decoded on the card
   (l7_decode_device_blocks) and none coded on the host
   (cm_host_blocks); both rates beside the host path's, medians of 3
   runs each in turns, and one torch.profiler / cProfile breakdown each
   of the level-2, 6 and 7 decodes and of the level-7 encode;
9b. K's path: the pass as a caller runs it, ops.lz.lz_match_pass over 8
   MiB of the corpus at 4 MiB blocks, at hash_log 16 (LZ) and 19 (LZX),
   the counters reset just before and read just after: lz_count,
   lz_scan and lz_scatter once a digit pass (2 a pass at hash_log 16 and
   19), lz_lcp and lz_match_pass once a pass, each pass's prev and lcp
   equal to match_pass_plain's on the card; then, once the plain
   workers of phase 4 are read (they load the host's CPU, on which this
   part's times are taken), the LZ transform's path: on each 4 MiB
   block of the corpus's first 16 MiB at hash_log 16 and 19 K's pass
   with its copies (lcp back as uint8, and as int32) and the native
   parse that reads its hints (csrc/lzx_hint.cpp), its bytes equal to
   the native parse's, each timed beside the native parse (host wall,
   medians of 5); K's copies step by step; the level 1, 2 and 3 CLI
   compress of the 16 MiB with the transform's gate open, closed and on
   the host path in turns (medians of 3), the outputs equal and
   lz_match_pass and lz_hinted_blocks once an LZ block with the gate
   open; the gate's crossover (levels 1 and 3 at 256 KiB, 1 MiB and 4
   MiB blocks, open and closed in turns, medians of 5); level 3 at -j
   4, the gate closed, open, and open with a CUDA stream a thread;
9c. the block mesh over more than one shard: parallel.dryrun's
   dryrun_multichip over the card named 2 and 3 times (3 shards cut
   some batches unevenly) and, on a machine with several cards, over
   all of them: the l5, l2, l3 and l6 chains at 1 and k shards and l7
   at k, each container byte-identical with the host writer's and
   decoded back, every kernel of a chain launched once a shard, the
   sharded ANS0 round trip and the MESH_SCALING line;
9d. corrupt streams through the decode kernels (while the plain workers
   run): kanzi_tpu_torch.testing.corrupt's corrupt_cases over 1088 KiB
   of the corpus at 256 KiB blocks (payload bytes flipped past the
   headers, ANS0 chunks and Huffman fragments cut short in the sinks
   that feed C and E, FPAQ and CM payloads written 1-3 bytes short,
   level-5 streams whose ZRLT bytes no input makes, one a zero run of
   34 digits) and tests/test_torch_malformed.py's streams, through
   the container's ANS0 and Huffman decodes and the l2, l3, l5, l6 and
   l7 mesh decodes on the card: each outcome (a typed failure or bytes)
   equal to its base path's (device cpu: the plain versions; or the host
   path), no CUDA error, a good stream decoded on the card after each,
   C, E, sbrt_inv, H and J launched;
9e. the C API (after the plain workers): kanzi_tpu_torch/csrc/capi.cpp
   and its script driver tests/test_torch_capi.c built from the
   checkout; the driver, a C program, runs over 16 MiB of the corpus on
   the card in a process of its own (NONE & ANS0, the level-3 chain &
   HUFFMAN, NONE & ANS1 at 4 MiB blocks, NONE & FPAQ at 256 KiB; -j 1
   and 4 for ANS0 and level 3, checksum 64 on one, headerless on one),
   each file byte-identical with the host path's (the driver with
   KANZI_TPU_DISABLE=1) and the in-process Python API's, each decode the
   input, A-G and K launched in the C process (read through its
   embedded interpreter, and counted as this path's launches); its
   MiB/s each way for ANS0 and level 3 beside the Python API's and the
   host path's, medians of 3 in turns, and its first call's seconds;
10. require that neither jax nor kanzi_tpu was imported.

The second-to-last line is a JSON object with each kernel's launches on
its main path, its largest difference from the plain version, its time,
the plain version's, its bound and the library call's; the last line is
{"ok": true, "device": {...}}. Without a CUDA card the script exits
non-zero before printing either. Scratch files go to build/chip_smoke/.
(``chip_smoke.py --plain FILE`` is the worker mode of phase 4.
``chip_smoke.py --kernels`` runs phases 1-3 and phase 4's kernels A-E,
G, H, I, J and SBRT only (G and H against their plain versions on the
card at SMALL_FPAQ, I and J at SMALL_CM, and timed at 16 x 4 MiB against
the native coders, with G's crossover;
SBRT's small checks and its timed RANK input; no plain workers), prints
their lines and no JSON: a short check of those kernels while one of
them is redesigned. ``chip_smoke.py --decoders`` runs phases 1-3 and
phase 4's H, I and J only, as ``--kernels`` runs them: the quick check of
the lockstep binary decoders, ``chip_smoke.py --cm`` I and J alone.
``chip_smoke.py --containers``
runs phases 1-3 and 5 only, no plain workers beside them, and no JSON:
the container rates of two trees compared in one call.
``chip_smoke.py --lz`` runs phases 1-3, phase 4's K, 9b's pass and 9c:
the quick check of the LZ match pass and the mesh. ``chip_smoke.py
--hint`` runs phases 1-3 and 9b's LZ transform part alone. ``chip_smoke.py --lz
TREE`` runs phases 1-3 and times K alone (its device part and the whole
pass at one 4 MiB block, hash_log 16 and 19) with kanzi_tpu_torch
imported from TREE, whichever design of K that tree has: run it parent,
change, change, parent in one call. ``chip_smoke.py --chains
[TREE]`` runs phases 1-3 and times the level-2, level-3 and level-5
mesh chains alone, with kanzi_tpu_torch imported from TREE (default this checkout)
and the corpus made from this checkout: two trees' chain rates compared
on one corpus in one call. ``chip_smoke.py --corrupt`` runs phases 1-3
and 9d alone, ``chip_smoke.py --capi`` phases 1-3 and 9e alone.
``chip_smoke.py --bwt`` runs phase 1 and times the BWT forward's two
routes, native SA-IS and the card's suffix array, by block size: the
crossover behind transform/bwt.py's BWT_DEVICE_MIN_BLOCK.)
"""

import cProfile
import io
import json
import pstats
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
MiB = 1 << 20
SEED = 20261016
BLOCK = 4 * MiB
N_CHUNKS = 4096                     # 64 MiB = one device call of the writer
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
# The kernels' work is 32-bit integer ALU operations. The H100 SXM data
# sheet's 67e12 fp32 rate counts an FMA as two operations on 128 fp32
# lanes an SM; an SM has 64 INT32 lanes (NVIDIA's Hopper architecture
# whitepaper), so its integer issue rate is a quarter of that.
INT32_OPS_PER_S = 67e12 / 4
# integer operations per symbol (per slot for the compaction, per input
# byte for FPAQ: 8 bit steps of ~24, 64-bit operations counted twice),
# counted from the kernels' inner loops; for SBRT per step of the host
# automaton (transform/sbrt.py): read the symbol and its rank, write the
# output, qc (and, and, add, shift), set p, q and the symbol's new rank.
# D and F are each one function computed by two kernels, whose bound is
# split between them (split_bound); each operation of the function is
# counted once, none of the design's own. D's prologue: the fragment
# length sum (extract, look up, shift, add; the table build comes as
# extra operations); D's pack: extract, look up, split length and code,
# shift-or into 64 bits, count, and a word store every ~3 symbols. F1:
# two byte loads, the pair index, the table load, split f and cum, the
# small compare, clz, the bias select, the shift, the LUT load; F2:
# cmplFreq, xmax, compare, select, umulhi, shift, multiply-add, add, the
# slot's select and permute, its store. These count the function's work,
# not a design's: the table loads that H and J make before a bit is known
# for both of its outcomes (H's grandchildren, J's children and the next
# byte's root) are the design's speculative work, not in the bound
OPS = {"ans0_encode_scan": 12, "ans0_compact": 4, "ans0_decode": 12,
       "huff_code_tables": 4, "huff_pack": 12, "huff_decode": 8,
       "ans1_gather": 11, "ans1_chain": 11, "fpaq_encode": 8 * 24,
       "fpaq_decode": 8 * 24, "sbrt": 10, "cm_encode": 8 * 64,
       "cm_decode": 8 * 64, "lz_count": 8, "lz_scan": 0, "lz_scatter": 4,
       "lz_lcp": 0}
# K's function, each operation counted once in the kernel that does it,
# none of the sort's (a design's): the hash a position in lz_count (the
# window from two words and a funnel shift (3), the shift, the 64-bit
# multiply (2), the shift, the key: 8); prev a position in lz_scatter
# (the neighbour's bucket compare, the select, the store: 4); in lz_lcp a
# compare of 8-byte windows (LZ_STEP_OPS: two windows' funnel shifts, the
# xor, the test and the lowest set bit) for each 8 bytes this block's
# prefixes need
LZ_STEP_OPS = 6
# D's table build, per chunk: a sort of its 256 byte counts (256 x 8
# compare-exchanges of 3 operations); per symbol slot its canonical
# code (count its length, its rank among the symbols of that length, the
# code, the pack); per tree node of Moffat-Katajainen (two picks of
# compare, select, load and store)
SORT_OPS = 256 * 8 * 3
CODE_OPS = 8
NODE_OPS = 20
# and per rank its walk visits: test r > 0, read the symbol below and its
# q, compare, move it up (two writes)
SBRT_VISIT_OPS = 6
# I's and J's bit step (64-bit operations counted twice): the bit (2, I
# only) or the compare with current (2, J only), counter1's row (1), its
# three loads (3), p (4), counter2's index (4) and two loads (2), p12 (5),
# the split (subtract, shift, multiply, shift, add: 12), the bound kept
# (6), four counter updates and stores (20), the context (1), the flush
# test (5); the flush's own work, data-dependent, not counted
REPLACES = {
    "ans0_encode_scan": ("ans0.cu", "kanzi_tpu/ops/ans.py:120"),
    "ans0_compact": ("ans0.cu", "kanzi_tpu/ops/ans.py:210"),
    "ans0_decode": ("ans0.cu", "kanzi_tpu/ops/ans.py:568"),
    # D is two kernels: its prologue builds the code tables that kanzi_tpu
    # builds in XLA (compute_code_tables, kanzi_tpu/ops/huffman.py:98) for
    # Pallas kernel 2's gather, which the pack runs
    "huff_code_tables": ("huffman.cu", "kanzi_tpu/ops/ans.py:145"),
    "huff_pack": ("huffman.cu", "kanzi_tpu/ops/ans.py:145"),
    "huff_decode": ("huffman.cu", "kanzi_tpu/ops/huffman.py:317"),
    "ans1_gather": ("ans1.cu", "kanzi_tpu/ops/ans1.py:142"),
    "ans1_chain": ("ans1.cu", "kanzi_tpu/ops/ans1.py:221"),
    "fpaq_encode": ("fpaq.cu", "kanzi_tpu/ops/fpaq.py:286"),
    # H: XLA in kanzi_tpu, no Pallas kernel
    "fpaq_decode": ("fpaq_dec.cu", "kanzi_tpu/ops/fpaq_jnp.py:216"),
    # I and J: XLA in kanzi_tpu, no Pallas kernel
    "cm_encode": ("cm.cu", "kanzi_tpu/ops/cm_jnp.py:186"),
    "cm_decode": ("cm.cu", "kanzi_tpu/ops/cm_jnp.py:291"),
    # SBRT: the forward's three kernels (entry states, then segments)
    # and the inverse
    "sbrt_occ": ("sbrt.cu", "kanzi_tpu/ops/sbrt.py:33"),
    "sbrt_entry": ("sbrt.cu", "kanzi_tpu/ops/sbrt.py:33"),
    "sbrt_fwd": ("sbrt.cu", "kanzi_tpu/ops/sbrt.py:33"),
    "sbrt_inv": ("sbrt.cu", "kanzi_tpu/ops/sbrt.py:33"),
    # K: XLA in kanzi_tpu, no Pallas kernel (its hash, sort, prev and lcp,
    # _match_fn :80-104): a radix sort's count, scan and scatter a digit
    # pass, the last scatter writing prev, then lcp
    "lz_count": ("lz.cu", "kanzi_tpu/ops/lz.py:108"),
    "lz_scan": ("lz.cu", "kanzi_tpu/ops/lz.py:108"),
    "lz_scatter": ("lz.cu", "kanzi_tpu/ops/lz.py:108"),
    "lz_lcp": ("lz.cu", "kanzi_tpu/ops/lz.py:108"),
}
SMALL_ANS1 = (16, 64 << 10)         # F1, F2 against their plain versions
SMALL_FPAQ = (64, 8 << 10, 2048)    # G, H: streams, bytes, FPAQ chunk bytes
HOST_FPAQ_BYTES = 256 << 10         # G's plain run on the CPU: each of the
                                    # 16 main-path streams' first bytes
SMALL_SBRT = 16 << 10               # SBRT against its plain versions on the
                                    # card: 16 blocks of this many bytes,
SMALL_SEGMENT = 1 << 10             # the forward cut into segments of this
HOST_SBRT_BYTES = 256 << 10         # and on the CPU: each RANK input's
                                    # first bytes
# C's and E's step in the SASS: the byte load at the step's index plus
# the table's uniform base (C's residue table; E's length table, whose
# symbol load adds an offset), one in each of C's 16 and E's 64
# unrolled steps
TABLE_ANCHOR = r"LDS\.U8 R\d+, \[R\d+\+UR\d+\]"
# H's step: the upper half of the 64-bit compare of its split with
# `current` (the only unsigned 64-bit compare of the decode), one in each
# of the 8 unrolled bit steps of a byte (a step is counted without its
# flush, whose branch it takes)
FPAQ_DEC_ANCHOR = r"ISETP\.[GL][ET]\.U32\.AND\.EX "
# I's and J's byte loops (sass_loop), each found by an instruction in it:
# I's coder's predicated store of a flush word, which nothing else of the
# kernel makes; J's store of counter2's first updated entry (counter2
# sits at byte 0x20200 of shared memory, after counter1; J also loads it
# before its byte loop, for the first root)
CM_ANCHORS = {"cm_encode": r"@!?P\d STS ",
              "cm_decode": r"STS \[R\d+\+0x20200\]"}
SMALL_CM = (16, 4 << 10)            # I, J against their plain versions on the
                                    # card: streams, bytes
HOST_CM_BYTES = 32 << 10            # and on the CPU: each of the 16 main-path
                                    # streams' first bytes
L5_CHAIN = (16, MiB)                # the fused chain: blocks, bytes
LZ_BYTES = 8 * MiB                  # the LZ match pass's input as a caller
LZ_HINT_BYTES = 16 * MiB            # the LZ transform's, the CLI's
LZ_HINT_SIZES = (256 << 10, MiB, 4 * MiB)   # block sizes of the gate's sweep
WORK = ROOT / "build" / "chip_smoke"


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


T_START = time.perf_counter()


def stamp(phase: str) -> None:
    log(f"phase {phase} starts at {time.perf_counter() - T_START:.1f} s")


def read_files(paths, cap: int) -> bytes:
    buf = bytearray()
    for p in paths:
        try:
            buf += Path(p).read_bytes()
        except OSError:
            continue
        if len(buf) >= cap:
            break
    return bytes(buf[:cap])


def make_corpus(n: int) -> bytes:
    """1 MiB segments cycling through content classes, as bench.py's
    corpus does; the source-text class is this repository's own code."""
    rng = np.random.default_rng(SEED)
    seg = MiB
    code = read_files(sorted(
        str(p) for ext in ("*.py", "*.cpp", "*.md")
        for p in ROOT.rglob(ext)
        if "build" not in p.relative_to(ROOT).parts), 8 * seg)
    usr_bin = Path("/usr/bin")
    elf = read_files(sorted(
        str(p) for p in usr_bin.iterdir()
        if p.is_file() and not p.is_symlink()), 16 * seg)
    words = [b"the", b"of", b"and", b"compression", b"entropy", b"block",
             b"transform", b"stream", b"suffix", b"array", b"kanzi",
             b"parallel", b"device", b"kernel", b"lattice", b"data"]
    eng = b" ".join(words[i] for i in rng.integers(0, len(words), 2 * seg))
    rnd = rng.integers(0, 256, 16 * seg, dtype=np.uint8).tobytes()
    sparse = rng.choice(np.arange(12, dtype=np.uint8), 8 * seg).tobytes()
    runs = np.repeat((37 * np.arange(1, 200001)) & 0xFF,
                     rng.integers(1, 80, 200000)).astype(np.uint8).tobytes()
    classes = [code, elf, eng, rnd, sparse, bytes(8 * seg), runs]
    weights = [3, 3, 2, 3, 2, 1, 1]
    out = bytearray()
    cursors = [0] * len(classes)
    while len(out) < n:
        for k, w in enumerate(weights):
            for _ in range(w):
                c = classes[k]
                s = cursors[k] % max(len(c) - seg, 1)
                out += c[s:s + seg]
                cursors[k] += seg
    return bytes(out[:n])


def median_ms(fn, runs: int) -> float:
    """Median device time of `runs` calls, each bracketed by CUDA events
    after one warm-up call."""
    fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def once_ms(fn):
    """(result, device time in ms) of one call bracketed by CUDA events:
    for the plain versions of F and G, whose one call at a small shape
    takes seconds of launches."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def max_abs_err(a, b) -> int:
    if a.shape != b.shape or a.dtype != b.dtype:
        fail(f"shape/dtype {tuple(a.shape)} {a.dtype} vs "
             f"{tuple(b.shape)} {b.dtype}")
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(name: str, moved: int, items: int, extra_ops: int = 0) -> dict:
    """The least time the card could take: bytes moved (each input read
    once, each output written once) over the memory rate, or the
    operations (OPS per item, plus extra_ops) over the integer rate,
    whichever is larger."""
    t_bytes = 1000 * moved / HBM_BYTES_PER_S
    t_ops = 1000 * (OPS[name] * items + extra_ops) / INT32_OPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def split_bound(parts: dict) -> dict:
    """The bounds of the kernels that compute one function together:
    parts {kernel: (bytes, operations)}, the function's bytes (its inputs
    read once, its outputs written once; not the scratch between the
    kernels) and operations, each in the share of the one kernel that
    reads, writes or does it. The function's bound is the larger of its
    bytes and operations times; each kernel gets its share of the one
    that binds, so the kernels' bounds add up to the function's."""
    t_bytes = {k: 1000 * b / HBM_BYTES_PER_S for k, (b, _) in parts.items()}
    t_ops = {k: 1000 * o / INT32_OPS_PER_S for k, (_, o) in parts.items()}
    by_bytes = sum(t_bytes.values()) >= sum(t_ops.values())
    t = t_bytes if by_bytes else t_ops
    return {k: dict(bound_ms=t[k],
                    bound_by="bytes" if by_bytes else "operations")
            for k in parts}


def profile(label: str, fn) -> None:
    """One run of fn under torch.profiler: device time by kernel and
    copy (the 12 largest), and the device's idle share of the run's
    wall time; then one under cProfile: the host functions with the most
    self time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            dev[evt.name] = dev.get(evt.name, 0.0) + evt.time_range.elapsed_us()
    busy = sum(dev.values()) / 1e6
    log(f"profile {label}: device busy {busy * 1000:.3f} ms of {wall:.4f} s "
        f"wall, idle share {1 - busy / wall:.4f}")
    for name, us in sorted(dev.items(), key=lambda kv: -kv[1])[:12]:
        log(f"  device {us / 1000:9.3f} ms  {name[:90]}")
    copies = {k: v for k, v in dev.items() if k.startswith("Memcpy")}
    log("  copies: " + (", ".join(
        f"{k} {v / 1000:.3f} ms" for k, v in sorted(copies.items()))
        or "none"))
    pr = cProfile.Profile()
    pr.enable()
    fn()
    torch.cuda.synchronize()
    pr.disable()
    rows = sorted(pstats.Stats(pr).stats.items(), key=lambda kv: -kv[1][2])
    for (fname, line, func), (_, _, tt, ct, _) in rows[:6]:
        log(f"  host self {tt:8.4f} s  cum {ct:8.4f} s  "
            f"{Path(fname).name}:{line} {func}")


def gather_ms(table, idx) -> float:
    """library_ms of kernels A and D: torch.gather of a per-chunk
    256-entry table at every symbol, the gather that Pallas kernels 1
    and 2 compute alone."""
    table = table.contiguous()
    idx = idx.long()
    return median_ms(lambda: torch.gather(table, 1, idx), 5)


def check_ans0_kernels(chunks, dans) -> dict:
    freqs = dans.normalize(dans.histogram(chunks))
    packed, inv = dans.encode_tables(freqs)
    res = {}

    # A: encode scan
    got = dans.ans0_encode_scan(chunks, packed, inv)
    ref = dans.ans0_encode_scan_plain(chunks, packed, inv)
    states, vm, nren = got
    # and a batch that leaves the kernel's last block of 8 chunks ragged
    ragged = dans.ans0_encode_scan(chunks[:13], packed[:13], inv[:13])
    res["ans0_encode_scan"] = dict(
        err=max(max_abs_err(g, r) for g, r in zip(
            got + ragged, ref + tuple(x[:13] for x in ref))),
        ms=median_ms(lambda: dans.ans0_encode_scan(chunks, packed, inv), 5),
        plain_ms=median_ms(
            lambda: dans.ans0_encode_scan_plain(chunks, packed, inv), 2),
        library_ms=gather_ms(packed, chunks),
        **bound("ans0_encode_scan", nbytes(chunks, packed, inv, *got),
                chunks.numel()))

    log(f"kernel A (ans0_encode_scan) at C={chunks.shape[0]}: "
        f"{res['ans0_encode_scan']['ms']} ms, "
        f"{1e6 * res['ans0_encode_scan']['ms'] / dans.STEPS:.2f} ns per "
        f"dependent step ({dans.STEPS} a lane); torch.gather "
        f"{res['ans0_encode_scan']['library_ms']} ms")

    # B: compaction
    plen16 = nren.long().sum(1)
    off16 = plen16.cumsum(0) - plen16
    total16 = int(plen16.sum())
    flat = dans.compact_rows(vm, off16, total16)
    flags = ((vm >> 16) & 1).bool()
    res["ans0_compact"] = dict(
        err=max_abs_err(flat, dans.compact_rows_plain(vm, off16, total16)),
        ms=median_ms(lambda: dans.compact_rows(vm, off16, total16), 5),
        plain_ms=median_ms(
            lambda: dans.compact_rows_plain(vm, off16, total16), 3),
        library_ms=median_ms(lambda: torch.masked_select(vm, flags), 5),
        **bound("ans0_compact", nbytes(vm, off16, flat), vm.numel()))
    r = res["ans0_compact"]
    log(f"kernel B (ans0_compact) at {vm.shape[0]} rows: {r['ms']} ms, "
        f"{nbytes(vm, off16, flat) / r['ms'] / 1e6:.1f} GB/s, "
        f"{r['bound_ms'] / r['ms']:.1%} of its bound ({r['bound_by']})")

    # C: decode, of the compacted payload just produced
    f2s, fc = dans.decode_tables(freqs)
    off_bytes = 2 * off16
    got = dans.ans0_decode(f2s, fc, states, flat, off_bytes)
    ref = dans.ans0_decode_plain(f2s, fc, states, flat, off_bytes)
    res["ans0_decode"] = dict(
        err=max(max_abs_err(g, r) for g, r in zip(got, ref)),
        ms=median_ms(
            lambda: dans.ans0_decode(f2s, fc, states, flat, off_bytes), 5),
        plain_ms=median_ms(
            lambda: dans.ans0_decode_plain(f2s, fc, states, flat, off_bytes),
            2),
        library_ms=None,
        **bound("ans0_decode",
                nbytes(f2s, fc, states, flat, off_bytes, *got),
                chunks.numel()))
    multi = (freqs > 0).sum(1) > 1           # single-symbol chunks: no payload
    if not torch.equal(got[0][multi], chunks[multi]):
        fail("ans0_decode does not round-trip the encoded chunks")
    if not torch.equal(got[1][multi].long(), 2 * plen16[multi]):
        fail("ans0_decode consumed a different payload size")
    # and at one 4 MiB block's launch: its 256 chunks and their payload
    k = BLOCK // dans.CHUNK
    one = (f2s[:k], fc[:k], states[:k],
           flat[:int(2 * (off16[k - 1] + plen16[k - 1]))], off_bytes[:k])
    got = dans.ans0_decode(*one)
    ref = dans.ans0_decode_plain(*one)
    res["ans0_decode"]["err"] = max(
        res["ans0_decode"]["err"],
        *(max_abs_err(g, r) for g, r in zip(got, ref)))
    ms_one = median_ms(lambda: dans.ans0_decode(*one), 9)
    res["ans0_decode"]["shape"] = (f"C={len(f2s)}; one block's {k}: "
                                   f"{ms_one} ms")
    # the SM clock during a queue of launches, and ptxas's step
    ms = res["ans0_decode"]["ms"]
    for _ in range(int(300 / ms)):
        dans.ans0_decode(f2s, fc, states, flat, off_bytes)
    time.sleep(0.1)
    mhz = sm_clock_mhz()
    torch.cuda.synchronize()
    from kanzi_tpu_torch.ops import _build
    n_ins, stall = sass_step(_build.library_path("ans0.cu"),
                             "ans0_decode_kernel", TABLE_ANCHOR,
                             unrolled=16)
    steps = dans.STEPS
    log(f"kernel C (ans0_decode): {len(f2s)} chunks {ms} ms, "
        f"{1e6 * ms / steps:.2f} ns per step ({steps} a lane), "
        f"{ms * mhz / steps * 1e3:.1f} cycles; one block's {k} chunks "
        f"{ms_one} ms, {1e6 * ms_one / steps:.2f} ns per step, "
        f"{ms_one * mhz / steps * 1e3:.1f} cycles, at the {mhz} MHz SM "
        f"clock read during a queue of launches; ptxas's schedule "
        f"(cuobjdump -sass): {n_ins} instructions and {stall} static "
        f"stall cycles a step, a chain floor of {steps} x {stall} / "
        f"{mhz} MHz = {steps * stall / mhz / 1e3:.4f} ms before the "
        f"shared loads' waits")
    return res


def fragments(enc) -> list:
    """The byte-aligned fragment bitstreams of each ok chunk (its pairs,
    then its residual bits MSB first) from the nine Huffman encode
    outputs, as HuffmanDecoder._read_fragments reads them."""
    _, _, ok, _, flat, npairs, acc, nb, _ = enc
    out, base = [], 0
    for ci in range(len(ok)):
        for f in range(4):
            k = int(npairs[ci, f])
            raw = flat[2 * base:2 * (base + k)].tobytes()
            base += k
            r = int(nb[ci, f])
            if ok[ci] and r:
                v = (int(acc[ci, f]) & ((1 << r) - 1)) << (16 - r)
                raw += v.to_bytes(2, "big")[:(r + 7) // 8]
            if ok[ci]:
                out.append(raw)
    return out


def geometric_chunks(n: int) -> np.ndarray:
    """n chunks of geometric bytes, chunk i from seed i: a long tail of
    rare symbols, so that many codes run past 12 bits (the test suite's
    _geometric); seeds 90, 263 and 348 take the length limit's slow path,
    90 then its 8-bit codes."""
    out = np.empty((n, 16384), np.uint8)
    for i in range(n):
        rng = np.random.default_rng(i)
        out[i] = rng.geometric(rng.uniform(0.3, 0.7), 16384)
    return out


def coded_blocks(corpus: bytes) -> int:
    """The corpus's 4 MiB blocks that hold a 16 KiB chunk of more than
    one symbol: those the Huffman decode hands to kernel E."""
    a = np.frombuffer(corpus, np.uint8).reshape(-1, BLOCK // 16384, 16384)
    return int((a != a[:, :, :1]).any(2).any(1).sum())


def length_limits(dhuff, hist) -> tuple:
    """(chunks whose code runs past 12 bits, chunks of those that take
    the limit's slow path), from the plain version's limit."""
    lens, sbr, m = dhuff.code_lengths_by_rank(hist)
    over = (m > 1) & (lens[:, 0] > dhuff.MAX_SYMBOL_SIZE)
    slow = dhuff.limit_code_lengths(lens, sbr, m, hist)[2]
    return int(over.sum()), int(slow.sum())


def check_huffman_kernels(chunks, dhuff) -> tuple:
    hist = dhuff.histogram(chunks)
    tables_ms = median_ms(lambda: dhuff.compute_code_tables(hist), 3)
    res = {}

    # D's prologue on chunks past 12 bits, the slow path's among them
    geo = torch.from_numpy(geometric_chunks(512)).to(chunks.device)
    geo_hist = dhuff.histogram(geo)
    got = dhuff.huff_code_tables(geo, geo_hist)
    ref = dhuff.huff_code_tables_plain(geo, geo_hist)
    geo_err = max(max_abs_err(g, r) for g, r in zip(got, ref))
    over, slow = length_limits(dhuff, geo_hist)
    log(f"kernel huff_code_tables on {len(geo)} geometric chunks: "
        f"max_abs_err {geo_err} against its plain version; {over} codes "
        f"past 12 bits, {slow} of them through the limit's slow path; "
        f"{int(got[4].sum())} ok")
    if slow < 1 or not torch.equal(got[4], got[3] > 1):
        fail("huff_code_tables: the geometric chunks did not take the "
             "slow path, or a chunk of more than one symbol is not ok")

    # D's prologue: code tables and each fragment's bit count
    got = dhuff.huff_code_tables(chunks, hist)
    ref = dhuff.huff_code_tables_plain(chunks, hist)
    codes, sizes, maxlen, m, ok, bits = got
    res["huff_code_tables"] = dict(
        err=max(geo_err, *(max_abs_err(g, r) for g, r in zip(got, ref))),
        ms=median_ms(lambda: dhuff.huff_code_tables(chunks, hist), 5),
        plain_ms=median_ms(
            lambda: dhuff.huff_code_tables_plain(chunks, hist), 2),
        library_ms=None)

    # D's pack: the pair stream (its used front), acc, nb, npairs, at the
    # offsets that huff_encode_scan cumsums from the bit counts
    off16 = dhuff.pair_offsets(ok, bits)
    got = dhuff.huff_pack(chunks, codes, ok, off16)
    ref = dhuff.huff_pack_plain(chunks, codes, ok, off16)
    npairs = got[3].long().view(-1)
    n16 = int(npairs.sum())
    err = max(max_abs_err(g, r) for g, r in zip(got[1:], ref[1:]))
    err = max(err, max_abs_err(got[0][:2 * n16], ref[0][:2 * n16]),
              max_abs_err(off16.view(-1), npairs.cumsum(0) - npairs))
    res["huff_pack"] = dict(
        err=err,
        ms=median_ms(lambda: dhuff.huff_pack(chunks, codes, ok, off16), 5),
        plain_ms=median_ms(
            lambda: dhuff.huff_pack_plain(chunks, codes, ok, off16), 2),
        library_ms=gather_ms(codes, chunks))
    # D's function: chunks and hist in; the tables, the used pairs,
    # offsets, acc, nb and npairs out (bits is scratch between the two)
    c = chunks.shape[0]
    table_ops = ((SORT_OPS + 256 * CODE_OPS) * c
                 + NODE_OPS * int(m.long().sum()))
    for k, v in split_bound({
            "huff_code_tables": (
                nbytes(chunks, hist, codes, sizes, maxlen, m, ok),
                OPS["huff_code_tables"] * chunks.numel() + table_ops),
            "huff_pack": (nbytes(off16, *got[1:]) + 2 * n16,
                          OPS["huff_pack"] * chunks.numel())}).items():
        res[k].update(v)
    whole_ms = median_ms(lambda: dhuff.huff_encode_scan(chunks, hist), 5)
    log(f"kernel D (huff_encode_scan = huff_code_tables, pair_offsets' "
        f"cumsum, huff_pack) at C={c}: {whole_ms} ms; prologue "
        f"{res['huff_code_tables']['ms']} ms, pack {res['huff_pack']['ms']} "
        f"ms; {2 * n16} pair bytes written")

    # E: decode of the same chunks' fragments
    enc = dhuff.encode_chunks_np(chunks.cpu().numpy(), chunks.device)
    parts = fragments(enc)
    sel = torch.from_numpy(np.nonzero(enc[2])[0]).to(chunks.device)
    dev = chunks.device
    pay = torch.from_numpy(np.frombuffer(b"".join(parts), np.uint8).copy()
                           ).to(dev)
    bounds = torch.from_numpy(np.cumsum(
        [0] + [len(p) for p in parts], dtype=np.int64)).to(dev)
    tbl = dhuff.decode_table(codes[sel] & 0xFFF, sizes[sel])
    got = dhuff.huff_decode(tbl, pay, bounds)
    ref = dhuff.huff_decode_plain(tbl, pay, bounds)
    res["huff_decode"] = dict(
        err=max_abs_err(got, ref),
        ms=median_ms(lambda: dhuff.huff_decode(tbl, pay, bounds), 5),
        plain_ms=median_ms(
            lambda: dhuff.huff_decode_plain(tbl, pay, bounds), 2),
        library_ms=None,
        **bound("huff_decode", nbytes(tbl, pay, bounds, got), got.numel()))
    if not torch.equal(got, chunks[sel]):
        fail("huff_decode does not round-trip the encoded chunks")
    # and at the main path's launch: one 4 MiB block's chunks, the first
    # 256 that the card codes
    k = BLOCK // dhuff.CHUNK
    one = (tbl[:k], pay[:int(bounds[4 * k])], bounds[:4 * k + 1])
    got = dhuff.huff_decode(*one)
    res["huff_decode"]["err"] = max(res["huff_decode"]["err"],
                                    max_abs_err(got,
                                                dhuff.huff_decode_plain(*one)))
    ms_one = median_ms(lambda: dhuff.huff_decode(*one), 9)
    res["huff_decode"]["shape"] = (f"C={len(tbl)}, the chunks the card "
                                   f"codes; one block's {k}: {ms_one} ms")
    # the SM clock during a queue of launches, and ptxas's step
    ms = res["huff_decode"]["ms"]
    for _ in range(int(300 / ms)):
        dhuff.huff_decode(tbl, pay, bounds)
    time.sleep(0.1)
    mhz = sm_clock_mhz()
    torch.cuda.synchronize()
    from kanzi_tpu_torch.ops import _build
    n_ins, stall = sass_step(_build.library_path("huffman.cu"),
                             "huff_decode_kernel", TABLE_ANCHOR,
                             unrolled=64)
    steps = dhuff.FRAG
    log(f"kernel E (huff_decode): {len(tbl)} chunks {ms} ms, "
        f"{1e6 * ms / steps:.2f} ns per step ({steps} a fragment); one "
        f"block's {k} chunks (the main path's launch) {ms_one} ms, "
        f"{1e6 * ms_one / steps:.2f} ns per step, "
        f"{ms_one * mhz / steps * 1e3:.1f} cycles at the {mhz} MHz SM "
        f"clock read during a queue of launches; ptxas's schedule "
        f"(cuobjdump -sass): {n_ins} instructions and {stall} static "
        f"stall cycles a step, a chain floor of {steps} x {stall} / "
        f"{mhz} MHz = {steps * stall / mhz / 1e3:.4f} ms before the "
        f"shared loads' waits")
    over, slow = length_limits(dhuff, hist)
    log(f"huffman: {int(ok.sum())} of {len(ok)} chunks coded on the card "
        f"(the rest: one symbol, a header only); {over} codes past 12 "
        f"bits limited on the card, {slow} of them through the slow path; "
        f"code tables alone in plain torch (compute_code_tables, "
        f"{len(ok)} chunks, median): {tables_ms} ms")
    if not torch.equal(ok, m > 1):
        fail("huff_code_tables: a chunk of more than one symbol is not ok")
    return res


def plain_worker(path: Path) -> None:
    """Worker mode: run one plain version on the CPU on the inputs saved
    at path, save its outputs and seconds beside them."""
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    from kanzi_tpu_torch.ops import ans1 as dans1
    from kanzi_tpu_torch.ops import cm as dcm
    from kanzi_tpu_torch.ops import fpaq as dfp
    from kanzi_tpu_torch.ops import sbrt as dsb
    a = torch.load(path)
    t0 = time.perf_counter()
    if a["kind"] == "ans1_encode_scan":
        out = dans1.ans1_chain_plain(dans1.ans1_gather_plain(
            a["chunks"], a["table"], a["lut"]))
    elif a["kind"] == "sbrt":
        fwd = dsb.sbrt_plain(a["blocks"], a["lens"], dsb.MODE_RANK, False)
        out = (fwd, dsb.sbrt_plain(fwd, a["lens"], dsb.MODE_RANK, True))
    elif a["kind"] == "fpaq_decode":
        out = dfp.fpaq_decode_plain(*a["args"], a["chunk"],
                                    *dfp.fpaq_init_state(len(a["args"][5])))
    elif a["kind"] == "cm_encode":
        words, cnt, st = dcm.cm_encode_plain(
            a["streams"], a["lens"], a["cap"],
            dcm.cm_init_state(len(a["lens"]), 6))
        out = (words, cnt, *st)
    elif a["kind"] == "cm_decode":
        dec, consumed, st = dcm.cm_decode_plain(
            *a["args"], dcm.cm_init_state(len(a["args"][4]), 6))
        out = (dec, consumed, *st)
    else:
        out = dfp.fpaq_encode_plain(a["streams"], a["lens"], a["chunk_win"],
                                    a["cap"])
    torch.save({"out": list(out), "seconds": time.perf_counter() - t0},
               path.with_suffix(".out"))


def start_plain_workers(corpus, dans1, dfp, native, rank_in) -> dict:
    """Save the full-shape inputs of F, G and SBRT (see phase 4) and start
    one worker process on each. Returns {kernel: (inputs, process)}."""
    host = np.frombuffer(corpus[:dans1.CHUNK1], np.uint8)[None]
    f_in = {"kind": "ans1_encode_scan",
            "chunks": torch.from_numpy(host.copy()),
            "table": dans1.encode_table(torch.from_numpy(
                ans1_freqs(host, native))),
            "lut": dans1.INV_LUT}
    streams = np.frombuffer(corpus, np.uint8).reshape(-1, dfp.CHUNK_B)
    g_in = {"kind": "fpaq_encode",
            "streams": torch.from_numpy(
                streams[:, :HOST_FPAQ_BYTES].copy()),
            "lens": torch.full((len(streams),), HOST_FPAQ_BYTES,
                               dtype=torch.int64),
            "chunk_win": dfp.CHUNK_B // dfp.WIN_B,
            "cap": HOST_FPAQ_BYTES // dfp.WIN_B * dfp.REGION_W}
    s_in = {"kind": "sbrt",
            "blocks": rank_in[:, :HOST_SBRT_BYTES].cpu().contiguous(),
            "lens": torch.full((len(rank_in),), HOST_SBRT_BYTES,
                               dtype=torch.int64)}
    return {a["kind"]: start_worker(a) for a in (f_in, g_in, s_in)}


def start_worker(a: dict) -> tuple:
    """Save one plain version's inputs and start a worker process of
    this script on them. Returns (inputs, process)."""
    path = WORK / f"plain_{a['kind']}.pt"
    torch.save(a, path)
    err = open(path.with_suffix(".err"), "w")
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--plain",
         str(path)], stdout=subprocess.DEVNULL, stderr=err)
    err.close()
    return a, proc


# the kernels that each worker's plain version checks
WORKER_KERNELS = {"ans1_encode_scan": ("ans1_gather", "ans1_chain"),
                  "fpaq_encode": ("fpaq_encode",),
                  "fpaq_decode": ("fpaq_decode",),
                  "cm_encode": ("cm_encode",), "cm_decode": ("cm_decode",),
                  "sbrt": ("sbrt_occ", "sbrt_entry", "sbrt_fwd", "sbrt_inv")}


def finish_plain_workers(workers, full_got, kres) -> None:
    """Wait for the workers, hold the kernels' outputs on the same
    inputs (full_got) against theirs, fold the difference into kres'
    max_abs_err and fail on any."""
    for k, (a, proc) in workers.items():
        path = WORK / f"plain_{k}.pt"
        if proc.wait(timeout=900) != 0:
            fail(f"the plain worker of {k} exited {proc.returncode}: "
                 f"{path.with_suffix('.err').read_text()[-2000:]}")
        res = torch.load(path.with_suffix(".out"))
        err = max(max_abs_err(g, r) for g, r in zip(full_got[k], res["out"]))
        shape = a.get("shape") or "x".join(map(str, next(
            a[key] for key in ("chunks", "streams", "blocks")
            if key in a).shape))
        log(f"kernel {k}: max_abs_err {err} against its plain version on "
            f"the host's CPU at [{shape}] (plain {res['seconds']:.3f} s)")
        for name in WORKER_KERNELS[k]:
            kres[name]["err"] = max(kres[name]["err"], err)
        if err != 0:
            fail(f"{k} differs from its plain version on the host's CPU")


def ans1_freqs(host_chunks, native):
    return np.stack([native.ans1_norm(native.ans1_hist(ch))
                     for ch in host_chunks])


def check_ans1_kernel(corpus, dans1, native, dev, f_in, full_got) -> dict:
    """F1 and F2 against their plain versions at SMALL_ANS1, then timed
    apart at the main path's shape: the corpus as 4 MiB order-1 chunks,
    16 a call, whose bitstream (headers from the native helpers, states
    and payload from F1, F2 and B in one launch each) must equal
    native.ans1_enc_block's. Their outputs on f_in (one 4 MiB chunk, timed
    too) go to full_got for the plain worker's check."""
    from kanzi_tpu_torch.bitstream import BitWriter
    from kanzi_tpu_torch.core.context import Context
    from kanzi_tpu_torch.entropy.ans import ANSRangeEncoder
    lut = dans1.INV_LUT.to(dev)
    n, size = SMALL_ANS1
    host = np.frombuffer(corpus[:n * size], np.uint8).reshape(n, size)
    small = torch.from_numpy(host.copy()).to(dev)
    table = dans1.encode_table(torch.from_numpy(ans1_freqs(host, native))
                               .to(dev))
    consts = dans1.ans1_gather(small, table, lut)
    ref_consts, plain_g_ms = once_ms(
        lambda: dans1.ans1_gather_plain(small, table, lut))
    err_g = max_abs_err(consts, ref_consts)
    got = dans1.ans1_chain(ref_consts)
    ref, plain_c_ms = once_ms(lambda: dans1.ans1_chain_plain(ref_consts))
    err_c = max(max_abs_err(g, r) for g, r in zip(got, ref))
    del consts, ref_consts
    one = [f_in[k].to(dev) for k in ("chunks", "table", "lut")]
    full_got["ans1_encode_scan"] = [
        t.cpu() for t in dans1.ans1_encode_scan(*one)]
    ms_one = median_ms(lambda: dans1.ans1_encode_scan(*one), 3)
    del one

    host = np.frombuffer(corpus, np.uint8).reshape(-1, dans1.CHUNK1)
    chunks = torch.from_numpy(host.copy()).to(dev)
    table = dans1.encode_table(torch.from_numpy(ans1_freqs(host, native))
                               .to(dev))
    ms_g = median_ms(lambda: dans1.ans1_gather(chunks, table, lut), 3)
    consts = dans1.ans1_gather(chunks, table, lut)
    ms_c = median_ms(lambda: dans1.ans1_chain(consts), 3)
    states, vm = dans1.ans1_chain(consts)
    ms = median_ms(lambda: dans1.ans1_encode_scan(chunks, table, lut), 3)
    idx = dans1.build_sym_idx(chunks).long()
    library_ms = median_ms(lambda: torch.gather(table, 1, idx), 3)
    del idx
    block = np.frombuffer(corpus, np.uint8)
    w = BitWriter()
    enc = ANSRangeEncoder(w, Context({"device": str(dev)}), order=1)
    if enc._encode_device1(block, len(block)) != len(block):
        fail("ans1: the corpus is not whole 4 MiB order-1 chunks")
    data, nbits = native.ans1_enc_block(block, dans1.CHUNK1,
                                        dans1.LOG_RANGE1)
    if w.written() != nbits or w.getvalue() != data.tobytes():
        fail("ans1: the card's order-1 bitstream differs from "
             "native.ans1_enc_block's")
    q = dans1.CHUNK1 // 4
    log(f"kernel F (ans1_encode_scan = ans1_gather, ans1_chain): "
        f"{len(host)} chunks of 4 MiB, 4 lanes x {q} steps each: {ms} ms; "
        f"F1 ans1_gather {ms_g} ms, F2 ans1_chain {ms_c} ms, "
        f"{1e6 * ms_c / q:.2f} ns per dependent step; at one chunk "
        f"{ms_one} ms; plain_ms F1 {plain_g_ms}, F2 {plain_c_ms} at {n} "
        f"chunks of {size >> 10} KiB (once); bitstream == "
        f"native.ans1_enc_block")
    # F's function: chunks, tables and LUT in, states and vm out (the
    # constant words are scratch between F1 and F2)
    b = split_bound({
        "ans1_gather": (nbytes(chunks, table, lut),
                        OPS["ans1_gather"] * chunks.numel()),
        "ans1_chain": (nbytes(states, vm),
                       OPS["ans1_chain"] * chunks.numel())})
    return {
        "ans1_gather": dict(err=err_g, ms=ms_g, plain_ms=plain_g_ms,
                            library_ms=library_ms, **b["ans1_gather"]),
        "ans1_chain": dict(err=err_c, ms=ms_c, plain_ms=plain_c_ms,
                           library_ms=None, **b["ans1_chain"])}


def check_fpaq_kernel(corpus, dfp, native, dev, g_in, full_got) -> dict:
    """G against its plain version at SMALL_FPAQ, then timed at the main
    path's shape: the corpus as 16 streams of 4 MiB (one FPAQ chunk
    each), whose flush bytes and final low (fpaq_encode_batch, the
    container's call) must equal the native host coder's, which is timed
    per stream: the crossover of the container's FPAQ gate is G's time
    over that. Its outputs on g_in go to full_got for the plain
    worker's check (none with --kernels, which starts no worker)."""
    from kanzi_tpu_torch.entropy.native_bin import KIND_FPAQ, _new_handle
    from kanzi_tpu_torch.io.compressed_stream import FPAQ_MIN_STREAMS
    n, size, chunk = SMALL_FPAQ
    small = torch.from_numpy(np.frombuffer(corpus[:n * size], np.uint8)
                             .reshape(n, size).copy()).to(dev)
    lens = torch.full((n,), size, dtype=torch.int64, device=dev)
    cap = size // dfp.WIN_B * dfp.REGION_W
    got = dfp.fpaq_encode(small, lens, chunk // dfp.WIN_B, cap)
    ref, plain_ms = once_ms(
        lambda: dfp.fpaq_encode_plain(small, lens, chunk // dfp.WIN_B, cap))
    err = max(max_abs_err(g, r) for g, r in zip(got, ref))
    if g_in is not None:
        full_got["fpaq_encode"] = [t.cpu() for t in dfp.fpaq_encode(
            g_in["streams"].to(dev), g_in["lens"].to(dev),
            g_in["chunk_win"], g_in["cap"])]

    host = np.frombuffer(corpus, np.uint8).reshape(-1, dfp.CHUNK_B)
    streams = torch.from_numpy(host.copy()).to(dev)
    lens = torch.full((len(host),), dfp.CHUNK_B, dtype=torch.int64,
                      device=dev)
    cw = dfp.CHUNK_B // dfp.WIN_B
    cap = dfp.CHUNK_B // dfp.WIN_B * dfp.REGION_W
    ms = median_ms(lambda: dfp.fpaq_encode(streams, lens, cw, cap), 3)
    # the SM clock while the kernel runs: its cycles a bit step
    _, win_cnt, win_low = dfp.fpaq_encode(streams, lens, cw, cap)
    time.sleep(ms / 4000)
    mhz = sm_clock_mhz()
    torch.cuda.synchronize()
    bufs, lows, _, _ = dfp.fpaq_encode_batch(
        host, np.full(len(host), dfp.CHUNK_B), dfp.CHUNK_B, dev)
    total = win_cnt.long().sum(1).cpu().numpy()
    host_s = 0.0
    for i, row in enumerate(host):
        h = _new_handle(KIND_FPAQ, None)
        t0 = time.perf_counter()
        buf, n_out = native.bincoder_enc_chunk(h, row)
        host_s += time.perf_counter() - t0
        low = native.bincoder_get_low(h) | 0xFFFFFF
        native.bincoder_free(h)
        if bufs[i] != bytes(buf[:n_out]) or lows[i] != low:
            fail(f"fpaq: stream {i} differs from the native FPAQ coder")
    steps = 8 * dfp.CHUNK_B
    host_ms = 1000 * host_s / len(host)
    log(f"kernel fpaq_encode: {len(host)} streams of 4 MiB, {steps} bit "
        f"steps each: kernel_ms {ms}, {1e6 * ms / steps:.2f} ns per "
        f"dependent step ({ms * mhz / steps * 1e3:.1f} cycles at the "
        f"{mhz} MHz SM clock read during a launch); plain_ms {plain_ms} "
        f"at {n} streams of "
        f"{size >> 10} KiB (once); bytes and lows == the native coder's; "
        f"native coder {host_ms:.3f} ms a stream on the host, crossover "
        f"{ms / host_ms:.2f} streams (the container's gate: "
        f"{FPAQ_MIN_STREAMS})")
    # the words the kernel writes are the flushes this data needs
    moved = nbytes(streams, lens, win_cnt, win_low) + 4 * int(total.sum())
    return {"fpaq_encode": dict(
        err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        **bound("fpaq_encode", moved, streams.numel()))}


def fpaq_args(enc, lens, chunk: int, dfp, dev) -> list:
    """G's outputs (fpaq_encode_batch: bufs, low56, window words and
    lows) as H's flat arguments on dev: each chunk's record as the
    decoder reads it (its words and its boundary low, 7 bytes, after the
    7 that prime its current), flat (ops.fpaq.flat_records), and lens."""
    bufs, low56, ww, wl = enc
    wpc = chunk // dfp.WIN_B
    frames = []
    for i, buf in enumerate(bufs):
        ends = np.cumsum(ww[i])
        nch = -(-int(lens[i]) // chunk)
        chunks, pos = [], 0
        for k in range(nch):
            w_end = min((k + 1) * wpc, ww.shape[1])
            low = int(wl[i, w_end - 1]) if k + 1 < nch else low56[i]
            words = buf[4 * pos:4 * int(ends[w_end - 1])]
            pos = int(ends[w_end - 1])
            tail = words + low.to_bytes(7, "big")
            chunks.append((int.from_bytes(tail[:7], "big"), tail[7:]))
        frames.append(chunks)
    return [torch.from_numpy(a).to(dev) for a in (
        *dfp.flat_records(frames), np.asarray(lens, np.int64))]


def check_fpaq_decode_kernel(corpus, dfp, native, dev, workers,
                             full_got) -> dict:
    """H against its plain version on the card at SMALL_FPAQ (G's
    streams, framed as the decoder reads them; bytes, words consumed and
    end state), then timed at the main path's shape: the corpus as 16
    streams of 4 MiB, one FPAQ chunk each, encoded by G, whose output
    must be the input; the native host decoder timed on the same
    streams. With workers (not with --kernels), a worker holds H's
    bytes, words consumed and state after each main-path stream's first
    HOST_FPAQ_BYTES against the plain version's on the host's CPU, on
    the same payload."""
    from kanzi_tpu_torch.entropy.native_bin import KIND_FPAQ, _new_handle
    n, size, chunk = SMALL_FPAQ
    host = np.frombuffer(corpus[:n * size], np.uint8).reshape(n, size)
    lens = np.full(n, size)
    args = fpaq_args(dfp.fpaq_encode_batch(host, lens, chunk, dev), lens,
                     chunk, dfp, dev)
    got = dfp.fpaq_decode(*args, chunk)
    ref, plain_ms = once_ms(lambda: dfp.fpaq_decode_plain(
        *args, chunk, *dfp.fpaq_init_state(n, dev)))
    err = max(max_abs_err(g, r) for g, r in zip(
        (got[0], got[1], *got[2]), ref))
    if not np.array_equal(got[0].cpu().numpy(), host):
        fail("fpaq_decode does not return G's input at SMALL_FPAQ")

    host = np.frombuffer(corpus, np.uint8).reshape(-1, dfp.CHUNK_B)
    lens = np.full(len(host), dfp.CHUNK_B)
    enc = dfp.fpaq_encode_batch(host, lens, dfp.CHUNK_B, dev)
    args = fpaq_args(enc, lens, dfp.CHUNK_B, dfp, dev)
    if workers is not None:
        cut = args[:5] + [args[5].clamp(max=HOST_FPAQ_BYTES)]
        workers["fpaq_decode"] = start_worker({
            "kind": "fpaq_decode", "args": [a.cpu() for a in cut],
            "chunk": dfp.CHUNK_B,
            "shape": f"{len(host)}x{HOST_FPAQ_BYTES}, 4 MiB chunks"})
        out, consumed, state = dfp.fpaq_decode(*cut, dfp.CHUNK_B)
        full_got["fpaq_decode"] = [t.cpu() for t in (out, consumed, *state)]
        del cut, out, consumed, state
    ms = median_ms(lambda: dfp.fpaq_decode(*args, dfp.CHUNK_B), 3)
    out, consumed, _ = dfp.fpaq_decode(*args, dfp.CHUNK_B)
    time.sleep(ms / 4000)
    mhz = sm_clock_mhz()
    torch.cuda.synchronize()
    if not np.array_equal(out.cpu().numpy(), host):
        fail("fpaq_decode does not return the 16 streams G encoded")
    host_s = 0.0
    for i, row in enumerate(host):
        tail = enc[0][i] + enc[1][i].to_bytes(7, "big")
        payload = np.frombuffer(tail[7:] + bytes(8), np.uint8)
        h = _new_handle(KIND_FPAQ, None)
        dec = np.empty(dfp.CHUNK_B, np.uint8)
        t0 = time.perf_counter()
        rc = native.bincoder_dec_chunk(h, payload, len(tail) - 7,
                                       int.from_bytes(tail[:7], "big"), dec)
        host_s += time.perf_counter() - t0
        native.bincoder_free(h)
        if rc != 0 or not np.array_equal(dec, row):
            fail(f"fpaq: the native decoder does not return stream {i}")
    steps = 8 * dfp.CHUNK_B
    log(f"kernel fpaq_decode (H): {len(host)} streams of 4 MiB, {steps} "
        f"bit steps each: kernel_ms {ms}, {1e6 * ms / steps:.2f} ns per "
        f"bit step ({ms * mhz / steps * 1e3:.1f} cycles at the {mhz} MHz "
        f"SM clock read during a launch); plain_ms {plain_ms} at {n} "
        f"streams of {size >> 10} KiB with {chunk >> 10} KiB chunks "
        f"(once); output == the input; native decoder "
        f"{1000 * host_s / len(host):.3f} ms a stream on the host, "
        f"{1000 * host_s:.1f} ms for the {len(host)}")
    from kanzi_tpu_torch.ops import _build
    n_ins, stall = sass_step(_build.library_path("fpaq_dec.cu"),
                             "fpaq_decode_kernel", FPAQ_DEC_ANCHOR,
                             unrolled=8, taken=True)
    log(f"kernel fpaq_decode (H): ptxas's schedule (cuobjdump -sass): "
        f"{n_ins} instructions and {stall} static stall cycles a bit step "
        f"without a flush, from one compare with `current` to the next "
        f"(the branch past the flush taken): the chain of the compare, the "
        f"selects of the bit and the next step's split, with the load of "
        f"the step's grandchildren beside it; a chain floor of {steps} x "
        f"{stall} / "
        f"{mhz} MHz = {steps * stall / mhz / 1e3:.1f} ms before the "
        f"shared loads' waits")
    # every payload word read once, the chunk records, the state in and
    # out, the output written once
    moved = nbytes(*args, out, consumed) + 2 * len(host) * (16 + 4 * 1024)
    return {"fpaq_decode": dict(
        err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        **bound("fpaq_decode", moved, out.numel()))}


def cm_args(enc, lens, dcm, dev) -> list:
    """I's outputs (cm_encode_batch: bufs, low56) as J's flat arguments on
    dev: each stream's record as the decoder reads it (its words and its
    final low, 7 bytes, after the 7 that prime its current), flat
    (ops.cm.flat_records), and lens."""
    recs = []
    for buf, low in zip(enc[0], enc[1]):
        tail = buf + low.to_bytes(7, "big")
        recs.append((int.from_bytes(tail[:7], "big"), tail[7:]))
    return [torch.from_numpy(a).to(dev) for a in (
        *dcm.flat_records(recs), np.asarray(lens, np.int64))]


def cm_moved(state, n: int) -> int:
    """Bytes of n streams' CM state, read once and written once."""
    return 2 * n * sum(t[0].numel() * t.element_size() for t in state)


def check_cm_kernels(corpus, dcm, native, dev, workers, full_got) -> dict:
    """I and J against their plain versions on the card at SMALL_CM (the
    first 4 KiB of each main-path stream): I's words, counts and end
    state; J, on I's output framed as the decoder reads it, its bytes
    (the input), words consumed and end state. Then each timed at the
    main path's shape, the corpus as 16 streams of 4 MiB (one CM block
    each): I's bytes and final low must equal the native host coder's,
    J's output the input; the native coder and decoder timed on the same
    streams. With workers (not with --kernels), two workers hold I's and
    J's outputs against their plain versions on the host's CPU, at each
    main-path stream's first HOST_CM_BYTES: I on those bytes, J on I's
    whole payload, its output cut there."""
    from kanzi_tpu_torch.core.context import Context
    from kanzi_tpu_torch.entropy.native_bin import KIND_CM, _new_handle
    host = np.frombuffer(corpus, np.uint8).reshape(-1, BLOCK)
    n, size = SMALL_CM
    rows = np.ascontiguousarray(host[:n, :size])
    small = torch.from_numpy(rows).to(dev)
    lens = torch.full((n,), size, dtype=torch.int64, device=dev)
    st = dcm.cm_init_state(n, 6, dev)
    got = dcm.cm_encode(small, lens, size + 64, st)
    ref, enc_plain_ms = once_ms(
        lambda: dcm.cm_encode_plain(small, lens, size + 64, st))
    err_i = max(max_abs_err(g, r) for g, r in zip(
        (got[0], got[1], *got[2]), (ref[0], ref[1], *ref[2])))
    args = cm_args(dcm.cm_encode_batch(rows, np.full(n, size), 6, dev),
                   np.full(n, size), dcm, dev)
    got = dcm.cm_decode(*args, st)
    ref, dec_plain_ms = once_ms(lambda: dcm.cm_decode_plain(*args, st))
    err_j = max(max_abs_err(g, r) for g, r in zip(
        (got[0], got[1], *got[2]), (ref[0], ref[1], *ref[2])))
    if not np.array_equal(got[0].cpu().numpy(), rows):
        fail("cm_decode does not return I's input at SMALL_CM")

    b = len(host)
    lens_np = np.full(b, BLOCK)
    streams = torch.from_numpy(host.copy()).to(dev)
    lens = torch.full((b,), BLOCK, dtype=torch.int64, device=dev)
    st = dcm.cm_init_state(b, 6, dev)
    if workers is not None:
        cut = np.ascontiguousarray(host[:, :HOST_CM_BYTES])
        workers["cm_encode"] = start_worker({
            "kind": "cm_encode", "streams": torch.from_numpy(cut),
            "lens": torch.full((b,), HOST_CM_BYTES, dtype=torch.int64),
            "cap": HOST_CM_BYTES + 64})
        words, cnt, end = dcm.cm_encode(
            streams[:, :HOST_CM_BYTES].contiguous(),
            lens.clamp(max=HOST_CM_BYTES), HOST_CM_BYTES + 64, st)
        full_got["cm_encode"] = [t.cpu() for t in (words, cnt, *end)]
        del words, cnt, end
    ms_i = median_ms(lambda: dcm.cm_encode(streams, lens, BLOCK + 64, st), 3)
    words, cnt, end = dcm.cm_encode(streams, lens, BLOCK + 64, st)
    time.sleep(ms_i / 4000)
    mhz_i = sm_clock_mhz()
    torch.cuda.synchronize()
    total = int(cnt.sum())
    moved_i = nbytes(streams, lens, cnt) + 4 * total + cm_moved(st, b)
    del words, cnt, end
    enc = dcm.cm_encode_batch(host, lens_np, 6, dev)
    if any(enc[2]):
        fail("cm_encode: a 4 MiB stream overflowed its L + 64 words")
    ctx = Context({"bsVersion": 6})
    enc_s = dec_s = 0.0
    for i, row in enumerate(host):
        h = _new_handle(KIND_CM, ctx)
        t0 = time.perf_counter()
        buf, n_out = native.bincoder_enc_chunk(h, row)
        enc_s += time.perf_counter() - t0
        low = native.bincoder_get_low(h) | 0xFFFFFF
        native.bincoder_free(h)
        if enc[0][i] != bytes(buf[:n_out]) or enc[1][i] != low:
            fail(f"cm: stream {i} differs from the native CM coder")
        tail = enc[0][i] + enc[1][i].to_bytes(7, "big")
        payload = np.frombuffer(tail[7:] + bytes(8), np.uint8)
        h = _new_handle(KIND_CM, ctx)
        dec = np.empty(BLOCK, np.uint8)
        t0 = time.perf_counter()
        rc = native.bincoder_dec_chunk(h, payload, len(tail) - 7,
                                       int.from_bytes(tail[:7], "big"), dec)
        dec_s += time.perf_counter() - t0
        native.bincoder_free(h)
        if rc != 0 or not np.array_equal(dec, row):
            fail(f"cm: the native decoder does not return stream {i}")
    del streams
    args = cm_args(enc, lens_np, dcm, dev)
    if workers is not None:
        cut = args[:4] + [args[4].clamp(max=HOST_CM_BYTES)]
        workers["cm_decode"] = start_worker({
            "kind": "cm_decode", "args": [a.cpu() for a in cut],
            "shape": f"{b}x{HOST_CM_BYTES} of 4 MiB streams"})
        out, consumed, end = dcm.cm_decode(*cut, st)
        full_got["cm_decode"] = [t.cpu() for t in (out, consumed, *end)]
        del cut, out, consumed, end
    ms_j = median_ms(lambda: dcm.cm_decode(*args, st), 3)
    out, consumed, _ = dcm.cm_decode(*args, st)
    time.sleep(ms_j / 4000)
    mhz_j = sm_clock_mhz()
    torch.cuda.synchronize()
    if not np.array_equal(out.cpu().numpy(), host):
        fail("cm_decode does not return the 16 streams I encoded")
    moved_j = nbytes(*args, out, consumed) + cm_moved(st, b)
    from kanzi_tpu_torch.ops import _build
    steps = 8 * BLOCK
    res = {}
    for k, ms, mhz, plain_ms, host_s, err, moved in (
            ("cm_encode", ms_i, mhz_i, enc_plain_ms, enc_s, err_i, moved_i),
            ("cm_decode", ms_j, mhz_j, dec_plain_ms, dec_s, err_j,
             moved_j)):
        tag = "I" if k == "cm_encode" else "J"
        log(f"kernel {k} ({tag}): {b} streams of 4 MiB, {steps} bit steps "
            f"each: kernel_ms {ms}, {1e6 * ms / steps:.2f} ns per bit step "
            f"({ms * mhz / steps * 1e3:.1f} cycles at the {mhz} MHz SM "
            f"clock read during a launch); plain_ms {plain_ms} at {n} "
            f"streams of {size >> 10} KiB (once); native host coder "
            f"{1000 * host_s / b:.3f} ms a stream, {1000 * host_s:.1f} ms "
            f"for the {b}")
        n_ins, stall = sass_loop(_build.library_path("cm.cu"),
                                 f"{k}_kernel", CM_ANCHORS[k])
        chain = ("the coder's 8 splits, flush tests and selects (the "
                 "producer warp runs the predictor a window ahead)" if
                 tag == "I" else "the byte's 8 steps' chains of counter2's "
                 "pair, p12, the split, the compare with `current` and the "
                 "selects of the bit, with the loads of each step's "
                 "children's counter1 entries beside them")
        log(f"kernel {k} ({tag}): ptxas's schedule (cuobjdump -sass): "
            f"{n_ins} instructions and {stall} static stall cycles a byte "
            f"without a flush ({stall / 8:.1f} a bit step), {chain}: a "
            f"chain floor of {BLOCK} x {stall} / {mhz} MHz = "
            f"{BLOCK * stall / mhz / 1e3:.1f} ms before the shuffles' and "
            f"shared loads' waits")
        res[k] = dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                      **bound(k, moved, b * BLOCK))
    log("kernel cm_encode: bytes and final lows == the native CM coder's; "
        "cm_decode: output == the input")
    return res


def l5_rank_inputs(corpus, pp, dev):
    """The RANK input of the level-5 chain's blocks: the corpus's 4 MiB
    blocks through the device BWT and its block-codec header, [16, 4 MiB
    + 33] uint8 on the card."""
    blocks = torch.frombuffer(bytearray(corpus), dtype=torch.uint8).view(
        -1, BLOCK).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rank_in = pp._bwt_codec(blocks)
    torch.cuda.synchronize()
    log(f"device BWT and header of {len(blocks)} blocks of 4 MiB "
        f"(pipeline._bwt_codec): {time.perf_counter() - t0:.3f} s")
    return rank_in


def sbrt_visits(x, ranks, m1: int, m2: int, shift: int) -> int:
    """The ranks that the host automaton's walks visit on x [B, M] uint8
    (whole rows, the mode's masks and shift), given its forward output
    `ranks`: per step the ranks a symbol passes on its way down, plus
    the one that stops it. The rank list stays sorted by q, highest
    first, and qc never falls below the symbol's old q, so a symbol
    stops at new_r = the number of other symbols whose q exceeds qc. So
    the sum needs no walk: each step's qc from the symbol's previous
    position (a sort by symbol, then position), each symbol's q before
    every step (a running maximum), and new_r counted symbol by
    symbol."""
    b, m = x.shape
    idx = torch.arange(m, device=x.device).expand(b, m)
    c = x.long()

    def after(t, fill):                 # t[:, i - 1] at column i
        return torch.cat([torch.full_like(t[:, :1], fill), t[:, :-1]], 1)

    order = (c * m + idx).argsort(dim=1)
    sc = c.gather(1, order)
    prev = torch.where(sc == after(sc, -1), after(order, 0), 0)
    p_prev = torch.empty_like(c).scatter_(1, order, prev)
    del order, sc, prev
    qc = ((idx & m1) + (p_prev & m2)) >> shift
    del p_prev
    new_r = torch.zeros_like(c)
    for s in range(256):
        mine = c == s
        q_s = after(torch.where(mine, qc, 0).cummax(1).values, 0)
        new_r += (q_s > qc) & ~mine
    walked = ranks.long() - new_r
    if bool((walked < 0).any()):
        fail("sbrt_visits: a symbol moved up")
    return int(walked.sum() + (new_r > 0).sum())


def sm_clock_mhz() -> int:
    """The SM clock nvidia-smi reads now (call it while a kernel runs)."""
    return int(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


def sass_ins(lib: Path, kernel: str) -> list:
    """The instructions of `kernel` in the built library, from cuobjdump
    -sass: (address, text, ptxas's stall count, bits 41-44 of the
    instruction's second 64-bit word) each."""
    from kanzi_tpu_torch.ops import _build
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    lines = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                           capture_output=True, text=True,
                           check=True).stdout.splitlines()
    ins, inside = [], False
    for k, line in enumerate(lines):
        if "Function :" in line:
            inside = kernel in line
        m = re.match(r"\s+/\*([0-9a-f]{4})\*/\s+(.*?)\s*"
                     r"/\* 0x[0-9a-f]+ \*/", line)
        if inside and m:
            hi = int(re.search(r"0x[0-9a-f]+", lines[k + 1]).group(), 16)
            ins.append((int(m.group(1), 16), m.group(2), (hi >> 41) & 0xF))
    return ins


def sass_loop(lib: Path, kernel: str, anchor: str) -> tuple:
    """(instructions, static stall cycles) of one pass of the loop of
    `kernel` that holds the first instruction matching the regex
    `anchor`: from the target of the first backward branch after it to
    that branch, along the path that takes each forward branch that
    skips no shared load (J: a byte of the loop, its flushes skipped;
    I's coder has no branch in its byte). The waits on variable-latency
    results (shuffles, shared-memory loads) are not in the count."""
    ins = sass_ins(lib, kernel)
    addr = [a for a, _, _ in ins]

    def target(op):
        m = re.match(r"(?:@!?U?P\d+ )?BRA (0x[0-9a-f]+)", op)
        return int(m.group(1), 16) if m else None

    a = next((k for k, (_, op, _) in enumerate(ins) if re.match(anchor, op)),
             None)
    if a is None:
        fail(f"sass_loop: no {anchor} in {kernel}")
    end = next((k for k in range(a, len(ins))
                if (target(ins[k][1]) or addr[a] + 1) <= addr[a]), None)
    if end is None:
        fail(f"sass_loop: no loop around {anchor} in {kernel}")
    k, n, st = addr.index(target(ins[end][1])), 0, 0
    while k <= end:
        n, st = n + 1, st + ins[k][2]
        t = target(ins[k][1])
        if t is not None and t > addr[k] and not any(
                op.startswith("LDS") for _, op, _ in
                ins[k + 1:addr.index(t)]):
            k = addr.index(t)
        else:
            k += 1
    return n, st


def sass_step(lib: Path, kernel: str, anchor: str,
              unrolled: int | None = None, taken: bool = False) -> tuple:
    """(instructions, static stall cycles) of one step of `kernel` in the
    built library, read from cuobjdump -sass: each instruction's second
    64-bit word carries ptxas's stall count in bits 41-44. A step runs
    from one instruction that matches the regex `anchor` (one a step)
    to the next; the median over the unrolled loop's steps. Where the
    kernel's one loop unrolls a known number of steps, `unrolled`, it
    fails unless the anchor occurs exactly that often. With `taken`, a
    step counts the path that takes each predicated forward branch
    inside it (H: the bit steps without a flush), else every instruction
    between its anchors. The waits on variable-latency results
    (shuffles, shared-memory loads) are not in the count."""
    ins = sass_ins(lib, kernel)
    at = [k for k, (_, op, _) in enumerate(ins) if re.match(anchor, op)]
    if len(at) < 2:
        fail(f"sass_step: no two {anchor} in {kernel}")
    if unrolled is not None and len(at) != unrolled:
        fail(f"sass_step: {len(at)} {anchor} in {kernel}, not one a "
             f"step of its {unrolled} unrolled steps")
    addr = [a for a, _, _ in ins]
    steps = []
    for a, b in zip(at, at[1:]):
        n = st = 0
        k = a
        while k < b:
            n, st = n + 1, st + ins[k][2]
            br = re.match(r"@!?P\d BRA (0x[0-9a-f]+)", ins[k][1])
            if taken and br and addr[k] < int(br.group(1), 16) <= addr[b]:
                k = addr.index(int(br.group(1), 16))
            else:
                k += 1
        steps.append((n, st))
    return (statistics.median(n for n, _ in steps),
            statistics.median(st for _, st in steps))


def check_sbrt_kernels(rank_in, dsb, native, s_in, full_got) -> dict:
    """The SBRT kernels against their plain versions on the card at 16 x
    SMALL_SBRT (the RANK inputs' first bytes, ragged lengths, the
    forward cut into SMALL_SEGMENT segments) in all three modes, both
    ways, and the state kernels against segment_states_plain; then each
    kernel timed apart at the whole RANK input, the forward whole and
    the inverse, held against
    native.sbrt (timed too, block by block on the host). Its outputs on
    s_in go to full_got for the plain worker's check (none with
    --kernels, which starts no worker)."""
    dev = rank_in.device
    small = rank_in[:, :SMALL_SBRT].contiguous()
    lens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, SMALL_SBRT + 1, len(small))).to(dev)
    lens[:3] = torch.tensor([SMALL_SBRT, 0, 4 * SMALL_SEGMENT])
    err = dict.fromkeys(("sbrt_occ", "sbrt_entry", "sbrt_fwd", "sbrt_inv"),
                        0)
    plain_ms = {}
    for mode in (1, 2, 3):
        got = dsb.segment_states(small, lens, mode, SMALL_SEGMENT)
        ref, ms = once_ms(lambda: dsb.segment_states_plain(
            small, lens, mode, SMALL_SEGMENT))
        e = max(max_abs_err(g.long(), r.long()) for g, r in zip(got, ref))
        err["sbrt_occ"] = err["sbrt_entry"] = max(err["sbrt_occ"], e)
        if mode == dsb.MODE_RANK:
            plain_ms["sbrt_occ"] = plain_ms["sbrt_entry"] = ms
        for inverse in (False, True):
            name = "sbrt_inv" if inverse else "sbrt_fwd"
            src = small if not inverse else dsb.sbrt_plain(small, lens, mode,
                                                           False)
            got = dsb.sbrt(src, lens, mode, inverse, segment=SMALL_SEGMENT)
            ref, ms = once_ms(lambda: dsb.sbrt_plain(src, lens, mode,
                                                     inverse))
            err[name] = max(err[name], max_abs_err(got, ref))
            if mode == dsb.MODE_RANK:
                plain_ms[name] = ms
    log(f"kernels sbrt_*: max_abs_err {err} against their plain versions "
        f"at {len(small)} x {SMALL_SBRT >> 10} KiB, ragged lengths, "
        f"segments of {SMALL_SEGMENT} bytes, modes 1-3 both ways")
    if s_in is not None:
        x = s_in["blocks"].to(dev)
        lx = s_in["lens"].to(dev)
        fwd = dsb.sbrt(x, lx, dsb.MODE_RANK, False)
        full_got["sbrt"] = [fwd.cpu(),
                            dsb.sbrt(fwd, lx, dsb.MODE_RANK, True).cpu()]
        del x, lx, fwd

    b, m = rank_in.shape
    mode, seg = dsb.MODE_RANK, dsb.SEGMENT
    lens = torch.full((b,), m, dtype=torch.int64, device=dev)
    x, _ = dsb.kernel_rows(rank_in, lens)
    occ = dsb.launch_occ(x, lens, seg)
    state = dsb.launch_entry(*occ, mode)
    ms = {"sbrt_occ": median_ms(lambda: dsb.launch_occ(x, lens, seg), 5),
          "sbrt_entry": median_ms(lambda: dsb.launch_entry(*occ, mode), 5),
          "sbrt_fwd": median_ms(
              lambda: dsb.launch_fwd(x, lens, seg, *state, mode), 5)}
    del occ, state
    ms_whole = median_ms(lambda: dsb.sbrt(rank_in, lens, mode, False), 5)
    fwd = dsb.sbrt(rank_in, lens, mode, False)
    xf, _ = dsb.kernel_rows(fwd, lens)
    ms["sbrt_inv"] = median_ms(lambda: dsb.launch_inv(xf, lens, mode), 3)
    dsb.launch_inv(xf, lens, mode)
    time.sleep(ms["sbrt_inv"] / 4000)
    mhz = sm_clock_mhz()
    inv = dsb.sbrt(fwd, lens, mode, True)
    if not torch.equal(inv, rank_in):
        fail("sbrt: the inverse does not give back the RANK input")
    host_in, host_fwd = rank_in.cpu().numpy(), fwd.cpu().numpy()
    host_s = [0.0, 0.0]
    for i in range(b):
        for k, (src, want) in enumerate(((host_in[i], host_fwd[i]),
                                         (host_fwd[i], host_in[i]))):
            t0 = time.perf_counter()
            h = native.sbrt(src, mode, inverse=k == 1)
            host_s[k] += time.perf_counter() - t0
            if not np.array_equal(h, want):
                fail(f"sbrt: block {i} differs from native.sbrt "
                     f"({'inverse' if k else 'forward'})")
    visits = sbrt_visits(rank_in, fwd, *dsb._MODES[mode])
    from kanzi_tpu_torch.ops import _build
    lib = _build.library_path("sbrt.cu")
    n_fwd, st_fwd = sass_step(lib, "sbrt_fwd_kernel", "REDUX")
    n_inv, st_inv = sass_step(lib, "sbrt_inv_kernel", "SHFL.IDX")
    low = [float((fwd < k).float().mean()) for k in (8, 32)]
    nseg = -(-m // seg)
    log(f"kernels sbrt_*: {b} blocks of {m} bytes (the level-5 RANK "
        f"input); the forward in {b * nseg} segments of {seg} bytes: "
        f"sbrt_occ {ms['sbrt_occ']} ms, sbrt_entry {ms['sbrt_entry']} ms, "
        f"sbrt_fwd {ms['sbrt_fwd']} ms ({1e6 * ms['sbrt_fwd'] / seg:.2f} "
        f"ns per step of a segment's chain), the whole forward "
        f"{ms_whole} ms; the inverse, one chain of {m} steps a block: "
        f"{ms['sbrt_inv']} ms ({1e6 * ms['sbrt_inv'] / m:.2f} ns, "
        f"{ms['sbrt_inv'] * mhz / m * 1e3:.1f} cycles a step at the {mhz} "
        f"MHz SM clock read during a launch); ptxas's schedule "
        f"(cuobjdump -sass): the inverse {n_inv} instructions and {st_inv} "
        f"static stall cycles a step, a chain floor of {m} x {st_inv} / "
        f"{mhz} MHz = {m * st_inv / mhz / 1e3:.1f} ms before the shuffle's "
        f"and the shared load's waits; sbrt_fwd {n_fwd} instructions and "
        f"{st_fwd} static stall cycles a step; share of ranks < 8 in the "
        f"forward's output {low[0]:.4f}, < 32 (the inverse's head) "
        f"{low[1]:.4f}; native.sbrt on the host, {b} blocks "
        f"one after another: forward {1000 * host_s[0]:.3f} ms, inverse "
        f"{1000 * host_s[1]:.3f} ms; bytes == native.sbrt's both ways; "
        f"plain_ms {plain_ms} at {b} x {SMALL_SBRT >> 10} KiB (once); the "
        f"host automaton's walks visit {visits} ranks "
        f"({visits / rank_in.numel():.3f} a step)")
    # the forward is one function over three kernels: its bytes (the
    # input read once by sbrt_occ, lens and the output by sbrt_fwd) and
    # its operations (every step and walk, all in sbrt_fwd); the entry
    # states are the design's own scratch
    ops = OPS["sbrt"] * rank_in.numel() + SBRT_VISIT_OPS * visits
    bounds = split_bound({"sbrt_occ": (nbytes(rank_in), 0),
                          "sbrt_entry": (0, 0),
                          "sbrt_fwd": (nbytes(lens, fwd), ops)})
    bounds["sbrt_inv"] = bound("sbrt", nbytes(fwd, lens, inv),
                               rank_in.numel(), SBRT_VISIT_OPS * visits)
    return {k: dict(err=err[k], ms=ms[k], plain_ms=plain_ms[k],
                    library_ms=None, **bounds[k]) for k in err}


def check_l5_chain(corpus, pp, dbwt, native, launches, timed, rate) -> None:
    """Phase 8: the device level-5 chain on the corpus against the host
    path, then the fused chain's rate."""
    import kanzi_tpu_torch
    import kanzi_tpu_torch.ops as ops
    dev = torch.device("cuda", 0)
    block = np.frombuffer(corpus[:BLOCK], np.uint8)
    out, idx = dbwt.bwt_forward(block, 8, dev)
    nat, nat_idx = native.bwt_forward(block, 8)
    if not (np.array_equal(out, nat) and list(idx) == list(nat_idx)):
        fail("the device bwt_forward differs from native.bwt_forward")
    log("device bwt_forward of one 4 MiB block == native.bwt_forward "
        "(bytes and the 8 primary indexes)")

    ops.reset_counters()
    blob, t_enc = timed(pp.compress_l5_mesh, corpus, BLOCK)
    enc = dict(ops.COUNTERS)
    ops.reset_counters()
    back, t_dec = timed(pp.decompress_l5_mesh, blob)
    dec = dict(ops.COUNTERS)
    log(f"device level-5 chain ({pp.CHAIN} & {pp.ENTROPY}, 4 MiB blocks): "
        f"{len(corpus)} -> {len(blob)} bytes, encode {rate(t_enc)} "
        f"({t_enc:.3f} s), decode {rate(t_dec)} ({t_dec:.3f} s); "
        f"{enc.get('l5_encode_device_blocks', 0)} of "
        f"{len(corpus) // BLOCK} blocks through the device chain on encode, "
        f"{dec.get('l5_decode_device_blocks', 0)} on decode; launches: "
        f"encode {enc}, decode {dec}")
    if back != corpus:
        fail("decompress_l5_mesh does not return the input")
    if kanzi_tpu_torch.decompress_bytes(blob) != corpus:
        fail("decompress_bytes of the level-5 chain's container differs "
             "from the input")
    for k, counts in (("sbrt_occ", enc), ("sbrt_entry", enc),
                      ("sbrt_fwd", enc), ("ans0_encode_scan", enc),
                      ("ans0_compact", enc), ("sbrt_inv", dec),
                      ("ans0_decode", dec)):
        if counts.get(k, 0) < 1:
            fail(f"kernel {k} was not launched by the device level-5 chain")
        launches[k] = launches.get(k, 0) + counts[k]
    if enc.get("l5_encode_device_blocks", 0) < 1:
        fail("no block took the device level-5 chain")
    ops.disable()
    try:
        host, t_henc = timed(kanzi_tpu_torch.compress_bytes, corpus,
                             pp.CHAIN, pp.ENTROPY, block_size=BLOCK)
        _, t_hdec = timed(kanzi_tpu_torch.decompress_bytes, host)
    finally:
        ops.enable()
    log(f"level-5 chain host path (native C++, one thread): encode "
        f"{rate(t_henc)} ({t_henc:.3f} s), decode {rate(t_hdec)} "
        f"({t_hdec:.3f} s)")
    if blob != host:
        fail("the device level-5 chain's container differs from the host "
             "writer's")
    profile("device level-5 chain encode",
            lambda: pp.compress_l5_mesh(corpus, BLOCK))
    profile("device level-5 chain decode",
            lambda: pp.decompress_l5_mesh(blob))

    b, n = L5_CHAIN
    blocks = torch.frombuffer(bytearray(corpus[:b * n]),
                              dtype=torch.uint8).view(b, n).to(dev)
    pp.l5_chain(blocks)
    best = min(timed(pp.l5_chain, blocks)[1] for _ in range(3))
    log(f"fused level-5 chain (pipeline.l5_chain: BWT + header, RANK, ZRLT, "
        f"ANS0 encode of {b} blocks of {n >> 20} MiB on the card, best of "
        f"3): {b * n / MiB / best:.1f} MiB/s ({best:.3f} s)")


def check_mesh_chains(corpus, pp, launches, timed, rate) -> None:
    """Phase 9: the level-2, 3, 6 and 7 mesh chains on the corpus at 4
    MiB blocks against the host path, each call with the counters reset
    just before and read just after; then one profile each of the
    level-2, 6 and 7 decodes and of the level-7 encode."""
    import kanzi_tpu_torch
    import kanzi_tpu_torch.ops as ops
    from kanzi_tpu_torch.transform import lz as lzt
    dev = torch.device("cuda", 0)
    blocks = len(corpus) // BLOCK
    blobs = {}
    for name, cm, dm, chain, entropy, enc_path, dec_path in (
            ("l2", pp.compress_l2_mesh, pp.decompress_l2_mesh, pp.CHAIN_L2,
             pp.ENTROPY_L2, ("huff_code_tables", "huff_pack"),
             ("huff_decode",)),
            ("l3", pp.compress_l3_mesh, pp.decompress_l3_mesh, pp.CHAIN_L3,
             pp.ENTROPY_L3, ("huff_code_tables", "huff_pack"),
             ("huff_decode",)),
            ("l6", pp.compress_l6_mesh, pp.decompress_l6_mesh, pp.CHAIN_L6,
             pp.ENTROPY_L6, ("fpaq_encode",), ("fpaq_decode",)),
            ("l7", pp.compress_l7_mesh, pp.decompress_l7_mesh, pp.CHAIN_L7,
             pp.ENTROPY_L7, ("cm_encode",), ("cm_decode",))):
        ops.reset_counters()
        blob, _ = timed(cm, corpus, BLOCK)
        enc = dict(ops.COUNTERS)
        ops.reset_counters()
        back, _ = timed(dm, blob)
        dec = dict(ops.COUNTERS)
        log(f"{name} mesh chain ({chain} & {entropy}, 4 MiB blocks): "
            f"{len(corpus)} -> {len(blob)} bytes; launches: encode {enc}, "
            f"decode {dec}")
        if back != corpus:
            fail(f"decompress_{name}_mesh does not return the input")
        for k, counts in ([(k, enc) for k in enc_path]
                          + [(k, dec) for k in dec_path]):
            if counts.get(k, 0) < 1:
                fail(f"kernel {k} was not launched by the {name} mesh chain")
            launches[k] = launches.get(k, 0) + counts[k]
        for k in dec_path:                 # every block's stage at once
            if dec[k] != 1:
                fail(f"the {name} mesh decode launched {k} {dec[k]} times")
        if name == "l7" and enc["cm_encode"] != 1:
            fail(f"the l7 mesh encode launched cm_encode {enc['cm_encode']} "
                 "times")
        if enc.get("huff_host_chunks", 0) or dec.get("huff_host_chunks", 0):
            fail(f"the {name} mesh chain coded Huffman chunks on the host")
        # l2's LZ and l3's LZX run the LZ transform, K where its gate holds
        lz_hl = {"l2": 16, "l3": 19}.get(name)
        if lz_hl and lzt._lz_on_device(dev, BLOCK, lz_hl):
            if not (enc.get("lz_match_pass", 0)
                    == enc.get("lz_hinted_blocks", -1) >= 1):
                fail(f"the {name} mesh encode did not run K and the hinted "
                     f"parse once an LZ block: {enc}")
            for k in LZ_KERNELS:
                launches[k] = launches.get(k, 0) + enc[k]
        elif lz_hl and "lz_match_pass" in enc:
            fail(f"the {name} mesh encode ran K with the gate closed")
        if name == "l6" and dec.get("l6_decode_device_blocks") != blocks:
            fail(f"the l6 mesh decode took {dec.get('l6_decode_device_blocks')}"
                 f" of the {blocks} blocks, each with an FPAQ payload, on "
                 "the card")
        if name == "l7" and (dec.get("l7_decode_device_blocks") != blocks
                             or enc.get("cm_host_blocks", 0)
                             or dec.get("cm_host_blocks", 0)):
            fail(f"the l7 mesh chain took "
                 f"{dec.get('l7_decode_device_blocks')} of the {blocks} "
                 "blocks, each with a CM payload, on the card, or coded "
                 "CM blocks on the host")
        # both rates beside the host path's: medians of 3 runs each, in
        # turns; the host path's first run is also the check that the
        # container is the host writer's and that the host reader decodes
        # the chain's
        secs = {k: [] for k in ("card enc", "host enc", "card dec",
                                "host dec")}
        for r in range(3):
            secs["card enc"].append(timed(cm, corpus, BLOCK)[1])
            secs["card dec"].append(timed(dm, blob)[1])
            ops.disable()
            try:
                host, t_enc = timed(kanzi_tpu_torch.compress_bytes, corpus,
                                    chain, entropy, block_size=BLOCK)
                back, t_dec = timed(kanzi_tpu_torch.decompress_bytes, blob)
            finally:
                ops.enable()
            if r == 0 and back != corpus:
                fail(f"the host reader does not decode the {name} mesh "
                     "chain's container")
            if r == 0 and blob != host:
                fail(f"the {name} mesh chain's container differs from the "
                     "host writer's")
            secs["host enc"].append(t_enc)
            secs["host dec"].append(t_dec)
        med = {k: statistics.median(v) for k, v in secs.items()}
        log(f"{name} mesh chain, medians of 3 runs each in turns: encode "
            f"{rate(med['card enc'])} (host path {rate(med['host enc'])}, "
            f"{med['host enc'] / med['card enc']:.2f}x), decode "
            f"{rate(med['card dec'])} (host path {rate(med['host dec'])}, "
            f"{med['host dec'] / med['card dec']:.2f}x); seconds "
            + ", ".join(f"{k} {v}" for k, v in secs.items()))
        blobs[name] = blob
    profile("l2 mesh decode", lambda: pp.decompress_l2_mesh(blobs["l2"]))
    profile("l6 mesh decode", lambda: pp.decompress_l6_mesh(blobs["l6"]))
    profile("l7 mesh decode", lambda: pp.decompress_l7_mesh(blobs["l7"]))
    profile("l7 mesh encode", lambda: pp.compress_l7_mesh(corpus, BLOCK))


LZ_KERNELS = ("lz_count", "lz_scan", "lz_scatter", "lz_lcp")


def lz_edges() -> dict:
    """K's edge inputs: a block of 1 byte, one below 8, one of a repeated
    byte, one ending in zeros (prefixes run into the padding), a random
    one, and text over three tiles, the last one short."""
    rng = np.random.default_rng(SEED)
    return {"one_byte": np.array([7], np.uint8),
            "below_8": np.frombuffer(b"abcab", np.uint8).copy(),
            "repeated": np.full(5000, 0x41, np.uint8),
            "zero_tail": np.concatenate(
                [rng.integers(0, 3, 4000, dtype=np.uint8),
                 np.zeros(1000, np.uint8)]),
            "random": rng.integers(0, 256, 5000, dtype=np.uint8),
            "tiles_text": np.frombuffer(
                (b"digit passes, tile by tile; " * 700)[:17384],
                np.uint8).copy()}


def wall_ms(fn, runs: int = 5) -> float:
    """Median host wall time of `runs` calls, the card idle at each end,
    after one warm-up call."""
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1000 * (time.perf_counter() - t0))
    return statistics.median(times)


def queued_ms(fn, reps: int = 10, runs: int = 5) -> float:
    """Device time of one call of fn with `reps` calls queued back to back
    between two CUDA events (median of `runs`), after a warm-up call: the
    card's time where the host launches faster than it runs."""
    fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def kernel_device_ms(fn, names, runs: int = 5) -> dict:
    """Each named kernel's device time in one call of fn, from
    torch.profiler over `runs` calls: the sum of its launches a call."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us = dict.fromkeys(names, 0.0)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            for k in names:
                if f"{k}_kernel" in evt.name:
                    us[k] += evt.time_range.elapsed_us()
    if not all(us.values()):
        fail(f"torch.profiler saw no device time for some of {us}")
    return {k: v / 1000 / runs for k, v in us.items()}


def lz_diff(err: dict, kernel: str, got, want) -> None:
    """Raise err[kernel] to the largest difference of got from want,
    tensors or None alike."""
    for g, w in zip(got, want):
        if (g is None) != (w is None):
            fail(f"{kernel}: returned {g is None and 'None'} where its plain "
                 f"version returned {w is None and 'None'}")
        if g is not None:
            err[kernel] = max(err[kernel], max_abs_err(g, w))


def lz_steps(dlz, pad, n: int, hl: int, err: dict) -> tuple:
    """Each kernel of K against its plain version on the same inputs, one
    digit pass after another, then lcp; err raised to the largest
    difference. Returns each pass's plain inputs (keys, counts and last,
    lz_scan's outputs) and the plain prev."""
    keys = None
    steps = []
    for p in range(len(dlz.digit_plan(hl))):
        counts = dlz.lz_count_plain(pad, keys, n, hl, p)
        lz_diff(err, "lz_count", dlz.lz_count(pad, keys, n, hl, p), counts)
        scan = dlz.lz_scan_plain(*counts)
        lz_diff(err, "lz_scan", dlz.lz_scan(*counts), scan)
        out = dlz.lz_scatter_plain(pad, keys, n, hl, p)
        lz_diff(err, "lz_scatter", (dlz.lz_scatter(
            pad, keys, n, hl, p, *scan, check=False),), (out,))
        steps.append((p, keys, counts, scan))
        keys = out
    lz_diff(err, "lz_lcp", (dlz.lz_lcp(pad, keys, n, check=False),),
            (dlz.lz_lcp_plain(pad, keys, n),))
    return steps, keys


def check_lz_kernel(corpus, dlz, native, dev) -> dict:
    """K (each digit pass's lz_count, lz_scan and lz_scatter, then
    lz_lcp) against its plain versions on the card, each kernel on its
    plain version's inputs: at one 4 MiB block of the corpus and a 4 MiB
    block in one bucket, at hash_log 16 (LZ) and 19 (LZX), and on the
    edge inputs, where lz_match_pass must also equal the numpy model;
    every pass (match_pass_kernels) equal to match_pass_plain. Then at the
    corpus block: K's device part as one CUDA-event span (a caller's
    pass, median of 9; and passes queued back to back), each kernel's
    device time in a pass (torch.profiler, its launches summed), the plain
    versions, torch.sort of the keys, the whole pass with its host steps
    and native.lzx_forward's parse of the block."""
    block = np.frombuffer(corpus[:BLOCK], np.uint8)
    n = len(block)
    err = dict.fromkeys(LZ_KERNELS, 0)
    cases = [("corpus", block), ("one_bucket", np.zeros(BLOCK, np.uint8)),
             *lz_edges().items()]
    for name, data in cases:
        for hl in (16, 19):
            pad = dlz.pad_block(data, dev)
            lz_steps(dlz, pad, len(data), hl, err)
            got = dlz.match_pass_kernels(pad, len(data), hl)
            want = dlz.match_pass_plain(torch.from_numpy(data.copy()).to(dev),
                                        hl)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                fail(f"match_pass_kernels differs from match_pass_plain on "
                     f"{name} at hash_log {hl}")
            if len(data) < BLOCK:
                prev, lcp = dlz.lz_match_pass(data, hl, dev)
                gprev, glcp = dlz.match_pass_np(data, hl)
                if not (np.array_equal(prev, gprev)
                        and np.array_equal(lcp, glcp)):
                    fail(f"lz_match_pass differs from match_pass_np on "
                         f"{name} at hash_log {hl}")
    pad = dlz.pad_block(block, dev)
    times = {}
    for hl in (16, 19):
        span = median_ms(lambda: dlz.match_pass_kernels(pad, n, hl), 9)
        queued = queued_ms(lambda: dlz.match_pass_kernels(pad, n, hl))
        each = kernel_device_ms(lambda: dlz.match_pass_kernels(pad, n, hl),
                                LZ_KERNELS)
        times[hl] = (span, queued, each)
        log(f"K's device part (match_pass_kernels: {len(dlz.digit_plan(hl))}"
            f" digit passes of count, scan, scatter, then lcp), one 4 MiB "
            f"block of the corpus, hash_log {hl}: {span} ms a caller's pass "
            f"(CUDA events, median of 9), {queued} ms a pass queued back to "
            f"back; device time a pass (torch.profiler): " + ", ".join(
                f"{k} {v:.4f}" for k, v in each.items())
            + f" (sum {sum(each.values()):.4f})")
    steps, prev = lz_steps(dlz, pad, n, 16, dict.fromkeys(LZ_KERNELS, 0))
    lcp = dlz.lz_lcp_plain(pad, prev, n)
    plain = {
        "lz_count": lambda: [dlz.lz_count_plain(pad, k, n, 16, p)
                             for p, k, _, _ in steps],
        "lz_scan": lambda: [dlz.lz_scan_plain(*c) for _, _, c, _ in steps],
        "lz_scatter": lambda: [dlz.lz_scatter_plain(pad, k, n, 16, p)
                               for p, k, _, _ in steps],
        "lz_lcp": lambda: dlz.lz_lcp_plain(pad, prev, n)}
    plain_ms = {k: median_ms(fn, 3) for k, fn in plain.items()}
    keys = dlz.block_keys_plain(pad, n, 16)
    sort_ms = median_ms(lambda: torch.sort(keys), 5)
    # the whole pass as a caller runs it, and its host steps: the block's
    # upload and padding (pad_block), and prev and lcp brought back
    # through pinned buffers
    pass_ms = wall_ms(lambda: dlz.lz_match_pass(block, 16, dev))
    pad_ms = wall_ms(lambda: dlz.pad_block(block, dev))
    back_ms = wall_ms(lambda: dlz._to_numpy(dev, prev, lcp))
    native.lzx_forward(block, 16, 4)        # builds the library at first use
    native_ms = wall_ms(lambda: native.lzx_forward(block, 16, 4), 3)
    # the work this block needs: lcp compares 8-byte windows up to the
    # first that differs, at most CAP / 8 of them, where prev >= 0
    live = prev >= 0
    cmps = int(torch.where(live, (lcp // 8 + 1).clamp(max=dlz.CAP // 8),
                           0).sum())
    # K's function: the block in, prev and lcp out (keys, counts and
    # offsets are the design's scratch)
    b = split_bound({
        "lz_count": (n, OPS["lz_count"] * n),
        "lz_scan": (0, 0),
        "lz_scatter": (nbytes(prev), OPS["lz_scatter"] * n),
        "lz_lcp": (nbytes(lcp), LZ_STEP_OPS * cmps)})
    span, queued, each = times[16]
    log(f"kernel K at hash_log 16: bound "
        + " + ".join(f"{b[k]['bound_ms']}" for k in LZ_KERNELS)
        + f" ms ({b['lz_count']['bound_by']}; K's function: the block in, "
        f"prev and lcp out); plain versions " + ", ".join(
            f"{k} {v:.3f}" for k, v in plain_ms.items())
        + f" ms; {int(live.sum())} positions with a previous occurrence, "
        f"{cmps} window compares; bit-identical with the plain versions "
        f"at hash_log 16 and 19 on the corpus block, a 4 MiB block in one "
        f"bucket and {len(lz_edges())} edge inputs (lz_match_pass == "
        f"match_pass_np there)")
    log(f"torch.sort of the block's {n} int64 keys (the old design's step "
        f"between its two kernels): {sort_ms} ms")
    log(f"the whole pass (lz_match_pass of the block, host wall time, "
        f"median of 5): {pass_ms:.3f} ms = pad_block (pinned staging, "
        f"upload, the tail zeroed on the card) {pad_ms:.3f} + K's device "
        f"part {span:.3f} + prev and lcp brought back {back_ms:.3f} + the "
        f"rest {pass_ms - pad_ms - span - back_ms:.3f}; "
        f"native.lzx_forward's parse of the block {native_ms:.3f} ms "
        f"(median of 3)")
    return {k: dict(err=err[k], ms=each[k], plain_ms=plain_ms[k],
                    library_ms=None,
                    shape="one 4 MiB block, hash_log 16; device time a pass",
                    **b[k]) for k in LZ_KERNELS}


def check_lz_pass(corpus, dlz, dev, launches) -> None:
    """K's path. No container runs the pass (the port's LZX parse is the
    native one, transform/lz.py), so a caller runs it through
    ops.lz.lz_match_pass: the 8 MiB of the corpus at 4 MiB blocks, at
    hash_log 16 (LZ) and 19 (LZX), the counters reset just before and
    read just after; lz_count, lz_scan and lz_scatter once a digit pass,
    lz_lcp and lz_match_pass once a pass, and each pass's prev and lcp
    equal to match_pass_plain's on the card."""
    import kanzi_tpu_torch.ops as ops
    data = np.frombuffer(corpus[:LZ_BYTES], np.uint8)
    blocks = [data[i:i + BLOCK] for i in range(0, len(data), BLOCK)]
    torch.cuda.synchronize()
    ops.reset_counters()
    t0 = time.perf_counter()
    outs = [(hl, blk, dlz.lz_match_pass(blk, hl, dev))
            for hl in (16, 19) for blk in blocks]
    secs = time.perf_counter() - t0
    counts = dict(ops.COUNTERS)
    digit_passes = sum(len(dlz.digit_plan(hl)) for hl, _, _ in outs)
    want = {"lz_match_pass": len(outs), "lz_lcp": len(outs),
            **dict.fromkeys(("lz_count", "lz_scan", "lz_scatter"),
                            digit_passes)}
    if counts != want:
        fail(f"the {len(outs)} passes launched {counts}, expected {want}")
    for k in LZ_KERNELS:
        launches[k] = launches.get(k, 0) + counts[k]
    for hl, blk, (prev, lcp) in outs:
        want = dlz.match_pass_plain(torch.from_numpy(blk.copy()).to(dev), hl)
        if not (np.array_equal(prev, want[0].cpu().numpy())
                and np.array_equal(lcp, want[1].cpu().numpy())):
            fail(f"lz_match_pass differs from match_pass_plain at hash_log "
                 f"{hl}")
    log(f"the LZ match pass as a caller runs it (lz_match_pass): "
        f"{len(data)} bytes at 4 MiB blocks, hash_log 16 and 19, "
        f"{len(outs)} passes in {secs:.3f} s "
        f"({2 * len(data) / MiB / secs:.1f} MiB/s); launches {counts}; "
        f"each pass == match_pass_plain on the card")


def time_lz(corpus, dev) -> None:
    """--lz TREE: K alone with the package that TREE holds, whichever
    design of K it has, at one 4 MiB block of the corpus, hash_log 16 and
    19: the device part (a caller's pass, CUDA events, median of 9; and
    passes queued back to back), each equal to match_pass_plain, then the
    whole pass and pad_block on the host's clock (medians of 5)."""
    import kanzi_tpu_torch
    from kanzi_tpu_torch.ops import lz as dlz
    log(f"kanzi_tpu_torch from {Path(kanzi_tpu_torch.__file__).parent}")
    block = np.frombuffer(corpus[:BLOCK], np.uint8)
    n = len(block)
    pad = dlz.pad_block(block, dev)
    for hl in (16, 19):
        if hasattr(dlz, "match_pass_kernels"):
            design = "digit passes of count, scan, scatter, then lcp"

            def part():
                return dlz.match_pass_kernels(pad, n, hl)
        else:
            design = "lz_hash, torch.sort, key check, lz_prev_lcp"

            def part():
                keys = torch.sort(dlz.lz_hash(pad, n, hl)).values
                return dlz.lz_prev_lcp(pad, keys, n)
        want = dlz.match_pass_plain(torch.from_numpy(block.copy()).to(dev), hl)
        if not all(torch.equal(g, w) for g, w in zip(part(), want)):
            fail(f"K differs from match_pass_plain at hash_log {hl}")
        span = median_ms(part, 9)
        queued = queued_ms(part)
        pass_ms = wall_ms(lambda: dlz.lz_match_pass(block, hl, dev))
        pad_ms = wall_ms(lambda: dlz.pad_block(block, dev))
        log(f"K ({design}), one 4 MiB block, hash_log {hl}: device part "
            f"{span} ms (CUDA events, median of 9), {queued} ms a pass "
            f"queued back to back; the whole pass {pass_ms:.4f} ms, "
            f"pad_block {pad_ms:.4f} ms (host wall, medians of 5)")


# the kernels of each chain of parallel.dryrun, each way, that launch
# once a shard
MESH_KERNELS = {
    ("l5", "encode"): ("sbrt_occ", "sbrt_entry", "sbrt_fwd",
                       "ans0_encode_scan", "ans0_compact"),
    ("l5", "decode"): ("sbrt_inv", "ans0_decode"),
    ("l2", "encode"): ("huff_code_tables", "huff_pack"),
    ("l2", "decode"): ("huff_decode",),
    ("l3", "encode"): ("huff_code_tables", "huff_pack"),
    ("l3", "decode"): ("huff_decode",),
    ("l6", "encode"): ("fpaq_encode",),
    ("l6", "decode"): ("fpaq_decode",),
    ("l7", "encode"): ("cm_encode",),
    ("l7", "decode"): ("cm_decode",),
}


def check_mesh(dev) -> None:
    """The block mesh over more than one shard: parallel.dryrun over the
    card named 2 and 3 times (3 shards cut some batches unevenly), and
    over every card where there are several; each chain's container
    equal to the host writer's and decoded back (dryrun raises
    otherwise), and each kernel of a chain launched once a shard."""
    from kanzi_tpu_torch.parallel import dryrun
    from kanzi_tpu_torch.parallel.mesh import block_mesh
    meshes = [(dev,) * 2, (dev,) * 3]
    if torch.cuda.device_count() > 1:
        meshes.append(block_mesh())
    for mesh in meshes:
        t0 = time.perf_counter()
        res = dryrun.dryrun_multichip(mesh)
        k = len(mesh)
        for (name, way), kernels in MESH_KERNELS.items():
            for d in ((k,) if name == "l7" else (1, k)):
                counts = res["launches"][(name, d, way)]
                for kern in kernels:
                    if counts.get(kern) != d:
                        fail(f"mesh of {k} ({[str(x) for x in mesh]}): "
                             f"the {name} {way} at {d} shard(s) launched "
                             f"{kern} {counts.get(kern)} times: {counts}")
        log(f"mesh {[str(x) for x in mesh]}: dryrun_multichip passed in "
            f"{time.perf_counter() - t0:.1f} s (l5, l2, l3, l6 at 1 and "
            f"{k} shards, l7 at {k}, every container == the host writer's "
            f"and decoded back, each chain's kernels once a shard); "
            f"launches " + "; ".join(
                f"{n} {w} x{d}: {c}"
                for (n, d, w), c in res["launches"].items()))


def cli_seconds(argv) -> float:
    """Host wall seconds of one in-process CLI call (app.cli.main), the
    card idle at its end; fails on a non-zero exit."""
    from kanzi_tpu_torch.app.cli import main as cli_main
    t0 = time.perf_counter()
    rc = cli_main(["-f", *map(str, argv)])
    torch.cuda.synchronize()
    if rc != 0:
        fail(f"kanzi_tpu_torch {' '.join(map(str, argv))} exited {rc}")
    return time.perf_counter() - t0


def thread_streams(lzt):
    """The LZ transform's card step (transform/lz.py _hinted_forward)
    wrapped to run on a CUDA stream of its thread's own, so that with -j
    N one block's pass need not wait for another's copies: (the step,
    the wrapped step)."""
    import threading
    local = threading.local()
    step = lzt._hinted_forward

    def on_own_stream(src, hash_log, min_match, dev):
        if getattr(local, "stream", None) is None:
            local.stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(local.stream):
            return step(src, hash_log, min_match, dev)
    return step, on_own_stream


def check_lz_hinted(corpus, dlz, native, dev, launches) -> None:
    """9b, the LZ transform on the card: K's pass (with its copies, lcp
    brought back as uint8 and as int32) and the native parse that reads
    its hints, against the native parse alone, on each 4 MiB block of the
    corpus's first 16 MiB at hash_log 16 (LZ) and 19 (LZX), the bytes
    equal (host wall times, medians of 5); K's copies step by step; the
    level 1, 2 and 3 CLI compress of those 16 MiB with the gate open,
    closed and on the host path (ops disabled) in turns, medians of 3,
    the bytes equal and lz_match_pass once an LZ block; the gate's
    crossover: levels 1 and 3 at 256 KiB, 1 and 4 MiB blocks, gate open
    and closed in turns, medians of 5; level 3 at -j 4, gate closed,
    open, and open on a stream a thread."""
    import kanzi_tpu_torch.ops as ops
    from kanzi_tpu_torch.ops.ans import _to_numpy
    from kanzi_tpu_torch.transform import lz as lzt
    data = np.frombuffer(corpus[:LZ_HINT_BYTES], np.uint8)
    blocks = [data[i:i + BLOCK] for i in range(0, len(data), BLOCK)]
    total = {16: [0.0, 0.0], 19: [0.0, 0.0]}
    for b, blk in enumerate(blocks):
        for hl in (16, 19):
            ops.reset_counters()
            prev, lcp = dlz.lz_match_pass(blk, hl, dev, lcp_dtype=np.uint8)
            counts = dict(ops.COUNTERS)
            if counts.get("lz_match_pass") != 1 or counts.get("lz_lcp") != 1:
                fail(f"lz_match_pass launched {counts}")
            st = {}
            got = native.lzx_forward_hinted(blk, hl, 4, prev, lcp, stats=st)
            want = native.lzx_forward(blk, hl, 4)
            if (got is None) != (want is None) or (
                    got is not None and got.tobytes() != want.tobytes()):
                fail(f"the hinted parse differs from the native parse on "
                     f"block {b} at hash_log {hl}")
            t_pass = wall_ms(lambda: dlz.lz_match_pass(
                blk, hl, dev, lcp_dtype=np.uint8))
            t_pass32 = wall_ms(lambda: dlz.lz_match_pass(blk, hl, dev))
            t_hint = wall_ms(lambda: native.lzx_forward_hinted(
                blk, hl, 4, prev, lcp))
            t_nat = wall_ms(lambda: native.lzx_forward(blk, hl, 4))
            total[hl][0] += t_pass + t_hint
            total[hl][1] += t_nat
            log(f"LZ block {b} ({len(blk)} bytes), hash_log {hl}: K's pass with its "
                f"copies {t_pass:.3f} ms (lcp as int32 {t_pass32:.3f}), the "
                f"hinted parse {t_hint:.3f} ms, the native parse "
                f"{t_nat:.3f} ms: {t_pass + t_hint:.3f} against "
                f"{t_nat:.3f} ({t_nat / (t_pass + t_hint):.2f}x); bytes "
                f"equal; parse counters "
                + ", ".join(f"{k} {v}" for k, v in st.items() if v))
    for hl, (h, n) in total.items():
        log(f"LZ {len(data)} bytes at hash_log {hl}: K's pass + the hinted parse "
            f"{h:.3f} ms against the native parse {n:.3f} ms "
            f"({n / h:.2f}x; host wall, medians of 5 a block)")
    # K's copies, one block: the pinned staging buffer's allocation, the
    # bytes into it, pad_block whole; prev and lcp back as int32 or with
    # lcp as uint8
    blk = blocks[0]
    staged = torch.empty(len(blk), dtype=torch.uint8, pin_memory=True)

    def fill():
        staged.numpy()[:] = blk
    prev_d, lcp_d = dlz.match_pass_kernels(dlz.pad_block(blk, dev),
                                           len(blk), 19)
    t_alloc = wall_ms(lambda: torch.empty(len(blk), dtype=torch.uint8,
                                          pin_memory=True))
    t_fill = wall_ms(fill)
    t_pad = wall_ms(lambda: dlz.pad_block(blk, dev))
    t_back32 = wall_ms(lambda: _to_numpy(dev, prev_d, lcp_d))
    t_back8 = wall_ms(lambda: _to_numpy(dev, prev_d, lcp_d.to(torch.uint8)))
    log(f"K's copies, one block of {len(blk)} bytes (host wall, medians of 5): a pinned "
        f"staging buffer's allocation {t_alloc:.3f} ms, the block into it "
        f"{t_fill:.3f}, pad_block whole {t_pad:.3f}; prev and lcp back "
        f"{t_back32:.3f} ms as int32, {t_back8:.3f} with lcp as uint8")

    # the CLI on the 16 MiB: gate open, closed, host path, in turns
    src = WORK / "lz_in.bin"
    src.write_bytes(data.tobytes())
    from kanzi_tpu_torch.app.cli import DEFAULT_BLOCK_SIZE
    gate = lzt.LZ_HINT_MIN_BLOCK
    n_blocks = -(-len(data) // DEFAULT_BLOCK_SIZE)

    def compress(level, where, out, *flags):
        lzt.LZ_HINT_MIN_BLOCK = dict.fromkeys(
            gate, 0 if where == "open" else None)
        if where == "host":
            ops.disable()
        try:
            return cli_seconds(["-c", "-i", src, "-o", out, "-l", level,
                                "-v", 0, *flags])
        finally:
            ops.enable()
            lzt.LZ_HINT_MIN_BLOCK = gate

    try:
        for level in (1, 2, 3):
            outs = {w: WORK / f"lz_l{level}_{w}.knz"
                    for w in ("open", "closed", "host")}
            secs = {w: [] for w in outs}
            for i in range(4):
                for where, out in outs.items():
                    ops.reset_counters()
                    t = compress(level, where, out)
                    counts = dict(ops.COUNTERS)
                    if i:
                        secs[where].append(t)
                    if where == "open" and i == 0:
                        want = {"lz_match_pass": counts.get("lz_hinted_blocks")}
                        if (counts.get("lz_match_pass", 0)
                                != counts.get("lz_hinted_blocks", -1)
                                or counts.get("lz_match_pass", 0) < 1
                                or (level != 2 and counts["lz_match_pass"]
                                    != n_blocks)):
                            fail(f"level-{level} CLI with the gate open: "
                                 f"{counts}, expected lz_match_pass once an "
                                 f"LZ block, {want}")
                        for k in LZ_KERNELS:
                            launches[k] = launches.get(k, 0) + counts[k]
                        log(f"level {level} CLI, gate open: launches "
                            f"{counts}")
                    elif where != "open" and "lz_match_pass" in counts:
                        fail(f"level-{level} CLI ({where}) ran the pass")
            ref = outs["host"].read_bytes()
            for where, out in outs.items():
                if out.read_bytes() != ref:
                    fail(f"level-{level} CLI output ({where}) differs from "
                         "the host path's")
            med = {w: len(data) / MiB / statistics.median(t)
                   for w, t in secs.items()}
            log(f"level {level} CLI compress, {len(data)} bytes at 4 MiB "
                f"blocks, "
                f"medians of 3 in turns: gate open {med['open']:.1f} MiB/s, "
                f"closed {med['closed']:.1f}, host path {med['host']:.1f} "
                f"({med['open'] / med['closed']:.2f}x closed, "
                f"{med['open'] / med['host']:.2f}x host); seconds "
                + "; ".join(f"{w} " + ", ".join(f"{x:.4f}" for x in t)
                            for w, t in secs.items()))
        # the gate's crossover: levels 1 and 3 at three block sizes
        for level in (1, 3):
            for size in LZ_HINT_SIZES:
                secs = {"open": [], "closed": []}
                for i in range(6):
                    for where in secs:
                        t = compress(level, where,
                                     WORK / f"lz_gate_{where}.knz", "-b",
                                     size)
                        if i:
                            secs[where].append(t)
                if (WORK / "lz_gate_open.knz").read_bytes() != (
                        WORK / "lz_gate_closed.knz").read_bytes():
                    fail(f"level {level} at -b {size}: the gate open and "
                         "closed differ")
                o, c = (statistics.median(secs[w]) for w in ("open",
                                                             "closed"))
                log(f"LZ gate, level {level} CLI compress at {size} byte "
                    f"blocks ({len(data)} bytes, medians of 5 in turns): "
                    f"gate open "
                    f"{len(data) / MiB / o:.1f} MiB/s, closed "
                    f"{len(data) / MiB / c:.1f} ({c / o:.2f}x)")
        # -j 4: the writer's block threads call the pass at once
        step, own = thread_streams(lzt)
        runs = {"closed": ("closed", step), "open": ("open", step),
                "open, a stream a thread": ("open", own)}
        secs = {w: [] for w in runs}
        for i in range(4):
            for j, (where, (gate_at, fn)) in enumerate(runs.items()):
                lzt._hinted_forward = fn
                try:
                    t = compress(3, gate_at, WORK / f"lz_j4_{j}.knz", "-j",
                                 4)
                finally:
                    lzt._hinted_forward = step
                if i:
                    secs[where].append(t)
        ref = (WORK / "lz_l3_host.knz").read_bytes()
        for j, where in enumerate(runs):
            if (WORK / f"lz_j4_{j}.knz").read_bytes() != ref:
                fail(f"level 3 at -j 4 ({where}) differs from -j 1")
        log(f"level 3 CLI compress at -j 4 ({len(data)} bytes, medians of 3 "
            f"in turns): "
            + ", ".join(f"{w} {len(data) / MiB / statistics.median(t):.1f} "
                        f"MiB/s" for w, t in secs.items())
            + "; bytes equal to -j 1's")
    finally:
        lzt.LZ_HINT_MIN_BLOCK = gate


def report_kernels(kres: dict) -> None:
    """Print each kernel's line of phase 4; fail on any difference from
    its plain version."""
    for k, r in kres.items():
        shape = {"ans1_gather": "16 chunks of 4 MiB; plain on the card "
                                "at 16 x 64 KiB",
                 "ans1_chain": "16 chunks of 4 MiB; plain on the card at "
                               "16 x 64 KiB",
                 "fpaq_encode": "16 streams of 4 MiB; plain on the card "
                                "at 64 x 8 KiB",
                 "fpaq_decode": "16 streams of 4 MiB; plain on the card "
                                "at 64 x 8 KiB, 2 KiB chunks",
                 "cm_encode": "16 streams of 4 MiB; plain on the card at "
                              "16 x 4 KiB",
                 "cm_decode": "16 streams of 4 MiB; plain on the card at "
                              "16 x 4 KiB",
                 }.get(k, r.get("shape", f"C={N_CHUNKS}"))
        if k.startswith("sbrt_"):
            shape = ("16 RANK inputs of 4 MiB + 33; plain on the card at "
                     "16 x 16 KiB")
        log(f"kernel {k}: max_abs_err {r['err']} kernel_ms {r['ms']} "
            f"plain_ms {r['plain_ms']} library_ms {r['library_ms']} "
            f"bound_ms {r['bound_ms']} ({r['bound_by']}) ({shape})")
        if r["err"] != 0:
            fail(f"{k} differs from its plain version")


BWT_ROUTE_SIZES = (4 << 10, 16 << 10, 32 << 10, 64 << 10, 128 << 10,
                   256 << 10, 1 * MiB, 4 * MiB, 16 * MiB)


def time_bwt_route(dev) -> None:
    """--bwt: the BWT forward's two routes (transform/bwt.py bwt_forward)
    on the bytes the level-7 chain's BWT gets from the benchmark's enwik8
    stand-in (gpubench/corpus.py, 32 MiB through LZP+TEXT+UTF in 16 MiB
    blocks), cut to each of BWT_ROUTE_SIZES: native SA-IS and the card's
    suffix array in turns (medians of 9 below 1 MiB, 5 below 16 MiB and
    3 there, after an untimed call each), bytes, the 8 primary indexes
    and the byte counters checked, and the card path's peak memory above
    what was allocated before it."""
    import kanzi_tpu_torch.ops as ops
    from gpubench import corpus
    from kanzi_tpu_torch.core.context import Context
    from kanzi_tpu_torch.transform import bwt as tbwt
    from kanzi_tpu_torch.transform.factory import (new_transform,
                                                   transform_name_to_type)
    raw = corpus.gen_wiki(corpus.member_rng(2147490001, 0), 32 * MiB)
    post = []
    for pos in range(0, raw.size, 16 * MiB):
        blk = raw[pos:pos + 16 * MiB]
        ctx = Context()
        ctx.put("blockSize", blk.size)
        ctx.put("size", blk.size)
        post.append(new_transform(ctx, transform_name_to_type(
            "LZP+TEXT+UTF")).forward(blk))
    post = np.concatenate(post)
    log(f"bwt route: {raw.size} wiki bytes -> {post.size} after "
        f"LZP+TEXT+UTF; floor {tbwt.BWT_DEVICE_MIN_BLOCK} B, "
        f"{tbwt.BWT_DEVICE_PEAK_PER_BYTE} B of peak a byte")

    def route(floor):
        def fn(b):
            tbwt.BWT_DEVICE_MIN_BLOCK = floor
            return tbwt.bwt_forward(b, dev)
        return fn

    floor = tbwt.BWT_DEVICE_MIN_BLOCK
    host, card = route(1 << 40), route(1)
    try:
        for n in BWT_ROUTE_SIZES:
            block = np.ascontiguousarray(post[:n])
            ops.reset_counters()
            want, got = host(block), card(block)
            if not (np.array_equal(want[0], got[0])
                    and list(want[1]) == list(got[1])):
                fail(f"bwt route: the card's BWT of {n} B differs from "
                     "native SA-IS")
            if (ops.COUNTERS.get("bwt_forward_host_bytes"),
                    ops.COUNTERS.get("bwt_forward_device_bytes")) != (n, n):
                fail(f"bwt route: counters {ops.COUNTERS} after one "
                     f"forward of {n} B on each side")
            times = {"native": [], "card": []}
            turns = 9 if n < 1 * MiB else 5 if n < 16 * MiB else 3
            for _ in range(turns):
                for k, fn in (("native", host), ("card", card)):
                    torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    fn(block)
                    times[k].append(time.perf_counter() - t0)
            med = {k: statistics.median(v) for k, v in times.items()}
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            card(block)
            peak = torch.cuda.max_memory_allocated(dev) - base
            log(f"bwt route {n} B: native {med['native'] * 1e3:.3f} ms, "
                f"card {med['card'] * 1e3:.3f} ms "
                f"({med['native'] / med['card']:.2f}x), every run "
                f"{[round(x * 1e3, 3) for x in times['native']]} / "
                f"{[round(x * 1e3, 3) for x in times['card']]} ms; "
                f"peak {peak} B ({peak / n:.1f} a byte)")
    finally:
        tbwt.BWT_DEVICE_MIN_BLOCK = floor


def time_chains(corpus, pp, timed, rate) -> None:
    """--chains: the level-2, level-3 and level-5 mesh chains on the
    corpus at 4 MiB blocks, compress then decompress, 3 runs after an untimed one,
    each decode equal to the corpus; the medians and every run."""
    import kanzi_tpu_torch
    log(f"kanzi_tpu_torch from {Path(kanzi_tpu_torch.__file__).parent}")
    for name in ("l2", "l3", "l5"):
        cm = getattr(pp, f"compress_{name}_mesh")
        dm = getattr(pp, f"decompress_{name}_mesh")
        secs = {"encode": [], "decode": []}
        for i in range(4):
            blob, te = timed(cm, corpus, BLOCK)
            out, td = timed(dm, blob)
            if out != corpus:
                fail(f"the {name} mesh chain does not decode back")
            if i:
                secs["encode"].append(te)
                secs["decode"].append(td)
        log(f"{name} mesh chain, medians of 3: " + ", ".join(
            f"{way} {rate(statistics.median(t))} "
            f"({statistics.median(t):.4f} s; runs "
            f"{', '.join(f'{x:.4f}' for x in t)})"
            for way, t in secs.items()))


# ---------------------------------------------------------------------
# The C API (kanzi_tpu_torch/csrc/capi.cpp) from a C program
# ---------------------------------------------------------------------

CAPI_BYTES = 16 * MiB
L3_CHAIN = "TEXT+UTF+PACK+MM+LZX"
# (transform, entropy, block, jobs, checksum, headerless, the kernels its
# encode and decode launch in the C process)
CAPI_RUNS = (
    ("NONE", "ANS0", BLOCK, 1, 0, 0,
     ("ans0_encode_scan", "ans0_compact", "ans0_decode")),
    ("NONE", "ANS0", BLOCK, 4, 0, 0,
     ("ans0_encode_scan", "ans0_compact")),
    (L3_CHAIN, "HUFFMAN", BLOCK, 1, 64, 0,
     ("huff_code_tables", "huff_pack", "huff_decode", *LZ_KERNELS)),
    (L3_CHAIN, "HUFFMAN", BLOCK, 4, 0, 0,
     ("huff_code_tables", "huff_pack", "huff_decode")),
    ("NONE", "ANS1", BLOCK, 1, 0, 0, ("ans1_gather", "ans1_chain")),
    ("NONE", "FPAQ", 256 << 10, 1, 0, 0, ("fpaq_encode",)),
    ("NONE", "ANS0", BLOCK, 1, 0, 1,
     ("ans0_encode_scan", "ans0_compact", "ans0_decode")),
)
# the timed runs: ANS0 and the level-3 chain, -j 1, no checksum
CAPI_TIMED = ((("NONE", "ANS0"), "ANS0"), ((L3_CHAIN, "HUFFMAN"), "level 3"))
CAPI_ROUNDS = 3


def capi_script(work: Path, src: Path, runs, tag: str) -> list:
    """The driver's lines for runs (CAPI_RUNS' first six fields), each
    compressed then decompressed, the counters printed after each
    command; the outputs under work, named by tag and run. A compress of
    the input's first MiB with each transform and entropy of runs comes
    first (capi_warm of them): the process's first call starts the
    interpreter, torch and the CUDA context, and each loads its native
    host libraries."""
    lines = []
    for t, e in capi_warm(runs):
        lines += [f"c {work / 'warm.bin'} {work / (tag + 'warm.knz')} {t} "
                  f"{e} {MiB} 1 0 0", "p kanzi_tpu_torch.ops"]
    for i, (t, e, bs, jobs, ck, hl, *_) in enumerate(runs):
        knz, out = work / f"{tag}{i}.knz", work / f"{tag}{i}.out"
        lines.append(f"c {src} {knz} {t} {e} {bs} {jobs} {ck} {hl}")
        lines.append("p kanzi_tpu_torch.ops")
        if hl:
            lines.append(f"d {knz} {out} {jobs} 1 {t} {e} {bs} "
                         f"{src.stat().st_size} {ck}")
        else:
            lines.append(f"d {knz} {out} {jobs} 0")
        lines.append("p kanzi_tpu_torch.ops")
    return lines


def capi_warm(runs) -> list:
    return sorted({(r[0], r[1]) for r in runs})


def run_driver(exe: Path, work: Path, lines: list, host: bool,
               name: str) -> list:
    """The driver over lines in a process of its own (the host path with
    KANZI_TPU_DISABLE=1); returns its result lines, split."""
    import os
    script = work / f"{name}.txt"
    script.write_text("\n".join(lines) + "\n")
    env = dict(os.environ)
    env.pop("KANZI_TPU_DISABLE", None)
    env.pop("PYTHONPATH", None)
    if host:
        env["KANZI_TPU_DISABLE"] = "1"
    r = subprocess.run([str(exe), str(script)], env=env, capture_output=True,
                       text=True, timeout=900)
    out = [ln.split(" ", 1) if ln.startswith("p ") else ln.split()
           for ln in r.stdout.splitlines()
           if ln[:2] in ("c ", "d ", "p ") or ln == "t"]
    if r.returncode != 0 or len(out) != len(lines):
        fail(f"the C driver ({name}) exited {r.returncode}: "
             f"{r.stdout[-1500:]} {r.stderr[-1500:]}")
    return out


def capi_launches(out: list) -> list:
    """Each c/d line of a driver's output with the launches it made (the
    counters printed after it, less those before), and its return code
    and seconds."""
    res, before = [], {}
    for i in range(0, len(out), 2):
        cmd, counts = out[i], json.loads(out[i + 1][1])
        res.append((cmd, {k: v - before.get(k, 0) for k, v in counts.items()
                          if v != before.get(k, 0)}))
        before = counts
    return res


def check_capi(corpus: bytes, k, native, launches: dict) -> None:
    """Phase 9e: the port's C API library and tests/test_torch_capi.c
    built from the checkout; the driver, a C program that links them,
    runs CAPI_RUNS over 16 MiB of the corpus on the card in a process of
    its own, each run's counters read through its embedded interpreter:
    every kernel of the run launched in the C process (added to
    launches, this path's count); each output file
    byte-identical with the host path's (the same driver with
    KANZI_TPU_DISABLE=1) and with the Python API's in this process
    (CompressedWriter, the same settings), each decode the input. Then
    the C API's MiB/s each way for ANS0 and level 3, medians of
    CAPI_ROUNDS runs, the card's path and the host path in turns in one C
    process, beside the Python API's in this process; and the first
    call's seconds (the driver's first compress: the interpreter, torch,
    the CUDA context)."""
    work = WORK / "capi"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    so = native.capi_library()
    exe = work / "test_torch_capi"
    subprocess.run(["gcc", "-O2", str(ROOT / "tests" / "test_torch_capi.c"),
                    *native.capi_link_flags(so), "-o", str(exe)],
                   check=True, capture_output=True, timeout=300)
    log(f"C API: {Path(so).name} and its driver built in "
        f"{time.perf_counter() - t0:.2f} s")
    data = corpus[:CAPI_BYTES]
    src = work / "in.bin"
    src.write_bytes(data)
    (work / "warm.bin").write_bytes(data[:MiB])
    runs = [r[:6] for r in CAPI_RUNS]
    card = capi_launches(run_driver(exe, work,
                                    capi_script(work, src, runs, "card"),
                                    False, "card"))
    host = capi_launches(run_driver(exe, work,
                                    capi_script(work, src, runs, "host"),
                                    True, "host"))
    first = float(card[0][0][4])
    card, host = card[len(capi_warm(runs)):], host[len(capi_warm(runs)):]
    for i, run in enumerate(CAPI_RUNS):
        t, e, bs, jobs, ck, hl, kernels = run
        (c, c_n), (d, d_n) = card[2 * i], card[2 * i + 1]
        (hc, h_n), (hd, hd_n) = host[2 * i], host[2 * i + 1]
        label = f"{t}/{e} {bs >> 10} KiB -j {jobs} -x {ck} headerless {hl}"
        if c[1] != "0" or d[1] != "0" or hc[1] != "0" or hd[1] != "0":
            fail(f"C API {label}: return codes {c[1]} {d[1]} on the card, "
                 f"{hc[1]} {hd[1]} on the host path")
        blob = (work / f"card{i}.knz").read_bytes()
        if blob != (work / f"host{i}.knz").read_bytes():
            fail(f"C API {label}: the card's file differs from the host "
                 "path's")
        sink = io.BytesIO()
        w = k.CompressedWriter(sink, transform=t, entropy=e, block_size=bs,
                               checksum_bits=ck, headerless=bool(hl),
                               jobs=jobs)
        for pos in range(0, len(data), bs):
            w.write(data[pos:pos + bs])
        w.close()
        if blob != sink.getvalue():
            fail(f"C API {label}: the file differs from the Python API's")
        if ((work / f"card{i}.out").read_bytes() != data
                or (work / f"host{i}.out").read_bytes() != data):
            fail(f"C API {label}: a decode differs from the input")
        got = {**c_n, **{x: c_n.get(x, 0) + v for x, v in d_n.items()}}
        missing = [x for x in kernels if got.get(x, 0) < 1]
        for x, v in got.items():
            if x in REPLACES:
                launches[x] = launches.get(x, 0) + v
        if missing or h_n or hd_n:
            fail(f"C API {label}: kernels {missing} not launched in the C "
                 f"process, or the host path launched {h_n} {hd_n}")
        log(f"C API {label}: {len(data)} -> {len(blob)} bytes, == host "
            f"path == Python API, decodes to the input; launches in the C "
            f"process: compress {c_n}, decompress {d_n}")
    log(f"C API first call (a C process's first initCompressor, compress "
        f"and disposeCompressor, 1 MiB {' '.join(capi_warm(runs)[0])}: the "
        f"interpreter, torch, the CUDA context, the first batch): "
        f"{first:.3f} s")
    # rates: one C process runs the card's path and the host path in
    # turns (kanzi_tpu_torch.ops disabled and enabled again through its
    # interpreter), each timed run once on each path first (the first of
    # a size pays its pinned buffers, the kernels' first launches); then
    # the Python API in this process
    timed = [(*te, BLOCK, 1, 0, 0) for te, _ in CAPI_TIMED]
    lines = capi_script(work, src, timed, "t")
    order = []
    for r in range(-1, CAPI_ROUNDS):
        for where in ("card", "host"):
            lines.append(f"t kanzi_tpu_torch.ops "
                         f"{'enable' if where == 'card' else 'disable'}")
            for i, (t, e, bs, *_) in enumerate(timed):
                knz, out = work / f"t{i}.knz", work / f"t{i}.out"
                lines += [f"c {src} {knz} {t} {e} {bs} 1 0 0",
                          f"d {knz} {out} 1 0"]
                order.append((r, where, (t, e)))
    cd = [o for o in run_driver(exe, work, lines, False, "timed")
          if o[0] in ("c", "d")][-2 * len(order):]
    secs = {}
    for (r, where, te), c, d in zip(order, cd[0::2], cd[1::2]):
        if c[1] != "0" or d[1] != "0" or int(d[2]) != len(data):
            fail(f"C API timed run {te} on the {where} path failed: {c} {d}")
        if r >= 0:
            secs.setdefault((where, te, "compress"), []).append(float(c[4]))
            secs.setdefault((where, te, "decompress"), []).append(float(d[3]))
    for _ in range(CAPI_ROUNDS):
        for run in timed:
            t, e, bs = run[:3]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sink = io.BytesIO()
            w = k.CompressedWriter(sink, transform=t, entropy=e,
                                   block_size=bs)
            for pos in range(0, len(data), bs):
                w.write(data[pos:pos + bs])
            w.close()
            t1 = time.perf_counter()
            back = b"".join(k.CompressedReader(sink.getvalue()).read_blocks())
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if back != data:
                fail(f"Python API {t}/{e} round trip differs")
            secs.setdefault(("python", run[:2], "compress"), []).append(t1 - t0)
            secs.setdefault(("python", run[:2], "decompress"), []).append(t2 - t1)
    for te, name in CAPI_TIMED:
        for way in ("compress", "decompress"):
            rate = {w: len(data) / MiB / statistics.median(secs[(w, te, way)])
                    for w in ("card", "python", "host")}
            log(f"C API {name} {way}, 16 MiB at 4 MiB blocks, medians of "
                f"{CAPI_ROUNDS}: the C process on the card "
                f"{rate['card']:.1f} MiB/s and on the host path "
                f"{rate['host']:.1f} (in turns), the Python API on the card "
                f"in this process {rate['python']:.1f}; seconds "
                + ", ".join(f"{w} {[round(x, 6) for x in secs[(w, te, way)]]}"
                            for w in ("card", "host", "python")))


CORRUPT_BLOCK = 256 << 10


def check_corrupt_phase(corpus: bytes, dev) -> None:
    """Phase 9d: kanzi_tpu_torch.testing.corrupt's corrupt_cases over
    1088 KiB of the corpus (code, words, random bytes, runs) at 256 KiB
    blocks, two random blocks before the tail (the l5 mesh decode's
    device rows: RANK through sbrt_inv), and test_torch_malformed.py's
    streams, through the decode kernels on the card (check_corrupt);
    every one of CORRUPT_KERNELS launched."""
    from kanzi_tpu_torch.testing import corrupt
    data = (corpus[:256 << 10] + corpus[6 * MiB:6 * MiB + (256 << 10)]
            + corpus[8 * MiB:8 * MiB + (512 << 10)]
            + corpus[14 * MiB:14 * MiB + (64 << 10)])
    t0 = time.perf_counter()
    cases, good = corrupt.corrupt_cases(data, CORRUPT_BLOCK, (dev,))
    try:
        launches, outcomes = corrupt.check_corrupt(cases, good, dev)
    except AssertionError as e:
        fail(str(e))
    log(f"corrupt streams: {len(cases)} on {dev}, {outcomes['err']} typed "
        f"failures and {outcomes['ok']} decodes equal to their base path's, "
        f"a good stream decoded after each; decode launches "
        f"{ {key: v for key, v in sorted(launches.items())} }")
    missing = [x for x in corrupt.CORRUPT_KERNELS if launches.get(x, 0) < 1]
    if missing:
        fail(f"corrupt streams: kernels {missing} never launched")
    log(f"corrupt streams phase: {time.perf_counter() - t0:.1f} s")


def main(mode: str, tree: Path = ROOT) -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this script runs only "
             "on a CUDA card")
    sys.path.insert(0, str(tree))
    workers = {}
    try:
        run(workers, mode)
    finally:
        for _, proc in workers.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def run(workers: dict, mode: str) -> None:
    """Phases 1-10 (mode "full"); 1-4 for A-E, G-K and SBRT only
    ("kernels"), for H-J only ("decoders"), for I and J only ("cm"); 1-3
    and 5 ("containers"); 1-3, phase 4's K, 9b and 9c ("lz"); 1-3 and
    the l2 and l3 mesh chains' times ("chains"); 1-3 and K's times
    ("lz_time"); 1-3 and 9d ("corrupt"); 1-3 and 9e ("capi"); 1 and the
    BWT forward's routes ("bwt")."""
    import kanzi_tpu_torch
    import kanzi_tpu_torch.ops as ops
    from kanzi_tpu_torch.app.cli import LEVEL_TABLE
    from kanzi_tpu_torch.ops import _build
    from kanzi_tpu_torch.ops import ans as dans
    from kanzi_tpu_torch.ops import ans1 as dans1
    from kanzi_tpu_torch.ops import bwt as dbwt
    from kanzi_tpu_torch.ops import cm as dcm
    from kanzi_tpu_torch.ops import fpaq as dfp
    from kanzi_tpu_torch.ops import huffman as dhuff
    from kanzi_tpu_torch.ops import sbrt as dsb
    from kanzi_tpu_torch.parallel import pipeline as pp
    from kanzi_tpu_torch.utils import native

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi.splitlines()[0])
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    if mode == "bwt":
        time_bwt_route(torch.device("cuda", 0))
        return

    # 2. build
    t0 = time.perf_counter()
    libs = _build.build()
    _build.kernel("ans0_decode")
    log(f"build: {', '.join(so.name for so in libs)} in "
        f"{time.perf_counter() - t0:.3f} s")
    for so in libs:
        log(so.with_suffix(".log").read_text().strip())

    # 3. corpus and the level-5 chain's RANK input; the plain workers of
    # F, G and SBRT start on them
    corpus = make_corpus(BLOCK if mode == "lz_time"
                         else N_CHUNKS * dans.CHUNK)
    log(f"corpus: {len(corpus)} bytes")
    dev = torch.device("cuda", 0)
    if mode in ("full", "kernels"):
        rank_in = l5_rank_inputs(corpus, pp, dev)
    if mode == "full":
        WORK.mkdir(parents=True, exist_ok=True)
        workers.update(start_plain_workers(corpus, dans1, dfp, native,
                                           rank_in))
    full_got = {}

    def timed(fn, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def rate(seconds):
        return f"{len(corpus) / MiB / seconds:.1f} MiB/s"

    if mode == "chains":
        time_chains(corpus, pp, timed, rate)
        return
    if mode == "lz_time":
        time_lz(corpus, dev)
        return
    # (after --chains and --lz TREE, which may import an older tree's
    # package, one without ops.lz or with another design of it)
    from kanzi_tpu_torch.ops import lz as dlz

    # 4. kernels against their plain versions at the main path's shape
    if mode == "hint":
        WORK.mkdir(parents=True, exist_ok=True)
        check_lz_hinted(corpus, dlz, native, dev, {})
        return
    if mode == "corrupt":
        check_corrupt_phase(corpus, dev)
        return
    if mode == "capi":
        check_capi(corpus, kanzi_tpu_torch, native, {})
        return
    if mode == "lz":
        kres = check_lz_kernel(corpus, dlz, native, dev)
        report_kernels(kres)
        check_lz_pass(corpus, dlz, dev, {})
        check_mesh(dev)
        return
    if mode in ("decoders", "cm"):
        kres = {} if mode == "cm" else check_fpaq_decode_kernel(
            corpus, dfp, native, dev, None, full_got)
        kres.update(check_cm_kernels(corpus, dcm, native, dev, None,
                                     full_got))
        report_kernels(kres)
        return
    if mode != "containers":
        chunks = torch.frombuffer(bytearray(corpus), dtype=torch.uint8
                                  ).view(N_CHUNKS, dans.CHUNK).to(dev)
        kres = check_ans0_kernels(chunks, dans)
        kres.update(check_huffman_kernels(chunks, dhuff))
        del chunks
        if mode == "kernels":
            kres.update(check_fpaq_kernel(corpus, dfp, native, dev, None,
                                          full_got))
            kres.update(check_fpaq_decode_kernel(corpus, dfp, native, dev,
                                                 None, full_got))
            kres.update(check_cm_kernels(corpus, dcm, native, dev, None,
                                         full_got))
            kres.update(check_sbrt_kernels(rank_in, dsb, native, None,
                                           full_got))
            kres.update(check_lz_kernel(corpus, dlz, native, dev))
            report_kernels(kres)
            return
        kres.update(check_ans1_kernel(corpus, dans1, native, dev,
                                      workers["ans1_encode_scan"][0],
                                      full_got))
        kres.update(check_fpaq_kernel(corpus, dfp, native, dev,
                                      workers["fpaq_encode"][0], full_got))
        kres.update(check_fpaq_decode_kernel(corpus, dfp, native, dev,
                                             workers, full_got))
        kres.update(check_cm_kernels(corpus, dcm, native, dev, workers,
                                     full_got))
        kres.update(check_sbrt_kernels(rank_in, dsb, native,
                                       workers["sbrt"][0], full_got))
        kres.update(check_lz_kernel(corpus, dlz, native, dev))
        del rank_in
        torch.cuda.empty_cache()
        report_kernels(kres)

    # 5. the main paths on the card. An untimed pass over one block of
    # each first builds the native host libraries (g++, at first use).
    stamp("5")
    for entropy in ("ANS0", "HUFFMAN", "ANS1", "FPAQ"):
        warm = kanzi_tpu_torch.compress_bytes(corpus[:BLOCK], "NONE",
                                              entropy, block_size=BLOCK)
        kanzi_tpu_torch.decompress_bytes(warm)
    launches = {}
    blobs = {}
    # (entropy, kernels of its path); the ANS1 and FPAQ decodes run on
    # the host's native coders, as in kanzi_tpu
    for entropy, path in (
            ("ANS0", ("ans0_encode_scan", "ans0_compact", "ans0_decode")),
            ("HUFFMAN", ("huff_code_tables", "huff_pack", "huff_decode")),
            ("ANS1", ("ans1_gather", "ans1_chain", "ans0_compact")),
            ("FPAQ", ("fpaq_encode",))):
        ops.reset_counters()
        blob, t_enc = timed(kanzi_tpu_torch.compress_bytes, corpus, "NONE",
                            entropy, block_size=BLOCK)
        back, t_dec = timed(kanzi_tpu_torch.decompress_bytes, blob)
        counts = dict(ops.COUNTERS)
        blobs[entropy] = blob
        log(f"container NONE/{entropy} on the card: {len(corpus)} -> "
            f"{len(blob)} bytes, encode {rate(t_enc)} ({t_enc:.3f} s), "
            f"decode {rate(t_dec)} ({t_dec:.3f} s), launches {counts}")
        if back != corpus:
            fail(f"NONE/{entropy} round trip differs from the input")
        for k in path:
            if counts.get(k, 0) < 1:
                fail(f"kernel {k} was not launched by the NONE/{entropy} "
                     "container")
            launches[k] = launches.get(k, 0) + counts[k]
        if entropy == "HUFFMAN" and "ans0_compact" in counts:
            fail("the NONE/HUFFMAN container launched the compaction B")
        if entropy == "HUFFMAN":
            # the card limits over-long codes, its slow path included;
            # the decode launches E once a block that has a chunk to code
            want = coded_blocks(corpus)
            log(f"container NONE/HUFFMAN: huff_host_chunks "
                f"{counts.get('huff_host_chunks', 0)}; huff_decode "
                f"launches {counts['huff_decode']}, blocks with a chunk "
                f"of more than one symbol {want}")
            if counts.get("huff_host_chunks", 0):
                fail("the NONE/HUFFMAN container coded chunks on the host")
            if counts["huff_decode"] != want:
                fail("the NONE/HUFFMAN decode did not launch E once a "
                     "block")
        if entropy == "ANS1" and (counts["ans1_gather"] != 1
                                  or counts["ans1_chain"] != 1):
            fail("the 16 blocks of the NONE/ANS1 container took more than "
                 "one launch of F")
        ops.disable()
        try:
            host, t_henc = timed(kanzi_tpu_torch.compress_bytes, corpus,
                                 "NONE", entropy, block_size=BLOCK)
            _, t_hdec = timed(kanzi_tpu_torch.decompress_bytes, host)
        finally:
            ops.enable()
        log(f"container NONE/{entropy} host path (native C++, one "
            f"thread): encode {rate(t_henc)}, decode {rate(t_hdec)}")
        if blob != host:
            fail(f"NONE/{entropy} output differs from the host path's")
    profile("NONE/ANS0 encode", lambda: kanzi_tpu_torch.compress_bytes(
        corpus, "NONE", "ANS0", block_size=BLOCK))
    profile("NONE/ANS0 decode",
            lambda: kanzi_tpu_torch.decompress_bytes(blobs["ANS0"]))
    profile("NONE/HUFFMAN encode", lambda: kanzi_tpu_torch.compress_bytes(
        corpus, "NONE", "HUFFMAN", block_size=BLOCK))
    profile("NONE/HUFFMAN decode",
            lambda: kanzi_tpu_torch.decompress_bytes(blobs["HUFFMAN"]))
    profile("NONE/ANS1 encode", lambda: kanzi_tpu_torch.compress_bytes(
        corpus, "NONE", "ANS1", block_size=BLOCK))
    profile("NONE/FPAQ encode", lambda: kanzi_tpu_torch.compress_bytes(
        corpus, "NONE", "FPAQ", block_size=BLOCK))
    chunks_np = np.frombuffer(corpus, np.uint8).reshape(-1, dans.CHUNK)
    for mod in (dans, dhuff):
        _, t_stage = timed(mod.encode_chunks_np, chunks_np, "cuda")
        log(f"device encode stage ({mod.__name__}.encode_chunks_np, "
            f"{len(chunks_np)} chunks, host->device copy and back "
            f"included): {t_stage:.3f} s, {rate(t_stage)}")
    if mode == "containers":
        return

    # 6. every level through the port (this also builds every native
    # host library before the CLI's timed runs)
    stamp("6")
    data = corpus[:MiB]
    for level in range(10):
        t0 = time.perf_counter()
        blob = kanzi_tpu_torch.compress_bytes(data, *LEVEL_TABLE[level],
                                              block_size=MiB)
        if kanzi_tpu_torch.decompress_bytes(blob) != data:
            fail(f"level {level} round trip differs from the input")
        log(f"level {level} round trip: {len(data)} -> {len(blob)} bytes in "
            f"{time.perf_counter() - t0:.2f} s")

    # 7. levels 5, 3 (the default) and 6 (FPAQ on the card) through the
    # CLI's entry point
    stamp("7")
    log(f"native SA-IS available: {native.sais_available()}")
    work = WORK
    data = corpus[:16 * MiB]
    src = work / "in.bin"
    src.write_bytes(data)

    def cli(*argv) -> float:
        return cli_seconds(argv)

    # the default level's LZX runs K on the card where the transform's
    # gate holds at the CLI's 4 MiB blocks
    from kanzi_tpu_torch.app.cli import DEFAULT_BLOCK_SIZE
    from kanzi_tpu_torch.transform import lz as lzt
    l3_lz = (LZ_KERNELS if lzt._lz_on_device(dev, DEFAULT_BLOCK_SIZE, 19)
             else ())
    for level, flags, path in (
            (5, ["-l", "5"], ("ans0_encode_scan", "ans0_compact",
                              "ans0_decode")),
            (3, [], ("huff_code_tables", "huff_pack", "huff_decode",
                     *l3_lz)),
            (6, ["-l", "6", "-b", "256k"], ("fpaq_encode",))):
        mib, bwt_bytes = {}, {}
        for where in ("card", "host"):
            knz, dec = work / f"l{level}_{where}.knz", work / f"l{level}.out"
            if where == "host":
                ops.disable()
            ops.reset_counters()
            try:
                t_c = cli("-c", "-i", src, "-o", knz, *flags)
                t_d = cli("-d", "-i", knz, "-o", dec)
            finally:
                ops.enable()
            counts = dict(ops.COUNTERS)
            # the BWT stage's input bytes, on either side: the same bytes
            bwt_bytes[where] = (counts.pop("bwt_forward_device_bytes", 0)
                                + counts.pop("bwt_forward_host_bytes", 0))
            if dec.read_bytes() != data:
                fail(f"level-{level} CLI round trip ({where}) differs from "
                     "the input")
            mib[where] = (len(data) / MiB / t_c, len(data) / MiB / t_d)
            if where == "card":
                for k in path:
                    if counts.get(k, 0) < 1:
                        fail(f"kernel {k} was not launched by the level-"
                             f"{level} CLI")
                    launches[k] = launches.get(k, 0) + counts[k]
                if level == 3 and ("ans0_compact" in counts
                                   or "huff_host_chunks" in counts):
                    fail("the level-3 CLI launched the compaction B or "
                         "coded chunks on the host")
                log(f"level {level} CLI ({' '.join(flags) or 'no -l'}) on "
                    f"the card: launches {counts}; BWT input bytes on the "
                    f"card {ops.COUNTERS.get('bwt_forward_device_bytes', 0)}"
                    f", on the host "
                    f"{ops.COUNTERS.get('bwt_forward_host_bytes', 0)}")
            elif counts or ops.COUNTERS.get("bwt_forward_device_bytes"):
                fail(f"the host path launched {dict(ops.COUNTERS)}")
            elif bwt_bytes["host"] != bwt_bytes["card"]:
                fail(f"the level-{level} CLI's BWT stage took {bwt_bytes} "
                     "bytes on the card's path and on the host path")
        knz = work / f"l{level}_card.knz"
        if knz.read_bytes() != (work / f"l{level}_host.knz").read_bytes():
            fail(f"level-{level} CLI output differs from the host path's")
        log(f"level {level} CLI: {len(data)} -> {knz.stat().st_size} bytes, "
            f"compress {mib['card'][0]:.1f} MiB/s (host path "
            f"{mib['host'][0]:.1f}), decompress {mib['card'][1]:.1f} MiB/s "
            f"(host path {mib['host'][1]:.1f})")
        if level == 3:
            # the default level's decompress, card and host path in turns
            secs = {"card": [], "host": []}
            for _ in range(5):
                for where in ("card", "host"):
                    if where == "host":
                        ops.disable()
                    try:
                        secs[where].append(cli("-d", "-i", knz, "-o", dec))
                    finally:
                        ops.enable()
                    if dec.read_bytes() != data:
                        fail(f"level-3 CLI decompress ({where}) differs "
                             "from the input")
            med = {k: len(data) / MiB / statistics.median(v)
                   for k, v in secs.items()}
            log(f"level 3 CLI decompress, medians of 5 runs each in turns: "
                f"card {med['card']:.1f} MiB/s, host path "
                f"{med['host']:.1f} MiB/s ({med['card'] / med['host']:.2f}x)")

    # 8. the device level-5 chain, and the fused chain
    stamp("8")
    check_l5_chain(corpus, pp, dbwt, native, launches, timed, rate)

    # 9. the level-2, 3, 6 and 7 mesh chains
    stamp("9")
    check_mesh_chains(corpus, pp, launches, timed, rate)

    # 9b. K's path: the LZ match pass as a caller runs it (the LZ
    # transform's part follows the plain workers, whose load on the
    # host's CPU would blur its host-bound times)
    check_lz_pass(corpus, dlz, dev, launches)

    # 9c. the block mesh over 2 and 3 shards of the card (and every card)
    stamp("9c")
    check_mesh(dev)

    # 9d. corrupt streams through the decode kernels on the card (no
    # times: it runs while the plain workers load the host's CPU)
    stamp("9d")
    check_corrupt_phase(corpus, dev)

    # F, G, H, I, J and SBRT against their plain versions on the host's
    # CPU
    stamp("of the plain workers' wait")
    finish_plain_workers(workers, full_got, kres)

    # 9e. the C API from a C program on the card, with the host's CPU
    # free for its rates
    stamp("9e")
    check_capi(corpus, kanzi_tpu_torch, native, launches)

    # 9b, the LZ transform that runs K on the card and parses from its
    # hints, with the host's CPU free
    stamp("9b's LZ transform")
    check_lz_hinted(corpus, dlz, native, dev, launches)

    # 10. no JAX, nothing of the JAX package
    stamp("10")
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "kanzi_tpu"))
    if foreign:
        fail(f"imported {foreign}")

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda",
         "source": f"kanzi_tpu_torch/csrc/{src_name}", "replaces": rep,
         "launches": launches[k], "max_abs_err": kres[k]["err"],
         "ms": kres[k]["ms"], "plain_ms": kres[k]["plain_ms"],
         "bound_ms": kres[k]["bound_ms"], "bound_by": kres[k]["bound_by"],
         "library_ms": kres[k]["library_ms"]}
        for k, (src_name, rep) in REPLACES.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--plain"]:
        plain_worker(Path(sys.argv[2]))
    elif sys.argv[1:2] == ["--chains"]:
        main("chains", Path(sys.argv[2]).resolve() if sys.argv[2:] else ROOT)
    elif sys.argv[1:2] == ["--lz"] and sys.argv[2:]:
        main("lz_time", Path(sys.argv[2]).resolve())
    else:
        main({"--kernels": "kernels", "--containers": "containers",
              "--decoders": "decoders", "--cm": "cm", "--lz": "lz",
              "--hint": "hint", "--corrupt": "corrupt",
              "--capi": "capi", "--bwt": "bwt"}.get(
            sys.argv[1] if sys.argv[1:] else "", "full"))
