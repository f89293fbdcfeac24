"""Typed error codes, mirroring the reference enum (src/Error.hpp:27-48)."""

from __future__ import annotations

import enum


class Error(enum.IntEnum):
    ERR_MISSING_PARAM = 1
    ERR_BLOCK_SIZE = 2
    ERR_INVALID_CODEC = 3
    ERR_CREATE_COMPRESSOR = 4
    ERR_CREATE_DECOMPRESSOR = 5
    ERR_OUTPUT_IS_DIR = 6
    ERR_OVERWRITE_FILE = 7
    ERR_CREATE_FILE = 8
    ERR_CREATE_BITSTREAM = 9
    ERR_OPEN_FILE = 10
    ERR_READ_FILE = 11
    ERR_WRITE_FILE = 12
    ERR_PROCESS_BLOCK = 13
    ERR_CREATE_CODEC = 14
    ERR_INVALID_FILE = 15
    ERR_STREAM_VERSION = 16
    ERR_CREATE_STREAM = 17
    ERR_INVALID_PARAM = 18
    ERR_CRC_CHECK = 19
    ERR_RESERVED = 20
    ERR_UNKNOWN = 127


class KanziError(Exception):
    """Framework error carrying a typed code (maps to CLI exit codes)."""

    def __init__(self, message: str, code: Error = Error.ERR_UNKNOWN):
        super().__init__(message)
        self.code = Error(code)
