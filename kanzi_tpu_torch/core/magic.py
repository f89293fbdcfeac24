"""File-type sniffing from leading magic bytes (src/Magic.hpp:30-171)."""

from __future__ import annotations

NO_MAGIC = 0
JPG = 0xFFD8FFE0
GIF = 0x47494638
PDF = 0x25504446
ZIP = 0x504B0304
LZMA = 0x377ABCAF
RAR = 0x52617221
PNG = 0x89504E47
ELF = 0x7F454C46
MAC_MAGIC32 = 0xFEEDFACE
MAC_CIGAM32 = 0xCEFAEDFE
MAC_MAGIC64 = 0xFEEDFACF
MAC_CIGAM64 = 0xCFFAEDFE
ZSTD = 0x28B52FFD
BROTLI = 0x81CFB2CE
RIFF = 0x52494646
CAB = 0x4D534346
FLAC = 0x664C6143
XZ = 0xFD377A58
KNZ = 0x4B414E5A
BZIP2 = 0x425A68
MP3_ID3 = 0x494433
GZIP = 0x1F8B
BMP = 0x424D
WIN = 0x4D5A
PBM = 0x5034
PGM = 0x5035
PPM = 0x5036

_KEYS32 = {GIF, PDF, ZIP, LZMA, PNG, ELF, MAC_MAGIC32, MAC_CIGAM32,
           MAC_MAGIC64, MAC_CIGAM64, ZSTD, BROTLI, CAB, RIFF, FLAC, XZ,
           KNZ, RAR}
_KEYS16 = {GZIP, BMP, WIN}
_COMPRESSED = {JPG, GIF, PNG, LZMA, ZSTD, BROTLI, CAB, ZIP, GZIP, BZIP2,
               FLAC, MP3_ID3, XZ, KNZ, RAR}
_MULTIMEDIA = {JPG, GIF, PNG, RIFF, FLAC, MP3_ID3, BMP, PBM, PGM, PPM}
_EXECUTABLE = {ELF, WIN, MAC_MAGIC32, MAC_CIGAM32, MAC_MAGIC64, MAC_CIGAM64}


def get_type(src: bytes) -> int:
    """Sniff magic from the first 4 bytes (src/Magic.hpp:68-106)."""
    if len(src) < 4:
        return NO_MAGIC
    key = int.from_bytes(src[:4], "big")
    if (key & ~0x0F) == JPG:
        return key
    if (key >> 8) in (BZIP2, MP3_ID3):
        return key >> 8
    if key in _KEYS32:
        return key
    key16 = key >> 16
    if key16 in _KEYS16:
        return key16
    if key16 in (PBM, PGM, PPM):
        sub = (key >> 8) & 0xFF
        if sub in (0x07, 0x0A, 0x0D, 0x20):
            return key16
    return NO_MAGIC


def is_compressed(magic: int) -> bool:
    return magic in _COMPRESSED


def is_multimedia(magic: int) -> bool:
    return magic in _MULTIMEDIA


def is_executable(magic: int) -> bool:
    return magic in _EXECUTABLE
