"""EXE codec: x86/ARM64 call & jump target absolutization.

Reference: src/transform/EXECodec.cpp. detectType parses ELF/PE/Mach-O
headers for arch + code section, else counts jump opcodes; x86 rewrites
E8/E9/0F-8x rel32 to MASK_ADDRESS-xored absolute big-endian with escape
0x9B; ARM64 rewrites B/BL imm26. Output: mode byte + codeStart +
codeEnd-in-output (int32 LE each) + rewritten code from offset 9.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from kanzi_tpu_torch.core import magic as magiclib
from kanzi_tpu_torch.core import stats
from kanzi_tpu_torch.transform.base import ByteTransform, as_u8

X86_MASK_JUMP = 0xFE
X86_INSTRUCTION_JUMP = 0xE8
X86_INSTRUCTION_JCC = 0x80
X86_TWO_BYTE_PREFIX = 0x0F
X86_MASK_JCC = 0xF0
X86_ESCAPE = 0x9B
NOT_EXE = 0x80
X86 = 0x40
ARM64 = 0x20
MASK_DT = 0x0F
X86_ADDR_MASK = (1 << 24) - 1
MASK_ADDRESS = 0xF0F0F0F0
ARM_B_ADDR_MASK = (1 << 26) - 1
ARM_B_OPCODE_MASK = (0xFFFFFFFF ^ ARM_B_ADDR_MASK)
ARM_B_ADDR_SGN_MASK = 1 << 25
ARM_OPCODE_B = 0x14000000
ARM_OPCODE_BL = 0x94000000 - (1 << 32)  # int32 value
ARM_CB_REG_BITS = 5
ARM_CB_ADDR_MASK = 0x00FFFFE0
ARM_CB_OPCODE_MASK = 0x7F000000
ARM_OPCODE_CBZ = 0x34000000
ARM_OPCODE_CBNZ = 0x35000000
WIN_PE = 0x00004550
WIN_X86_ARCH = 0x014C
WIN_AMD64_ARCH = 0x8664
WIN_ARM64_ARCH = 0xAA64
ELF_X86_ARCH = 0x03
ELF_AMD64_ARCH = 0x3E
ELF_ARM64_ARCH = 0xB7
MAC_AMD64_ARCH = 0x01000007
MAC_ARM64_ARCH = 0x0100000C
MAC_MH_EXECUTE = 0x02
MAC_LC_SEGMENT = 0x01
MAC_LC_SEGMENT64 = 0x19
MIN_BLOCK_SIZE = 4096
MAX_BLOCK_SIZE = (1 << 28) - 1


def _i32(x):
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


def _le32(b, i):
    return _i32(int.from_bytes(bytes(b[i:i + 4]), "little"))


def _le16(b, i):
    return int.from_bytes(bytes(b[i:i + 2]), "little")


def _le64(b, i):
    v = int.from_bytes(bytes(b[i:i + 8]), "little")
    return v - (1 << 64) if v >= (1 << 63) else v


def _be32(b, i):
    return _i32(int.from_bytes(bytes(b[i:i + 4]), "big"))


def _be16(b, i):
    return int.from_bytes(bytes(b[i:i + 2]), "big")


def _be64(b, i):
    v = int.from_bytes(bytes(b[i:i + 8]), "big")
    return v - (1 << 64) if v >= (1 << 63) else v


def _set_code_range(count, code_start, code_end, start, length):
    if start < 0 or length < 0 or start > count or length > count - start:
        return False, code_start, code_end
    if code_start == 0:
        code_start = int(start)
    code_end = int(start + length)
    return True, code_start, code_end


def parse_header(src, count, mg):
    """Returns (known, arch, code_start, code_end) — EXECodec::parseHeader."""
    code_start = 0
    code_end = count
    arch = 0
    if mg == magiclib.WIN and count >= 64:
        pos_pe = _le32(src, 60)
        if 0 < pos_pe <= count - 48 and _le32(src, pos_pe) == WIN_PE:
            ok, code_start, code_end = _set_code_range(
                count, code_start, code_end,
                _le32(src, pos_pe + 44), _le32(src, pos_pe + 28))
            if not ok:
                return False, arch, code_start, code_end
            arch = _le16(src, pos_pe + 4)
        return True, arch, code_start, code_end
    if mg == magiclib.ELF and count >= 64:
        code_start = 0
        le = src[5] == 1
        rd16, rd32, rd64 = (_le16, _le32, _le64) if le else (_be16, _be32, _be64)
        if src[4] == 2:  # 64 bits
            nb = rd16(src, 0x3C)
            sz = rd16(src, 0x3A)
            pos = rd64(src, 0x28)
            if sz <= 0 or pos < 0 or pos > count - 0x28:
                return False, arch, code_start, code_end
            for i in range(nb):
                st = pos + i * sz
                if st > count - 0x28:
                    return False, arch, code_start, code_end
                typ = rd32(src, st + 4)
                off = rd64(src, st + 0x18)
                ln = rd64(src, st + 0x20)
                if typ == 1 and ln >= 64:
                    ok, code_start, code_end = _set_code_range(
                        count, code_start, code_end, off, ln)
                    if not ok:
                        return False, arch, code_start, code_end
        else:  # 32 bits
            nb = rd16(src, 0x30)
            sz = rd16(src, 0x2E)
            pos = rd32(src, 0x20)
            if sz <= 0 or pos < 0 or pos > count - 0x18:
                return False, arch, code_start, code_end
            for i in range(nb):
                st = pos + i * sz
                if st > count - 0x18:
                    return False, arch, code_start, code_end
                typ = rd32(src, st + 4)
                off = rd32(src, st + 0x10)
                ln = rd32(src, st + 0x14)
                if typ == 1 and ln >= 64:
                    ok, code_start, code_end = _set_code_range(
                        count, code_start, code_end, off, ln)
                    if not ok:
                        return False, arch, code_start, code_end
        arch = rd16(src, 18)
        code_start = min(code_start, count)
        code_end = min(code_end, count)
        return True, arch, code_start, code_end
    if mg in (magiclib.MAC_MAGIC32, magiclib.MAC_CIGAM32,
              magiclib.MAC_MAGIC64, magiclib.MAC_CIGAM64) and count >= 64:
        is64 = mg in (magiclib.MAC_MAGIC64, magiclib.MAC_CIGAM64)
        code_start = 0
        if _le32(src, 12) != MAC_MH_EXECUTE:
            return False, arch, code_start, code_end
        arch = _le32(src, 4)
        nb_cmds = _le32(src, 0x10)
        pos = 0x20 if is64 else 0x1C
        cmd = 0
        while cmd < nb_cmds:
            if pos < 0 or pos > count - 8:
                return False, arch, code_start, code_end
            ld_cmd = _le32(src, pos)
            sz_cmd = _le32(src, pos + 4)
            sz_seg_hdr = 0x48 if is64 else 0x38
            if sz_cmd < 8 or sz_cmd > count - pos:
                return False, arch, code_start, code_end
            if ld_cmd in (MAC_LC_SEGMENT, MAC_LC_SEGMENT64):
                if pos > count - 14 or pos > count - sz_seg_hdr:
                    return False, arch, code_start, code_end
                if bytes(src[pos + 8:pos + 14]) == b"__TEXT":
                    pos_sec = pos + sz_seg_hdr
                    min_sz = 0x38 if is64 else 0x30
                    if pos_sec > count - min_sz:
                        return False, arch, code_start, code_end
                    if bytes(src[pos_sec:pos_sec + 6]) == b"__text":
                        if is64:
                            ok, code_start, code_end = _set_code_range(
                                count, code_start, code_end,
                                _le64(src, pos_sec + 0x30),
                                _le32(src, pos_sec + 0x28))
                        else:
                            ok, code_start, code_end = _set_code_range(
                                count, code_start, code_end,
                                _le32(src, pos_sec + 0x2C),
                                _le32(src, pos_sec + 0x28))
                        if not ok:
                            return False, arch, code_start, code_end
                        break
            cmd += 1
            pos += sz_cmd
        code_start = min(code_start, count)
        code_end = min(code_end, count)
        return True, arch, code_start, code_end
    return False, arch, code_start, code_end


def detect_type(src, count):
    """Returns (mode, code_start, code_end) — EXECodec::detectType."""
    mg = magiclib.get_type(bytes(src[:4]))
    code_start = 0
    code_end = count
    block_size = count
    known, arch, code_start, code_end = parse_header(src, count, mg)
    if known:
        if code_start < 0 or code_start > block_size or code_end < code_start \
                or code_end > block_size:
            return NOT_EXE | stats.UNDEFINED, code_start, code_end
        if arch in (ELF_X86_ARCH, ELF_AMD64_ARCH, WIN_X86_ARCH,
                    WIN_AMD64_ARCH, MAC_AMD64_ARCH):
            return X86, code_start, code_end
        if arch in (ELF_ARM64_ARCH, WIN_ARM64_ARCH, MAC_ARM64_ARCH):
            return ARM64, code_start, code_end
        count = code_end - code_start
    if code_start < 0 or code_start > block_size or code_end < code_start \
            or code_end > block_size:
        return NOT_EXE | stats.UNDEFINED, code_start, code_end
    if count <= 0:
        return NOT_EXE | stats.UNDEFINED, code_start, code_end

    from kanzi_tpu_torch.utils import native
    if native.transforms_available():
        nhisto, jumps_x86, jumps_arm = native.exe_detect_scan(
            src, code_start, code_end)
        return _detect_classify(count, code_start, code_end,
                                nhisto, jumps_x86, jumps_arm)
    jumps_x86 = 0
    jumps_arm = 0
    histo = [0] * 256
    i = code_start
    while i < code_end:
        histo[src[i]] += 1
        if (i + 4) < code_end and (src[i] & X86_MASK_JUMP) == X86_INSTRUCTION_JUMP:
            if src[i + 4] in (0, 0xFF):
                jumps_x86 += 1
                i += 1
                continue
        elif src[i] == X86_TWO_BYTE_PREFIX and i + 1 < code_end:
            j = i + 1
            if src[j] in (0x38, 0x3A) and j + 1 < code_end:
                j += 1
            if (src[j] & X86_MASK_JCC) == X86_INSTRUCTION_JCC:
                jumps_x86 += 1
                i = j + 1
                continue
            i = j  # falls through to the ARM check at position j
        if (i & 3) == 0 and i + 4 <= code_end:
            instr = _le32(src, i)
            op1 = instr & _i32(ARM_B_OPCODE_MASK)
            op2 = instr & ARM_CB_OPCODE_MASK
            if op1 in (ARM_OPCODE_B, ARM_OPCODE_BL) or \
                    op2 in (ARM_OPCODE_CBZ, ARM_OPCODE_CBNZ):
                jumps_arm += 1
        i += 1

    return _detect_classify(count, code_start, code_end,
                            np.array(histo, dtype=np.int64),
                            jumps_x86, jumps_arm)


def _detect_classify(count, code_start, code_end, histo, jumps_x86,
                     jumps_arm):
    dt = stats.detect_simple_type(count, np.asarray(histo, dtype=np.int64))
    if dt != stats.BIN:
        return NOT_EXE | dt, code_start, code_end
    if histo[0] < count // 10 or histo[255] < count // 100:
        return NOT_EXE | dt, code_start, code_end
    if int(histo[:16].sum()) > count // 2:
        return NOT_EXE | dt, code_start, code_end
    if jumps_x86 >= count // 200:
        return X86, code_start, code_end
    if jumps_arm >= count // 200:
        return ARM64, code_start, code_end
    return NOT_EXE | dt, code_start, code_end


class EXECodec(ByteTransform):
    def max_encoded_length(self, src_len: int) -> int:
        # reference EXECodec.hpp:96-100
        return src_len + 32 if src_len <= 256 else src_len + src_len // 8

    def forward(self, src: np.ndarray) -> Optional[np.ndarray]:
        src = as_u8(src)
        count = len(src)
        if count == 0:
            return src.copy()
        if count < MIN_BLOCK_SIZE or count > MAX_BLOCK_SIZE:
            return None
        dt = self.ctx.get_int("dataType", stats.UNDEFINED)
        if dt not in (stats.UNDEFINED, stats.EXE, stats.BIN):
            return None
        # bytes gives O(1)-ish conversion and Python-int indexing for the
        # header parse; the full tolist is deferred until a rewrite
        # actually runs (most blocks are NOT_EXE and skip it entirely)
        buf = src.tobytes()
        mode, code_start, code_end = detect_type(buf, count)
        if mode & NOT_EXE:
            self.ctx.put("dataType", mode & MASK_DT)
            return None
        mode &= ~MASK_DT
        res = None
        from kanzi_tpu_torch.utils import native
        if mode in (X86, ARM64) and native.transforms_available():
            res = native.exe_forward(src, mode == ARM64, code_start,
                                     code_end, self.capacity_for(count))
        elif mode == X86:
            res = self._forward_x86(src, src.tolist(), count, code_start,
                                    code_end)
        elif mode == ARM64:
            res = self._forward_arm(src, src.tolist(), count, code_start,
                                    code_end)
        if res is not None:
            self.ctx.put("dataType", stats.EXE)
        return res

    def _forward_x86(self, src, data, count, code_start, code_end):
        dst_capacity = self.capacity_for(count)
        dst = bytearray(9)
        dst[0] = X86
        src_idx = code_start
        matches = 0
        dst_end = dst_capacity - 5
        boundary = False
        if code_start < 0 or code_start > count or 9 + code_start > dst_capacity:
            return None
        if code_end < code_start or code_end > count:
            return None
        if code_start > 0:
            dst += src[:code_start].tobytes()

        while src_idx < code_end and len(dst) < dst_end:
            if data[src_idx] == X86_TWO_BYTE_PREFIX:
                if src_idx + 1 >= code_end:
                    boundary = True
                    break
                if (data[src_idx + 1] & X86_MASK_JCC) == X86_INSTRUCTION_JCC:
                    if src_idx + 5 >= code_end:
                        boundary = True
                        break
                dst.append(data[src_idx])
                src_idx += 1
                if (data[src_idx] & X86_MASK_JCC) != X86_INSTRUCTION_JCC:
                    if data[src_idx] == X86_ESCAPE:
                        dst.append(X86_ESCAPE)
                    dst.append(data[src_idx])
                    src_idx += 1
                    continue
                if src_idx + 4 >= code_end:
                    boundary = True
                    break
            elif (data[src_idx] & X86_MASK_JUMP) != X86_INSTRUCTION_JUMP:
                if data[src_idx] == X86_ESCAPE:
                    dst.append(X86_ESCAPE)
                dst.append(data[src_idx])
                src_idx += 1
                continue
            elif src_idx + 4 >= code_end:
                boundary = True
                break

            sgn = data[src_idx + 4]
            offset = _le32(data, src_idx + 1)
            if (sgn not in (0, 0xFF)) or offset == _i32(0xFF000000):
                dst.append(X86_ESCAPE)
                dst.append(data[src_idx])
                src_idx += 1
                continue
            addr = src_idx + (offset if sgn == 0 else -((-offset) & X86_ADDR_MASK))
            dst.append(data[src_idx])
            src_idx += 1
            dst += ((addr ^ MASK_ADDRESS) & 0xFFFFFFFF).to_bytes(4, "big")
            src_idx += 4
            matches += 1

        if matches < 16 or (src_idx < code_end and not boundary):
            return None
        if len(dst) + (count - src_idx) > dst_end:
            return None
        dst[1:5] = (code_start & 0xFFFFFFFF).to_bytes(4, "little")
        dst[5:9] = (len(dst) & 0xFFFFFFFF).to_bytes(4, "little")
        dst += src[src_idx:count].tobytes()
        if len(dst) > count + count // 50:
            return None
        return np.frombuffer(bytes(dst), dtype=np.uint8)

    def _forward_arm(self, src, data, count, code_start, code_end):
        dst_capacity = self.capacity_for(count)
        dst = bytearray(9)
        dst[0] = ARM64
        src_idx = code_start
        matches = 0
        dst_end = dst_capacity - 8
        if code_start < 0 or code_start > count or 9 + code_start > dst_capacity:
            return None
        if code_end < code_start or code_end > count:
            return None
        if code_start > 0:
            dst += src[:code_start].tobytes()

        while src_idx + 4 <= code_end and len(dst) < dst_end:
            instr = _le32(data, src_idx)
            op1 = instr & _i32(ARM_B_OPCODE_MASK)
            is_bl = op1 in (ARM_OPCODE_B, ARM_OPCODE_BL)
            if not is_bl:
                dst += src[src_idx:src_idx + 4].tobytes()
                src_idx += 4
                continue
            offset = instr & ARM_B_ADDR_MASK
            sgn = instr & ARM_B_ADDR_SGN_MASK
            addr = src_idx + 4 * (offset if sgn == 0 else -((-offset) & ARM_B_ADDR_MASK))
            if addr < 0:
                addr = 0
            val = op1 | (addr >> 2)
            if addr == 0:
                dst += (val & 0xFFFFFFFF).to_bytes(4, "little")
                dst += src[src_idx:src_idx + 4].tobytes()
                src_idx += 4
                continue
            dst += (val & 0xFFFFFFFF).to_bytes(4, "little")
            src_idx += 4
            matches += 1

        if matches < 16 or (src_idx + 4 <= code_end and len(dst) >= dst_end):
            return None
        if len(dst) + (count - src_idx) > dst_end:
            return None
        dst[1:5] = (code_start & 0xFFFFFFFF).to_bytes(4, "little")
        dst[5:9] = (len(dst) & 0xFFFFFFFF).to_bytes(4, "little")
        dst += src[src_idx:count].tobytes()
        if len(dst) > count + count // 50:
            return None
        return np.frombuffer(bytes(dst), dtype=np.uint8)

    def inverse(self, src: np.ndarray) -> np.ndarray:
        src = as_u8(src)
        count = len(src)
        if count == 0:
            return src.copy()
        if count < 9:
            raise ValueError("EXE codec: block too short")
        mode = int(src[0])
        from kanzi_tpu_torch.utils import native
        if mode in (X86, ARM64) and native.transforms_available():
            return native.exe_inverse(src, mode == ARM64)
        if mode == X86:
            return self._inverse_x86(src, count)
        if mode == ARM64:
            return self._inverse_arm(src, count)
        raise ValueError("EXE codec: invalid mode")

    def _inverse_x86(self, src, count):
        data = src.tolist()
        src_idx = 9
        dst = bytearray()
        code_start = _le32(data, 1)
        code_end = _le32(data, 5)
        if code_start < 0 or code_end < src_idx or code_end > count or \
                code_start > code_end - src_idx:
            raise ValueError("EXE codec: invalid code range")
        if code_start > 0:
            dst += src[src_idx:src_idx + code_start].tobytes()
            src_idx += code_start
        while src_idx < code_end:
            if data[src_idx] == X86_TWO_BYTE_PREFIX:
                if src_idx + 1 >= code_end:
                    dst.append(data[src_idx])
                    src_idx += 1
                    break
                dst.append(data[src_idx])
                src_idx += 1
                if (data[src_idx] & X86_MASK_JCC) != X86_INSTRUCTION_JCC:
                    if data[src_idx] == X86_ESCAPE:
                        src_idx += 1
                        if src_idx >= code_end:
                            raise ValueError("EXE codec: truncated escape")
                    dst.append(data[src_idx])
                    src_idx += 1
                    continue
            elif (data[src_idx] & X86_MASK_JUMP) != X86_INSTRUCTION_JUMP:
                if data[src_idx] == X86_ESCAPE:
                    src_idx += 1
                    if src_idx >= code_end:
                        raise ValueError("EXE codec: truncated escape")
                dst.append(data[src_idx])
                src_idx += 1
                continue
            if src_idx + 4 >= code_end:
                raise ValueError("EXE codec: truncated address")
            addr = _be32(data, src_idx + 1) ^ _i32(MASK_ADDRESS)
            offset = addr - len(dst)
            enc = offset if offset >= 0 else -((-offset) & X86_ADDR_MASK)
            dst.append(data[src_idx])
            src_idx += 1
            dst += (enc & 0xFFFFFFFF).to_bytes(4, "little")
            src_idx += 4
        dst += src[src_idx:count].tobytes()
        return np.frombuffer(bytes(dst), dtype=np.uint8)

    def _inverse_arm(self, src, count):
        data = src.tolist()
        src_idx = 9
        dst = bytearray()
        code_start = _le32(data, 1)
        code_end = _le32(data, 5)
        if code_start < 0 or code_end < src_idx or code_end > count or \
                code_start > code_end - src_idx:
            raise ValueError("EXE codec: invalid code range")
        if code_start > 0:
            dst += src[src_idx:src_idx + code_start].tobytes()
            src_idx += code_start
        while src_idx < code_end:
            if src_idx + 4 > code_end:
                raise ValueError("EXE codec: truncated instruction")
            instr = _le32(data, src_idx)
            op1 = instr & _i32(ARM_B_OPCODE_MASK)
            is_bl = op1 in (ARM_OPCODE_B, ARM_OPCODE_BL)
            if not is_bl:
                dst += src[src_idx:src_idx + 4].tobytes()
                src_idx += 4
                continue
            addr = (instr & ARM_B_ADDR_MASK) << 2
            offset = (addr - len(dst)) >> 2
            val = op1 | (offset & ARM_B_ADDR_MASK)
            if addr == 0:
                if src_idx + 8 > code_end:
                    raise ValueError("EXE codec: truncated escape")
                dst += src[src_idx + 4:src_idx + 8].tobytes()
                src_idx += 8
                continue
            dst += (val & 0xFFFFFFFF).to_bytes(4, "little")
            src_idx += 4
        dst += src[src_idx:count].tobytes()
        return np.frombuffer(bytes(dst), dtype=np.uint8)
