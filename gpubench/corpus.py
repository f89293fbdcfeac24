"""One general generator of the benchmark's inputs.

A traffic mix is a JSON file under gpubench/traffic/ that this module
reads: the members of the corpus (each a name, a content class and a size
in bytes), how they are put together (one raw stream, or a tar archive of
a stated size) and how the result is cut into the files that the calls
compress (whole, or into content-defined backup chunks). Everything is
made from the run's seed with vectorised NumPy; nothing is read from
outside gpubench/.

The content classes stand in for the corpora kanzi's own README measures
(enwik8, silesia.tar). Each is a small token grammar or a numeric model
whose settings are listed under "assumed" in the traffic file; a new
traffic that reuses these classes is data only.
"""

from __future__ import annotations

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
_GATHER = 1 << 23            # output bytes gathered per pass (bounds temps)


def _words() -> list:
    with open(os.path.join(HERE, "data", "words.txt"), "rb") as f:
        return [w for w in f.read().split(b"\n") if w]


def _syllable_words(n: int, syll: list, seed: int) -> list:
    """n pseudo-words of 2-4 syllables, the long tail of a vocabulary
    (names, rare words), the same for every run seed."""
    r = np.random.default_rng(seed)
    k = r.integers(2, 5, n)
    picks = r.integers(0, len(syll), (n, 4))
    return [b"".join(syll[j] for j in picks[i, :k[i]]) for i in range(n)]


_SYLL_EN = [s.encode() for s in (
    "ka ro mi sel tan ber lin dor vak ast el mon ric hal wen gor ten sha "
    "bri col dan fer gil hur jor kel lor mar nor pel quin ros sor tor ul "
    "var wil yor zan ad ing er ton ley field ham burg ville ford wood"
).split()]
_SYLL_PL = [s.encode() for s in (
    "prze szcz rz cz sz dzie wie ko ni ła ło ść ąc ęd ży źd ńs ów ka ma "
    "sta go wa ra je mi na po za ro ta ny ki li do bie cie wy ze lu mó"
).split()]


class Pieces:
    """A table of byte strings; emit(ids) is their concatenation."""

    def __init__(self, strings):
        self.pool = np.frombuffer(b"".join(strings), np.uint8)
        self.len = np.array([len(s) for s in strings], np.int64)
        self.off = np.cumsum(self.len) - self.len

    def emit(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        lens = self.len[ids]
        out = np.empty(int(lens.sum()), np.uint8)
        ends = np.cumsum(lens)
        pos = 0
        i = 0
        while i < len(ids):
            j = int(np.searchsorted(ends, pos + _GATHER, "right"))
            j = max(j, i + 1)
            ln = lens[i:j]
            start = ends[i:j] - ln
            idx = np.repeat(self.off[ids[i:j]] - start, ln)
            idx += np.arange(pos, pos + idx.size)
            out[pos:pos + idx.size] = self.pool[idx]
            pos += idx.size
            i = j
        return out


def _zipf_p(n: int, s: float = 1.0, q: float = 2.7) -> np.ndarray:
    p = 1.0 / (np.arange(n) + q) ** s
    return p / p.sum()


class Grammar:
    """Units of slots, each slot a literal piece or a draw from a word
    table (Zipf over its ranks) or a number table (uniform). A text is a
    sequence of units drawn by weight, every slot resolved to a piece."""

    def __init__(self, rng, tables: dict, literals: list, units: list):
        # tables: name -> (list of byte strings, probabilities or None);
        # literals: pieces listed ahead of the units' own, part of the
        # table whose mean length sizes each batch of draws (so they fix
        # the stream a seed makes)
        self.rng = rng
        strings, self.base, self.p = [], {}, {}
        for name, (items, p) in tables.items():
            self.base[name] = len(strings)
            self.p[name] = p
            strings += items
            self.p[name + "#n"] = len(items)
        lit_ix = {}
        for s in literals + [x for u in units for x in u[1]
                             if isinstance(x, bytes)]:
            if s not in lit_ix:
                lit_ix[s] = len(strings)
                strings.append(s)
        self.pieces = Pieces(strings)
        nslot = max(len(u[1]) for u in units)
        self.weights = np.array([u[0] for u in units], float)
        self.weights /= self.weights.sum()
        self.nslots = np.array([len(u[1]) for u in units], np.int64)
        self.kind = np.full((len(units), nslot), -1, np.int64)
        self.lit = np.zeros((len(units), nslot), np.int64)
        self.tables = list(tables)
        for k, (_, slots) in enumerate(units):
            for j, s in enumerate(slots):
                if isinstance(s, bytes):
                    self.lit[k, j] = lit_ix[s]
                else:
                    self.kind[k, j] = self.tables.index(s)

    def text(self, size: int) -> np.ndarray:
        mean = float((self.pieces.len.mean() + 1) * (self.nslots * self.weights).sum())
        parts, total = [], 0
        while total < size:
            n = int((size - total) / mean * 1.1) + 64
            u = self.rng.choice(len(self.weights), n, p=self.weights)
            ns = self.nslots[u]
            su = np.repeat(u, ns)
            sj = np.arange(su.size) - np.repeat(np.cumsum(ns) - ns, ns)
            kind = self.kind[su, sj]
            ids = self.lit[su, sj]
            for t, name in enumerate(self.tables):
                m = kind == t
                cnt = int(m.sum())
                if not cnt:
                    continue
                nt = self.p[name + "#n"]
                p = self.p[name]
                draw = (self.rng.choice(nt, cnt, p=p) if p is not None
                        else self.rng.integers(0, nt, cnt))
                ids[m] = self.base[name] + draw
            part = self.pieces.emit(ids)
            parts.append(part)
            total += part.size
        return np.concatenate(parts)[:size]


def _vocab(words, tail):
    """Word table: the frozen list first (most frequent), the syllable
    tail after it, Zipf over the ranks."""
    v = words + tail
    return v, _zipf_p(len(v))


def _cap(ws):
    return [w[:1].upper() + w[1:] for w in ws]


def _numbers(rng, n, lo, hi, fmt):
    return [(fmt % v).encode() for v in rng.integers(lo, hi, n)]


# ---------------------------------------------------------------------------
# content classes: gen(rng, size) -> uint8 [size]
# ---------------------------------------------------------------------------

def gen_wiki(rng, size):
    """Wikipedia XML dump pages: page/title/revision/text records around
    wiki markup, English words drawn Zipf-wise, numbers and dates."""
    words = _words()
    v, p = _vocab(words, _syllable_words(20000, _SYLL_EN, 1))
    sp = [b" " + w for w in v]
    g = Grammar(rng, {
        "w": (sp, p), "W": ([b" " + w for w in _cap(v)], p),
        "n": ([w for w in _cap(v)], p), "l": (v, p),
        "y": (_numbers(rng, 4000, 1000, 2100, " %d"), None),
        "k": (_numbers(rng, 4000, 0, 100000, " %d"), None),
    }, [b"[[", b"]]", b"|", b"'''", b"''", b"{{", b"}}", b",", b".", b"\n\n",
        b"\n== ", b" ==\n", b"\n* ", b" &lt;ref&gt;", b"&lt;/ref&gt;",
        b"\n|-\n|", b" ||", b" (", b")", b"\n[[Category:", b"]]\n",
        b" [http://www.", b".org]", b"&quot;", b" &amp;"],
        [(40, ["w"]), (5, ["W"]), (4, [b" [[", "n", b"]]"]),
         (1.5, [b" [[", "n", b"|", "l", b"]]"]), (1, [b" '''", "n", b"'''"]),
         (1, [b" ''", "l", b"''"]), (0.6, [b" {{", "l", b"|", "l", b"}}"]),
         (5, [b","]), (6, [b"."]), (1.2, [b".", b"\n\n"]),
         (0.3, [b"\n== ", "n", "w", b" ==\n"]), (0.5, [b"\n* ", "n"]),
         (1.5, ["y"]), (0.8, ["k"]), (0.3, [b" &lt;ref&gt;", "n", "w", "y", b"&lt;/ref&gt;"]),
         (0.3, [b"\n|-\n|", "w", b" ||", "k"]), (0.4, [b" (", "l", "y", b")"]),
         (0.15, [b"\n[[Category:", "n", "w", b"]]\n"]),
         (0.1, [b" [http://www.", "l", b".org]"]), (0.3, [b"&quot;"])])
    body = g.text(size)
    # cut the markup stream into pages of lognormal length around headers
    n_pages = size // 1000 + 2                 # their lengths cover size
    lens = np.maximum(64, rng.lognormal(7.3, 1.0, n_pages)).astype(np.int64)
    cuts = np.minimum(np.cumsum(lens), size)
    cuts[-1] = size
    titles = g.rng.choice(len(v), (n_pages, 2), p=p)
    user = g.rng.choice(len(v), n_pages, p=p)
    ts = g.rng.integers(0, 10**8, n_pages)
    out, prev, page_id = [b"<mediawiki xml:lang=\"en\">\n"], 0, 1
    capv = _cap(v)
    for i in range(n_pages):
        c = int(cuts[i])
        if c <= prev:
            break
        page_id += 1 + int(ts[i] % 7)
        t = ts[i]
        out.append(b"  <page>\n    <title>%s %s</title>\n    <id>%d</id>\n"
                   b"    <revision>\n      <id>%d</id>\n      <timestamp>"
                   b"200%d-%02d-%02dT%02d:%02d:%02dZ</timestamp>\n      "
                   b"<contributor>\n        <username>%s</username>\n"
                   b"        <id>%d</id>\n      </contributor>\n      "
                   b"<text xml:space=\"preserve\">" % (
                       capv[titles[i, 0]], v[titles[i, 1]], page_id,
                       page_id * 13 + 1000, t % 7, 1 + t % 12, 1 + t % 28,
                       t % 24, t % 60, (t >> 6) % 60, capv[user[i]],
                       t % 99991))
        out.append(body[prev:c].tobytes())
        out.append(b"</text>\n    </revision>\n  </page>\n")
        prev = c
    return np.frombuffer(b"".join(out), np.uint8)[:size]


def gen_prose(rng, size, syll=None):
    """Novel-like prose: sentences of Zipf words, commas, quotes, line
    breaks every few words, paragraphs (syll: a syllable set for a
    vocabulary of another language, UTF-8)."""
    words = _words() if syll is None else _syllable_words(3000, syll, 2)
    v, p = _vocab(words, _syllable_words(8000, syll or _SYLL_EN, 3))
    g = Grammar(rng, {"w": ([b" " + w for w in v], p),
                      "W": ([b" " + w for w in _cap(v)], p)},
                [b",", b".", b";", b"\n", b"\n\n", b" \"", b"\"", b"!", b"?"],
                [(60, ["w"]), (4, ["W"]), (6, [b","]), (5, [b"."]),
                 (6, [b"\n"]), (0.8, [b".", b"\n\n"]),
                 (0.6, [b";"]), (1, [b" \"", "W"]), (1, [b"\""]),
                 (0.4, [b"!"]), (0.4, [b"?"])])
    return g.text(size)


def gen_polish(rng, size):
    return gen_prose(rng, size, syll=_SYLL_PL)


def gen_html_dict(rng, size):
    """An HTML dictionary: one entry a headword, pronunciation, part of
    speech and definitions in English words."""
    words = _words()
    v, p = _vocab(words, _syllable_words(20000, _SYLL_EN, 4))
    g = Grammar(rng, {"w": ([b" " + w for w in v], p), "h": (_cap(v), p),
                      "pos": ([b"n.", b"v. t.", b"v. i.", b"a.", b"adv.",
                               b"prep."], None)},
                [b"<p><hw>", b"</hw> <pr>(", b")</pr>, <pos>", b"</pos>",
                 b"<def>", b"</def></p>\n", b"<sn>", b"</sn>", b",", b".",
                 b" <i>", b"</i>", b" [<ety>", b"</ety>]"],
                [(1, [b"<p><hw>", "h", b"</hw> <pr>(", "h", b")</pr>, <pos>",
                      "pos", b"</pos>", b"<def>"]),
                 (30, ["w"]), (3, [b","]), (2, [b"."]), (1, [b"</def></p>\n"]),
                 (0.5, [b"<sn>", "w", b"</sn>"]), (1, [b" <i>", "h", b"</i>"]),
                 (0.3, [b" [<ety>", "w", "w", b"</ety>]"])])
    return g.text(size)


def gen_xml(rng, size):
    """XML records: nested elements with attributes, words and numbers."""
    words = _words()
    v, p = _vocab(words, _syllable_words(5000, _SYLL_EN, 5))
    g = Grammar(rng, {"w": ([b" " + w for w in v], p), "t": (v, p),
                      "n": (_numbers(rng, 5000, 0, 10**6, "%d"), None)},
                [b"<record id=\"", b"\">\n  <name>", b"</name>\n  <value>",
                 b"</value>\n  <note>", b"</note>\n</record>\n", b"<",
                 b">", b"</", b">\n"],
                [(1, [b"<record id=\"", "n", b"\">\n  <name>", "t", b"</name>\n  <value>",
                      "n", b"</value>\n  <note>"]), (6, ["w"]),
                 (1, [b"</note>\n</record>\n"]),
                 (0.7, [b"<", "t", b">", "n", b"</", "t", b">\n"])])
    return g.text(size)


_C_TOKENS = [s.encode() for s in (
    "if ( ) { } ; , = == != -> . * & return int char void static struct "
    "const unsigned size_t NULL for while else break case switch default "
    "goto sizeof uint32_t bool true false talloc_free DEBUG status NTSTATUS "
    "TALLOC_CTX mem_ctx ret errno + - < > <= >= && || ! 0 1 2 -1"
).split()]


def gen_source(rng, size):
    """C source of a tar of many files: identifiers, keywords, operators,
    indentation and comments, a 512-byte tar header each file."""
    words = _words()
    ids, p = _vocab([w.replace(b"-", b"_") for w in words],
                    _syllable_words(6000, _SYLL_EN, 6))
    ident = [a + b"_" + b for a, b in zip(ids[:2000], ids[1000:3000])] + ids
    pi = _zipf_p(len(ident))
    g = Grammar(rng, {"i": ([b" " + w for w in ident], pi),
                      "k": ([b" " + t for t in _C_TOKENS], _zipf_p(len(_C_TOKENS), 0.6)),
                      "c": ([b" " + w for w in words], _zipf_p(len(words)))},
                [b"\n", b"\n\t", b"\n\t\t", b"\n/* ", b" */", b"\n#include <",
                 b".h>", b"(", b");"],
                [(20, ["k"]), (14, ["i"]), (3, [b"\n\t"]), (2, [b"\n\t\t"]),
                 (1.5, [b"\n"]), (0.3, [b"\n/* ", "c", "c", "c", "c", b" */"]),
                 (0.1, [b"\n#include <", "i", b".h>"]), (2, ["i", b"(", "i", b");"])])
    src = g.text(size)
    # a tar header every ~24 KiB (the archive's member files)
    pos, out = 0, []
    names = rng.choice(len(ident), size // 2000 + 2)
    k = 0
    while pos < size:
        n = int(rng.integers(2000, 46000))
        out.append(_tar_header(b"samba/source/" + ident[names[k]].strip() + b".c", n))
        out.append(src[pos:pos + n].tobytes())
        out.append(bytes(-n % 512))
        pos += n
        k += 1
    return np.frombuffer(b"".join(out), np.uint8)[:size]


def gen_chem(rng, size):
    """A chemical structure database as text: SD records of atom lines
    with fixed-width coordinates, bond lines and a record separator."""
    coord = [("%10.4f" % x).encode() for x in rng.normal(0, 3, 30000)]
    elem = [b" C   0  0  0  0  0  0  0  0  0  0  0  0\n", b" N   0  0  0  0  0  0  0  0  0  0  0  0\n",
            b" O   0  0  0  0  0  0  0  0  0  0  0  0\n", b" H   0  0  0  0  0  0  0  0  0  0  0  0\n",
            b" S   0  0  0  0  0  0  0  0  0  0  0  0\n", b" Cl  0  0  0  0  0  0  0  0  0  0  0  0\n"]
    bond = [("%3d%3d%3d  0  0  0  0\n" % (a, b, t)).encode()
            for a in range(1, 40) for b in range(1, 40) for t in (1, 2)]
    g = Grammar(rng, {"x": (coord, None), "e": (elem, [.5, .15, .15, .12, .05, .03]),
                      "b": (bond, None),
                      "id": (_numbers(rng, 5000, 1, 10**6, "%d\n"), None)},
                [b"\n  -ISIS-  ", b"\n\n", b"M  END\n$$$$\n"],
                [(20, ["x", "x", "x", "e"]), (20, ["b"]),
                 (1, [b"M  END\n$$$$\n", "id", b"\n  -ISIS-  ", "id", b"\n\n"])])
    return g.text(size)


def gen_exe(rng, size):
    """x86 executable bytes: instruction-like byte strings drawn Zipf-wise
    (a few thousand distinct, as compiled code repeats its idioms), string
    tables, little-endian pointer tables and zero padding."""
    ops = np.array([0x8B, 0x89, 0xE8, 0x83, 0x55, 0xC3, 0x50, 0x51, 0x53,
                    0x56, 0x57, 0x5D, 0x5E, 0x5F, 0x74, 0x75, 0xEB, 0x85,
                    0x33, 0x3B, 0x8D, 0xFF, 0x6A, 0x68, 0xC7, 0x0F, 0x81],
                   np.uint8)
    n_ins = 6000
    lens = rng.choice([1, 2, 3, 5, 6, 7], n_ins, p=[.2, .25, .25, .15, .1, .05])
    ins = []
    for i in range(n_ins):
        b = rng.integers(0, 256, lens[i]).astype(np.uint8)
        b[0] = ops[rng.integers(0, len(ops))]
        if lens[i] >= 5:                     # a small immediate or offset
            b[-2:] = 0 if rng.random() < .6 else 0xFF
        ins.append(b.tobytes())
    code = Pieces(ins)
    pz = _zipf_p(n_ins, 1.1)
    words = _words()
    strs = Pieces([w + b"\0" for w in words])
    out, total = [], 0
    while total < size:
        kind = rng.choice(4, p=[.72, .12, .1, .06])
        n = int(rng.integers(4096, 65536))
        if kind == 0:
            part = code.emit(rng.choice(n_ins, n // 3, p=pz))
        elif kind == 1:
            part = strs.emit(rng.choice(len(words), n // 8, p=_zipf_p(len(words))))
        elif kind == 2:
            base = int(rng.integers(0x400000, 0x800000))
            part = (base + np.cumsum(rng.integers(0, 64, n // 4))).astype("<u4").view(np.uint8)
        else:
            part = np.zeros(n, np.uint8)
        out.append(part)
        total += part.size
    return np.concatenate(out)[:size]


def gen_bindb(rng, size):
    """A binary database file: fixed 100-byte records of a sequential key,
    small integers, a double, a date and space-padded names."""
    n = size // 100 + 1
    words = _words()
    rec = np.zeros(n, np.dtype([("id", "<u4"), ("a", "<u2"), ("b", "<u2"),
                                ("x", "<f8"), ("date", "<u4"), ("flag", "u1"),
                                ("name", "S31"), ("city", "S24"), ("pad", "S24")]))
    rec["id"] = np.arange(1, n + 1)
    rec["a"] = rng.integers(0, 50, n)
    rec["b"] = rng.zipf(1.5, n).clip(0, 65535)
    rec["x"] = np.round(rng.gamma(2, 500, n), 2)
    rec["date"] = 19900101 + rng.integers(0, 30, n) * 10000 + rng.integers(1, 12, n) * 100
    rec["flag"] = rng.integers(0, 2, n)
    w = np.array(words, dtype="S31")
    rec["name"] = w[rng.choice(len(words), n, p=_zipf_p(len(words)))]
    rec["city"] = w[rng.integers(0, 200, n)].astype("S24")
    raw = rec.view(np.uint8).reshape(n, -1).copy()
    # the string fields are space padded, as a fixed-width table stores them
    sl = slice(rec.dtype.fields["name"][1], 100)
    seg = raw[:, sl]
    seg[seg == 0] = 0x20
    return raw.reshape(-1)[:size]


def _field(rng, h, w, blobs):
    """A smooth 2-D field: gaussian blobs over a gradient (a body in an
    image), values in [0, 1]."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    f = 0.2 + 0.2 * x / w
    for _ in range(blobs):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        s = rng.uniform(0.05, 0.3) * min(h, w)
        f += rng.uniform(0.2, 0.6) * np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / (2 * s * s))
    return f / f.max()


def gen_image16(rng, size, side=512, bits=12):
    """16-bit little-endian medical images: 12-bit slices of a smooth field
    with noise, one after another."""
    out, total = [], 0
    while total < size:
        f = _field(rng, side, side, 6)
        img = f * ((1 << bits) - 1) + rng.normal(0, 12, f.shape)
        img = np.clip(img, 0, (1 << bits) - 1).astype("<u2")
        out.append(img.view(np.uint8).reshape(-1))
        total += out[-1].size
    return np.concatenate(out)[:size]


def gen_xray(rng, size):
    return gen_image16(rng, size, side=1024, bits=12)


def gen_stars(rng, size):
    """A star catalogue: 28-byte records of a double right ascension in
    zones, a double declination, a spectral type and magnitudes."""
    n = size // 28 + 1
    rec = np.zeros(n, np.dtype([("ra", "<f8"), ("dec", "<f8"), ("sp", "S2"),
                                ("mag", "<i2"), ("pmra", "<f4"), ("pmdec", "<f4")]))
    zone = np.sort(rng.uniform(-np.pi / 2, np.pi / 2, n))
    rec["dec"] = zone
    rec["ra"] = rng.uniform(0, 2 * np.pi, n)
    rec["sp"] = np.array([b"A0", b"B5", b"F2", b"G0", b"K0", b"M2"])[rng.integers(0, 6, n)]
    rec["mag"] = (rng.normal(850, 120, n)).astype(np.int16)
    rec["pmra"] = rng.normal(0, 1e-6, n)
    rec["pmdec"] = rng.normal(0, 1e-6, n)
    return rec.view(np.uint8)[:size]


CLASSES = {"wiki": gen_wiki, "prose": gen_prose, "polish": gen_polish,
           "html_dict": gen_html_dict, "xml": gen_xml, "source": gen_source,
           "chem": gen_chem, "exe": gen_exe, "bindb": gen_bindb,
           "image16": gen_image16, "xray": gen_xray, "stars": gen_stars}


# ---------------------------------------------------------------------------
# assembly
# ---------------------------------------------------------------------------

def _tar_header(name: bytes, size: int) -> bytes:
    h = bytearray(512)
    h[0:len(name[:99])] = name[:99]
    h[100:108] = b"0000644\0"
    h[108:116] = b"0001750\0"
    h[116:124] = b"0001750\0"
    h[124:136] = b"%011o\0" % size
    h[136:148] = b"%011o\0" % 1104537600
    h[148:156] = b" " * 8
    h[156:157] = b"0"
    h[257:265] = b"ustar  \0"
    h[148:156] = b"%06o\0 " % sum(h)
    return bytes(h)


def member_rng(seed: int, k: int):
    return np.random.default_rng(np.random.SeedSequence([int(seed), k]))


def make_stream(traffic: dict, seed: int) -> bytes:
    """The corpus of a traffic mix: its members, raw or in a tar."""
    parts = []
    tar = traffic.get("container") == "tar"
    for k, m in enumerate(traffic["members"]):
        body = CLASSES[m["class"]](member_rng(seed, k), int(m["size"]))
        if body.size != m["size"]:
            raise ValueError(f"{m['name']}: made {body.size} bytes, not {m['size']}")
        if tar:
            parts.append(_tar_header(m["name"].encode(), int(m["size"])))
            parts.append(body.tobytes())
            parts.append(bytes(-int(m["size"]) % 512))
        else:
            parts.append(body.tobytes())
    data = b"".join(parts)
    if tar:
        data += bytes(1024)
        total = int(traffic["tar_size"])
        if len(data) > total:
            raise ValueError(f"tar of {len(data)} bytes over its {total}")
        data += bytes(total - len(data))
    return data


def chunk_sizes(split: dict, total: int, seed: int) -> list:
    """Backup-chunk sizes: min + an exponential draw of mean mean_extra,
    cut at max, drawn from the traffic's own size_seed (every run seed
    cuts the same multiset of sizes) and put in the run seed's order."""
    r = np.random.default_rng(int(split["size_seed"]))
    sizes, left = [], total
    while left > 0:
        n = int(min(split["max"], split["min"] + r.exponential(split["mean_extra"])))
        n = min(n, left)
        sizes.append(n)
        left -= n
    order = np.random.default_rng(np.random.SeedSequence([int(seed), 1 << 20]))
    return [sizes[i] for i in order.permutation(len(sizes))]


def make_files(traffic: dict, seed: int) -> list:
    """The files the window's calls compress, one call each, in order."""
    data = make_stream(traffic, seed)
    split = traffic.get("split")
    if not split:
        return [data]
    files, pos = [], 0
    for n in chunk_sizes(split, len(data), seed):
        files.append(data[pos:pos + n])
        pos += n
    return files
