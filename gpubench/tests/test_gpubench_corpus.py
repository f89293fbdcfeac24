"""The general generator: deterministic by seed, the stated sizes, the
tar's layout and the chunk bounds."""

import json
import os

import numpy as np
import pytest

from gpubench import corpus

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def traffic(name):
    return json.load(open(os.path.join(HERE, "traffic", name + ".json")))


@pytest.mark.parametrize("cls", sorted(corpus.CLASSES))
def test_class_exact_size_and_seeded(cls):
    gen = corpus.CLASSES[cls]
    a = gen(corpus.member_rng(2**33 + 7, 0), 50001)
    b = gen(corpus.member_rng(2**33 + 7, 0), 50001)
    c = gen(corpus.member_rng(2**33 + 8, 0), 50001)
    assert a.dtype == np.uint8 and a.size == 50001
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


def test_silesia_tar_layout():
    tr = traffic("silesia")
    assert tr["tar_size"] == 211957760
    sizes = [m["size"] for m in tr["members"]]
    assert sum(sizes) == 211938580          # the corpus's twelve members
    small = dict(tr, members=[dict(m, size=1000 + k) for k, m in
                              enumerate(tr["members"])])
    small["tar_size"] = sum(512 + m["size"] + (-m["size"] % 512)
                            for m in small["members"]) + 1024 + 512
    data = corpus.make_stream(small, 11)
    assert len(data) == small["tar_size"]
    assert data[257:262] == b"ustar"
    assert data[0:len(b"dickens")] == b"dickens"


def test_stream_deterministic_and_sized():
    tr = dict(traffic("enwik8"), members=[dict(traffic("enwik8")["members"][0],
                                               size=200000)])
    a = corpus.make_files(tr, 2**40 + 1)
    assert a == corpus.make_files(tr, 2**40 + 1)
    assert a != corpus.make_files(tr, 2**40 + 2)
    assert [len(f) for f in a] == [200000]
    assert a[0].startswith(b"<mediawiki")


def test_chunk_bounds_and_multiset():
    split = traffic("chunks")["split"]
    total = 100000000
    s1 = corpus.chunk_sizes(split, total, 1)
    s2 = corpus.chunk_sizes(split, total, 2)
    assert sum(s1) == total
    assert sorted(s1) == sorted(s2) and s1 != s2     # one multiset, reordered
    body = sorted(s1)[1:]                             # the tail may be short
    assert min(body) >= split["min"] and max(s1) <= split["max"]
    assert 0.8e6 < np.mean(s1) < 1.4e6               # about 1 MiB


def test_published_sizes_named():
    assert traffic("enwik8")["members"][0]["size"] == 100000000
    assert traffic("enwik8")["published_compressed"]["kanzi-l7"] == 22817360
    assert traffic("silesia")["published_compressed"]["kanzi-l5"] == 53853702
