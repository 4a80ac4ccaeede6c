"""Philox4x32-10 of the port: known answers, exact products, counter addressing."""

import numpy as np
import pytest
import torch

from ofdm_tpu_torch.ops import prng

M32 = 0xFFFFFFFF

# Random123's known-answer vectors: (counter, key) -> words.
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32,) * 4, (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    (
        (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
        (0xA4093822, 0x299F31D0),
        (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
    ),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_known_answers(ctr, key, want):
    words = prng.philox4x32_10(*(torch.tensor([c], dtype=torch.int64) for c in ctr), key)
    assert tuple(int(w[0]) for w in words) == want


def test_mulhilo_is_exact():
    rng = np.random.default_rng(7)
    b = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64)
    b[:3] = (0, 1, M32)
    for a in (0xD2511F53, 0xCD9E8D57):
        hi, lo = prng._mulhilo(a, torch.tensor(b.astype(np.int64)))
        want = [a * int(x) for x in b]
        assert hi.tolist() == [w >> 32 for w in want]
        assert lo.tolist() == [w & M32 for w in want]


@pytest.mark.parametrize("cuts", [(0, 700, 1000), (0, 1, 999, 1000), (0, 512, 1000)])
def test_link_words_do_not_depend_on_chunking(cuts):
    key = prng.key_words(0x1234_5678_9ABC_DEF0)
    a, b = 3_000_000_000, 3_000_001_000  # crosses no 2^32 boundary: also check hi words below
    whole = prng.link_words(key, a, b - a, 64)
    parts = [prng.link_words(key, a + s, e - s, 64) for s, e in zip(cuts[:-1], cuts[1:])]
    for w, ws in zip(whole, zip(*parts)):
        assert torch.equal(w, torch.cat(ws))


def test_link_words_address_high_symbol_words():
    key = (5, 6)
    sym0 = (1 << 32) - 2
    raw, w1, w2 = prng.link_words(key, sym0, 4, 3)
    for i in range(4):
        s = sym0 + i
        for k in range(3):
            ctr = [torch.tensor([v]) for v in (s & M32, s >> 32, k, 0)]
            want = [int(w[0]) for w in prng.philox4x32_10(*ctr, key)]
            assert [int(raw[i, k]), int(w1[i, k]), int(w2[i, k])] == want[:3]


def test_philox_words_cpu_is_plain_and_distinct_streams():
    w = prng.philox_words(1024, 3, 9, (11, 12), "cpu")
    assert torch.equal(w, prng.philox_words_plain(1024, 3, 9, (11, 12)))
    assert w.shape == (1024, 4) and int(w.min()) >= 0 and int(w.max()) <= M32
    assert len(set(w[:, 0].tolist())) == 1024


def test_key_words_range():
    assert prng.key_words((7 << 32) | 9) == (9, 7)
    with pytest.raises(ValueError):
        prng.key_words(-1)
