"""Port parity: metamer extraction (K1's plain version) equals the JAX
package's ``extract_metamers`` bit for bit, on the generators of
tests/test_encode.py (N, IUPAC, lowercase, lengths 24-1001)."""

import numpy as np
import pytest
import torch

from metabuli_tpu.ops import encode as jenc
from metabuli_tpu.ops.genetic_code import encode_seqs_padded
from metabuli_tpu_torch.ops import encode as tenc
import ref_impl


def _iupac_dna(rng, length):
    bases = np.array(list(b"ACGT"), np.uint8)
    iupac = np.array(list(b"RYSWKMBDHUVNX*-"), np.uint8)
    seq = bases[rng.integers(0, 4, size=length)]
    m = rng.random(length) < 0.03
    seq[m] = iupac[rng.integers(0, len(iupac), size=int(m.sum()))]
    m = rng.random(length) < 0.2
    low = seq[m]
    seq[m] = np.where((low >= 65) & (low <= 90), low + 32, low)
    return seq.tobytes()


def _compare(seqs, max_len=None, **kw):
    codes, lens = encode_seqs_padded(list(seqs), max_len=max_len)
    want = jenc.extract_metamers(codes, lens, **kw)
    got = tenc.extract_metamers(torch.from_numpy(codes),
                                torch.from_numpy(lens), **kw)
    valid = np.asarray(want.valid)
    assert np.array_equal(got.valid.numpy(), valid)
    assert np.array_equal(got.pos.numpy(), np.asarray(want.pos))
    # values are only defined on valid windows
    assert np.array_equal(got.value.numpy()[valid],
                          np.asarray(want.value).view(np.int64)[valid])
    assert np.array_equal(got.dna48.numpy()[valid],
                          np.asarray(want.dna48).view(np.int64)[valid])
    return int(valid.sum())


@pytest.mark.parametrize("syncmer", [0, 1])
@pytest.mark.parametrize("length", [24, 25, 26, 47, 151, 302, 1001])
def test_extract_matches_jax(length, syncmer):
    rng = np.random.default_rng(length + 7 * syncmer)
    seqs = [ref_impl.random_dna(rng, length, n_prob=0.03) for _ in range(6)]
    n = _compare(seqs, syncmer=bool(syncmer))
    assert n > 0 or length < 26


@pytest.mark.parametrize("syncmer", [0, 1])
def test_extract_mixed_lengths_iupac_lowercase(syncmer):
    rng = np.random.default_rng(31 + syncmer)
    lengths = [2, 23, 24, 60, 99, 150, 151, 152, 250]
    seqs = [_iupac_dna(rng, L) for L in lengths]
    assert _compare(seqs, max_len=260, syncmer=bool(syncmer)) > 0


@pytest.mark.parametrize("smer_len", [3, 6, 7])
def test_extract_syncmer_lengths(smer_len):
    rng = np.random.default_rng(100 + smer_len)
    seqs = [ref_impl.random_dna(rng, 160, n_prob=0.1) for _ in range(6)]
    assert _compare(seqs, syncmer=True, smer_len=smer_len) > 0


def test_extract_short_batch_is_empty():
    codes, lens = encode_seqs_padded([b"ACGTACGTAC"])
    mm = tenc.extract_metamers(torch.from_numpy(codes),
                               torch.from_numpy(lens))
    assert mm.value.shape == (1, 6, 0)


@pytest.mark.parametrize("syncmer", [0, 1])
def test_extract_long_row_among_reads(syncmer):
    """A ~5,000-base row among 150-base reads: the batch's windows span
    several of K1's 256-window chunks, the short rows' windows past their
    end stay invalid."""
    rng = np.random.default_rng(50 + syncmer)
    seqs = [ref_impl.random_dna(rng, 150, n_prob=0.01) for _ in range(5)]
    seqs.insert(2, ref_impl.random_dna(rng, 5003, n_prob=0.002))
    assert _compare(seqs, syncmer=bool(syncmer)) > 4000
