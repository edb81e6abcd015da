"""Port parity for kernel K12's plain versions, the amino-acid k-mer
scanners of the UniRef DBs: ``encode_aa_seqs_padded``,
``extract_aa_kmers`` (protein rows, syncmers off and on) and
``extract_aa_kmers_dna`` (6-frame translated DNA rows), against the JAX
package on the CPU. Tolerance is zero: every output slot, valid or not,
is equal."""

import numpy as np
import pytest
import torch

from metabuli_tpu.ops import encode as jenc
from metabuli_tpu.ops.genetic_code import encode_seqs_padded
from metabuli_tpu_torch.ops import encode as tenc

import ref_impl

# residues, the ambiguity and gap letters (codes 20-27) and lowercase
# (invalid in the reference's table)
LETTERS = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV" * 3 + b"BZUOX*-.?acwy",
                        np.uint8)


def _assert_equal(want, got):
    for w, g in zip(want, got):
        w = np.asarray(w)
        if w.dtype == np.uint64:
            w = w.view(np.int64)
        assert g.shape == w.shape
        assert np.array_equal(g.numpy(), w)


def _proteins(rng, lengths):
    return [bytes(rng.choice(LETTERS, n)) for n in lengths]


def test_encode_aa_seqs_padded_equals_jax():
    rng = np.random.default_rng(1)
    seqs = _proteins(rng, [0, 3, 40, 17]) + ["MKV*x"]
    assert np.array_equal(tenc.AA_CHAR_CODE, jenc.AA_CHAR_CODE)
    for max_len in (None, 8, 64):
        want = jenc.encode_aa_seqs_padded(seqs, max_len)
        got = tenc.encode_aa_seqs_padded(seqs, max_len)
        for w, g in zip(want, got):
            assert w.dtype == g.dtype and np.array_equal(w, g)


@pytest.mark.parametrize("syncmer,smer_len", [(0, 5), (1, 5), (1, 3),
                                               (1, 12)])
def test_extract_aa_kmers_equals_jax(syncmer, smer_len):
    """Rows shorter than k, at k and past it, residues above 23 and
    lowercase letters (both invalid), padded to a shared length."""
    rng = np.random.default_rng(10 + smer_len + syncmer)
    seqs = _proteins(rng, [0, 5, 11, 12, 13, 60, 300])
    seqs += [bytes(rng.choice(LETTERS[:20], 200))] * 2
    codes, lens = jenc.encode_aa_seqs_padded(seqs, 320)
    kw = dict(syncmer=bool(syncmer), smer_len=smer_len)
    want = jenc.extract_aa_kmers(codes, lens, **kw)
    got = tenc.extract_aa_kmers(torch.from_numpy(codes),
                                torch.from_numpy(lens), **kw)
    _assert_equal(want, got)
    assert got[2].sum() > (20 if syncmer else 300)


def test_extract_aa_kmers_short_batch():
    """A batch padded to less than k: no windows."""
    codes, lens = jenc.encode_aa_seqs_padded([b"MKV", b"A"])
    got = tenc.extract_aa_kmers(torch.from_numpy(codes),
                                torch.from_numpy(lens))
    assert [t.shape for t in got] == [(2, 0)] * 3
    _assert_equal(jenc.extract_aa_kmers(codes, lens), got)


@pytest.mark.parametrize("n_prob", [0.0, 0.03])
def test_extract_aa_kmers_dna_equals_jax(n_prob):
    """Lengths 0-400 (the residues mod 3 of each frame begin), N runs,
    mixed lengths in one batch."""
    rng = np.random.default_rng(int(n_prob * 100) + 3)
    lengths = [0, 1, 2, 3, 37, 38, 39, 40, 41, 42, 150, 151, 152, 299, 400]
    seqs = [ref_impl.random_dna(rng, n, n_prob=n_prob) for n in lengths]
    seqs.append(ref_impl.random_dna(rng, 120, 0.0) + b"N" * 9
                + ref_impl.random_dna(rng, 120, 0.0))
    codes, lens = encode_seqs_padded(seqs)
    want = jenc.extract_aa_kmers_dna(codes, lens)
    got = tenc.extract_aa_kmers_dna(torch.from_numpy(codes),
                                    torch.from_numpy(lens))
    _assert_equal(want, got)
    assert got[2][:, 3:].sum() > 0 and got[2][:, :3].sum() > 0


def test_extract_aa_kmers_dna_batched_equals_alone():
    """A record's valid k-mers (the multiset assign_uniref scores) are the
    same in a padded batch as alone, for every residue of its length
    mod 3: the reverse frames begin from the record's own length."""
    rng = np.random.default_rng(8)
    seqs = [ref_impl.random_dna(rng, n, n_prob=0.01)
            for n in (60, 61, 62, 150, 301)]
    codes, lens = encode_seqs_padded(seqs, 512)
    v, _, ok = tenc.extract_aa_kmers_dna(torch.from_numpy(codes),
                                         torch.from_numpy(lens))
    n = 0
    for i, s in enumerate(seqs):
        c1, l1 = encode_seqs_padded([s])
        jv, _, jok = jenc.extract_aa_kmers_dna(c1, l1)
        alone = np.sort(np.asarray(jv)[np.asarray(jok)].view(np.int64))
        batched = np.sort(v[i][ok[i]].numpy())
        assert np.array_equal(batched, alone)
        n += len(alone)
    assert n > 100


def test_aa_kmer_arguments_checked():
    codes = torch.zeros((2, 30), dtype=torch.uint8)
    lens = torch.full((2,), 30, dtype=torch.int32)
    with pytest.raises(ValueError):
        tenc.extract_aa_kmers(codes, lens, syncmer=True, smer_len=13)
    with pytest.raises(ValueError):
        tenc.extract_aa_kmers_dna(codes, lens[:1])
