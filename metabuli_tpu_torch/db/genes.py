"""Gene prediction for database construction (ctypes bridge).

Drives the native modules that replace the reference's vendored Prodigal
during `build` (`IndexCreator.cpp:1128-1218`): per-species training on the
longest sequence, min-hash strandedness check, gene prediction, and
extended-ORF block computation.

Two predictors, selected by the reference's own mode rule
(`IndexCreator.cpp:1140-1151`):

  * single mode (training sequence >= 100 kb, non-Eukaryota):
    `native/prodigal.cpp`, a BIT-EXACT port of the vendored Prodigal's
    trainASpecies + getPredictedGenes (locked against the compiled
    reference by tests/test_prodigal_port.py);
  * meta mode (< 100 kb or Eukaryota): the reference would use Prodigal's
    50 precomputed metagenomic models, which are a missing large blob in
    the reference checkout — `native/genepred.cpp`'s self-training
    reimplementation stands in (no oracle authority possible).

The min-hash / intergenic-kmer / extended-ORF machinery follows the
reference semantics exactly (`SeqIterator.cpp:65-152`,
`ProdigalWrapper.cpp:344-560`).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..native import get_lib

MINHASH_CAP = 3000
INTER_CAP = 1 << 16


class GenePredictor:
    """Per-species trained predictor with the reference's build protocol."""

    def __init__(self):
        self.lib = get_lib()
        if self.lib is None:
            raise RuntimeError("native library unavailable")
        self.lib.gp_train.restype = ctypes.c_int64
        self.lib.gp_predict.restype = ctypes.c_int64
        self.lib.gp_minhash.restype = ctypes.c_int64
        self.lib.gp_minhash_same_strand.restype = ctypes.c_int32
        self.lib.gp_intergenic_kmers.restype = ctypes.c_int64
        self.lib.gp_extended_orfs.restype = ctypes.c_int64
        self.lib.gp_xxh64.restype = ctypes.c_uint64
        self.lib.pdg_train.restype = ctypes.c_int64
        self.lib.pdg_predict.restype = ctypes.c_int64
        self.lib.pdg_train_meta.restype = ctypes.c_int64
        self.lib.pdg_meta_load.restype = ctypes.c_int64
        self._model = 0
        self._port = False      # True: bit-exact Prodigal port (single mode)
        self._meta_bins = self._load_meta_bins()
        self._train_len = 0
        self._train_sketch = None
        self._inter = np.zeros(INTER_CAP, np.uint64)
        self._n_inter = ctypes.c_int64(0)

    # keyed on the METABULI_META_BINS value so setting/changing the env
    # var after the first GenePredictor still (re)loads the bins
    _meta_bins_cache: dict[str, int] = {}

    def _load_meta_bins(self) -> int:
        """Load the Prodigal metagenomic training bins (once per env-var
        value) from METABULI_META_BINS. The reference's own 50 bins are a
        missing large blob in this checkout (lib/prodigal/training.cpp in
        .MISSING_LARGE_BLOBS); with a bin file supplied, meta-mode gene
        prediction (< 100 kb or Eukaryota, `IndexCreator.cpp:1140-1151`)
        runs the reference's trainMeta machinery bit-exactly (differential:
        tests/test_prodigal_port.py::test_meta_mode_vs_compiled_reference);
        without one it falls back to the self-training stand-in."""
        import os

        cache = GenePredictor._meta_bins_cache
        path = os.environ.get("METABULI_META_BINS", "")
        if path not in cache:
            n = 0
            if path:
                n = max(0, int(self.lib.pdg_meta_load(path.encode())))
            cache[path] = n
        return cache[path]

    def _free_model(self):
        if self._model and self.lib is not None:
            try:
                if self._port:
                    self.lib.pdg_free(ctypes.c_int64(self._model))
                else:
                    self.lib.gp_free(ctypes.c_int64(self._model))
            except Exception:
                pass
        self._model = 0

    def __del__(self):
        if getattr(self, "_model", 0):
            self._free_model()

    # ------------------------------------------------------------- training
    def train(self, seq: bytes, euk: bool = False):
        """Train on the species' longest sequence; seeds the intergenic
        23-mer list and the strandedness sketch (`IndexCreator.cpp:1130-1166`).
        Mode selection mirrors `IndexCreator.cpp:1140-1151`: single mode
        (the bit-exact Prodigal port) for >= 100 kb non-Eukaryota training
        sequences, the self-training meta stand-in otherwise."""
        self._free_model()
        meta_case = len(seq) < 100_000 or euk
        self._port = not meta_case
        if self._port:
            self._model = int(self.lib.pdg_train(seq, ctypes.c_int64(len(seq))))
        elif self._meta_bins:
            h = int(self.lib.pdg_train_meta(
                seq, ctypes.c_int64(len(seq)), None))
            if h > 0:
                self._model = h
                self._port = True  # predict through the port's meta path
            else:  # no GC-compatible bin: stand-in keeps the build going
                self._model = int(self.lib.gp_train(seq, ctypes.c_int64(len(seq))))
        else:
            self._model = int(self.lib.gp_train(seq, ctypes.c_int64(len(seq))))
        self._train_len = len(seq)
        self._train_sketch = self.minhash(seq)
        self._n_inter = ctypes.c_int64(0)
        # the intergenic seed uses the RAW gene list (the reference passes
        # prodigal->genes, not finalGenes, to generateIntergenicKmerList)
        genes = self.predict(seq, final=False)
        if len(genes[0]):
            n = self.lib.gp_intergenic_kmers(
                seq, ctypes.c_int64(len(seq)),
                genes[0].ctypes, genes[1].ctypes, genes[2].ctypes,
                ctypes.c_int64(len(genes[0])),
                self._inter.ctypes, ctypes.c_int64(INTER_CAP),
            )
            self._n_inter = ctypes.c_int64(int(n))
        # snapshot the freshly-seeded list so per-batch processing can
        # reset to the post-training state (the reference seeds a new
        # ProdigalWrapper per AccessionBatch, `IndexCreator.cpp:1128-1218`)
        self._inter0 = self._inter.copy()
        self._n_inter0 = int(self._n_inter.value)

    def reset_intergenic(self):
        """Restore the intergenic 23-mer list to its post-train state."""
        if getattr(self, "_inter0", None) is not None:
            self._inter[:] = self._inter0
            self._n_inter = ctypes.c_int64(self._n_inter0)

    def minhash(self, seq: bytes) -> np.ndarray:
        out = np.zeros(MINHASH_CAP + 1, np.uint64)
        n = self.lib.gp_minhash(
            seq, ctypes.c_int64(len(seq)), out.ctypes,
            ctypes.c_int64(MINHASH_CAP),
        )
        return out[: int(n)]

    def same_strand(self, seq: bytes) -> bool:
        """compareMinHashList vs the training sketch (`SeqIterator.cpp:65-86`)."""
        sk = self.minhash(seq)
        return bool(self.lib.gp_minhash_same_strand(
            self._train_sketch.ctypes, ctypes.c_int64(len(self._train_sketch)),
            sk.ctypes, ctypes.c_int64(len(sk)),
            ctypes.c_int64(self._train_len), ctypes.c_int64(len(seq)),
        ))

    # ------------------------------------------------------------ prediction
    def predict(self, seq: bytes, final: bool = True):
        """Predicted genes (1-based begin/end, strand +1/-1). ``final``
        applies removeCompletelyOverlappingGenes (the list fed to the
        extended-ORF blocks); ``final=False`` is the raw list (the
        intergenic 23-mer seed). The meta stand-in always dedups."""
        cap = max(64, len(seq) // 200)
        while True:
            b = np.zeros(cap, np.int32)
            e = np.zeros(cap, np.int32)
            s = np.zeros(cap, np.int32)
            if self._port:
                n = int(self.lib.pdg_predict(
                    ctypes.c_int64(self._model), seq,
                    ctypes.c_int64(len(seq)),
                    b.ctypes, e.ctypes, s.ctypes, ctypes.c_int64(cap),
                    ctypes.c_int32(1 if final else 0),
                ))
            else:
                n = int(self.lib.gp_predict(
                    ctypes.c_int64(self._model), seq, ctypes.c_int64(len(seq)),
                    b.ctypes, e.ctypes, s.ctypes, ctypes.c_int64(cap),
                ))
            if n <= cap:
                return b[:n], e[:n], s[:n]
            cap = n

    def extended_orfs(self, seq: bytes):
        """Predicted genes -> extended-ORF SequenceBlocks (start, end,
        strand; 0-based inclusive), updating the intergenic 23-mer list."""
        gb, ge, gs = self.predict(seq, final=True)
        cap = max(16, 2 * len(gb) + 4)
        bs = np.zeros(cap, np.int32)
        be = np.zeros(cap, np.int32)
        bt = np.zeros(cap, np.int32)
        n = int(self.lib.gp_extended_orfs(
            seq, ctypes.c_int64(len(seq)),
            gb.ctypes, ge.ctypes, gs.ctypes, ctypes.c_int64(len(gb)),
            self._inter.ctypes, ctypes.byref(self._n_inter),
            ctypes.c_int64(INTER_CAP),
            bs.ctypes, be.ctypes, bt.ctypes, ctypes.c_int64(cap),
        ))
        return bs[:n], be[:n], bt[:n]


def revcomp(seq: bytes) -> bytes:
    return seq.translate(bytes.maketrans(b"ACGTacgt", b"TGCAtgca"))[::-1]
