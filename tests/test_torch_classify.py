"""Port end to end on the CPU: the golden world of tests/test_golden.py,
built by the JAX package's ``build_database`` and classified through the
port's CLI, gives the committed classifications and reports byte for
byte; paths the port does not have raise ``NotImplementedError``
(``tests/test_torch_slice7.py`` holds the host taxonomer, long reads and
the batch pipeline)."""

import os
import pathlib
import shutil

import pytest
import torch

from metabuli_tpu.db.build import build_database
from metabuli_tpu.params import BuildParams
from metabuli_tpu_torch.cli import main
from test_golden import GOLDEN_DIR, _world


def _golden_db(tmp_path, syncmer):
    root, q = _world(tmp_path)
    db = os.path.join(root, f"db_s{syncmer}")
    build_database(db, os.path.join(root, "library.txt"),
                   os.path.join(root, "acc2taxid.map"),
                   os.path.join(root, "taxonomy"),
                   BuildParams(gene_prediction=0, syncmer=syncmer,
                               mask_mode=1))
    return root, q, db


@pytest.mark.parametrize("syncmer", [0, 1])
def test_port_cli_reproduces_golden(tmp_path, syncmer):
    root, q, db = _golden_db(tmp_path, syncmer)
    out = os.path.join(root, "out")
    assert main(["classify", q, db, out, "gold", "--seq-mode", "1",
                 "--batch-reads", "8", "--device", "cpu"]) == 0
    for kind in ("classifications", "report"):
        got = pathlib.Path(out, f"gold_{kind}.tsv").read_text()
        want = (GOLDEN_DIR / f"{kind}_s{syncmer}.tsv").read_text()
        assert got == want, kind


@pytest.mark.parametrize("syncmer", [0, 1])
def test_port_paired_end_equals_jax(tmp_path, syncmer):
    """--seq-mode 2: mates share a read's (species, frame) blocks, with
    mate 2 offset by usedLen(mate 1) + 3."""
    from metabuli_tpu.classify.classifier import Classifier
    from metabuli_tpu.params import ClassifyParams

    root, q, db = _golden_db(tmp_path, syncmer)
    recs = pathlib.Path(q).read_text().split(">")[1:]
    mates = ([], [])
    for rec in recs:
        name, seq = rec.split("\n")[:2]
        rc = seq.translate(str.maketrans("ACGTN", "TGCAN"))[::-1]
        mates[0].append(f">{name}\n{seq[:80]}\n")
        mates[1].append(f">{name}\n{rc[:80]}\n")
    q1, q2 = os.path.join(root, "m1.fna"), os.path.join(root, "m2.fna")
    pathlib.Path(q1).write_text("".join(mates[0]))
    pathlib.Path(q2).write_text("".join(mates[1]))
    Classifier(db, ClassifyParams(seq_mode=2, batch_reads=8)).classify_file(
        q1, q2, os.path.join(root, "jax"), "pe")
    assert main(["classify", q1, q2, db, os.path.join(root, "port"), "pe",
                 "--seq-mode", "2", "--batch-reads", "8",
                 "--device", "cpu"]) == 0
    for kind in ("classifications", "report"):
        want = pathlib.Path(root, "jax", f"pe_{kind}.tsv").read_text()
        got = pathlib.Path(root, "port", f"pe_{kind}.tsv").read_text()
        assert got == want, kind
        if kind == "classifications":
            assert got.count("\n1\t") >= 15  # most pairs classified


def test_port_max_cap_below_deepest_group_equals_jax(tmp_path):
    """--max-cap 3 on a DB whose AA groups are 40 deep: the JAX retry
    ladder grows its cap to the DB's deepest group, the port starts there,
    and both write the same classifications and report."""
    import numpy as np

    from metabuli_tpu.classify.classifier import Classifier
    from metabuli_tpu.db.formats import DbParameters
    from metabuli_tpu.db.index import MetamerIndex
    from metabuli_tpu.db.taxonomy import Taxonomy
    from metabuli_tpu.params import ClassifyParams
    from metabuli_tpu_torch.classify.classifier import Classifier as Port
    from metabuli_tpu_torch.params import ClassifyParams as PortParams
    from test_torch_match import skew_data

    values, taxids, _, reads = skew_data(40)
    species = np.unique(taxids)
    tdir = tmp_path / "taxonomy"
    tdir.mkdir()
    (tdir / "nodes.dmp").write_text(
        "1\t|\t1\t|\tno rank\t|\n2\t|\t1\t|\tgenus\t|\n"
        + "".join(f"{t}\t|\t2\t|\tspecies\t|\n" for t in species))
    (tdir / "names.dmp").write_text("".join(
        f"{t}\t|\tT{t}\t|\t\t|\tscientific name\t|\n"
        for t in (1, 2, *species)))
    (tdir / "merged.dmp").write_text("")
    tax = Taxonomy.from_dmp(*(str(tdir / f) for f in
                              ("names.dmp", "nodes.dmp", "merged.dmp")))
    db = str(tmp_path / "db")
    MetamerIndex(values=values, taxids=taxids.astype(np.uint32),
                 taxonomy=tax, params=DbParameters(db_name="skew"),
                 max_group=40).save(db)
    q = tmp_path / "reads.fna"
    q.write_text("".join(f">r{i}\n{r.decode()}\n" for i, r in enumerate(reads)))

    jax_clf = Classifier(db, ClassifyParams(seq_mode=1, batch_reads=16,
                                            max_cap=3))
    assert jax_clf.cap == 3 < jax_clf.index.max_group == 40
    jax_clf.classify_file(str(q), None, str(tmp_path / "jax"), "f1")
    assert jax_clf.cap == 40  # the ladder ran to the deepest group
    port_clf = Port(db, PortParams(seq_mode=1, batch_reads=16, max_cap=3),
                    device="cpu")
    assert port_clf.cap == port_clf.index.max_group == 40
    assert main(["classify", str(q), db, str(tmp_path / "port"), "f1",
                 "--seq-mode", "1", "--batch-reads", "16", "--max-cap", "3",
                 "--device", "cpu"]) == 0
    for kind in ("classifications", "report"):
        want = (tmp_path / "jax" / f"f1_{kind}.tsv").read_bytes()
        got = (tmp_path / "port" / f"f1_{kind}.tsv").read_bytes()
        assert got == want, kind
    assert want.count(b"\n") > 2


@pytest.fixture(scope="module")
def golden_s0(tmp_path_factory):
    return _golden_db(tmp_path_factory.mktemp("gold"), 0)


@pytest.mark.parametrize("flags,item", [
    (["--reduced-aa", "1"], "item 9"),
    (["--max-ram", "0"], "item 7"),
])
def test_port_raises_for_paths_not_ported(tmp_path, golden_s0, flags,
                                          item):
    _, q, db = golden_s0
    if flags == ["--reduced-aa", "1"]:
        # db.parameters decides the alphabet: mark a copy of the DB reduced
        db = shutil.copytree(db, tmp_path / "db_reduced")
        p = pathlib.Path(db, "db.parameters")
        p.write_text(p.read_text().replace("Reduced_alphabet\t0",
                                           "Reduced_alphabet\t1"))
    with pytest.raises(NotImplementedError, match=item):
        main(["classify", q, str(db), str(tmp_path / "out"), "x",
              "--seq-mode", "1", "--device", "cpu", *flags])


def test_port_raises_for_multi_process_runs(tmp_path, golden_s0,
                                            monkeypatch):
    _, q, db = golden_s0
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="item 13"):
        main(["classify", q, db, str(tmp_path / "out"), "x", "--seq-mode",
              "1", "--device", "cpu"])


def test_port_defaults_to_cuda_and_never_falls_back_to_cpu(
        tmp_path, golden_s0, monkeypatch):
    _, q, db = golden_s0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["classify", q, db, str(tmp_path / "out"), "x", "--seq-mode",
              "1"])


def test_port_raises_for_a_db_larger_than_the_card(tmp_path, golden_s0,
                                                   monkeypatch):
    # the guard runs before any tensor reaches the card, so a card with
    # 1 KiB free can be stood in for on the CPU
    _, q, db = golden_s0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (1 << 10, 80 << 30))
    with pytest.raises(NotImplementedError, match="larger than the card"):
        main(["classify", q, db, str(tmp_path / "out"), "x", "--seq-mode",
              "1"])


def _deep_world(tmp_path):
    """tests/test_deep_tier.py::test_cli_classifier_on_deep_world's world:
    24 species sharing a wobble-diverged 3 kb core (AA groups ~24 deep)
    with 2 kb unique tails, its DB built by the JAX package's
    ``build_database``, and 48 reads, half from the cores."""
    import numpy as np

    rng = np.random.default_rng(5)
    acgt = np.array(list(b"ACGT"), np.uint8)
    core = rng.choice(acgt, 3000)
    n_sp = 24
    nodes = [(1, 1, "no rank"), (2, 1, "genus")]
    names = {1: "root", 2: "G"}
    taxdir = tmp_path / "taxonomy"
    taxdir.mkdir()
    fasta_dir = tmp_path / "fasta"
    fasta_dir.mkdir()
    paths, acc_rows = [], []
    for s in range(n_sp):
        t = 3 + s
        nodes.append((t, 2, "species")); names[t] = f"S{s}"
        c = core.copy()
        w = np.arange(2, 3000, 3)
        m = w[rng.random(len(w)) < 0.15]
        c[m] = acgt[(np.searchsorted(acgt, c[m])
                     + rng.integers(1, 4, len(m))) % 4]
        uniq = rng.choice(acgt, 2000)
        seq = np.concatenate([c, uniq])
        acc = f"DP_{s}.1"
        p = fasta_dir / f"{acc}.fna"
        p.write_text(f">{acc}\n{bytes(seq).decode()}\n")
        paths.append(str(p))
        acc_rows.append(f"{acc.split('.')[0]}\t{acc}\t{t}\t0\n")
    (taxdir / "nodes.dmp").write_text(
        "".join(f"{t}\t|\t{p}\t|\t{r}\t|\n" for t, p, r in nodes))
    (taxdir / "names.dmp").write_text(
        "".join(f"{t}\t|\t{n}\t|\t\t|\tscientific name\t|\n"
                for t, n in names.items()))
    (taxdir / "merged.dmp").write_text("")
    (tmp_path / "library.txt").write_text("\n".join(paths) + "\n")
    (tmp_path / "acc2taxid.map").write_text(
        "accession\taccession.version\ttaxid\tgi\n" + "".join(acc_rows))
    db = str(tmp_path / "db")
    build_database(db, str(tmp_path / "library.txt"),
                   str(tmp_path / "acc2taxid.map"), str(taxdir),
                   BuildParams(gene_prediction=0, batch_bases=200_000))
    reads = []
    for i in range(48):
        g = open(paths[i % n_sp]).read().splitlines()[1].encode()
        st = int(rng.integers(0, 2800)) if i % 2 else int(
            rng.integers(3100, 4800))
        reads.append(g[st:st + 150])
    q = tmp_path / "reads.fna"
    q.write_text("".join(f">r{i}\n{r.decode()}\n" for i, r in enumerate(reads)))
    return db, str(q)


@pytest.mark.parametrize("below_deepest", [False, True])
def test_port_equals_jax_deep_tier_classifier(tmp_path, below_deepest):
    """F2 at the classifier: on a DB whose groups are deep enough for the
    JAX package's aligned deep tier (which fetches deep groups whole,
    whatever its cap2), the JAX Classifier and the port write the same
    classifications and report, at the default --max-cap and at one
    below the deepest group."""
    from metabuli_tpu.classify.classifier import Classifier
    from metabuli_tpu.params import ClassifyParams

    db, q = _deep_world(tmp_path)
    jax_clf = Classifier(db, ClassifyParams(seq_mode=1, batch_reads=64))
    assert jax_clf.dev_index.deep_w > 0  # the deep tier is active
    deepest = jax_clf.index.max_group
    cap = ["--max-cap", str(deepest - 1)] if below_deepest else []
    if below_deepest:
        jax_clf = Classifier(db, ClassifyParams(seq_mode=1, batch_reads=64,
                                                max_cap=deepest - 1))
        assert jax_clf.dev_index.deep_w > 0
    s = jax_clf.classify_file(q, None, str(tmp_path / "jax"), "dp")
    assert s["classified"] >= 0.9 * 48
    assert main(["classify", q, db, str(tmp_path / "port"), "dp",
                 "--seq-mode", "1", "--batch-reads", "64", "--device", "cpu",
                 *cap]) == 0
    for kind in ("classifications", "report"):
        want = (tmp_path / "jax" / f"dp_{kind}.tsv").read_bytes()
        got = (tmp_path / "port" / f"dp_{kind}.tsv").read_bytes()
        assert got == want, kind
