"""Every command of ``tests/test_cli_tools.py`` through both CLIs on the
CPU: ``metabuli_tpu.cli`` against a DB the JAX package built, the port's
``metabuli_tpu_torch.cli`` against one it built itself (``--device cpu``).
Each side works in a directory of its own; after each case the two
directories hold the same files, byte for byte (with each side's own
path written as one placeholder), and each command printed the same."""

import contextlib
import io
import json
import os
import pathlib
import shutil

import numpy as np
import pytest

from metabuli_tpu import cli as jax_cli
from metabuli_tpu_torch import __version__
from metabuli_tpu_torch import cli as port_cli

DATE = "2026-01-01"
ACGT = np.array(list(b"ACGT"), np.uint8)
# the commands that run the kernels: the port's take --device cpu here
ON_DEVICE = ("classify", "build", "updateDB", "filter")


def run(side: str, argv: list[str]) -> tuple[int, str]:
    """One command through the JAX (``side`` "jax") or the port's CLI;
    (exit code, stdout)."""
    if side == "port" and argv[0] in ON_DEVICE:
        argv = [*argv, "--device", "cpu"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = (jax_cli if side == "jax" else port_cli).main(argv)
    return rc, buf.getvalue()


def tree(d: pathlib.Path) -> dict[str, bytes]:
    """Every file under ``d``, its own path replaced by a placeholder."""
    return {str(p.relative_to(d)): p.read_bytes().replace(
                str(d).encode(), b"<side>")
            for p in sorted(d.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """test_cli_tools.py's world, DBs built by each package, and the
    query classified through each CLI."""
    root = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(99)
    genomes = {"ACC_A.1": (bytes(rng.choice(ACGT, 3000)), 4),
               "ACC_B.1": (bytes(rng.choice(ACGT, 3000)), 8)}
    nodes = [(1, 1, "no rank"), (2, 1, "superkingdom"), (3, 2, "genus"),
             (4, 3, "species"), (7, 2, "genus"), (8, 7, "species")]
    names = {1: "root", 2: "Bacteria", 3: "GenusA", 4: "SpA1", 7: "GenusB",
             8: "SpB1"}
    c = root / "common"
    (c / "taxonomy").mkdir(parents=True)
    (c / "taxonomy" / "nodes.dmp").write_text(
        "".join(f"{t}\t|\t{p}\t|\t{r}\t|\n" for t, p, r in nodes))
    (c / "taxonomy" / "names.dmp").write_text("".join(
        f"{t}\t|\t{n}\t|\t\t|\tscientific name\t|\n"
        for t, n in names.items()))
    (c / "taxonomy" / "merged.dmp").write_text("")
    paths = []
    for acc, (seq, _) in genomes.items():
        paths.append(c / f"{acc}.fna")
        paths[-1].write_text(f">{acc}\n{seq.decode()}\n")
    (c / "library.txt").write_text("".join(f"{p}\n" for p in paths))
    (c / "acc2taxid.map").write_text(
        "accession\taccession.version\ttaxid\tgi\n" + "".join(
            f"{a.split('.')[0]}\t{a}\t{t}\t0\n"
            for a, (_, t) in genomes.items()))
    g = genomes["ACC_A.1"][0]
    (c / "reads.fna").write_text("".join(
        f">r{i}\n{g[i * 150:i * 150 + 150].decode()}\n" for i in range(10)))
    (c / "answers.tsv").write_text("".join(f"r{i}\t4\n" for i in range(10)))
    # updateDB: a new genus with one species
    new = bytes(np.random.default_rng(123).choice(ACGT, 2000))
    (c / "ACC_C.1.fna").write_text(f">ACC_C.1\n{new.decode()}\n")
    (c / "newlist.txt").write_text(f"{c / 'ACC_C.1.fna'}\n")
    (c / "acc2taxid.new").write_text(
        "accession\taccession.version\ttaxid\tgi\nACC_C\tACC_C.1\t20\t0\n")
    (c / "newtaxa.tsv").write_text("19\t2\tgenus\tGenusC\n"
                                   "20\t19\tspecies\tSpC1\n")
    (c / "newreads.fna").write_text("".join(
        f">n{i}\n{new[i * 150:i * 150 + 150].decode()}\n" for i in range(5)))
    # filter: 5 reads of genome A, 5 random
    mix = [g[i * 150:i * 150 + 150] for i in range(5)] + [
        bytes(r) for r in np.random.default_rng(77).choice(ACGT, (5, 150))]
    (c / "mix.fna").write_text("".join(
        f">m{i}\n{r.decode()}\n" for i, r in enumerate(mix)))
    (c / "mapping.tsv").write_text("read1\tACC_A.1\nread2\tACC_B\n"
                                   "read3\tACC_X.1\n")
    (c / "genera.txt").write_text("3\n")
    (c / "taxid_by_file.tsv").write_text(
        "".join(f"{p.name}\t{t}\n" for p, (_, t) in
                zip(paths, genomes.values())))
    sides = {}
    for side in ("jax", "port"):
        s = root / side
        s.mkdir()
        assert run(side, ["build", str(s / "db"), str(c / "library.txt"),
                          str(c / "acc2taxid.map"), "--taxonomy-path",
                          str(c / "taxonomy"), "--gene-prediction", "0",
                          "--db-date", DATE])[0] == 0
        assert run(side, ["classify", str(c / "reads.fna"), str(s / "db"),
                          str(s / "cls_out"), "cj", "--seq-mode", "1",
                          "--batch-reads", "16"])[0] == 0
        sides[side] = s
    assert tree(sides["jax"]) == tree(sides["port"])
    return {"common": c, **sides}


# case -> commands; {R} is the side's directory (its DB and the query's
# classifications), {S} the case's own under it, {C} the common one
DB, CLS = "{R}/db", "{R}/cls_out/cj_classifications.tsv"
CASES = {
    "validatedb": [["validatedb", DB]],
    "extract": [["extract", "{C}/reads.fna", CLS, DB, "--tax-id", "4",
                 "--outdir", "{S}/extract"]],
    "taxdump": [["taxdump", DB, "{S}/dump"]],
    "database-report": [["database-report", DB, "{S}/dbreport.tsv"]],
    "expand_diffidx": [["expand_diffidx", DB + "/diffIdx", "{S}/exp.bin"],
                       ["expand_diffidx", DB + "/diffIdx", "--kmer-begin",
                        "3", "--kmer-end", "9"]],
    "printInfo": [["printInfo", DB + "/info", "5"],
                  ["printInfo", DB + "/info", "--info-begin", "2",
                   "--info-end", "6"]],
    "grade": [["grade", CLS, "{C}/answers.tsv", DB, "--rank",
               "species,genus"]],
    "updateDB": [["updateDB", "{S}/db2", "{C}/newlist.txt",
                  "{C}/acc2taxid.new", "--old-db", DB, "--new-taxa",
                  "{C}/newtaxa.tsv", "--db-date", DATE],
                 ["classify", "{C}/newreads.fna", "{S}/db2", "{S}/out_new",
                  "uj", "--seq-mode", "1"],
                 ["classify", "{C}/reads.fna", "{S}/db2", "{S}/out_old",
                  "oj", "--seq-mode", "1"]],
    "classify-em": [["classify", "{C}/reads.fna", DB, "{S}/em_out", "emj",
                     "--seq-mode", "1", "--em", "1", "--batch-reads", "32"]],
    "classifiedRefiner": [
        ["classifiedRefiner", CLS, DB, "--rank", "genus", "--report", "1",
         "--out", "{S}/refined.tsv"],
        ["classifiedRefiner", CLS, DB, "--select-taxid", "3", "--out",
         "{S}/sel.tsv"],
        ["classifiedRefiner", CLS, DB, "--rank", "species",
         "--rank-file-type", "2", "--out", "{S}/r2.tsv"]],
    "build-syncmer": [["build", "{S}/db_sync", "{C}/library.txt",
                       "{C}/acc2taxid.map", "--taxonomy-path",
                       "{C}/taxonomy", "--gene-prediction", "0",
                       "--syncmer", "1", "--db-date", DATE],
                      ["classify", "{C}/reads.fna", "{S}/db_sync",
                       "{S}/sync_out", "sj", "--seq-mode", "1",
                       "--batch-reads", "16"]],
    "make-report": [["make-report", CLS, DB, "{S}/rep.tsv"]],
    "add-to-library": [["add-to-library", "{C}/library.txt",
                        "{C}/acc2taxid.map", DB, "--library-path",
                        "{S}/lib"]],
    "count-common-kmers": [["count-common-kmers", DB]],
    "create-unique-kmer-list": [["create-unique-kmer-list", DB,
                                 "{S}/uniq"]],
    "create-common-kmer-list": [["create-common-kmer-list", DB,
                                 "{S}/common_kmers"]],
    "printDeltaIdx": [["printDeltaIdx", DB + "/diffIdx", "5"],
                      ["printDeltaIdx", DB + "/diffIdx", "--kmer-begin", "5",
                       "--kmer-end", "8"]],
    "query2reference": [["query2reference", CLS, "{C}/acc2taxid.map",
                         "{S}/q2r.tsv"]],
    "gradeByCladeSize": [["gradeByCladeSize", CLS, "{C}/answers.tsv", DB]],
    "editNames": [["editNames", "{S}/names.dmp", "{S}/gca_map.tsv"]],
    "maketestsets": [["maketestsets", "{C}/library.txt", "{C}/acc2taxid.map",
                      "{S}/bench", "--reads-per-assembly", "10",
                      "--error-rate", "0.01"],
                     ["classify", "{S}/bench.fna", DB, "{S}/bench_out", "bj",
                      "--seq-mode", "1"],
                     ["grade", "{S}/bench_out/bj_classifications.tsv",
                      "{S}/bench_answers.tsv", DB, "--rank", "species"]],
    # the contaminant DB: the DB itself, named relative to it
    "filter": [["filter", "{C}/mix.fna", DB, "{S}/fout", "fj",
                "--contam-list", ".", "--seq-mode", "1", "--batch-reads",
                "16", "--print-mode", "2"]],
    "ictv-format": [["ictv-format", CLS, DB, "{S}/ictv.csv"]],
    "makeAAoffset": [["makeAAoffset", "{S}/aa/diffIdx"]],
    "filter_by_genus": [["filter_by_genus", CLS, "{C}/genera.txt", DB,
                         "--out", "{S}/bygenus.tsv"]],
    "mapping2taxon": [["mapping2taxon", "{C}/mapping.tsv",
                       "{C}/acc2taxid.map", "{S}/m2t.tsv"]],
    "accession2taxid": [["accession2taxid", "{S}/library.txt",
                         "{C}/taxid_by_file.tsv"]],
    "createnewtaxalist": [["createnewtaxalist", DB, "{C}/newlist.txt",
                           "{S}/newtax", "{C}/acc2taxid.new",
                           "{S}/newtaxa_out"]],
    "databases": [["databases"]],
}


def _prepare(case: str, c: pathlib.Path, s: pathlib.Path):
    """Per-side inputs a case edits or writes beside."""
    if case == "editNames":
        (s / "names.dmp").write_text(
            "5\t|\t000001.1\t|\t\t|\tscientific name\t|\n")
        (s / "gca_map.tsv").write_text("GCA_000001.1\t5\n")
    elif case == "makeAAoffset":
        (s / "aa").mkdir()
        shutil.copy(s.parent / "db" / "diffIdx", s / "aa" / "diffIdx")
    elif case == "accession2taxid":
        shutil.copy(c / "library.txt", s / "library.txt")
    elif case == "createnewtaxalist":
        shutil.copytree(c / "taxonomy", s / "newtax")
        with open(s / "newtax" / "nodes.dmp", "a") as fh:
            fh.write("19\t|\t2\t|\tgenus\t|\n20\t|\t19\t|\tspecies\t|\n")
        with open(s / "newtax" / "names.dmp", "a") as fh:
            fh.write("19\t|\tGenusC\t|\t\t|\tscientific name\t|\n"
                     "20\t|\tSpC1\t|\t\t|\tscientific name\t|\n")


def _printed(side_dir: pathlib.Path, argv, out: str):
    """What a command printed, its side's path as a placeholder; JSON
    stats of build/updateDB keep the keys both CLIs print, and classify's
    summary (run times) is left out."""
    if argv[0] == "classify":
        return None
    out = out.replace(str(side_dir), "<side>")
    if argv[0] in ("build", "updateDB"):
        return json.loads(out.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_port_cli_command_equals_jax(world, case):
    c = world["common"]
    printed = {}
    for side in ("jax", "port"):
        r = world[side]
        s = r / case
        s.mkdir()
        _prepare(case, c, s)
        printed[side] = []
        for argv in CASES[case]:
            argv = [a.replace("{S}", str(s)).replace("{R}", str(r))
                    .replace("{C}", str(c)) for a in argv]
            rc, out = run(side, argv)
            assert rc == 0, (side, argv)
            printed[side].append(_printed(r, argv, out))
    for want, got in zip(printed["jax"], printed["port"]):
        if isinstance(want, dict):
            got = {k: got[k] for k in want}
        assert got == want
    assert tree(world["jax"]) == tree(world["port"])


def test_port_version_and_unknown_command(capsys):
    """F7: ``--version`` prints the version and returns 0, as the JAX CLI
    does; an unknown command returns 1; the help lists every command."""
    for cli in (jax_cli, port_cli):
        assert cli.main(["--version"]) == 0
        assert capsys.readouterr().out == f"{__version__}\n"
        assert cli.main(["no-such-command"]) == 1
        assert "Unknown command: no-such-command" in capsys.readouterr().err
    assert port_cli.main(["--help"]) == 0
    listed = [ln.split()[0] for ln in
              capsys.readouterr().out.split("Commands:")[1].splitlines()
              if ln.strip()]
    assert listed == list(port_cli.COMMANDS) == list(jax_cli.COMMANDS)


@pytest.mark.parametrize("argv,item", [
    (["grouping", "q.fna", "c.tsv", "out"], "item 12"),
    (["create-uniref-db", "u.xml", "db"], "item 12"),
    (["assign_uniref", "q.fna", "db", "out"], "item 12"),
])
def test_port_commands_of_item_12_raise(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        port_cli.main(argv)


def test_port_old_format_build_raises(world, tmp_path):
    """--kmer-format 1 (test_cli_tools' old-format round trip) is item
    14 in the port."""
    c = world["common"]
    with pytest.raises(NotImplementedError, match="item 14"):
        port_cli.main(["build", str(tmp_path / "db1"), str(c / "library.txt"),
                       str(c / "acc2taxid.map"), "--taxonomy-path",
                       str(c / "taxonomy"), "--gene-prediction", "0",
                       "--kmer-format", "1", "--device", "cpu"])
