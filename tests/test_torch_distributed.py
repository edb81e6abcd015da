"""Multi-process classify through the port's CLI on the CPU (gloo),
byte-equal to the JAX package's single-process ``classify`` and to its
``--db-shards 2`` run (the world of tests/test_distributed.py) on the same
DB and reads: 2 processes x 2 db shards and a 2 x 2 (data, db) mesh,
single-end and paired, syncmer, format 1, the plain route and the reduced
alphabet; a one-process ``--db-shards`` run; the mesh rules; and a run
whose rank dies fails instead of hanging. Tolerance is zero. The ranks
are processes that import only the port, each killed at the test's
timeout."""

import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import pytest
import torch

from helpers import jax_native
from metabuli_tpu.cli import main as jax_main
from metabuli_tpu.db.build import build_database
from metabuli_tpu.params import BuildParams
from metabuli_tpu_torch.cli import main as port_main
from metabuli_tpu_torch.parallel import distributed as dist
from test_golden import _world

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = ("j_classifications.tsv", "j_report.tsv", "j_krona.html")


@pytest.fixture(autouse=True, scope="module")
def _jax_native():
    """The JAX side on its native path, wherever this module runs."""
    jax_native.loaded()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(argvs, timeout=120, env=None):
    """One process per argv (``python -m ...`` from the repo root), all
    started together. The first to fail, or the timeout, kills the rest;
    returns each rank's (exit code, output)."""
    procs = [subprocess.Popen([sys.executable, "-m", *a], cwd=ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT,
                              env={**os.environ, **(env or {})})
             for a in argvs]
    end = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if (time.monotonic() > end
                    or any(p.poll() not in (None, 0) for p in procs)):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [(p.wait(), p.stdout.read().decode()) for p in procs]


def cli_ranks(files, db, out, world, shards, flags, env=None, timeout=120,
              module="metabuli_tpu_torch.cli"):
    """``classify`` over ``world`` processes with ``--db-shards shards``
    (through ``module``'s command line); asserts every rank exited 0."""
    port = free_port()
    res = spawn_ranks([[module, "classify", *files, db,
                        out, "j", *flags, "--device", "cpu",
                        "--num-processes", str(world), "--process-id",
                        str(i), "--coordinator", f"localhost:{port}",
                        "--db-shards", str(shards)]
                       for i in range(world)], timeout, env)
    for i, (rc, log) in enumerate(res):
        assert rc == 0, f"rank {i} exited {rc}:\n{log[-3000:]}"
    return res


def written(out) -> dict:
    return {f: pathlib.Path(out, f).read_bytes() for f in FILES}


def _mates(root, q):
    """The golden reads as pairs: mate 1 their first 80 bases, mate 2 the
    reverse complement's (tests/test_torch_classify.py's pairs)."""
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
    return [q1, q2]


# world name -> (BuildParams flags, paired)
WORLDS = {"se": ({}, False), "pe": ({}, True), "syncmer": ({"syncmer": 1},
                                                            False),
          "format1": ({"kmer_format": 1}, False),
          "reduced": ({"reduced_aa": 1}, False)}
# R8: the JAX package's distributed classify builds a reduced DB's shards
# in the standard layout (``distributed.distribute_index`` passes no
# ``reduced``) and its sharded step then fails, so on a reduced DB the
# port is held to JAX's single run here, and to JAX's sharded step on
# shards built as reduced in tests/test_torch_parallel.py
JAX_SHARDED_FAILS = {"reduced"}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Each world's DB (the golden world, built by the JAX package) and
    reads, with the JAX package's single-process classify and its
    --db-shards 2 run (the 8-device CPU mesh), whose files must agree."""
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        kw, paired = WORLDS[name]
        root, q = _world(tmp_path_factory.mktemp(name))
        db = os.path.join(root, "db")
        build_database(db, os.path.join(root, "library.txt"),
                       os.path.join(root, "acc2taxid.map"),
                       os.path.join(root, "taxonomy"),
                       BuildParams(gene_prediction=0, mask_mode=1, **kw))
        files = _mates(root, q) if paired else [q]
        flags = ["--seq-mode", "2" if paired else "1", "--batch-reads", "10"]
        want = {}
        for run, extra in (("single", []), ("shards", ["--db-shards", "2"])):
            if run == "shards" and name in JAX_SHARDED_FAILS:
                continue
            out = os.path.join(root, f"jax_{run}")
            assert jax_main(["classify", *files, db, out, "j", *flags,
                             *extra, "--verbosity", "0"]) == 0
            want[run] = written(out)
        assert want.get("shards", want["single"]) == want["single"]
        assert want["single"][FILES[0]].count(b"\n1\t") >= 10
        cache[name] = (root, files, db, flags, want["single"])
        return cache[name]

    return get


@pytest.mark.parametrize("world_name,world,shards,env", [
    ("se", 2, 2, {}), ("se", 4, 2, {}), ("pe", 2, 2, {}), ("pe", 4, 2, {}),
    ("syncmer", 2, 2, {}), ("format1", 2, 2, {}),
    ("se", 4, 2, {"METABULI_TPU_DIST_FUSED": "0"}), ("reduced", 2, 2, {})],
    ids=["se-2x1", "se-2x2", "pe-2x1", "pe-2x2", "syncmer-2x1",
         "format1-2x1", "plain-2x2", "reduced-2x1"])
def test_multi_process_cli_equals_jax(jax_runs, world_name, world, shards,
                                      env):
    """``--num-processes N --db-shards 2`` on gloo: the classifications,
    report and Krona file equal the JAX package's single and sharded runs.
    Batches of 10 reads over 21: the last batch leaves a 2 x 2 mesh's
    second data row without reads."""
    root, files, db, flags, want = jax_runs(world_name)
    out = os.path.join(root, f"port_{world}x{shards}_{len(env)}")
    cli_ranks(files, db, out, world, shards, flags, env)
    assert written(out) == want
    parts = sorted(p.name for p in pathlib.Path(out).iterdir()
                   if p.name.startswith(".j_part"))
    assert parts == [f".j_part{i}.tsv" for i in range(world)]


def _batch_free(flags):
    i = flags.index("--batch-reads")
    return flags[:i] + flags[i + 2:]


def test_ranks_agree_on_automatic_batches(jax_runs, tmp_path):
    """``--batch-reads 0`` with ranks that size their batches differently
    (rank 1 at half rank 0's reads and bases, as cards with different
    free memory would; the bases decide where a batch ends): the ranks
    agree on the smallest, and the files equal JAX's."""
    root, files, db, flags, want = jax_runs("se")
    out = str(tmp_path / "out")
    cli_ranks(files, db, out, 2, 2, [*_batch_free(flags), "--batch-reads",
                                     "0", "--skew-batch", "64,1300"],
              module="tests.helpers.torch_dist_rank")
    assert written(out) == want


def test_alltoall_overflow_runs_the_batch_again(jax_runs, tmp_path):
    """All_to_all blocks of one row: every batch's segments outgrow them,
    every rank of the row runs the batch again at the longest segment,
    and the files equal JAX's."""
    root, files, db, flags, want = jax_runs("se")
    out = str(tmp_path / "out")
    res = cli_ranks(files, db, out, 4, 2, [*flags, "--a2a-budget", "1"],
                    module="tests.helpers.torch_dist_rank")
    assert written(out) == want
    summaries = [json.loads([ln for ln in log.splitlines()
                             if ln.startswith("{")][-1]) for _, log in res]
    assert {s["route"] for s in summaries} == {"alltoall"}
    # an exchange a try; a rank has at most 3 batches of reads
    assert max(s["gathers"] for s in summaries) > 3


@pytest.mark.parametrize("shards", [2, 3])
def test_one_process_db_shards_equals_jax(jax_runs, shards, tmp_path):
    """``--db-shards N`` in one process: every shard on the one device,
    gathered by concatenation; the files equal JAX's."""
    root, files, db, flags, want = jax_runs("se")
    out = str(tmp_path / "out")
    assert port_main(["classify", *files, db, out, "j", *flags,
                      "--db-shards", str(shards), "--device", "cpu",
                      "--verbosity", "0"]) == 0
    assert written(out) == want


def test_rank_that_dies_fails_the_run(jax_runs, tmp_path):
    """A rank that cannot load its DB exits non-zero; the other fails at
    its next collective, or is killed, and never hangs the test."""
    root, files, db, flags, _ = jax_runs("se")
    port = free_port()
    t0 = time.monotonic()
    res = spawn_ranks([["metabuli_tpu_torch.cli", "classify", *files,
                        db if i == 0 else str(tmp_path / "no_db"),
                        str(tmp_path / "out"), "j", *flags, "--device",
                        "cpu", "--num-processes", "2", "--process-id",
                        str(i), "--coordinator", f"localhost:{port}",
                        "--db-shards", "2"] for i in range(2)], timeout=60)
    assert res[1][0] != 0
    assert res[0][0] != 0
    assert time.monotonic() - t0 < 60


def test_mesh_grid_follows_the_reference_rule():
    cpu = torch.device("cpu")
    assert (dist.global_mesh(None, cpu).n_db, dist.global_mesh(3, cpu).n_db,
            dist.global_mesh(3, cpu).db_cols) == (1, 3, [0, 1, 2])
    m = dist.global_mesh(3, cpu)
    assert (m.n_data, m.grouped, m.writer) == (1, False, True)
    with pytest.raises(ValueError, match="divisible"):
        dist.global_mesh(2, cpu, backend="gloo", world=3, rank=0)


def test_initialize_refuses_what_it_cannot_run(monkeypatch):
    """No process group without a coordinator, NCCL only on a card, a
    card only where there is one: no quiet switch to another."""
    assert dist.initialize(None, 1, 0, None, "cpu")[1:] == (None, 1, 0)
    with pytest.raises(ValueError, match="coordinator"):
        dist.initialize(None, 2, 0, None, "cpu")
    with pytest.raises(ValueError, match="nccl"):
        dist.initialize("localhost:1", 1, 0, "nccl", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.initialize("localhost:1", 2, 0, None, "cuda")


def test_cli_sharded_run_defaults_to_the_card(jax_runs, tmp_path,
                                              monkeypatch):
    """``--db-shards`` without ``--device``: the card, and without one an
    error, not a run on the CPU."""
    root, files, db, flags, _ = jax_runs("se")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["classify", *files, db, str(tmp_path / "out"), "j",
                   *flags, "--db-shards", "2"])
    assert not (tmp_path / "out").exists()
