"""ASan/UBSan pass over the port's native code, fed from the port's own
buffers.

The port's native sources are byte-identical copies of the JAX package's
(``tests/test_torch_host_copies.py``), but the port fills their argument
buffers from torch tensors. So the port's ``--device-tax 0`` classify
dumps its ``taxonomer_assign`` arguments (the copied dump hook of
``classify/native_taxonomer.py``), the dump must equal the JAX package's
byte for byte on the same world (dtypes, strides and lengths at the C
boundary), and ``sancheck`` built from ``metabuli_tpu_torch/native/``
replays it under the sanitizers, as ``tests/test_native_sanitize.py``
does for the JAX package. The JAX package is imported only inside the
CPU tests: the card's machine has no JAX.
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_NATIVE = ROOT / "metabuli_tpu_torch" / "native"
SANITIZER_ENV = dict(ASAN_OPTIONS="detect_leaks=1:abort_on_error=1",
                     UBSAN_OPTIONS="print_stacktrace=1:halt_on_error=1")
CLASSIFY = ["--seq-mode", "1", "--batch-reads", "64", "--device-tax", "0"]


def _write_world(root: pathlib.Path) -> None:
    """``tests/test_native_sanitize.py::_make_dump``'s world, drawn in the
    same order: seed 7, two 9 kb genomes, 60 reads of 150 bp."""
    root.mkdir(parents=True)
    rng = np.random.default_rng(7)
    (root / "taxonomy").mkdir()
    (root / "taxonomy" / "nodes.dmp").write_text(
        "1\t|\t1\t|\tno rank\t|\n2\t|\t1\t|\tgenus\t|\n"
        "4\t|\t2\t|\tspecies\t|\n8\t|\t2\t|\tspecies\t|\n")
    (root / "taxonomy" / "names.dmp").write_text("".join(
        f"{t}\t|\tName{t}\t|\t\t|\tscientific name\t|\n"
        for t in (1, 2, 4, 8)))
    (root / "taxonomy" / "merged.dmp").write_text("")
    g1 = bytes(rng.choice(np.array(list(b"ACGT"), np.uint8), 9000))
    g2 = bytes(rng.choice(np.array(list(b"ACGT"), np.uint8), 9000))
    (root / "a.fna").write_text(f">SAN_A.1\n{g1.decode()}\n")
    (root / "b.fna").write_text(f">SAN_B.1\n{g2.decode()}\n")
    (root / "lib.txt").write_text(f"{root}/a.fna\n{root}/b.fna\n")
    (root / "map.tsv").write_text("SAN_A.1\t4\nSAN_B.1\t8\n")
    reads = [g1[i * 250:i * 250 + 150] for i in range(30)] + \
            [g2[i * 250:i * 250 + 150] for i in range(30)]
    (root / "r.fq").write_text("".join(
        f"@r{i}\n{r.decode()}\n+\n{'I' * len(r)}\n"
        for i, r in enumerate(reads)))


def _with_dump(main, argv, dump: pathlib.Path) -> None:
    """``main(argv)`` with the native dump hook pointed at ``dump``."""
    os.environ["METABULI_TPU_DUMP_NATIVE"] = str(dump)
    try:
        assert main(argv) == 0
    finally:
        os.environ.pop("METABULI_TPU_DUMP_NATIVE", None)
    assert (dump / "manifest.txt").exists(), "the dump hook did not fire"


def _port_build(root: pathlib.Path) -> pathlib.Path:
    """The port's CLI build of the world (masking on), on the CPU."""
    from metabuli_tpu_torch.cli import main

    db = root / "port_db"
    assert main(["build", str(db), str(root / "lib.txt"),
                 str(root / "map.tsv"), "--taxonomy-path",
                 str(root / "taxonomy"), "--mask-mode", "1",
                 "--device", "cpu"]) == 0
    return db


def _port_dump(root, db, dump, device) -> pathlib.Path:
    """The port's ``--device-tax 0`` classify of the world on ``device``,
    its taxonomer_assign arguments dumped to ``dump``."""
    from metabuli_tpu_torch.cli import main

    _with_dump(main, ["classify", str(root / "r.fq"), str(db),
                      str(root / f"out_{dump.name}"), "san", *CLASSIFY,
                      "--device", device], dump)
    return dump


def _dump_files(dump: pathlib.Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(dump.iterdir())}


def _build_sancheck(exe: pathlib.Path) -> None:
    """``sancheck`` and the six sources it drives, all from the port's
    native directory, with the flags of tests/test_native_sanitize.py."""
    srcs = [str(PORT_NATIVE / f) for f in (
        "sancheck.cpp", "taxonomer.cpp", "masker.cpp", "genepred.cpp",
        "prodigal.cpp", "fastx.cpp", "sortkeys.cpp")]
    cmd = ["g++", "-O1", "-g", "-std=c++17", "-fopenmp",
           "-fsanitize=address,undefined", "-fno-omit-frame-pointer",
           "-fno-sanitize-recover=all", *srcs, "-o", str(exe), "-lz"]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]


def _replay(dump: pathlib.Path, exe: pathlib.Path) -> None:
    """``sancheck`` built from the port's sources replays ``dump`` under
    the sanitizers cleanly."""
    if not exe.exists():
        _build_sancheck(exe)
    res = subprocess.run([str(exe), str(dump)], capture_output=True,
                         text=True, timeout=600,
                         env=dict(os.environ, **SANITIZER_ENV))
    out = res.stdout + res.stderr
    assert res.returncode == 0, out[-4000:]
    assert "SANCHECK-OK" in out
    assert "AddressSanitizer" not in out, out[-4000:]
    assert "runtime error" not in out, out[-4000:]
    classified = re.search(r"(\d+) classified", out)
    assert classified and int(classified.group(1)) > 0, out[:500]


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """(the JAX package's dump, the port's) of the same world: each
    package's own CLI build (masking on) and ``--device-tax 0`` classify,
    the port on the CPU."""
    from helpers import jax_native
    from test_native_sanitize import _make_dump

    jax_native.loaded()  # the JAX side on its native host taxonomer
    tmp = tmp_path_factory.mktemp("sanitize")
    jax_dump = _make_dump(tmp)
    root = tmp / "port_world"
    _write_world(root)
    # the port's world is the JAX one's, file for file
    for name in ("a.fna", "b.fna", "map.tsv", "r.fq"):
        assert (root / name).read_bytes() == \
            (tmp / "world" / name).read_bytes(), name
    port_dump = _port_dump(root, _port_build(root), tmp / "port_dump",
                           "cpu")
    return jax_dump, port_dump, tmp


def test_port_dump_equals_jax_dump(dumps):
    """Every buffer and every manifest line equal, but ``need_sort``: the
    JAX package hands the native assign its matches to sort (1), the port
    hands it the rows its device sort already put in that order (0), and
    the buffers being equal shows they are in that order."""
    jax_dump, port_dump, _ = dumps
    want, got = _dump_files(jax_dump), _dump_files(port_dump)
    assert sorted(got) == sorted(want)
    for name in want:
        if name != "manifest.txt":
            assert got[name] == want[name], name
    got_m = got["manifest.txt"].decode().splitlines()
    want_m = want["manifest.txt"].decode().splitlines()
    assert [ln for ln in got_m if ln != "scalar need_sort 0"] == \
        [ln for ln in want_m if ln != "scalar need_sort 1"]
    assert "scalar need_sort 0" in got_m and "scalar need_sort 1" in want_m
    # the world's reads reached the native call with matches
    assert len(want) > 2 and len(got["qid.bin"]) > 0


def test_port_native_suite_under_sanitizers(dumps):
    _, port_dump, tmp = dumps
    _replay(port_dump, tmp / "sancheck")


def test_sanitize_variant_is_built_apart(tmp_path):
    """METABULI_TPU_SANITIZE builds a library of its own, with the
    sanitizers' symbols, and leaves the normal one as it is; a process
    only builds here (an ASan library loads only under LD_PRELOAD)."""
    from metabuli_tpu_torch import native

    code = "from metabuli_tpu_torch import native; print(native.build())"
    env = {k: v for k, v in os.environ.items()
           if k != native.SANITIZE_ENV}

    def build(extra):
        res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True, timeout=900,
                             env=dict(env, **extra))
        assert res.returncode == 0, res.stderr[-3000:]
        return res.stdout.strip().splitlines()[-1]

    normal = build({})
    assert normal == native._SO
    before = (os.stat(normal).st_mtime_ns, pathlib.Path(normal).read_bytes())
    variant = build({native.SANITIZE_ENV: "address,undefined"})
    assert variant == native._SO + ".asan.so" != normal
    assert (os.stat(normal).st_mtime_ns,
            pathlib.Path(normal).read_bytes()) == before
    syms = subprocess.run(["nm", "-D", variant], capture_output=True,
                          text=True, timeout=120).stdout
    assert "__asan_" in syms and "__ubsan_" in syms
    assert "__asan_" not in subprocess.run(
        ["nm", "-D", normal], capture_output=True, text=True,
        timeout=120).stdout
    assert build({}) == normal


@pytest.mark.gpu
def test_card_dump_under_sanitizers(tmp_path):
    """The world through the port on the card (``--device-tax 0``: K1 and
    K2 there, the native host assign): its dump equals the port's CPU
    dump byte for byte, and the sanitized replay of it is clean, so the
    CUDA match core's columns reach the native code in bounds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = tmp_path / "world"
    _write_world(root)
    db = _port_build(root)
    cpu = _port_dump(root, db, tmp_path / "cpu_dump", "cpu")
    card = _port_dump(root, db, tmp_path / "card_dump", "cuda")
    assert _dump_files(card) == _dump_files(cpu)
    _replay(card, tmp_path / "sancheck")
