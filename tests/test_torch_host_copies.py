"""The port's jax-free host modules and native sources are byte-identical copies of the JAX
package's, and the port never imports JAX or the JAX package (the card's
machine has no JAX, and ``metabuli_tpu/__init__.py`` imports it)."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
COPIES = [
    "params.py",
    "db/formats.py", "db/index.py", "db/taxonomy.py", "db/taxdb_binary.py",
    "db/genes.py", "db/cds.py",
    "io/fasta.py", "io/report.py",
    "classify/taxonomer.py", "classify/native_taxonomer.py",
    "classify/em.py",
    "ops/genetic_code.py", "ops/mask.py",
    "native/sort.py",
    "native/taxonomer.cpp", "native/masker.cpp", "native/fastx.cpp",
    "native/sortkeys.cpp", "native/genepred.cpp", "native/prodigal.cpp",
    "tools/validate.py", "tools/validate_input.py",
    "tools/accession.py", "tools/benchmark.py", "tools/benchmark_sets.py",
    "tools/databases.py", "tools/dbreport.py", "tools/extract.py",
    "tools/grade.py", "tools/library.py", "tools/misc.py",
    "tools/refiner.py",
    "uniref/tree.py",
]


@pytest.mark.parametrize("rel", COPIES)
def test_host_module_is_byte_identical_copy(rel):
    port = (ROOT / "metabuli_tpu_torch" / rel).read_bytes()
    assert port == (ROOT / "metabuli_tpu" / rel).read_bytes(), rel


def test_native_loader_compiles_only_the_ports_own_sources():
    from metabuli_tpu_torch import native

    port = ROOT / "metabuli_tpu_torch"
    assert native.SRCS
    for src in map(pathlib.Path, native.SRCS):
        assert src.resolve().is_relative_to(port), src
        assert src.is_file(), src


def test_port_cli_imports_neither_jax_nor_reference_package():
    code = ("import sys, metabuli_tpu_torch.cli, "
            "metabuli_tpu_torch.classify.classifier, "
            "metabuli_tpu_torch.tools.probes, metabuli_tpu_torch.db.build, "
            "metabuli_tpu_torch.db.update, metabuli_tpu_torch.tools.misc, "
            "metabuli_tpu_torch.readgroup.group, "
            "metabuli_tpu_torch.uniref.classifier, "
            "metabuli_tpu_torch.parallel.mesh, "
            "metabuli_tpu_torch.parallel.distributed, "
            "metabuli_tpu_torch.parallel.dist_classify; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'metabuli_tpu.')) or m == 'metabuli_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_have_no_jax_import():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax\b|import\s+metabuli_tpu\b"
                     r"(?!_torch)|from\s+metabuli_tpu\b(?!_torch))", re.M)
    hits = [str(p.relative_to(ROOT))
            for p in (ROOT / "metabuli_tpu_torch").rglob("*.py")
            if pat.search(p.read_text())]
    assert hits == []


@pytest.mark.parametrize("rel", ["chip_smoke.py",
                                 "metabuli_tpu_torch/tools/world.py"])
def test_smoke_script_and_world_import_no_bench_jax_or_reference(rel):
    """The smoke run needs neither the benchmark script nor JAX: every
    import in these files, at any depth, names another module."""
    import ast

    tree = ast.parse((ROOT / rel).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert names
    bad = [n for n in names
           if n.split(".")[0] in ("bench", "jax", "metabuli_tpu")]
    assert bad == [], bad
