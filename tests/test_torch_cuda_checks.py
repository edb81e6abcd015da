"""The CUDA library's checked build and resource record, on the CPU: the
ptxas log parser, the bounds-check macro (empty without MTB_CHECKED), the
variable that selects the checked library, every __global__ function
labelled, and a small rehearsal of the checked run's main-path checks
(the wrappers take their plain versions here; the kernels run only on
the card, in chip_smoke.py's ``checked`` phase)."""

import pathlib
import re
import subprocess

import pytest
import torch

from metabuli_tpu_torch.csrc import build

CSRC = pathlib.Path(build.CSRC)

# ptxas -v's report of two kernels and a device function, as nvcc prints it
PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114extract_kernelILb1ELb0EEEvPKhPKiiiiiiS4_S4_PlPiPbS5_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114extract_kernelILb1ELb0EEEvPKhPKiiiiiiS4_S4_PlPiPbS5_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 38 registers, used 1 barriers, 21536 bytes smem, 456 bytes cmem[0]
ptxas info    : Function properties for _ZN12_GLOBAL__N_17run_endERKNS_7MatchesEibiii
    16 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113double_kernelEPKilPi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113double_kernelEPKilPi
    8 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 16 registers, 376 bytes cmem[0]
"""


def test_ptxas_log_gives_each_kernels_resources():
    got = build.parse_ptxas(PTXAS_LOG, "x.cu")
    assert got == [
        {"name": "extract_kernel<true, false>", "kernel": "extract_kernel",
         "label": "K1 reduced", "source": "x.cu", "registers": 38, "smem": 21536,
         "stack": 0, "spill_stores": 0, "spill_loads": 0},
        {"name": "double_kernel", "kernel": "double_kernel", "label": "P3",
         "source": "x.cu", "registers": 16, "smem": 0, "stack": 8,
         "spill_stores": 12, "spill_loads": 12}]


@pytest.mark.parametrize("mangled,name", [
    ("_ZN12_GLOBAL__N_112count_kernelILb0EEEvPKlPKbS3_liPKiS7_S7_S7_PK4int4"
     "PKNSt11conditionalIXT_EjlE4typeEiiPiSF_SF_PlP4int2lPySG_S7_llb",
     "count_kernel<false>"),
    ("_ZN12_GLOBAL__N_115l2_evict_kernelEPK4int4lPi", "l2_evict_kernel"),
    ("_Z12plain_kernelPi", "plain_kernel"),
    ("not_mangled", "not_mangled"),
])
def test_kernel_names_demangle(mangled, name):
    assert build._demangle(mangled) == name


@pytest.mark.parametrize("name,want", [
    ("extract_kernel<false, false>", "K1"),
    ("extract_kernel<false, true>", "K1 format 1"),
    ("extract_kernel<true, true>", "K1 reduced format 1"),
    ("count_kernel<false>", "K2"), ("write_kernel<true>", "K11"),
    ("merge_join_kernel", "P2"), ("unknown_kernel", "?")])
def test_compiled_functions_are_labelled_by_kernel(name, want):
    assert build.label(name) == want


@pytest.mark.parametrize("checked", [False, True])
def test_check_macro_is_empty_without_the_checked_build(checked):
    """Without -DMTB_CHECKED a check expands to nothing, its arguments
    unevaluated; with it, to a print and a trap."""
    src = ('#include "check.cuh"\n'
           'void f(long i, long n) { MTB_CHECK_INDEX(i++, n); }\n')
    res = subprocess.run(
        ["g++", "-E", "-P", "-x", "c++", "-I", str(CSRC),
         *(["-DMTB_CHECKED"] if checked else []), "-"],
        input=src, capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    body = res.stdout[res.stdout.index("void f"):]
    assert ("__trap" in body) == checked
    assert ("printf" in body) == checked
    assert ("i++" in body) == checked


def test_every_global_function_is_labelled_and_every_source_checked():
    """KERNEL_LABELS names each __global__ function of csrc/*.cu once (the
    resources phase requires all 16), and each source takes check.cuh."""
    found = set()
    for src in CSRC.glob("*.cu"):
        text = src.read_text()
        assert '#include "check.cuh"' in text, src.name
        found |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
            text))
    assert found == set(build.KERNEL_LABELS)
    assert len(found) == 16


def test_checked_variable_selects_the_checked_library(monkeypatch):
    monkeypatch.delenv(build.CHECKED_ENV, raising=False)
    assert not build.checked() and build.library_path() == build.SO
    monkeypatch.setenv(build.CHECKED_ENV, "1")
    assert build.checked() and build.library_path() == build.CHECKED_SO
    assert build.CHECKED_SO != build.SO
    assert build.resources_path(build.CHECKED_SO).endswith(
        "libmetabuli_cuda_checked.resources.json")
    assert build.resources_path(build.SO).endswith(
        "libmetabuli_cuda.resources.json")


def test_checked_runner_main_path_rehearsal_on_the_cpu(tmp_path):
    """The checked run's main-path checks at a tiny size, from a batch that
    ``save_batch`` took of a classifier: the index it rebuilds is the
    classifier's own, and every kernel of chip_smoke.py's KERNELS and
    P1-P4 is run and compared. On the CPU every wrapper takes its plain
    version, so a check here cannot differ: what this shows is the set of
    kernels the run reaches, one record a check."""
    import numpy as np

    from metabuli_tpu_torch.classify import pipeline
    from metabuli_tpu_torch.classify.classifier import Classifier
    from metabuli_tpu_torch.params import ClassifyParams
    from metabuli_tpu_torch.tools import checked, world

    tax, genomes, rng = world.make_world(str(tmp_path / "world"), "skew")
    db = str(tmp_path / "db")
    world.build_db(db, tax, genomes[:2], "cpu")
    fq = str(tmp_path / "reads.fq")
    world.write_fastq(fq, world.sample_reads(genomes[:2], rng, 64, 150,
                                             max_mut=2))
    clf = Classifier(db, ClassifyParams(seq_mode=1, batch_reads=64),
                     device="cpu")
    reads = next(clf._iter_batches(fq, None))
    batch = str(tmp_path / "batch")
    checked.save_batch(batch, clf, reads)
    idx = pipeline.build_dev_index(np.load(f"{batch}/values.npy"),
                                   np.load(f"{batch}/taxids.npy"))
    for f in ("grest", "gstart", "gend", "taxdna", "d48", "prefix"):
        assert torch.equal(getattr(idx, f), getattr(clf.dev_index, f)), f

    check = checked.Checks()
    checked.main_path(check, torch.device("cpu"), batch, n_genomes=2,
                      residues=3000, probe_bits=(12,), stream_rows=4096)
    assert len(check.records) == 17  # 19 with the card's two probe sizes
    assert {r["kernel"] for r in check.records} == {
        "extract_metamers", "search_scan", "chain_matches", "combine_paths",
        "search_scan_reduced", "extract_metamers_f1", "extract_aa_kmers",
        "extract_aa_kmers_dna", "gather_tile_sum", "merge_join_sum",
        "smoke_double", "stream_sum"}


def test_checked_runner_needs_the_variable(monkeypatch, capsys):
    from metabuli_tpu_torch.tools import checked

    monkeypatch.delenv(build.CHECKED_ENV, raising=False)
    assert checked.main(["unused"]) == 2
    assert build.CHECKED_ENV in capsys.readouterr().out
