"""Command-line interface of the PyTorch port.

The command table of ``metabuli_tpu.cli`` (`MetabuliBase.cpp:12-295`),
command for command, with the same names, arguments and outputs:

  metabuli_tpu_torch classify <i:FASTA/Q> [<i:FASTA/Q2>] <i:DBDIR> <o:OUTDIR> <Job ID>
  metabuli_tpu_torch build    <o:DBDIR> <i:FASTA list> <i:accession2taxid> --taxonomy-path DIR
  metabuli_tpu_torch updateDB <o:DBDIR> <i:FASTA list> <i:accession2taxid> --old-db DIR
  metabuli_tpu_torch <command> ...   (``--help`` lists them all)

``classify``, ``build``, ``updateDB``, ``filter``, ``grouping`` (K1),
``create-uniref-db`` and ``assign_uniref`` (K12) take ``--device
cuda|cpu`` (default cuda: without a card they raise; cpu runs the plain
PyTorch versions of the kernels). ``classify`` with
``--num-processes``, ``--db-shards`` or ``--dist-backend`` runs over a
(data, db) mesh of processes (``parallel.dist_classify``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from contextlib import nullcontext

import numpy as np

from . import __version__
from .params import BuildParams, ClassifyParams, add_to_parser, from_args

DEVICE_HELP = ("torch device (default cuda; cpu runs the plain PyTorch "
               "versions of the kernels)")


def _classify(argv):
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch classify")
    ap.add_argument("files", nargs="+", help="query [query2] dbdir outdir jobid")
    ap.add_argument("--resume", action="store_true",
                    help="append to an existing partial classifications file")
    ap.add_argument("--trace-dir", default="",
                    help="write a torch.profiler trace of the run here")
    ap.add_argument("--lineage", type=int, default=None,
                    help="print lineage information (reference flag name)")
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    ap.add_argument("--coordinator", default="",
                    help="torch.distributed coordinator host:port "
                         "(multi-process)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--db-shards", type=int, default=0,
                    help="db-axis size of the (data, db) mesh "
                         "(0 = auto; >1 shards the metamer table)")
    ap.add_argument("--dist-backend", default="", choices=("", "nccl", "gloo"),
                    help="process-group backend (default nccl on a card, "
                         "gloo on the CPU; gloo lets several processes "
                         "share one card); asking for one runs the "
                         "distributed path even with one process")
    add_to_parser(ap, ClassifyParams)
    args = ap.parse_args(argv)
    par = from_args(ClassifyParams, args)
    if args.lineage is not None:
        par.print_lineage = args.lineage
    files = args.files
    if par.seq_mode == 2:
        if len(files) != 5:
            ap.error("--seq-mode 2 needs: <q1> <q2> <dbdir> <outdir> <jobid>")
        q1, q2, db_dir, out_dir, job_id = files
    else:
        if len(files) != 4:
            ap.error("needs: <query> <dbdir> <outdir> <jobid>")
        q1, db_dir, out_dir, job_id = files
        q2 = None
    if par.validate_input:
        from .tools.validate_input import validate_query_file

        for path in filter(None, (q1, q2)):
            problems = validate_query_file(path)
            if problems:
                print(f"Invalid query file {path}:", file=sys.stderr)
                for p in problems:
                    print(f"  {p}", file=sys.stderr)
                return 1
    if par.validate_db:
        from .tools.validate import validate_database

        problems = validate_database(db_dir)
        if problems:
            print("Database validation failed:", file=sys.stderr)
            for p in problems:
                print(f"  {p}", file=sys.stderr)
            return 1
    if args.num_processes > 1 or args.db_shards > 1 or args.dist_backend:
        from .parallel.dist_classify import classify_distributed

        summary = classify_distributed(
            db_dir, q1, q2, out_dir, job_id, par,
            args.coordinator or None, args.num_processes, args.process_id,
            n_db=args.db_shards or None, device=args.device,
            backend=args.dist_backend or None,
        )
        if par.verbosity > 0:
            print(json.dumps(summary))
        return 0
    from .classify.classifier import Classifier

    # the profile opens before the DB load, so it holds the load's spans
    prof = _profiler(args.device) if args.trace_dir else None
    with prof if prof is not None else nullcontext():
        clf = Classifier(db_dir, par, device=args.device)
        summary = clf.classify_file(q1, q2, out_dir, job_id, resume=args.resume)
    if prof is not None:
        os.makedirs(args.trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace_dir, "trace.json"))
    if par.verbosity > 0:
        print(json.dumps(summary))
    return 0


def _profiler(device: str):
    """The ``--trace-dir`` profiler: host and (on a card) device
    activities, each range's inputs (the program's spans carry their
    batch's id as one), and every thread where this torch can profile
    them all (the finish worker's spans)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        extra = {"experimental_config": torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)}
    except TypeError:  # a torch without the option
        extra = {}
    return torch.profiler.profile(activities=acts, record_shapes=True,
                                  **extra)


def _build(argv):
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch build")
    ap.add_argument("dbdir")
    ap.add_argument("fasta_list")
    ap.add_argument("acc2taxid")
    ap.add_argument("--taxonomy-path", default="", help="dir with names/nodes/merged.dmp")
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    add_to_parser(ap, BuildParams)
    args = ap.parse_args(argv)
    par = from_args(BuildParams, args)
    taxdir = args.taxonomy_path or os.path.join(args.dbdir, "taxonomy")
    from .db.build import build_database

    stats = build_database(args.dbdir, args.fasta_list, args.acc2taxid, taxdir, par,
                           device=args.device)
    if par.verbosity > 0:
        print(json.dumps(stats))
    return 0


def _updatedb(argv):
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch updateDB")
    ap.add_argument("dbdir")
    ap.add_argument("fasta_list")
    ap.add_argument("acc2taxid")
    ap.add_argument("--old-db", required=True)
    ap.add_argument("--new-taxa", default="")
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    add_to_parser(ap, BuildParams)
    args = ap.parse_args(argv)
    par = from_args(BuildParams, args)
    from .db.update import update_database

    stats = update_database(
        args.dbdir, args.old_db, args.fasta_list, args.acc2taxid, par,
        new_taxa=args.new_taxa, device=args.device,
    )
    print(json.dumps(stats))
    return 0


def _extract(argv):
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch extract")
    ap.add_argument("query")
    ap.add_argument("classifications")
    ap.add_argument("dbdir")
    ap.add_argument("--tax-id", type=int, required=True)
    ap.add_argument("--extract-mode", type=int, default=None)
    ap.add_argument("--extract-format", type=int, default=None,
                    help="0: original format, 1: FASTA, 2: FASTQ")
    ap.add_argument("--outdir", default="")
    args = ap.parse_args(argv)
    from .tools.extract import extract_reads

    mode = args.extract_mode
    if mode is None:
        mode = args.extract_format if args.extract_format is not None else 1
    out = extract_reads(
        args.query, args.classifications, args.dbdir, args.tax_id,
        extract_mode=mode, out_dir=args.outdir,
    )
    print(out)
    return 0


def _filter(argv):
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch filter")
    ap.add_argument("files", nargs="+")
    ap.add_argument("--contam-list", required=True)
    ap.add_argument("--print-mode", type=int, default=1,
                    help="1: only filtered reads, 2: filtered and removed")
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    add_to_parser(ap, ClassifyParams)
    args = ap.parse_args(argv)
    par = from_args(ClassifyParams, args)
    files = args.files
    if par.seq_mode == 2:
        q1, q2, db_dir, out_dir, job_id = files
    else:
        q1, db_dir, out_dir, job_id = files
        q2 = None
    from .tools.filter import filter_reads

    summary = filter_reads(q1, q2, db_dir, out_dir, job_id, args.contam_list,
                           par, print_mode=args.print_mode,
                           device=args.device)
    print(json.dumps(summary))
    return 0


def _validatedb(argv):
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch validatedb")
    ap.add_argument("dbdir")
    args = ap.parse_args(argv)
    from .tools.validate import validate_database

    problems = validate_database(args.dbdir)
    for p in problems:
        print(p)
    print("Database is valid." if not problems else "Database is INVALID.")
    return 1 if problems else 0


def _taxdump(argv):
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch taxdump")
    ap.add_argument("dbdir")
    ap.add_argument("outdir")
    args = ap.parse_args(argv)
    from .db.index import load_db_taxonomy

    tax = load_db_taxonomy(args.dbdir)
    tax.write_dmp(args.outdir)
    print(f"Wrote dmp files to {args.outdir}")
    return 0


def _database_report(argv):
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch database-report")
    ap.add_argument("dbdir")
    ap.add_argument("out", nargs="?", default="")
    args = ap.parse_args(argv)
    from .tools.dbreport import database_report

    out = args.out or os.path.join(args.dbdir, "database_report.tsv")
    database_report(args.dbdir, out)
    print(f"Wrote {out}")
    return 0


def _expand_diffidx(argv):
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch expand_diffidx")
    ap.add_argument("diffidx")
    ap.add_argument("out", nargs="?", default="")
    ap.add_argument("--kmer-begin", type=int, default=0)
    ap.add_argument("--kmer-end", type=int, default=0)
    args = ap.parse_args(argv)
    from .db.formats import delta_decode

    stream = np.fromfile(args.diffidx, dtype=np.uint16)
    values = delta_decode(stream)
    if args.kmer_begin or args.kmer_end:
        end = args.kmer_end or len(values)
        values = values[args.kmer_begin:end]
    if args.out:
        values.tofile(args.out)
        print(f"Wrote {len(values)} uint64 k-mers to {args.out}")
    else:
        for v in values:
            print(int(v))
    return 0


def _print_info(argv):
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch printInfo")
    ap.add_argument("info")
    ap.add_argument("n", nargs="?", type=int, default=20)
    ap.add_argument("--info-begin", type=int, default=0)
    ap.add_argument("--info-end", type=int, default=0)
    args = ap.parse_args(argv)
    begin = args.info_begin
    count = (args.info_end - begin) if args.info_end else args.n
    data = np.fromfile(args.info, dtype=np.uint32, count=count,
                       offset=begin * 4)
    for t in data:
        print(int(t))
    return 0


def _grade(argv):
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch grade")
    ap.add_argument("classifications")
    ap.add_argument("answer_sheet")
    ap.add_argument("dbdir")
    ap.add_argument("--rank", default="species")
    ap.add_argument("--test-rank", default="", help="alias of --rank (reference name)")
    ap.add_argument("--readid-col", type=int, default=0)
    ap.add_argument("--taxid-col", type=int, default=1)
    ap.add_argument("--test-type", default="",
                    help="read-id mangling: gtdb, hiv[-ex], cami[-long|-euk], over")
    ap.add_argument("--skip-secondary", type=int, default=0,
                    help="keep only the first classified observation per read")
    args = ap.parse_args(argv)
    from .tools.grade import grade

    result = grade(args.classifications, args.answer_sheet, args.dbdir,
                   args.test_rank or args.rank,
                   readid_col=args.readid_col, taxid_col=args.taxid_col,
                   test_type=args.test_type,
                   skip_secondary=bool(args.skip_secondary))
    print(json.dumps(result, indent=2))
    return 0


def _accession2taxid(argv):
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch accession2taxid")
    ap.add_argument("library", help="FASTA list file")
    ap.add_argument("taxid_map", nargs="?", default="",
                    help="file name -> taxid TSV")
    ap.add_argument("--assacc2taxid", default="",
                    help="assembly-accession -> taxid file (reference flag name)")
    args = ap.parse_args(argv)
    from .tools.accession import accession2taxid_from_library

    mapping = args.taxid_map or args.assacc2taxid
    if not mapping:
        ap.error("need a taxid map (positional or --assacc2taxid)")
    out = accession2taxid_from_library(args.library, mapping)
    print(f"Wrote {out}")
    return 0


def _refiner(argv):
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch classifiedRefiner")
    ap.add_argument("classifications")
    ap.add_argument("dbdir")
    ap.add_argument("--out", default="")
    ap.add_argument("--min-score", type=float, default=0.0)
    ap.add_argument("--remove-unclassified", type=int, default=0)
    ap.add_argument("--select-taxid", default="")
    ap.add_argument("--exclude-taxid", default="")
    ap.add_argument("--select-columns", default="")
    ap.add_argument("--print-columns", default="",
                    help="CSV of columns to print (reference flag name)")
    ap.add_argument("--rank", default="")
    ap.add_argument("--rank-file-type", type=int, default=0,
                    help="reads above --rank: 0 drop, 1 keep, 2 separate file")
    ap.add_argument("--report", type=int, default=0)
    args = ap.parse_args(argv)
    from .tools.refiner import refine

    out = refine(
        args.classifications, args.dbdir, args.out,
        min_score=args.min_score,
        remove_unclassified=bool(args.remove_unclassified),
        select_taxids=args.select_taxid,
        exclude_taxids=args.exclude_taxid,
        select_columns=args.select_columns or args.print_columns,
        rank=args.rank,
        report=bool(args.report),
        rank_file_type=args.rank_file_type,
    )
    print(out)
    return 0


def _databases(argv):
    from .tools.databases import download_database, print_catalog

    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch databases")
    ap.add_argument("selection", nargs="?", help="catalog entry name")
    ap.add_argument("out_db", nargs="?", help="output DB directory")
    ap.add_argument("tmp", nargs="?", help="tmp dir for the tarball")
    ap.add_argument("--base-url", default=None,
                    help="override the catalog base URL (file:// works)")
    ap.add_argument("--sha256", default=None,
                    help="verify the tarball against this checksum")
    args = ap.parse_args(argv)
    if not args.selection or not args.out_db or not args.tmp:
        print_catalog()
        return 0
    kwargs = {}
    if args.base_url:
        kwargs["base_url"] = args.base_url
    db_dir = download_database(
        args.selection, args.out_db, args.tmp, checksum=args.sha256, **kwargs
    )
    print(f"Database ready at {db_dir}")
    return 0


def _mapping2taxon(argv):
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch mapping2taxon")
    ap.add_argument("mapping", help="read\taccession TSV")
    ap.add_argument("acc2taxid")
    ap.add_argument("out")
    args = ap.parse_args(argv)
    from .db.build import read_acc2taxid

    acc2taxid = read_acc2taxid(args.acc2taxid)
    n = miss = 0
    with open(args.mapping) as fh, open(args.out, "w") as out:
        for line in fh:
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 2:
                continue
            taxid = acc2taxid.get(cols[1]) or acc2taxid.get(cols[1].split(".")[0], 0)
            out.write(f"{cols[0]}\t{taxid}\n")
            n += 1
            miss += taxid == 0
    print(f"{n} mappings written, {miss} accessions unknown")
    return 0


def _add_to_library(argv):
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch add-to-library")
    ap.add_argument("file_list")
    ap.add_argument("mapping")
    ap.add_argument("dbdir")
    ap.add_argument("--library-path", default="")
    args = ap.parse_args(argv)
    from .tools.library import add_to_library

    print(json.dumps(add_to_library(args.file_list, args.mapping, args.dbdir,
                                    args.library_path)))
    return 0


def _make_report(argv):
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch make-report")
    ap.add_argument("classifications")
    ap.add_argument("dbdir")
    ap.add_argument("out", nargs="?", default="")
    args = ap.parse_args(argv)
    from .tools.library import make_report

    print(make_report(args.classifications, args.dbdir, args.out))
    return 0


def _edit_names(argv):
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch editNames")
    ap.add_argument("names_dmp")
    ap.add_argument("taxid_map")
    args = ap.parse_args(argv)
    from .tools.misc import edit_names

    print(f"{edit_names(args.names_dmp, args.taxid_map)} names edited")
    return 0


def _createnewtaxalist(argv):
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch createnewtaxalist")
    ap.add_argument("old_dbdir")
    ap.add_argument("fasta_list")
    ap.add_argument("new_taxonomy_dir")
    ap.add_argument("acc2taxid")
    ap.add_argument("outdir")
    args = ap.parse_args(argv)
    from .tools.misc import create_new_taxa_list

    print(json.dumps(create_new_taxa_list(
        args.old_dbdir, args.fasta_list, args.new_taxonomy_dir,
        args.acc2taxid, args.outdir)))
    return 0


def _print_delta_idx(argv):
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch printDeltaIdx")
    ap.add_argument("diffidx")
    ap.add_argument("n", nargs="?", type=int, default=20)
    ap.add_argument("--kmer-begin", type=int, default=0)
    ap.add_argument("--kmer-end", type=int, default=0)
    args = ap.parse_args(argv)
    from .tools.misc import print_delta_idx

    for v in print_delta_idx(args.diffidx, args.n,
                             begin=args.kmer_begin, end=args.kmer_end):
        print(v)
    return 0


def _grade_by_clade_size(argv):
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch gradeByCladeSize")
    ap.add_argument("classifications")
    ap.add_argument("answer_sheet")
    ap.add_argument("dbdir")
    ap.add_argument("--rank", default="species")
    ap.add_argument("--clade-rank", default="",
                    help="rank whose clade sizes bucket the reads")
    args = ap.parse_args(argv)
    from .tools.misc import grade_by_clade_size

    print(json.dumps(
        grade_by_clade_size(args.classifications, args.answer_sheet,
                            args.dbdir, args.rank,
                            clade_rank=args.clade_rank), indent=2))
    return 0


def _query2reference(argv):
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch query2reference")
    ap.add_argument("classifications")
    ap.add_argument("acc2taxid")
    ap.add_argument("out")
    args = ap.parse_args(argv)
    from .tools.misc import query2reference

    n = query2reference(args.classifications, args.acc2taxid, args.out)
    print(f"{n} reads mapped")
    return 0


def _make_inclusion_queries(argv):
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch makeInclusionTestQueries")
    ap.add_argument("assembly_list", help="one assembly accession per line")
    ap.add_argument("taxonomy_path", help="dir with names/nodes/merged.dmp")
    args = ap.parse_args(argv)
    from .tools.benchmark_sets import make_inclusion_query_set

    out = make_inclusion_query_set(args.assembly_list, args.taxonomy_path)
    if out.get("error"):
        return 1
    print(json.dumps(out))
    return 0


def _make_virus_benchmark(argv):
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch make-virus-benchmark-set")
    ap.add_argument("assembly_list", help="one assembly accession per line")
    ap.add_argument("taxonomy_path", help="dir with names/nodes/merged.dmp")
    ap.add_argument("acc2taxid", help="assembly accession\ttaxid mapping")
    args = ap.parse_args(argv)
    from .tools.benchmark_sets import make_virus_benchmark_set

    out = make_virus_benchmark_set(args.assembly_list, args.taxonomy_path,
                                   args.acc2taxid)
    rc = out.pop("error", 0)
    print(json.dumps(out))
    return rc


def _uniref2taxonomy(argv):
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch uniref2taxonomy")
    ap.add_argument("mapping_file", help="UniRef idmapping TSV (10 columns)")
    ap.add_argument("db_dir")
    args = ap.parse_args(argv)
    from .tools.benchmark_sets import uniref2taxonomy

    return uniref2taxonomy(args.mapping_file, args.db_dir)


def _uniref(argv, mode):
    if mode == "db":
        ap = argparse.ArgumentParser(prog="metabuli_tpu_torch create-uniref-db")
        ap.add_argument("xml", nargs="?", default="")
        ap.add_argument("dbdir", nargs="?", default="")
        ap.add_argument("--uniref-xml", default="",
                        help="UniRef XML path (reference flag name)")
        ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
        args = ap.parse_args(argv)
        if args.uniref_xml and not args.dbdir:
            args.dbdir = args.xml
            args.xml = args.uniref_xml
        if not args.xml or not args.dbdir:
            ap.error("need <xml> <dbdir> (or --uniref-xml <xml> <dbdir>)")
        from .uniref.classifier import create_uniref_db

        print(json.dumps(create_uniref_db(args.xml, args.dbdir,
                                          device=args.device)))
        return 0
    if mode == "tree":
        ap = argparse.ArgumentParser(prog="metabuli_tpu_torch create-uniref-tree")
        ap.add_argument("xml")
        ap.add_argument("out")
        ap.add_argument("--uniref-size", default="",
                        help="CSV of UniRef 100/90/50 cluster counts "
                             "(pre-sizes hash reservations; optional here)")
        args = ap.parse_args(argv)
        from .uniref.tree import build_tree

        tree = build_tree(args.xml)
        tree.save(args.out)
        print(f"{len(tree.names)} nodes written to {args.out}")
        return 0
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch assign_uniref")
    ap.add_argument("query")
    ap.add_argument("dbdir")
    ap.add_argument("outdir")
    ap.add_argument("--protein", type=int, default=-1,
                    help="1=protein, 0=DNA, -1=auto-detect")
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = ap.parse_args(argv)
    from .uniref.classifier import UnirefClassifier

    clf = UnirefClassifier(args.dbdir, device=args.device)
    protein = None if args.protein == -1 else bool(args.protein)
    print(json.dumps(clf.classify_file(args.query, args.outdir, protein)))
    return 0


def _make_aa_offset(argv):
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch makeAAoffset")
    ap.add_argument("diffidx")
    args = ap.parse_args(argv)
    from .tools.misc import make_aa_offset

    print(json.dumps(make_aa_offset(args.diffidx)))
    return 0


def _ictv_format(argv):
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch ictv-format")
    ap.add_argument("classifications")
    ap.add_argument("dbdir")
    ap.add_argument("out", nargs="?", default="")
    args = ap.parse_args(argv)
    from .tools.misc import ictv_format

    print(ictv_format(args.classifications, args.dbdir, args.out))
    return 0


def _filter_by_genus(argv):
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch filter_by_genus")
    ap.add_argument("classifications")
    ap.add_argument("genus_list")
    ap.add_argument("dbdir")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    from .tools.misc import filter_by_genus

    print(filter_by_genus(args.classifications, args.genus_list, args.dbdir,
                          args.out))
    return 0


def _maketestsets(argv):
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch maketestsets")
    ap.add_argument("assembly_list")
    ap.add_argument("acc2taxid")
    ap.add_argument("out_prefix")
    ap.add_argument("--reads-per-assembly", type=int, default=100)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--error-rate", type=float, default=0.0)
    ap.add_argument("--paired", type=int, default=0)
    ap.add_argument("--exclusion-fraction", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--virus-taxid", type=int, default=0,
                    help="restrict to assemblies under this taxon (NCBI 10239)")
    ap.add_argument("--bacteria-taxid", type=int, default=0,
                    help="restrict to assemblies under this taxon (NCBI 2)")
    ap.add_argument("--archaea-taxid", type=int, default=0,
                    help="restrict to assemblies under this taxon (NCBI 2157)")
    ap.add_argument("--taxonomy-path", default="",
                    help="dir with names/nodes/merged.dmp (needed for "
                         "--virus/--bacteria/--archaea-taxid)")
    args = ap.parse_args(argv)
    from .tools.benchmark import make_test_set

    restrict = [t for t in (args.virus_taxid, args.bacteria_taxid,
                            args.archaea_taxid) if t]
    print(json.dumps(make_test_set(
        args.assembly_list, args.acc2taxid, args.out_prefix,
        reads_per_assembly=args.reads_per_assembly, read_len=args.read_len,
        error_rate=args.error_rate, paired=bool(args.paired),
        exclusion_fraction=args.exclusion_fraction, seed=args.seed,
        restrict_taxids=restrict or None,
        taxonomy_dir=args.taxonomy_path)))
    return 0


def _grouping(argv):
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch grouping")
    ap.add_argument("query")
    ap.add_argument("classifications")
    ap.add_argument("outdir")
    ap.add_argument("--min-shared-kmers", type=int, default=None)
    ap.add_argument("--min-edge", type=int, default=None,
                    help="min edge weight (shared k-mers); reference flag name")
    ap.add_argument("--weight-mode", type=int, default=0,
                    help="vote weights: 0 uniform, 1 score, 2 score squared")
    ap.add_argument("--min-vote-score", type=float, default=0.0)
    ap.add_argument("--score-col", type=int, default=5)
    ap.add_argument("--majority-thr", type=float, default=0.5)
    ap.add_argument("--neighbor-kmers", type=int, default=0,
                    help="common-k-mer suppression window: query k-mers "
                         "within this many bases of a --common-kmer-db "
                         "match are dropped before pair counting "
                         "(GroupGenerator.cpp:349-534)")
    ap.add_argument("--common-kmer-db", default="",
                    help="common-k-mer DB dir (diffIdx/info, e.g. from "
                         "create-common-kmer-list); enables the reference's "
                         "pre-grouping k-mer suppression")
    ap.add_argument("--dbdir", default="",
                    help="database dir (for taxonomy-aware majority LCA)")
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = ap.parse_args(argv)
    from .readgroup.group import group_reads_file

    min_edge = args.min_shared_kmers
    if min_edge is None:
        min_edge = args.min_edge if args.min_edge is not None else 2
    taxonomy = None
    if args.dbdir:
        from .db.index import load_db_taxonomy

        taxonomy = load_db_taxonomy(args.dbdir)
    print(json.dumps(group_reads_file(
        args.query, args.classifications, args.outdir, min_edge,
        weight_mode=args.weight_mode, min_vote_score=args.min_vote_score,
        score_col=args.score_col, taxonomy=taxonomy,
        majority_thr=args.majority_thr,
        neighbor_kmers=args.neighbor_kmers,
        common_kmer_db=args.common_kmer_db, device=args.device)))
    return 0


def _kmer_list(argv, mode):
    ap = argparse.ArgumentParser(prog=f"metabuli_tpu_torch {mode}")
    ap.add_argument("dbdir")
    ap.add_argument("out", nargs="?", default="")
    args = ap.parse_args(argv)
    from .db.build import filter_common_kmers, filter_unique_kmers
    from .db.formats import delta_encode
    from .db.index import MetamerIndex

    index = MetamerIndex.load(args.dbdir)
    species = index.species_table()[index.taxids.astype(np.int64)]
    if mode == "count-common-kmers":
        v, _ = filter_common_kmers(index.values, species, index.taxonomy)
        print(json.dumps({"total": len(index.values), "common": len(v)}))
        return 0
    if mode == "create-common-kmer-list":
        v, t = filter_common_kmers(index.values, species, index.taxonomy)
    else:
        v, t = filter_unique_kmers(index.values, index.taxids)
    out = args.out or os.path.join(args.dbdir, f"{mode.split('-')[1]}Kmers")
    os.makedirs(out, exist_ok=True)
    delta_encode(v).tofile(os.path.join(out, "diffIdx"))
    t.astype(np.uint32).tofile(os.path.join(out, "info"))
    print(json.dumps({"kmers": len(v), "out": out}))
    return 0


COMMANDS = {
    "classify": (_classify, "Assign taxonomy to reads"),
    "build": (_build, "Build a reference metamer database"),
    "updateDB": (_updatedb, "Add new sequences to an existing database"),
    "extract": (_extract, "Extract reads classified under a clade"),
    "filter": (_filter, "Filter reads matching contaminant databases"),
    "grade": (_grade, "Benchmark accuracy vs an answer sheet"),
    "validatedb": (_validatedb, "Validate database files"),
    "taxdump": (_taxdump, "Dump taxonomy dmp files from a database"),
    "database-report": (_database_report, "Per-species content report of a DB"),
    "expand_diffidx": (_expand_diffidx, "Decompress a diffIdx delta stream"),
    "printInfo": (_print_info, "Print entries of an info file"),
    "accession2taxid": (_accession2taxid, "Derive accession2taxid for GTDB-style libraries"),
    "classifiedRefiner": (_refiner, "Filter/reshape a classifications TSV"),
    "databases": (_databases, "Download and unpack prebuilt databases"),
    "mapping2taxon": (_mapping2taxon, "Map read->accession files to taxids"),
    "add-to-library": (_add_to_library, "Split FASTAs into per-species library files"),
    "make-report": (_make_report, "Regenerate a report from classifications"),
    "editNames": (_edit_names, "Fix taxonkit names.dmp for GTDB assemblies"),
    "createnewtaxalist": (_createnewtaxalist, "Produce --new-taxa input for updateDB"),
    "printDeltaIdx": (_print_delta_idx, "Print decoded diffIdx k-mers"),
    "gradeByCladeSize": (_grade_by_clade_size, "Accuracy stratified by clade size"),
    "query2reference": (_query2reference, "Map classified reads to reference accessions"),
    "grouping": (_grouping, "Group overlapping reads and propagate labels"),
    "maketestsets": (_maketestsets, "Sample benchmark reads + answer sheet from assemblies"),
    "makeAAoffset": (_make_aa_offset, "Decompose diffIdx into per-AA-group files"),
    "ictv-format": (_ictv_format, "Export classifications as ICTV-challenge CSV"),
    "filter_by_genus": (_filter_by_genus, "Keep classification rows of listed genera"),
    "makeInclusionTestQueries": (_make_inclusion_queries,
                                 "Assembly-split inclusion query sets"),
    "make-virus-benchmark-set": (_make_virus_benchmark,
                                 "Virus exclusion/inclusion benchmark sets"),
    "uniref2taxonomy": (_uniref2taxonomy,
                        "Parse a UniRef idmapping into cluster maps"),
    "create-uniref-db": (lambda a: _uniref(a, "db"),
                         "Build a UniRef cluster k-mer database from XML"),
    "create-uniref-tree": (lambda a: _uniref(a, "tree"),
                           "Build the UniRef100/90/50 cluster tree"),
    "assign_uniref": (lambda a: _uniref(a, "assign"),
                      "Classify protein/DNA queries to UniRef clusters"),
    "count-common-kmers": (lambda a: _kmer_list(a, "count-common-kmers"),
                           "Count k-mers shared between species"),
    "create-common-kmer-list": (lambda a: _kmer_list(a, "create-common-kmer-list"),
                                "Write the cross-species common k-mer index"),
    "create-unique-kmer-list": (lambda a: _kmer_list(a, "create-unique-kmer-list"),
                                "Write the single-taxon unique k-mer index"),
}



def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(f"metabuli_tpu_torch {__version__} — the PyTorch / CUDA port "
              "of metabuli_tpu")
        print("\nCommands:")
        for name, (_, help_text) in COMMANDS.items():
            print(f"  {name:18s} {help_text}")
        return 0
    if argv[0] == "--version":
        print(__version__)
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"Unknown command: {cmd}", file=sys.stderr)
        return 1
    return COMMANDS[cmd][0](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
