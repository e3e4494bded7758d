"""Command-line interface: index / discover / score / random / extract.

Counterpart of the reference's picocli modules (Main.scala:51-57 and
modules/*.scala), with identical flag names and defaults.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

logger = logging.getLogger("flashfry_tpu")


def _add_index(sub):
    p = sub.add_parser("index", help="Generate a binary representation of the genome that can be used for off-target searches")
    p.add_argument("--reference", "-reference", required=True)
    p.add_argument("--database", "-database", required=True)
    p.add_argument("--tmpLocation", "-tmpLocation", required=False, default=None,
                   help="unused (kept for CLI parity with the reference)")
    p.add_argument("--enzyme", "-enzyme", default="spCas9ngg")
    p.add_argument("--binSize", "-binSize", type=int, default=7)
    p.add_argument("--format", default="native", choices=["native", "flashfry"],
                   help="on-disk format: columnar npz (default) or the "
                        "reference's BGZF block format")
    return p


def _add_discover(sub):
    p = sub.add_parser("discover", help="Discover off-targets for the specified sequences within the genome of interest")
    p.add_argument("--fasta", "-fasta", required=True)
    p.add_argument("--database", "-database", required=True)
    p.add_argument("--output", "-output", required=True)
    p.add_argument("--positionOutput", "-positionOutput", action="store_true")
    p.add_argument("--forceLinear", "-forceLinear", action="store_true")
    p.add_argument("--maxMismatch", "-maxMismatch", type=int, default=4)
    p.add_argument("--flankingSequence", "-flankingSequence", type=int, default=6)
    p.add_argument("--maximumOffTargets", "-maximumOffTargets", type=int, default=2000)
    p.add_argument("--minGC", "-minGC", type=float, default=0.0)
    p.add_argument("--maxGC", "-maxGC", type=float, default=1.0)
    p.add_argument("--backend", default="auto", choices=["auto", "numpy", "jax"],
                   help="scan backend: jax (the device scan), numpy (the "
                        "host oracle), or auto (jax on an accelerator)")
    # multi-host scale-out (SURVEY §5.8): run the SAME
    # discover command once per host with --coordinator/--numProcesses/
    # --processId; the database's device planes shard across hosts (each
    # host uploads only its slab) and process 0 writes the output.
    p.add_argument("--coordinator", default=None,
                   help="multi-host: jax.distributed coordinator host:port")
    p.add_argument("--numProcesses", type=int, default=None,
                   help="multi-host: total number of processes")
    p.add_argument("--processId", type=int, default=None,
                   help="multi-host: this process's id (0-based)")
    return p


def _add_score(sub):
    p = sub.add_parser("score", help="Score candidate guides with the specified scoring metrics")
    p.add_argument("--input", "-input", required=True)
    p.add_argument("--output", "-output", required=True)
    p.add_argument("--database", "-database", required=True)
    p.add_argument("--scoringMetrics", "-scoringMetrics", required=True)
    p.add_argument("--maxMismatch", "-maxMismatch", type=int, default=None,
                   help="only consider off-targets within this mismatch distance (default: unlimited)")
    p.add_argument("--includeOTs", "-includeOTs", action="store_true")
    p.add_argument("--numericOutput", "-numericOutput", action="store_true")
    p.add_argument("--inputAnnotationBed", "-inputAnnotationBed", action="append", default=[])
    p.add_argument("--transformPositions", "-transformPositions", action="append", default=[])
    p.add_argument("--countOnTargetInScore", "-countOnTargetInScore", action="store_true")
    p.add_argument("--maxReciprocalMismatch", "-maxReciprocalMismatch", type=int, default=1)
    p.add_argument("--shortestGuideEnergy", "-shortestGuideEnergy", type=int, default=-1)
    return p


def _add_random(sub):
    p = sub.add_parser("random", help="Generate a random set of CRISPR targets")
    p.add_argument("--outputFile", "-outputFile", required=True)
    p.add_argument("--enzyme", "-enzyme", default="")
    p.add_argument("--namePrefix", "-namePrefix", default="random")
    p.add_argument("--onlyUnidirectional", "-onlyUnidirectional", action="store_true")
    p.add_argument("--randomCount", "-randomCount", type=int, required=True)
    p.add_argument("--sequenceContextLeft", "-sequenceContextLeft", type=int, default=0)
    p.add_argument("--sequenceContextRight", "-sequenceContextRight", type=int, default=0)
    p.add_argument("--patterned", "-patterned", default="")
    p.add_argument("--duplicatesAllowed", "-duplicatesAllowed", action="store_true")
    p.add_argument("--maxSuccessiveDesignFailures", "-maxSuccessiveDesignFailures", type=int, default=50)
    p.add_argument("--seed", type=int, default=None, help="deterministic output (extension)")
    return p


def _add_extract(sub):
    p = sub.add_parser("extract", help="Dump targets from the database to a FASTA")
    # reference flag name is -binaryOTFile/--binaryOTFile
    # (modules/DumpDatabase.scala:33-35); --database kept as an alias.
    p.add_argument("--binaryOTFile", "-binaryOTFile", "--database", "-database",
                   dest="database", required=True)
    p.add_argument("--outputFile", "-outputFile", required=True)
    p.add_argument("--minInGenome", "-minInGenome", type=int, default=0)
    p.add_argument("--maxInGenome", "-maxInGenome", type=int, default=2 ** 31 - 1)
    p.add_argument("--subsampleProportion", "-subsampleProportion", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=None)
    return p


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="flashfry-tpu",
                                 description="CRISPR target characterization on a JAX accelerator")
    sub = ap.add_subparsers(dest="command", required=True)
    _add_index(sub)
    _add_discover(sub)
    _add_score(sub)
    _add_random(sub)
    _add_extract(sub)
    return ap


def cmd_index(args) -> None:
    from .database import build_database, save_database
    from .standards import name_to_parameter_pack
    pack = name_to_parameter_pack(args.enzyme)
    logger.info("Discovering target sites in the input genome file...")
    db = build_database(args.reference, pack, bin_width=args.binSize)
    logger.info("Creating the final database file (%d targets)...", db.num_targets)
    if args.format == "flashfry":
        from .ffformat import export_flashfry_database
        export_flashfry_database(db, args.database)
    else:
        save_database(db, args.database)


def cmd_discover(args) -> None:
    from .database import load_database
    from .discovery import find_target_sites
    from .engine import ScanStats, discover
    from .targetio import write_output
    from .utils import iterate_fasta

    assert 0.0 <= args.minGC <= 1.0 and 0.0 <= args.maxGC <= 1.0
    db = load_database(args.database)

    scanner = None
    is_main = True
    backend = args.backend
    if args.coordinator is not None:
        # multi-host runs the SPMD device scan on every process; the numpy
        # oracle has no multi-process form, so honoring --backend numpy here
        # would silently hand the user something else — reject instead
        if backend == "numpy":
            raise SystemExit(
                "--coordinator (multi-host) requires the device scan; "
                "--backend numpy is single-process only")
        # multi-host: every process runs the identical SPMD program over the
        # global (db, guides) mesh; the triplet buffers are allgathered so
        # every process reconstructs the same hit set, and process 0 writes
        assert args.numProcesses is not None and args.processId is not None, \
            "--coordinator requires --numProcesses and --processId"
        from .parallel import multihost
        multihost.initialize(args.coordinator, args.numProcesses,
                             args.processId)
        import jax
        is_main = jax.process_index() == 0
        scanner = multihost.MultiHostScanner(
            db, mesh=multihost.make_global_mesh())
        backend = "jax"
        logger.info("multi-host discover: process %d/%d, %d devices",
                    args.processId, args.numProcesses, len(jax.devices()))

    logger.info("Reading the input fasta and scanning for candidate guides...")
    gsites = find_target_sites(iterate_fasta(args.fasta), db.pack,
                               flanking_sequence=args.flankingSequence,
                               capture_context=True)
    logger.info("Scanning %d candidate guides against the genome database...", len(gsites))
    stats = ScanStats()
    guides = discover(db, gsites,
                      max_mismatch=args.maxMismatch,
                      maximum_off_targets=args.maximumOffTargets,
                      min_gc=args.minGC, max_gc=args.maxGC,
                      force_linear=args.forceLinear,
                      backend=backend,
                      stats=stats,
                      scanner=scanner)
    logger.info("Performed a total of %s guide to target comparisons in %.3fs",
                format(stats.all_comparisons, ","), stats.scan_seconds)
    if is_main:
        write_output(args.output, guides, db.bit_encoding(), db.bit_position(),
                     models=(), write_ots=True,
                     write_positions=args.positionOutput)


def cmd_score(args) -> None:
    from .scoring import run_score_module
    run_score_module(args)


def cmd_random(args) -> None:
    from .random_guides import generate_random_fasta
    generate_random_fasta(args)


def cmd_extract(args) -> None:
    from .extract import dump_database
    dump_database(args)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s - %(message)s")
    t0 = time.time()
    args = build_parser().parse_args(argv)
    {"index": cmd_index, "discover": cmd_discover, "score": cmd_score,
     "random": cmd_random, "extract": cmd_extract}[args.command](args)
    logger.info("Total runtime %.2fs", time.time() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
