"""Full index -> discover -> score pipeline with pinned golden md5s.

Mirrors the reference's test_data/integration_test.sh:77-87 (which pins md5s
of EMX1.output and its scored variants on chr22 — that tarball is stripped
from this image, so we pin our own pipeline's outputs on the checked-in myc
fixture instead). Any unintended change to site discovery, the scan, overflow
accounting, scoring or the TSV format shows up as an md5 mismatch here.
"""

import hashlib
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MYC = "/root/reference/test_data/myc.fasta"
GUIDES = os.path.join(ROOT, "tests", "data", "myc_guides.fasta")

GOLDEN = {
    "g.out": "74308849221105d1de705bcb27a6dad0",
    "g.pos.out": "05926a0988c1b4e301ba9b8a94be9032",
    "g.scored": "999611d1d181e54c8e401e2fe33865de",
    "g.scored_ots": "c0cc916f589654303d2e277f29fbd357",
}


def run(args, platform=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    if platform:
        env["JAX_PLATFORMS"] = platform
        flags = env.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            env["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    subprocess.run([sys.executable, "-m", "flashfry_tpu"] + args,
                   check=True, env=env, capture_output=True)


def md5(path):
    return hashlib.md5(open(path, "rb").read()).hexdigest()


@pytest.mark.skipif(not os.path.exists(MYC), reason="reference fixture missing")
def test_full_pipeline_golden_md5(tmp_path):
    w = str(tmp_path)
    run(["index", "--reference", MYC, "--database", w + "/db",
         "--enzyme", "spcas9"])
    run(["discover", "--fasta", GUIDES, "--database", w + "/db",
         "--output", w + "/g.out", "--backend", "numpy"])
    run(["discover", "--fasta", GUIDES, "--database", w + "/db",
         "--output", w + "/g.pos.out", "--positionOutput", "--backend", "numpy"])
    run(["score", "--input", w + "/g.pos.out", "--output", w + "/g.scored",
         "--scoringMetrics",
         "doench2014ontarget,doench2016cfd,dangerous,hsu2013,minot",
         "--database", w + "/db"])
    run(["score", "--input", w + "/g.pos.out", "--output", w + "/g.scored_ots",
         "--scoringMetrics", "doench2016cfd", "--includeOTs",
         "--database", w + "/db"])
    for name, expect in GOLDEN.items():
        assert md5(os.path.join(w, name)) == expect, "%s changed" % name


@pytest.mark.skipif(not os.path.exists(MYC), reason="reference fixture missing")
def test_cpf1_pipeline_golden_md5(tmp_path):
    """BASELINE config #4: Cas12a/cpf1 (5' TTTN PAM) index + discover + score
    end-to-end through the CLI (alternate PAM/orientation path — 5' bin keys,
    no indexed blocks, 24bp scan length)."""
    w = str(tmp_path)
    run(["index", "--reference", MYC, "--database", w + "/db",
         "--enzyme", "cpf1"])
    run(["discover", "--fasta", MYC, "--database", w + "/db",
         "--output", w + "/g.pos.out", "--positionOutput", "--backend", "numpy"])
    run(["score", "--input", w + "/g.pos.out", "--output", w + "/g.scored",
         "--scoringMetrics", "dangerous,minot", "--database", w + "/db"])
    with open(w + "/g.pos.out") as fh:
        lines = fh.read().splitlines()
    assert len(lines) == 419  # header + 418 cpf1 sites in myc
    assert all(line.split("\t")[3].startswith("TTT") for line in lines[1:])
    assert md5(w + "/g.pos.out") == "dab884707b778f2982ce304eb46527d7"
    assert md5(w + "/g.scored") == "6274ee9ee14bed408768d4aad06bde37"


@pytest.mark.skipif(not os.path.exists(MYC), reason="reference fixture missing")
def test_bed_annotation_cli_golden_md5(tmp_path):
    """BASELINE config #2: BED-interval annotation through the score CLI
    (--inputAnnotationBed name:file), guides discovered with genomic
    coordinates so intervals genuinely overlap."""
    w = str(tmp_path)
    bed = os.path.join(ROOT, "tests", "data", "myc_overlap.bed")
    run(["index", "--reference", MYC, "--database", w + "/db",
         "--enzyme", "spcas9"])
    run(["discover", "--fasta", MYC, "--database", w + "/db",
         "--output", w + "/m.pos.out", "--positionOutput", "--backend", "numpy"])
    run(["score", "--input", w + "/m.pos.out", "--output", w + "/m.scored",
         "--scoringMetrics", "bedannotator",
         "--inputAnnotationBed", "anno:" + bed, "--database", w + "/db"])
    with open(w + "/m.scored") as fh:
        anno = [line.split("\t")[7] for line in fh.read().splitlines()[1:]]
    assert anno.count("regionA") == 110
    assert anno.count("regionA,regionB") == 1  # interval-boundary straddle
    assert anno.count("NA") == 310
    assert md5(w + "/m.scored") == "b491b9399c23119beacda8cf949ee390"


@pytest.mark.skipif(not os.path.exists(MYC), reason="reference fixture missing")
def test_jax_backend_cli_md5_equal(tmp_path):
    """The jax backend (8-virtual-CPU sharded scan) through the CLI must
    produce a file byte-identical to the numpy oracle backend."""
    w = str(tmp_path)
    run(["index", "--reference", MYC, "--database", w + "/db",
         "--enzyme", "spcas9"])
    run(["discover", "--fasta", GUIDES, "--database", w + "/db",
         "--output", w + "/g.np.out", "--positionOutput", "--backend", "numpy"])
    run(["discover", "--fasta", GUIDES, "--database", w + "/db",
         "--output", w + "/g.jax.out", "--positionOutput", "--backend", "jax"],
        platform="cpu")
    assert md5(w + "/g.jax.out") == md5(w + "/g.np.out")
    assert md5(w + "/g.jax.out") == GOLDEN["g.pos.out"]
