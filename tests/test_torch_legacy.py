"""The port's legacy ops (`--op check`, `--op solve`: the balancer and
traversal pipeline) against the JAX package.

The port keeps its own copies of `exceptions.py` and `legacy/*.py`.
Both CLIs run on the same inputs (the bundled 75-segment legacy case
and its junction database, a simulated S=16 case with long-read and
Hi-C guidance, the linear genomes of tests/test_legacy.py) and must
write the same files and print the same lines, byte for byte; the
modules' results must be equal. Every comparison here is exact.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ambigram_tpu import cli as jcli
from ambigram_tpu.io.lh import parse_lh_text as jparse
from ambigram_tpu.legacy import balancer as jbal
from ambigram_tpu.legacy import juncdb as jdb
from ambigram_tpu.legacy import reachability as jreach
from ambigram_tpu.legacy import traversal as jtrav
from ambigram_tpu.model.genome import Genome as JGenome
from ambigram_tpu_torch import cli as tcli
from ambigram_tpu_torch.io.lh import parse_lh_text as tparse
from ambigram_tpu_torch.legacy import balancer as tbal
from ambigram_tpu_torch.legacy import juncdb as tdb
from ambigram_tpu_torch.legacy import reachability as treach
from ambigram_tpu_torch.legacy import traversal as ttrav
from ambigram_tpu_torch.model.genome import Genome as TGenome

# the suite runs in several worker processes at once; torch's default of
# one intra-op thread per core would oversubscribe the CPU for all of them
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
LEGACY75 = os.path.join(DATA, "legacy75.lh")
LEGACY75_DB = os.path.join(DATA, "legacy75.junc.db")
N_MID = 16


def run_cli(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def check_both(tmp_path, capsys, lh, extra=()):
    """`--op check` through both CLIs; returns the two balanced files."""
    outs = {}
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        out_lh = str(tmp_path / ("%s.balanced.lh" % name))
        rc, text = run_cli(
            main, ["--op", "check", "--in_lh", lh, "--lp_prefix", str(tmp_path / name), "--out_lh", out_lh, *extra],
            capsys,
        )
        assert rc == 0
        outs[name] = (out_lh, text.replace(out_lh, "<out_lh>"))
    assert outs["port"][1] == outs["jax"][1]
    assert open(outs["port"][0]).read() == open(outs["jax"][0]).read()
    return outs["jax"][0], outs["port"][0]


def mid_case(tmp_path):
    """The simulated S=16 case of tests/test_solve_guidance.py, with its
    long-read fragments and Hi-C matrix drawn from the truth path."""
    from ambigram_tpu.scripts.simulate import all_junctions, legacy_lh_text, simulate_bfb_case

    case = simulate_bfb_case(seed=5, n_segments=N_MID, rounds=4, coverage=40.0, mode="process")
    lh = tmp_path / "mid.lh"
    lh.write_text(legacy_lh_text(case))
    path = case.truth_path
    frags = [" ".join("%d%s" % (s, d) for s, d in path[k : k + 4]) for k in range(0, len(path) - 4, 2)]
    (tmp_path / "frags.txt").write_text("\n".join(frags[:12]) + "\n")
    mat = np.zeros((N_MID, N_MID))
    for (s1, _d1, s2, _d2), cn in all_junctions(path).items():
        mat[s1 - 1, s2 - 1] += cn
        mat[s2 - 1, s1 - 1] += cn
    np.savetxt(tmp_path / "hic.txt", mat, fmt="%g")
    return str(lh)


@pytest.mark.parametrize("fixture", ["legacy75", "legacy75+juncdb", "mid16"])
def test_check_writes_the_jax_balanced_lh(fixture, tmp_path, capsys):
    if fixture == "mid16":
        check_both(tmp_path, capsys, mid_case(tmp_path))
    else:
        extra = ("--juncdb", LEGACY75_DB) if fixture.endswith("juncdb") else ()
        check_both(tmp_path, capsys, LEGACY75, extra)


@pytest.mark.parametrize(
    "fixture, guidance",
    [("legacy75", "none"), ("mid16", "none"), ("mid16", "tgs_order"), ("mid16", "hic_matrix"), ("mid16", "both")],
)
def test_solve_writes_the_jax_files(fixture, guidance, tmp_path, capsys):
    """Haploids, circuits and traversed paths of the balanced graph; the
    guidance files are drawn from the simulated case's truth."""
    lh = LEGACY75 if fixture == "legacy75" else mid_case(tmp_path)
    balanced_j, balanced_t = check_both(tmp_path, capsys, lh)
    extra = []
    if guidance in ("tgs_order", "both"):
        extra += ["--tgs_order", str(tmp_path / "frags.txt")]
    if guidance in ("hic_matrix", "both"):
        extra += ["--hic_matrix", str(tmp_path / "hic.txt")]
    files = {}
    for name, main, balanced in (("jax", jcli.main, balanced_j), ("port", tcli.main, balanced_t)):
        out = {k: str(tmp_path / ("%s.%s.txt" % (name, k))) for k in ("hap", "circuits", "traversed")}
        rc, text = run_cli(
            main,
            ["--op", "solve", "--in_lh", balanced, "--hap", out["hap"], "--circuits", out["circuits"],
             "--traversed", out["traversed"], *extra],
            capsys,
        )
        assert rc == 0
        files[name] = out
        assert text == "haploids written to %s\n" % out["hap"]
    for k in ("hap", "circuits", "traversed"):
        assert open(files["port"][k]).read() == open(files["jax"][k]).read(), k
    assert open(files["port"]["hap"]).read().startswith("partition")


def test_solve_default_hap_path_uses_lp_prefix(tmp_path, capsys, monkeypatch):
    _, balanced = check_both(tmp_path, capsys, LEGACY75)
    monkeypatch.chdir(tmp_path)
    prefix = str(tmp_path / "mysample")
    assert tcli.main(["--op", "solve", "--in_lh", balanced, "--lp_prefix", prefix]) == 0
    assert os.path.exists(prefix + ".haploids.txt")
    assert not os.path.exists(tmp_path / "haploids.txt")


def test_legacy_ops_run_on_the_host_whatever_the_device(tmp_path, capsys):
    """`--device` does not apply to check/solve: they never touch torch's
    devices, so a CUDA device without a card still runs them."""
    out_lh = str(tmp_path / "b.lh")
    argv = ["--op", "check", "--in_lh", LEGACY75, "--out_lh", out_lh, "--device", "cuda"]
    assert tcli.main(argv) == 0
    assert tcli.main(["--op", "solve", "--in_lh", out_lh, "--hap", str(tmp_path / "h.txt"), "--device", "cuda"]) == 0


def genomes(n=4, cn=2.0, extra_juncs=()):
    """The linear genome of tests/test_legacy.py, built by each package."""
    cov = 30.0
    text = "AVG_WHOLE_HOST_DP 30\nPURITY 1\nAVG_TUMOR_PLOIDY 2\nSOURCE 1\nSINK %d\n" % n
    for i in range(1, n + 1):
        text += "SEG H:%d:chr1:%d:%d %g %g\n" % (i, i * 1000, i * 1000 + 999, cov * cn / 2, cn)
    for i in range(1, n):
        text += "JUNC H:%d:+ H:%d:+ %g %g U B\n" % (i, i + 1, cov * cn / 2, cn)
    text += "".join(j + "\n" for j in extra_juncs)
    out = []
    for Genome, parse in ((JGenome, jparse), (TGenome, tparse)):
        g = Genome.from_records(parse(text))
        g.calculate_hap_depth()
        g.calculate_copy_num()
        out.append(g)
    return out


def db_dump(db):
    return [
        (r.chrom, r.pos, r.strand, [dataclasses.astuple(e) for e in r.forward_entries],
         [dataclasses.astuple(e) for e in r.backward_entries])
        for r in db.records
    ]


def test_junction_db_matches_jax():
    assert db_dump(tdb.JunctionDB(LEGACY75_DB)) == db_dump(jdb.JunctionDB(LEGACY75_DB))
    gj, gt = genomes()
    assert db_dump(tdb.JunctionDB(gt.junctions)) == db_dump(jdb.JunctionDB(gj.junctions))


@pytest.mark.parametrize("case", ["consistent", "noisy", "legacy75", "legacy75-relaxed"])
def test_balancer_matches_jax(case):
    if case.startswith("legacy75"):
        gj, gt = JGenome.from_lh(LEGACY75), TGenome.from_lh(LEGACY75)
        for g in (gj, gt):
            g.calculate_hap_depth()
            g.calculate_copy_num()
    else:
        gj, gt = genomes(n=4 if case == "consistent" else 3)
        if case == "noisy":
            gj.segments[1].weight.corrected_coverage = gt.segments[1].weight.corrected_coverage = 36.0
    jreach.connect_source_sink(gj)
    treach.connect_source_sink(gt)
    relaxed = case.endswith("relaxed")
    want = jbal.balance(gj, allow_junction_off=relaxed)
    got = tbal.balance(gt, allow_junction_off=relaxed)
    assert got.status == want.status == "optimal" and got.objective == want.objective
    for k in ("seg_cn", "junc_cn", "junc_on"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    jbal.apply_balance(gj, want)
    tbal.apply_balance(gt, got)
    assert [s.weight.copy_num for s in gt.segments] == [s.weight.copy_num for s in gj.segments]
    np.testing.assert_array_equal(tbal.scale_ilp_coef(np.array([10.0, 20.0, 30.0])),
                                  jbal.scale_ilp_coef(np.array([10.0, 20.0, 30.0])))


def test_reachability_matches_jax():
    gj, gt = genomes(n=4)
    infos = lambda res: {k: [v.info() for v in vs] for k, vs in res.items()}  # noqa: E731
    assert infos(treach.check_reachability(gt)) == infos(jreach.check_reachability(gj))
    jreach.connect_source_sink(gj)
    treach.connect_source_sink(gt)
    for a, b, signs in ((1, 4, "++"), (4, 1, "--"), (1, 4, "-+")):
        def vertex(g, i, s):
            seg = g.segment_by_id(i)
            return seg.pos if s == "+" else seg.neg

        assert treach.does_path_exist(gt, vertex(gt, a, signs[0]), vertex(gt, b, signs[1])) == jreach.does_path_exist(
            gj, vertex(gj, a, signs[0]), vertex(gj, b, signs[1])
        )
    gj, gt = genomes(n=4)
    added = []
    for g, reach, db_mod in ((gj, jreach, jdb), (gt, treach, tdb)):
        db = db_mod.JunctionDB()
        db.insert_record("chr1", g.segment_by_id(2).end, "+", "chr1", g.segment_by_id(4).start, "+", 7)
        added.append([j.info() for j in reach.add_all_juncs_from_db(g, db)])
    assert added[1] == added[0] and added[0]


def test_traversal_matches_jax(tmp_path):
    """Traversal, circuit extraction and division, haploids and the long
    fragments' merge on the duplication genome of tests/test_legacy.py."""
    written = {}
    for name, g, reach, trav, db_mod in zip(
        ("jax", "port"), genomes(n=4, extra_juncs=("JUNC H:3:+ H:2:+ 30 1 U B",)),
        (jreach, treach), (jtrav, ttrav), (jdb, tdb),
    ):
        g.segment_by_id(2).weight.set_copy_num(3)
        g.segment_by_id(3).weight.set_copy_num(3)
        reach.connect_source_sink(g)
        for j in g.junctions:
            if j.weight.copy_num < 0:
                j.weight.set_copy_num(2.0)
        tr = trav.Traverser(g)
        tr.traverse_graph(db_mod.JunctionDB(g.junctions))
        tr.extract_circuits()
        tr.divide_circuits()
        haps = tr.generate_haploids()
        tr.write_circuits(str(tmp_path / (name + ".c.txt")))
        tr.write_haploids(str(tmp_path / (name + ".h.txt")))
        frags = tmp_path / (name + ".frags.txt")
        frags.write_text("1+ 2+\n2+ 3+\n4- 3-\n")
        tr2 = trav.Traverser(g)
        tr2.read_long_frags(str(frags))
        written[name] = (
            {k: [[v.info() for v in p] for p in ps] for k, ps in haps.items()},
            sorted("".join(v.info() for v in p) for p in tr2.long_frags[1]),
            [v.info() for v in trav.get_complement([g.segment_by_id(1).pos, g.segment_by_id(2).pos])],
        )
    assert written["port"] == written["jax"]
    for kind in ("c", "h"):
        assert (tmp_path / ("port.%s.txt" % kind)).read_text() == (tmp_path / ("jax.%s.txt" % kind)).read_text()


def test_exceptions_copy_matches_jax():
    from ambigram_tpu import exceptions as jexc
    from ambigram_tpu_torch import exceptions as texc

    names = lambda m: sorted(n for n in dir(m) if n.endswith("Error"))  # noqa: E731
    assert names(texc) == names(jexc)
    for n in names(texc):
        assert [b.__name__ for b in getattr(texc, n).__mro__] == [b.__name__ for b in getattr(jexc, n).__mro__]
    assert issubclass(texc.ILPBalancerInfeasibleError, texc.AmbigramError)
