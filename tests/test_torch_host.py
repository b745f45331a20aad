"""The port's own copies of the JAX package's host modules against the
originals.

The port imports nothing of `ambigram_tpu`: parsing, program building,
the simulator, the manifest grammar and the path replay are copies
under `ambigram_tpu_torch/`. Here each copy is held against its
original on the same inputs: egfr6, the S=48 seed-0 suite case and a
two-chromosome LH (SOURCE 1,4 / SINK 3,6).
"""

import dataclasses
import io
import os

import numpy as np
import pytest
import torch

from ambigram_tpu import cli as jcli
from ambigram_tpu.engine import ilp as jilp
from ambigram_tpu.engine import pipeline as jpipeline
from ambigram_tpu.scripts import simulate as jsim
from ambigram_tpu_torch import cli as tcli
from ambigram_tpu_torch.engine import ilp as tilp
from ambigram_tpu_torch.engine import pipeline as tpipeline
from ambigram_tpu_torch.scripts import simulate as tsim

# the suite runs in several worker processes at once; torch's default of
# one intra-op thread per core would oversubscribe the CPU for all of them
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
EGFR6 = os.path.join(DATA, "egfr6.lh")

# two chromosomes, each with fold-back inversions, so both programs are
# non-trivial
TWO_CHROM_LH = (
    "AVG_WHOLE_HOST_DP 30\nPURITY 1\nAVG_TUMOR_PLOIDY 2\n"
    "SOURCE 1,4\nSINK 3,6\n"
    "SEG H:1:chr1:1000:2000 30.0 1.0\n"
    "SEG H:2:chr1:2001:3000 90.0 3.0\n"
    "SEG H:3:chr1:3001:4000 90.0 3.0\n"
    "SEG H:4:chr2:1000:2000 30.0 1.0\n"
    "SEG H:5:chr2:2001:3000 60.0 2.0\n"
    "SEG H:6:chr2:3001:4000 90.0 3.0\n"
    "JUNC H:3:+ H:3:- 30.0 1.0 U B\n"
    "JUNC H:2:- H:2:+ 30.0 1.0 U B\n"
    "JUNC H:5:- H:5:+ 30.0 1.0 U B\n"
    "JUNC H:6:+ H:6:- 15.0 0.5 U B\n"
)


def _lh(tmp_path, name):
    """The .lh path of one named input."""
    if name == "egfr6":
        return EGFR6
    if name == "two_chrom":
        path = tmp_path / "two_chrom.lh"
        path.write_text(TWO_CHROM_LH)
        return str(path)
    assert name == "s48_seed0"
    case = jsim.simulate_bfb_case(seed=0, n_segments=48, rounds=5, coverage=30.0, mode="process", noise=0.05)
    return jsim.write_case(case, str(tmp_path / "s48"))["lh"]


def assert_programs_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("name", ["egfr6", "s48_seed0", "two_chrom"])
def test_extract_programs_match_reference(name, tmp_path):
    path = _lh(tmp_path, name)
    got = tpipeline.extract_programs(path)
    want = jpipeline.extract_programs(path)
    assert [p is None for p in got] == [p is None for p in want]
    assert sum(p is not None for p in want) >= 1
    if name == "two_chrom":
        assert len(want) == 2 and all(p is not None for p in want)
    for g, w in zip(got, want):
        if w is not None:
            assert_programs_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_bfb_program_matches_reference(seed):
    """Random CN profiles, with and without long-read components."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 9))
    seg_cn = rng.integers(1, 7, size=n).astype(np.float64)
    fbi_cn = rng.integers(0, 3, size=n).astype(np.float64)
    comps = [[1, 2], [2, 3, 4]] if seed % 2 else []
    args = (1, n, seg_cn, fbi_cn, float(seg_cn.sum()), int(rng.integers(0, 3)))
    got = tilp.build_bfb_program(*args, components=comps, juncs_info=bool(comps))
    want = jilp.build_bfb_program(*args, components=comps, juncs_info=bool(comps))
    assert_programs_equal(got, want)


@pytest.mark.parametrize(
    "seed, kwargs",
    [
        (0, dict(n_segments=48, rounds=5, coverage=30.0, mode="process", noise=0.05)),
        (3, dict(n_segments=8, mode="nested")),
        (201, dict(n_segments=48, rounds=5, mode="process", noise=0.05)),
    ],
    ids=["s48_suite", "nested", "batch_recipe"],
)
def test_simulate_writes_the_same_case(seed, kwargs, tmp_path):
    got = tsim.write_case(tsim.simulate_bfb_case(seed=seed, **kwargs), str(tmp_path / "port"))
    want = jsim.write_case(jsim.simulate_bfb_case(seed=seed, **kwargs), str(tmp_path / "ref"))
    assert sorted(got) == sorted(want)
    for key in want:
        with open(got[key], "rb") as a, open(want[key], "rb") as b:
            assert a.read() == b.read(), key


@pytest.mark.parametrize("name", ["egfr6", "two_chrom"])
def test_run_bfb_replay_matches_reference(name, tmp_path):
    """The port's run_bfb (its own replay) prints and returns what the
    JAX package's does, with the exact solver."""
    path = _lh(tmp_path, name)
    out_t, out_j = io.StringIO(), io.StringIO()
    got = tpipeline.run_bfb(path, solver="exact", device="cpu", out=out_t)
    want = jpipeline.run_bfb(path, solver="exact", out=out_j)
    assert out_t.getvalue() == out_j.getvalue()
    assert got.path_strings == want.path_strings
    assert got.ilp_error == want.ilp_error
    assert got.target_cn == want.target_cn
    assert got.is_resolved == want.is_resolved


def test_parse_manifest_matches_reference(tmp_path):
    manifest = tmp_path / "cases.manifest"
    manifest.write_text(
        "# a comment\n\n%s\nrel.lh juncs=rel.juncs\nsc:a.lh,b.lh edges=1:2\n" % EGFR6
    )
    assert tcli.parse_manifest(str(manifest)) == jcli.parse_manifest(str(manifest))
    bad = tmp_path / "bad.manifest"
    bad.write_text("x.lh depth\n")
    with pytest.raises(ValueError, match=":1:"):
        tcli.parse_manifest(str(bad))


def test_parser_is_the_reference_parser_plus_device():
    def options(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices) for a in parser._actions}

    got, want = options(tcli.build_parser()), options(jcli.build_parser())
    assert got.pop("device") == (("--device",), "cuda", None)
    assert got == want
    for v in ("1", "true", "YES", "on", "false", "0", ""):
        assert tcli._boolish(v) == jcli._boolish(v)
