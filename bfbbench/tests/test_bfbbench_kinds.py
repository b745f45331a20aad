"""Generator kinds as files (`kinds/<kind>.py`).

Pinned: for each configuration's recipe and the traffic's cases 0-7 at
their places 0-7, the kind writes the LH bytes, and gives the program,
its LP bound (equal in float64) and the fused arm, that the harness
gave when it still knew its two kinds by name (`kinds_pinned.json`,
recorded from that harness's `_write` and `reference.case_program`).
The contract: every configuration names a kind with a file that gives
`write` and `case_program`; a missing kind, or one that lacks a
function, names the file; and a third kind, a copy of `sc` under
another name, runs through `make_cases` and `judge` with no other edit.
"""

import dataclasses
import hashlib
import json
import os
import shutil

import numpy as np
import pytest

from bfbbench import reference, run

HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(HERE, "kinds_pinned.json")) as f:
    PINNED = json.load(f)


def sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def program_digest(prog: reference.Program) -> str:
    """Every array of the reference's program, in float64 and int64."""
    h = hashlib.sha256()
    h.update(np.array([prog.K, prog.n, prog.bias], dtype=np.int64).tobytes())
    for m in (prog.residual, prog.hard):
        for a in (m.indptr, m.indices):
            h.update(np.asarray(a, dtype=np.int64).tobytes())
        h.update(np.asarray(m.data, dtype=np.float64).tobytes())
    for a in (prog.target, prog.x_ub, prog.hard_lo, prog.hard_hi):
        h.update(np.asarray(a, dtype=np.float64).tobytes())
    return h.hexdigest()


def config_recipe(name):
    bench = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
    (entry,) = [c for c in bench["configs"] if c["name"] == name]
    return run.load_json(os.path.join(run.ROOT, entry["file"]))["generator"]


@pytest.mark.parametrize(
    "config,case", [(name, row["case"]) for name, rows in sorted(PINNED.items()) for row in rows]
)
def test_kind_writes_and_reads_as_pinned(tmp_path, config, case):
    (want,) = [row for row in PINNED[config] if row["case"] == case]
    recipe = config_recipe(config)
    kind = run.load_kind(recipe["kind"])
    names = kind.write(recipe, case, case, str(tmp_path / ("c%d" % case)))
    got, texts = [], []
    for fn in names:
        with open(fn, "rb") as f:
            data = f.read()
        got.append([os.path.relpath(fn, str(tmp_path)), sha(data)])
        texts.append(data.decode())
    assert got == want["lh"]
    prog, reading = kind.case_program(texts)
    assert program_digest(prog) == want["program"]
    assert prog.lp_bound() == want["lp_bound"]
    assert (reading is None) == ("fused" not in want)
    if reading is not None:
        fused, _ = reference.fuse_c1(texts[0])
        assert sha(fused.encode()) == want["fused"]
        assert [[s, f, rev] for s, (f, rev) in sorted(reading.fused_of.items())] == want["fused_of"]
        assert list(reading.ends) == want["ends"]


def test_every_config_names_a_kind_with_both_functions():
    bench = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
    for entry in bench["configs"]:
        name = run.load_json(os.path.join(run.ROOT, entry["file"]))["generator"]["kind"]
        assert os.path.isfile(os.path.join(run.HERE, "kinds", name + ".py")), name
        kind = run.load_kind(name)
        assert callable(kind.write) and callable(kind.case_program), name


def test_a_missing_kind_names_its_file():
    with pytest.raises(ValueError, match=r"kinds/no_such_kind\.py"):
        run.load_kind("no_such_kind")


def test_a_kind_without_a_reading_is_refused(tmp_path, monkeypatch):
    (tmp_path / "half.py").write_text("def write(recipe, case_seed, index, prefix):\n    return []\n")
    monkeypatch.setattr(run, "KINDS", str(tmp_path))
    with pytest.raises(ValueError, match=r"half\.py gives no case_program"):
        run.load_kind("half")


def test_a_third_kind_needs_no_other_edit(tmp_path, monkeypatch):
    """A copy of `sc` as `sc_copy`, the only kind in its directory, drives
    a whole run of a small `sc_k3_single` on the CPU: the cases it
    writes are made (`make_cases`) and judged (`judge`) as its own."""
    pytest.importorskip("ambigram_tpu_torch.engine.sc")
    kinds = tmp_path / "kinds"
    kinds.mkdir()
    shutil.copy(os.path.join(run.HERE, "kinds", "sc.py"), str(kinds / "sc_copy.py"))
    monkeypatch.setattr(run, "KINDS", str(kinds))
    _, cell = run.load_cell("sc_k3_single")
    recipe = dict(cell.config["generator"], kind="sc_copy", n_segments=8)
    cell = dataclasses.replace(cell, config=dict(cell.config, generator=recipe))
    res = run.run_cell("sc_k3_single", 2**31 + 2424, 0.0, False, device="cpu", cell=cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 8 and res["failed"] == 0
    with pytest.raises(ValueError, match=r"kinds/sc\.py"):
        run.cell_kind(dataclasses.replace(cell, config=dict(cell.config, generator=dict(recipe, kind="sc"))))
