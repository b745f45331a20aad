"""The control comes out not correct under each cell's limits: the
program's own `edges` option coupling a chain of clones instead of every
pair (float32 is exact on these integer targets, so a lower precision
separates nothing). On the CPU at a size a test holds, and on the card
at the cell's own size and three seeds."""

import dataclasses

import pytest

from bfbbench import readings, run

CONTROL = {"sc_k3_single": "chain_edges", "sc_k3_cohort": "chain_edges"}
SEEDS = [2**31 + 101, 2**31 + 202, 2**31 + 303]


def fails(line, limits):
    return any(line["numbers"][k] > limits[k] for k in line["numbers"])


@pytest.mark.parametrize("workload", sorted(CONTROL))
def test_control_fails_on_the_cpu(workload):
    pytest.importorskip("ambigram_tpu_torch.engine.pipeline")
    _, cell = run.load_cell(workload)
    recipe = dict(cell.config["generator"], n_segments=8)
    cell = dataclasses.replace(cell, config=dict(cell.config, generator=recipe))
    lines = readings.readings(workload, SEEDS[:1], 0.2, control=CONTROL[workload], device="cpu", cell=cell, out=None)
    assert fails(lines[0], cell.limits), lines[0]["numbers"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(CONTROL))
def test_control_fails_on_the_card(workload):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, cell = run.load_cell(workload)
    lines = readings.readings(workload, SEEDS, 1.0, control=CONTROL[workload], out=None)
    assert all(fails(line, cell.limits) for line in lines), [line["numbers"] for line in lines]
