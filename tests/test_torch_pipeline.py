"""The port's pipeline and CLI against the JAX package's goldens.

The egfr6 golden and the README TRX goldens must come out of the port
byte for byte; the device branch is exercised on the CPU (its plain
scorer) through `--solver device --device cpu` and by lowering the auto
split. A subprocess shows that the port's main path loads no jax.
"""

import io
import os
import subprocess
import sys

import pytest
import torch

from ambigram_tpu.engine.pipeline import run_bfb as reference_run_bfb
from ambigram_tpu_torch import cli
from ambigram_tpu_torch.engine import pipeline
from ambigram_tpu_torch.utils.profiling import GLOBAL
from test_e2e_bfb import GOLDEN_EGFR6
from test_readme_trx_goldens import C1_GOLDEN_STAGE2, C2_GOLDEN, I1_GOLDEN, I2_GOLDEN

# the suite runs in several worker processes at once; torch's default of
# one intra-op thread per core would oversubscribe the CPU for all of them
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
EGFR6 = os.path.join(DATA, "egfr6.lh")


@pytest.fixture
def small_search(monkeypatch):
    monkeypatch.setenv("AMBIGRAM_SEARCH_POP", "8")
    monkeypatch.setenv("AMBIGRAM_SEARCH_ROUNDS", "2")
    monkeypatch.setenv("AMBIGRAM_SEARCH_SWEEPS", "64")


@pytest.mark.parametrize("solver", ["device", "auto", "exact"])
def test_cli_egfr6_golden(solver, small_search, capsys):
    GLOBAL.reset()
    rc = cli.main(["--op", "bfb", "--in_lh", EGFR6, "--solver", solver, "--device", "cpu", "--no-ledgers"])
    assert rc == 0
    assert capsys.readouterr().out.splitlines()[0] == GOLDEN_EGFR6
    # auto settles this 2x21-variable program on the host; device searches
    assert GLOBAL.counters.get("solve.device_calls", 0) == (1 if solver == "device" else 0)


def test_auto_above_the_split_takes_the_device_branch(small_search, monkeypatch):
    """With the split lowered below egfr6's size, auto runs the port's
    search and the shared auto tail, and still lands on the golden."""
    monkeypatch.setattr(pipeline, "AUTO_EXACT_FIRST_MAX_VARS", 8)
    GLOBAL.reset()
    res = pipeline.run_bfb(EGFR6, solver="auto", device="cpu")
    assert res.path_strings[0] == GOLDEN_EGFR6
    assert GLOBAL.counters["solve.device_calls"] == 1
    assert "solve.exact" not in GLOBAL.phases


@pytest.mark.parametrize(
    "fixture, field, golden",
    [
        ("readme_i1.lh", "path", I1_GOLDEN),
        ("readme_i2.lh", "merged", I2_GOLDEN),
        ("readme_c1.lh", "path", C1_GOLDEN_STAGE2),
        ("readme_c2.lh", "merged", C2_GOLDEN),
    ],
)
def test_readme_trx_goldens_through_port(fixture, field, golden, tmp_path, monkeypatch, small_search):
    monkeypatch.chdir(tmp_path)  # the TRX modes write ./new.lh
    res = pipeline.run_bfb(os.path.join(DATA, fixture), solver="device", device="cpu")
    got = res.path_strings[0] if field == "path" else res.merged_path_string
    assert got == golden


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slice_matches_reference_on_simulated_cases(seed, tmp_path, small_search):
    """The whole slice (port run_bfb, device search on the CPU) against
    the JAX package's run_bfb on the same simulated case."""
    from ambigram_tpu.scripts.simulate import simulate_bfb_case, write_case

    case = simulate_bfb_case(seed=seed, n_segments=8, mode="nested")
    lh = write_case(case, str(tmp_path / "sim"))["lh"]
    out_port, out_ref = io.StringIO(), io.StringIO()
    GLOBAL.reset()
    got = pipeline.run_bfb(lh, solver="device", device="cpu", out=out_port)
    assert GLOBAL.counters["solve.device_calls"] >= 1
    want = reference_run_bfb(lh, solver="exact", out=out_ref)
    assert got.ilp_error == pytest.approx(want.ilp_error, abs=1e-9)
    assert got.path_strings == want.path_strings
    assert out_port.getvalue() == out_ref.getvalue()


@pytest.mark.parametrize(
    "argv, message",
    [
        (["--op", "sc_bfb", "--manifest", "--in_lh", "SC_MANIFEST"], "use --op bfb"),
        (["--op", "check", "--in_lh", EGFR6, "--edges", "1:2"], "--edges is only meaningful"),
        (["--op", "bfb", "--manifest", "--in_lh", "SC_MANIFEST", "--edges", "1:2"], "not supported in manifest mode"),
    ],
    ids=["sc_bfb", "check", "manifest"],
)
def test_cli_unported_ops_exit_nonzero(argv, message, capsys, tmp_path):
    """The ops that earlier slices refused as not yet ported (sc_bfb,
    check, sc: manifest lines) now run (tests/test_torch_sc.py,
    tests/test_torch_legacy.py); they exit non-zero only on the JAX
    CLI's input errors, with its messages."""
    manifest = tmp_path / "sc.manifest"
    manifest.write_text("sc:%s,%s edges=1:2\n" % (EGFR6, EGFR6))
    argv = [str(manifest) if a == "SC_MANIFEST" else a for a in argv]
    assert cli.main(argv + ["--device", "cpu"]) != 0
    err = capsys.readouterr().err
    assert message in err and "not yet ported" not in err


def test_run_bfb_on_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.run_bfb(EGFR6, solver="auto", device="cuda")


# the port keeps its own copy of everything it needs: it imports neither
# jax nor any module of the JAX package, nor the repo's __graft_entry__
FORBIDDEN = ("jax", "ambigram_tpu", "__graft_entry__")


def test_port_main_path_loads_no_jax(tmp_path):
    code = (
        "import sys\n"
        "from ambigram_tpu_torch import cli\n"
        "res = cli.run(['--op', 'bfb', '--in_lh', %r, '--solver', 'device', '--device', 'cpu'])\n"
        "assert res.path_strings[0] == %r, res.path_strings\n"
        "print('JAX_LOADED=%%s' %% ('jax' in sys.modules))\n"
        "print('LOADED=%%s' %% ','.join(sorted(m for m in sys.modules if m.split('.')[0] in %r)))\n"
        % (EGFR6, GOLDEN_EGFR6, FORBIDDEN)
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update(
        AMBIGRAM_SEARCH_POP="8", AMBIGRAM_SEARCH_ROUNDS="2", AMBIGRAM_SEARCH_SWEEPS="64", OMP_NUM_THREADS="1"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_LOADED=False" in proc.stdout
    assert "LOADED=\n" in proc.stdout, proc.stdout[-2000:]
    assert proc.stdout.splitlines()[0] == GOLDEN_EGFR6


@pytest.mark.parametrize(
    "argv, expect",
    [
        (["--op", "sc_bfb", "--in_lh", "%s,%s" % (EGFR6, EGFR6), "--solver", "device", "--device", "cpu"],
         "res.path_strings[0][0] == %r" % GOLDEN_EGFR6),
        (["--op", "check", "--in_lh", os.path.join(DATA, "legacy75.lh"), "--out_lh", "balanced.lh"],
         "res.status == 'optimal'"),
    ],
    ids=["sc_bfb", "check"],
)
def test_port_other_ops_load_no_jax(argv, expect, tmp_path):
    """`--op sc_bfb` (the device route on the CPU) and `--op check` load
    no module of jax, the JAX package or __graft_entry__ either."""
    code = (
        "import sys\n"
        "from ambigram_tpu_torch import cli\n"
        "res = cli.run(%r)\n"
        "assert %s, res\n"
        "print('LOADED=%%s' %% ','.join(sorted(m for m in sys.modules if m.split('.')[0] in %r)))\n"
        % (argv + ["--no-ledgers"], expect, FORBIDDEN)
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update(
        AMBIGRAM_SEARCH_POP="8", AMBIGRAM_SEARCH_ROUNDS="2", AMBIGRAM_SEARCH_SWEEPS="64", OMP_NUM_THREADS="1"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED=\n" in proc.stdout, proc.stdout[-2000:]


def test_port_golden_suite_and_scripts_load_no_jax(tmp_path):
    """`python -m ambigram_tpu_torch.scripts.golden_suite --solver exact
    --device cpu`, after importing every host-only script the port
    copied, loads no module of jax, the JAX package or __graft_entry__."""
    code = (
        "import sys\n"
        "from ambigram_tpu_torch.scripts import barcode, juncdb_tool, legacy_pipeline, prep, support_profile, virus_sim\n"
        "from ambigram_tpu_torch.scripts import golden_suite\n"
        "assert golden_suite.main(['--solver', 'exact', '--device', 'cpu']) == 0\n"
        "print('LOADED=%%s' %% ','.join(sorted(m for m in sys.modules if m.split('.')[0] in %r)))\n"
        % (FORBIDDEN,)
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert '"ok": true' in proc.stdout
    assert "LOADED=\n" in proc.stdout, proc.stdout[-2000:]


@pytest.mark.parametrize(
    "code, expect",
    [
        ("from ambigram_tpu_torch.parallel.dryrun import main\nassert main(['4', '--device', 'cpu']) == 0\n",
         "dryrun_multichip ok: mesh=(2, 2)"),
        ("from ambigram_tpu_torch import bench\nbench.proxy_case_dir('.')\n"
         "from ambigram_tpu_torch.scripts.scaling_proxy import main\n"
         "assert main(['--cases', '.', '--mesh', '2', '--device', 'cpu']) == 0\n"
         "from ambigram_tpu_torch.scripts import bench_docs\n"
         "from ambigram_tpu_torch.parallel import distributed\n",
         '"mesh": 2'),
    ],
    ids=["dryrun", "scaling_proxy_bench_docs_distributed"],
)
def test_port_multi_device_entry_points_load_no_jax(code, expect, tmp_path, monkeypatch):
    """The dry run (n=4 on CPU labels: the sharded step, then run_bfb_many
    under the mesh with a V > 2048 case), the scaling proxy's command
    line (what the bench's proxy leg runs in each subprocess), bench_docs
    and the distributed module load no module of jax, the JAX package or
    __graft_entry__."""
    code = "import sys\n" + code + (
        "print('LOADED=%%s' %% ','.join(sorted(m for m in sys.modules if m.split('.')[0] in %r)))\n" % (FORBIDDEN,)
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update(AMBIGRAM_SHARD_POP="4", AMBIGRAM_SHARD_STEPS="4", AMBIGRAM_SHARD_ROUNDS="1", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert expect in proc.stdout
    assert "LOADED=\n" in proc.stdout, proc.stdout[-2000:]


def port_sources():
    """Every Python source of the port, with chip_smoke.py and the
    card-only test file, which run where JAX is not installed."""
    paths = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "tests", "test_torch_cuda.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "ambigram_tpu_torch")):
        paths += [os.path.join(dirpath, fn) for fn in sorted(files) if fn.endswith(".py")]
    return paths


def test_port_sources_import_nothing_that_loads_jax():
    """Every import statement of the port, lazy ones included."""
    import ast

    offenders = []
    for path in port_sources():
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    offenders.append("%s:%d has a relative import" % (path, node.lineno))
                    continue
                names = [node.module]
            else:
                continue
            for name in names:
                if any(name == m or name.startswith(m + ".") for m in FORBIDDEN):
                    offenders.append("%s:%d imports %s" % (path, node.lineno, name))
    assert len(port_sources()) > 20
    assert not offenders, offenders


def test_bench_workload_loads_no_module_of_the_jax_package(tmp_path):
    """The bench builds its workload from the port's own copy of the
    demo program."""
    code = (
        "import sys\n"
        "from ambigram_tpu_torch import bench\n"
        "prog, st, X = bench.build_workload(batch=64)\n"
        "assert X.shape == (64, 1152) and tuple(st.H8.shape) == (3840, 1152)\n"
        "print('LOADED=%%s' %% ','.join(sorted(m for m in sys.modules if m.split('.')[0] in %r)))\n"
        % (FORBIDDEN,)
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED=\n" in proc.stdout, proc.stdout[-2000:]
