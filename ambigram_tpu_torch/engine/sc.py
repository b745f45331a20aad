"""Single-cell mode: joint BFB reconstruction over multiple subclones.

Parity targets:
- main(), op "sc_bfb"  (localhap.cpp:390-679)
- BFB_ILP_SC           (src/LocalGenomicMap.cpp:4754-5093)

All subclone graphs share one integer program: each graph gets its own
copy of the per-chromosome constraint set (variable block k covers
graph k), and for every evolution edge (a, b) a coupling term
|x_t^a - x_t^b| joins the objective — which in the epsilon-eliminated
form is just an extra residual row (x_t^a - x_t^b with target 0).
Solutions therefore favor subclones sharing patterns/loops.

Port of ambigram_tpu/engine/sc.py; every function keeps the original's
meaning line for line. Where the port differs:

- one builder and one replay: `build_sc_sample` parses a sample and
  builds its block programs, `replay_sc_sample` replays its clones'
  paths from their solutions, and both entries go over the two
  (build, solve, replay); `extract_sc_programs` is a view of the
  builder. So the batch entry applies every clone's indel bias
  (`get_indel_bias`), as `run_sc_bfb` and the reference's sc_bfb op do,
  where JAX's `extract_sc_programs` does not, and it replays through
  `replay_sc_sample`, not through `run_sc_bfb`;
- `run_sc_bfb` and `run_sc_bfb_many` take a torch `device` (default
  `cuda`; a CUDA device without a card raises); `run_sc_bfb_many` also
  takes JAX's `mesh` (None: the one device `device`);
- `run_sc_bfb` solves each block program with the port's
  `pipeline._solve(sc_prog, solver, device)` (through
  `pipeline.solve_each`), timed under the `solve` phase; the builder
  times its parsing (the clones' genomes, the evolution edges, the
  props) under the `parse` phase and each chromosome's program build
  under `program_build`, the replay each clone's under `replay`, as the
  port's `run_bfb` times its own;
- `run_sc_bfb_many` solves all block programs with one call of the
  port's `solve_programs_batch(flat, index, solver=solver,
  device=device, mesh=mesh)`, which case-stacks same-interval block
  programs into one search;
- `build_sc_program` attaches the block program's G as a CSR, made
  from the clones' own (engine/ilp.py `g_csr`).
"""

from __future__ import annotations

import io as _io
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ambigram_tpu_torch.engine import pipeline
from ambigram_tpu_torch.engine.dag import construct_dag
from ambigram_tpu_torch.engine.enumerate import sorted_key_order
from ambigram_tpu_torch.engine.ilp import BfbProgram, attach_g_csr, build_bfb_program, g_csr
from ambigram_tpu_torch.engine.indel import get_indel_bias, indel_bfb
from ambigram_tpu_torch.engine.junccn import get_junc_cn
from ambigram_tpu_torch.engine.path import format_bfb, replay_bfb
from ambigram_tpu_torch.engine.props import parse_bfb_props
from ambigram_tpu_torch.model.genome import Genome, VertexPath
from ambigram_tpu_torch.utils.profiling import GLOBAL


def build_sc_program(
    progs: List[BfbProgram],
    evolution: List[List[int]],
) -> BfbProgram:
    """Combine per-graph programs into one block program with coupling
    terms |x_t^a - x_t^b| along evolution edges (LGM.cpp:5033-5071).

    Memory discipline (the block program is where variables multiply by
    K, so every dtype choice here scales by K^2 in the dense blocks):
    - G stays int8 block-diagonal — the per-clone G is already int8
      (engine/ilp.py) and a float lift would be gigabytes at K=4/S=64;
      its CSR (`g_csr`) is the clones' CSRs, block-diagonal alike;
    - coupling terms are stored as [P, 2] index PAIRS on the program
      (BfbProgram.coupling), not dense rows: each is a 2-nonzero row,
      and |edges| * 2T dense f64 rows would dwarf everything else.
      The scoring path materializes them as int8 rows on the padded
      tensors; host solvers via `residual_system` only when invoked.
    """
    from scipy.sparse import block_diag as sparse_block_diag

    K = len(progs)
    p0 = progs[0]
    T2 = p0.num_vars  # 2T, identical across graphs (same interval)
    V = T2 * K

    def block_diag(mats: List[np.ndarray], dtype) -> np.ndarray:
        rows = sum(m.shape[0] for m in mats)
        out = np.zeros((rows, V), dtype=dtype)
        r = 0
        for k, m in enumerate(mats):
            out[r : r + m.shape[0], k * T2 : (k + 1) * T2] = m
            r += m.shape[0]
        return out

    A_seg = block_diag([p.A_seg for p in progs], np.float64)
    c_seg = np.concatenate([p.c_seg for p in progs])
    A_fbi = block_diag([p.A_fbi for p in progs], np.float64)
    c_fbi = np.concatenate([p.c_fbi for p in progs])
    # coupling pairs, vectorized: every evolution edge (a, b) couples
    # all T2 variables of clone a to clone b's
    pair_blocks = []
    t_idx = np.arange(T2, dtype=np.int32)
    for a in range(len(evolution)):
        for b in evolution[a]:
            pair_blocks.append(
                np.stack([a * T2 + t_idx, b * T2 + t_idx], axis=1)
            )
    coupling = (
        np.concatenate(pair_blocks, axis=0) if pair_blocks else None
    )
    G = block_diag([p.G for p in progs], np.int8)
    g_lb = np.concatenate([p.g_lb for p in progs])
    g_ub = np.concatenate([p.g_ub for p in progs])
    x_ub = np.concatenate([p.x_ub for p in progs])
    prog = BfbProgram(
        start=p0.start,
        end=p0.end,
        pairs=p0.pairs,
        A_seg=A_seg,
        c_seg=c_seg,
        A_fbi=A_fbi,
        c_fbi=c_fbi,
        G=G,
        g_lb=g_lb,
        g_ub=g_ub,
        x_ub=x_ub,
        bias=0,
        coupling=coupling,
    )
    return attach_g_csr(prog, sparse_block_diag([g_csr(p) for p in progs], format="csr", dtype=np.int8))


def parse_evolution_edges(edges: str, names: List[str]) -> List[List[int]]:
    """Evolution DAG from the reference's `edges` grammar: comma-
    separated `parent:child` pairs whose tokens are the --in_lh file
    names (localhap.cpp:417-430 — the option is commented out there and
    hardcoded to "", but the parser exists; this port makes it
    reachable). Bare 1-based clone indices are accepted as an extension
    ("1:2,1:3"), matching the reference's own usage example. Empty
    string -> the reference's all-pairs default (localhap.cpp:430-434).
    """
    K = len(names)
    evolution: List[List[int]] = [[] for _ in range(K)]
    if not edges:
        for i in range(K):
            evolution[i] = list(range(i + 1, K))
        return evolution
    idx = {name: k for k, name in enumerate(names)}

    def resolve(tok: str) -> int:
        tok = tok.strip()
        if tok in idx:
            return idx[tok]
        if tok.isdigit() and 1 <= int(tok) <= K:
            return int(tok) - 1
        raise ValueError(
            "unknown clone %r in evolution edges (clones: %s)" % (tok, names)
        )

    seen = set()
    for pair in edges.split(","):
        if not pair.strip():
            continue
        if ":" not in pair:
            raise ValueError("evolution edge %r is not parent:child" % pair)
        # clone names may themselves contain colons (paths like
        # /data/run:3/c1.lh), so try every split point; if more than
        # one split resolves to a DIFFERENT edge the input is genuinely
        # ambiguous — raise instead of silently picking one
        candidates = set()
        for k in range(len(pair)):
            if pair[k] != ":":
                continue
            try:
                candidates.add((resolve(pair[:k]), resolve(pair[k + 1 :])))
            except ValueError:
                continue
        if len(candidates) > 1:
            raise ValueError(
                "ambiguous evolution edge %r: resolves to %s — rename the "
                "clone files or use 1-based indices"
                % (pair, sorted(candidates))
            )
        parsed = candidates.pop() if candidates else None
        if parsed is None:
            raise ValueError(
                "cannot resolve evolution edge %r (clones: %s)" % (pair, names)
            )
        a_i, b_i = parsed
        if a_i == b_i:
            raise ValueError("evolution edge %r couples a clone to itself" % pair)
        # coupling rows are |x_a - x_b| — direction-free — so a repeated
        # or reversed pair would silently double the coupling weight
        if (min(a_i, b_i), max(a_i, b_i)) in seen:
            continue
        seen.add((min(a_i, b_i), max(a_i, b_i)))
        evolution[a_i].append(b_i)
    return evolution


@dataclass
class ScBfbResult:
    paths: List[List[VertexPath]] = field(default_factory=list)
    path_strings: List[List[str]] = field(default_factory=list)
    genomes: List[Genome] = field(default_factory=list)
    seconds: float = 0.0


def build_sc_sample(lh_paths: str, edges: str = "") -> pipeline.CaseBuild:
    """Everything `run_sc_bfb` does before its solve: parse the clones
    named in `lh_paths` (comma list), the evolution DAG of `edges` and
    the props, then chromosome by chromosome (g0's intervals) apply
    every clone's indel bias and build the block program of each
    non-trivial one."""
    begin = time.perf_counter()
    names = [s for s in lh_paths.split(",") if s]
    genomes: List[Genome] = []
    with GLOBAL.phase("parse"):
        for name in names:
            g = Genome.from_lh(name)
            g.calculate_hap_depth()
            g.calculate_copy_num()
            genomes.append(g)
        # evolution DAG: user-supplied edges, else all-pairs default
        evolution = parse_evolution_edges(edges, names)

        g0 = genomes[0]
        props = parse_bfb_props(lh_paths)  # comma-joined name: degrades to empty

        sources = list(g0.sources)
        sinks = list(g0.sinks)
        for i, (src, snk) in enumerate(zip(sources, sinks)):
            for seg_id in range(src.id, snk.id + 1):
                g0.segment_by_id(seg_id).partition = i

    chromosomes: List[pipeline.ChromosomeBuild] = []
    for n in range(len(sources)):
        start_id = sources[n].id
        end_id = sinks[n].id
        with GLOBAL.phase("program_build"):
            _, junc_cn0 = get_junc_cn(g0, start_id, end_id)
            for g in genomes:
                get_indel_bias(g, start_id, end_id)
            if abs(float(junc_cn0[: end_id + 1, 1].sum())) < 1e-6:
                chromosomes.append(pipeline.ChromosomeBuild(start_id, end_id, [], None))
                continue
            inversions, progs = [], []
            for g in genomes:
                inversions_k, junc_cn = get_junc_cn(g, start_id, end_id)
                seg_cn = np.array(
                    [g.segment_by_id(i).weight.copy_num for i in range(start_id, end_id + 1)]
                )
                max_cn = sum(
                    g.segment_by_id(i).weight.copy_num for i in range(start_id, end_id + 1)
                )
                inversions.append(inversions_k)
                progs.append(
                    build_bfb_program(
                        start_id,
                        end_id,
                        seg_cn,
                        junc_cn[start_id : end_id + 1, 1],
                        max_cn,
                        0,
                    )
                )
            chromosomes.append(
                pipeline.ChromosomeBuild(start_id, end_id, inversions, build_sc_program(progs, evolution))
            )
    return pipeline.CaseBuild(genomes, props, chromosomes, seconds=time.perf_counter() - begin)


def extract_sc_programs(
    lh_paths: str, edges: str = ""
) -> List[Optional[BfbProgram]]:
    """Per-chromosome single-cell block programs for one sample (None
    where the chromosome is trivial): `build_sc_sample`'s."""
    return build_sc_sample(lh_paths, edges).programs


def run_sc_bfb_many(
    samples: List[dict],
    juncs_info: bool = False,
    is_reversed: bool = False,
    solver: str = "auto",
    device="cuda",
    out=None,
    result_store: Optional[str] = None,
    ledger_dir: Optional[str] = None,
    mesh=None,
) -> List[ScBfbResult]:
    """Batch single-cell pipeline: each sample is built once
    (`build_sc_sample`), every block program is solved in one call of
    the shared batch solver (the exact prepass, then case-stacked
    searches on `mesh`, by default the one device `device` —
    pipeline.solve_programs_batch), then each sample is replayed
    (`replay_sc_sample`) on a thread pool; its text reaches `out` in
    input order. A sample's `seconds` is its build and replay time.

    `samples`: [{"lh_paths": "a.lh,b.lh", "edges": "..."}, ...].
    This is the batched replacement for looping the reference's
    sc_bfb op over samples (localhap.cpp:390-679 is one process per
    sample); the block programs are the LARGEST programs the engine
    builds (variables multiply by K), so searching same-shape samples
    as one case-stacked group is where case parallelism pays most.

    `result_store` mirrors run_bfb_many's per-sample checkpoint/resume:
    the key hashes every clone file plus the edges string. `juncs_info`
    is accepted to match the CLI and the JAX signature and is ignored,
    as `run_sc_bfb` ignores its own."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from ambigram_tpu_torch.solver.search import resolve_device

    device = resolve_device(device)

    if out is None:
        out = _io.StringIO()
    cached: dict = {}
    store_keys: dict = {}
    if result_store:
        os.makedirs(result_store, exist_ok=True)
        for i, s in enumerate(samples):
            store_keys[i] = _sc_store_key(s)
            fn = os.path.join(result_store, store_keys[i] + ".json")
            if os.path.exists(fn):
                cached[i] = _sc_result_from_store(fn)

    active = [i for i in range(len(samples)) if i not in cached]
    builds = {i: build_sc_sample(samples[i]["lh_paths"], samples[i].get("edges", "")) for i in active}
    flat, index = pipeline.batch_programs({i: sample.programs for i, sample in builds.items()})
    solutions = pipeline.solve_programs_batch(flat, index, solver=solver, device=device, mesh=mesh)

    results: List[Optional[ScBfbResult]] = [None] * len(samples)
    buffers: dict = {}

    def _replay_sample(i: int) -> None:
        begin = time.perf_counter()
        sample = builds[i]
        buf = buffers[i] = _io.StringIO()
        results[i] = replay_sc_sample(
            sample, [solutions.get((i, n)) for n in range(len(sample.chromosomes))], buf, is_reversed
        )
        results[i].seconds = sample.seconds + time.perf_counter() - begin

    with ThreadPoolExecutor(max_workers=min(4, max(1, len(active)))) as pool:
        list(pool.map(_replay_sample, active))
    for i, s in enumerate(samples):
        if i in cached:
            results[i] = cached[i]
            continue
        out.write(buffers[i].getvalue())
        if ledger_dir is not None:
            # appended in input order on the main thread (in-thread
            # appends would interleave rows nondeterministically)
            _append_sc_ledger(results[i], s["lh_paths"], ledger_dir)
        if result_store:
            _sc_result_to_store(
                os.path.join(result_store, store_keys[i] + ".json"), results[i]
            )
    return results


def _sc_store_key(sample: dict) -> str:
    import hashlib
    import os

    h = hashlib.sha1()
    for name in sample["lh_paths"].split(","):
        if name:
            h.update(open(name, "rb").read())
    h.update(sample.get("edges", "").encode())
    first = sample["lh_paths"].split(",")[0]
    return "%s-sc-%s" % (os.path.basename(first), h.hexdigest()[:16])


def _sc_result_to_store(fn: str, res: ScBfbResult) -> None:
    import json
    import os

    tmp = fn + ".tmp"
    with open(tmp, "w") as f:
        json.dump(
            {"path_strings": res.path_strings, "seconds": res.seconds}, f
        )
    os.replace(tmp, fn)


def _sc_result_from_store(fn: str) -> ScBfbResult:
    import json

    payload = json.load(open(fn))
    return ScBfbResult(
        path_strings=payload["path_strings"], seconds=payload["seconds"]
    )


def run_sc_bfb(
    lh_paths: str,
    juncs_path: str = "",
    juncs_info: bool = False,
    is_reversed: bool = False,
    print_all: bool = False,
    solver: str = "auto",
    device="cuda",
    out=None,
    ledger_dir: Optional[str] = None,
    lp_prefix: str = "sample",
    edges: str = "",
    emit_lp: bool = False,
) -> ScBfbResult:
    """Joint BFB reconstruction of the clones named in `lh_paths` (comma
    list) over the evolution DAG of `edges`: `build_sc_sample`, then
    `pipeline._solve` on each non-trivial chromosome's block program
    with the search on `device` (a CUDA device without a card raises),
    then `replay_sc_sample`. `juncs_path` and `juncs_info` are accepted
    to match the CLI and the JAX signature and are ignored, as the
    reference's sc_bfb op reads no long-read junctions."""
    from ambigram_tpu_torch.solver.search import resolve_device

    device = resolve_device(device)
    begin = time.perf_counter()
    if out is None:
        out = _io.StringIO()
    sample = build_sc_sample(lh_paths, edges)
    solutions = pipeline.solve_each(sample.programs, solver, device, emit_lp, lp_prefix)
    result = replay_sc_sample(sample, solutions, out, is_reversed, print_all)
    result.seconds = time.perf_counter() - begin
    if ledger_dir is not None:
        _append_sc_ledger(result, lh_paths, ledger_dir)
    return result


def replay_sc_sample(
    sample: pipeline.CaseBuild,
    solutions: List,
    out,
    is_reversed: bool = False,
    print_all: bool = False,
) -> ScBfbResult:
    """Everything `run_sc_bfb` does after its solve: each clone's path
    replayed from its own slice of its chromosome's solution
    (`solutions[n]`, None where the chromosome is trivial) and written
    to `out`, then each clone's translocation merge. The caller sets
    `seconds`."""
    genomes = sample.genomes
    K = len(genomes)
    result = ScBfbResult(genomes=genomes)
    result.paths = [[] for _ in range(K)]

    for chrom, sol in zip(sample.chromosomes, solutions):
        start_id, end_id, prog = chrom.start, chrom.end, chrom.program
        if prog is None or sol.status not in ("optimal", "heuristic"):
            if prog is not None:
                out.write("ILP is unsolvable.\n")
            for k, g in enumerate(genomes):
                result.paths[k].append([g.segment_by_id(i).pos for i in range(start_id, end_id + 1)])
            continue

        T2 = prog.num_vars // K
        entries = sorted_key_order(prog.pairs)
        for k, g in enumerate(genomes):
            element_k = sol.x[k * T2 : (k + 1) * T2]
            with GLOBAL.phase("replay"):
                adj, node2pat, node2loop = construct_dag(entries, element_k)
                path: VertexPath = replay_bfb(
                    g,
                    adj,
                    node2pat,
                    node2loop,
                    chrom.inversions[k],
                    is_reversed=is_reversed,
                    print_all=print_all,
                    out=out,
                )
            indel_bfb(g, path, start_id, end_id, out=out)
            result.paths[k].append(path)

    # post-BFB translocation merging per graph (localhap.cpp:667-670)
    props = sample.props
    if props.ins_mode == 2 or props.con_mode == 2:
        from ambigram_tpu_torch.engine.trx import translocation_bfb

        for k, g in enumerate(genomes):
            res_path: VertexPath = []
            translocation_bfb(g, result.paths[k], res_path, props.main_chr, out=out)

    result.path_strings = [
        [format_bfb(p) for p in result.paths[k]] for k in range(K)
    ]
    return result


def _append_sc_ledger(result: ScBfbResult, lh_paths: str, ledger_dir: str) -> None:
    """The sc_bfb time.csv row (localhap.cpp:672-678 analog). Shared by
    run_sc_bfb and the batch pipeline's ordered ledger pass."""
    import os

    if not result.genomes:
        return  # store-cached summary: genomes not rehydrated
    genomes = result.genomes
    g0 = genomes[0]
    K = len(genomes)
    with open(os.path.join(ledger_dir, "time.csv"), "a") as f:
        seg_count = len(g0.segments)
        cn_sum = sum(int(s.weight.copy_num) for g in genomes for s in g.segments)
        max_cn = max(
            (int(s.weight.copy_num) for g in genomes for s in g.segments),
            default=0,
        )
        path_len = sum(len(p) for k in range(K) for p in result.paths[k])
        name = lh_paths[: lh_paths.find(".")] if "." in lh_paths else lh_paths
        f.write(
            "%s,%d,%d,%d,%d,%d,%d,%s\n"
            % (
                name,
                seg_count,
                0,
                len(g0.junctions),
                cn_sum,
                path_len,
                max_cn,
                result.seconds,
            )
        )
