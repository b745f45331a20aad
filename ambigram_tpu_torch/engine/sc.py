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

- `run_sc_bfb` and `run_sc_bfb_many` take a torch `device` (default
  `cuda`; a CUDA device without a card raises); `run_sc_bfb_many` also
  takes JAX's `mesh` (None: the one device `device`);
- `run_sc_bfb` solves each block program with the port's
  `pipeline._solve(sc_prog, solver, device)`, timed under the `solve`
  phase, and each clone's replay under the `replay` phase, as the
  port's `run_bfb` times its own; its parsing (the clones' genomes, the
  evolution edges, the props) runs under the `parse` phase and each
  chromosome's program build under `program_build`, as do those of
  `extract_sc_programs`;
- `run_sc_bfb_many` solves all block programs with the port's
  `solve_programs_batch(flat, index, solver=solver, device=device,
  mesh=mesh)`, which case-stacks same-interval block programs into one search;
- `build_sc_program` attaches the block program's G as a CSR, made
  from the clones' own (engine/ilp.py `g_csr`).
"""

from __future__ import annotations

import io as _io
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

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


def extract_sc_programs(
    lh_paths: str, edges: str = ""
) -> List[Optional[BfbProgram]]:
    """Per-chromosome single-cell block programs for one sample (None
    where the chromosome is trivial). Mirrors run_sc_bfb's preamble —
    the batch pipeline (`run_sc_bfb_many`) solves these through
    pipeline.solve_programs_batch and replays with `presolved`."""
    names = [s for s in lh_paths.split(",") if s]
    genomes: List[Genome] = []
    with GLOBAL.phase("parse"):
        for name in names:
            g = Genome.from_lh(name)
            g.calculate_hap_depth()
            g.calculate_copy_num()
            genomes.append(g)
        evolution = parse_evolution_edges(edges, names)
    g0 = genomes[0]
    out: List[Optional[BfbProgram]] = []
    for n in range(len(g0.sources)):
        start_id = g0.sources[n].id
        end_id = g0.sinks[n].id
        with GLOBAL.phase("program_build"):
            _, junc_cn0 = get_junc_cn(g0, start_id, end_id)
            if abs(float(junc_cn0[: end_id + 1, 1].sum())) < 1e-6:
                out.append(None)
                continue
            progs = []
            for g in genomes:
                _, junc_cn = get_junc_cn(g, start_id, end_id)
                seg_cn = np.array(
                    [
                        g.segment_by_id(i).weight.copy_num
                        for i in range(start_id, end_id + 1)
                    ]
                )
                max_cn = sum(
                    g.segment_by_id(i).weight.copy_num
                    for i in range(start_id, end_id + 1)
                )
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
            out.append(build_sc_program(progs, evolution))
    return out


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
    """Batch single-cell pipeline: every sample's block programs are
    solved through the shared batch solver (the exact prepass, then
    case-stacked searches on `mesh`, by default the one device `device`
    — pipeline.solve_programs_batch),
    then each sample's host-side replay completes independently.

    `samples`: [{"lh_paths": "a.lh,b.lh", "edges": "..."}, ...].
    This is the batched replacement for looping the reference's
    sc_bfb op over samples (localhap.cpp:390-679 is one process per
    sample); the block programs are the LARGEST programs the engine
    builds (variables multiply by K), so searching same-shape samples
    as one case-stacked group is where case parallelism pays most.

    `result_store` mirrors run_bfb_many's per-sample checkpoint/resume:
    the key hashes every clone file plus the edges string."""
    import os

    from ambigram_tpu_torch.engine.pipeline import solve_programs_batch
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
    per_sample_progs = {
        i: extract_sc_programs(
            samples[i]["lh_paths"], samples[i].get("edges", "")
        )
        for i in active
    }
    flat: List[BfbProgram] = []
    index: List[tuple] = []
    for i in active:
        for n, prog in enumerate(per_sample_progs[i]):
            if prog is not None:
                flat.append(prog)
                index.append((i, n))
    solutions = solve_programs_batch(flat, index, solver=solver, device=device, mesh=mesh)

    # per-sample replay on a thread pool with order-preserving output
    # buffers (same pattern as pipeline.run_bfb_many — the K per-clone
    # replays of a sample are host work that releases the GIL)
    from concurrent.futures import ThreadPoolExecutor

    results: List[Optional[ScBfbResult]] = [None] * len(samples)
    buffers: dict = {}

    def _replay_sample(i: int) -> None:
        presolved = [
            solutions.get((i, n)) for n in range(len(per_sample_progs[i]))
        ]
        buf = buffers[i] = _io.StringIO()
        results[i] = run_sc_bfb(
            samples[i]["lh_paths"],
            juncs_info=juncs_info,
            is_reversed=is_reversed,
            solver="exact",
            device=device,
            out=buf,
            edges=samples[i].get("edges", ""),
            presolved=presolved,
        )

    with ThreadPoolExecutor(max_workers=min(4, max(1, len(active)))) as pool:
        list(pool.map(_replay_sample, active))
    for i, s in enumerate(samples):
        if i in cached:
            results[i] = cached[i]
            continue
        if out is not None and i in buffers:
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
    presolved: Optional[List] = None,
) -> ScBfbResult:
    """Joint BFB reconstruction of the clones named in `lh_paths` (comma
    list) over the evolution DAG of `edges`. Each non-trivial
    chromosome's block program is solved by `_solve` with the search on
    `device` (a CUDA device without a card raises), unless `presolved`
    holds its solution; then each clone's path is replayed from its own
    slice of the solution."""
    from ambigram_tpu_torch.solver.search import resolve_device

    device = resolve_device(device)
    begin = time.perf_counter()
    if out is None:
        out = _io.StringIO()
    names = [s for s in lh_paths.split(",") if s]
    genomes: List[Genome] = []
    with GLOBAL.phase("parse"):
        for name in names:
            g = Genome.from_lh(name)
            g.calculate_hap_depth()
            g.calculate_copy_num()
            genomes.append(g)
        K = len(genomes)
        # evolution DAG: user-supplied edges, else all-pairs default
        evolution = parse_evolution_edges(edges, names)

        g0 = genomes[0]
        props = parse_bfb_props(lh_paths)  # comma-joined name: degrades to empty

        sources = list(g0.sources)
        sinks = list(g0.sinks)
        for i, (src, snk) in enumerate(zip(sources, sinks)):
            for seg_id in range(src.id, snk.id + 1):
                g0.segment_by_id(seg_id).partition = i

    result = ScBfbResult(genomes=genomes)
    result.paths = [[] for _ in range(K)]

    for n in range(len(sources)):
        start_id = sources[n].id
        end_id = sinks[n].id
        with GLOBAL.phase("program_build"):
            inversions0, junc_cn0 = get_junc_cn(g0, start_id, end_id)
            for g in genomes:
                get_indel_bias(g, start_id, end_id)

            inversion_cn_sum = float(junc_cn0[: end_id + 1, 1].sum())
            trivial = abs(inversion_cn_sum) < 1e-6
            if not trivial:
                progs = []
                for g in genomes:
                    _, junc_cn = get_junc_cn(g, start_id, end_id)
                    seg_cn = np.array(
                        [g.segment_by_id(i).weight.copy_num for i in range(start_id, end_id + 1)]
                    )
                    max_cn = sum(
                        g.segment_by_id(i).weight.copy_num for i in range(start_id, end_id + 1)
                    )
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
                sc_prog = build_sc_program(progs, evolution)
        if trivial:
            for k, g in enumerate(genomes):
                path = [g.segment_by_id(i).pos for i in range(start_id, end_id + 1)]
                result.paths[k].append(path)
            continue

        if emit_lp:
            # mirror of BFB_ILP_SC's artifact (LGM.cpp:5091-5092)
            from ambigram_tpu_torch.io.program_io import write_lp, write_mps

            write_lp(sc_prog, lp_prefix + ".lp")
            write_mps(sc_prog, lp_prefix + ".mps")
        from ambigram_tpu_torch.engine.pipeline import _solve

        if presolved is not None and n < len(presolved) and presolved[n] is not None:
            sol = presolved[n]
        else:
            with GLOBAL.phase("solve"):
                sol = _solve(sc_prog, solver, device)
        if sol.status not in ("optimal", "heuristic"):
            out.write("ILP is unsolvable.\n")
            for k, g in enumerate(genomes):
                path = [g.segment_by_id(i).pos for i in range(start_id, end_id + 1)]
                result.paths[k].append(path)
            continue

        T2 = progs[0].num_vars
        for k, g in enumerate(genomes):
            element_k = sol.x[k * T2 : (k + 1) * T2]
            entries = sorted_key_order(progs[0].pairs)
            with GLOBAL.phase("replay"):
                adj, node2pat, node2loop = construct_dag(entries, element_k)
                inversions_k, _ = get_junc_cn(g, start_id, end_id)
                path: VertexPath = replay_bfb(
                    g,
                    adj,
                    node2pat,
                    node2loop,
                    inversions_k,
                    is_reversed=is_reversed,
                    print_all=print_all,
                    out=out,
                )
            indel_bfb(g, path, start_id, end_id, out=out)
            result.paths[k].append(path)

    # post-BFB translocation merging per graph (localhap.cpp:667-670)
    if props.ins_mode == 2 or props.con_mode == 2:
        from ambigram_tpu_torch.engine.trx import translocation_bfb

        for k, g in enumerate(genomes):
            res_path: VertexPath = []
            translocation_bfb(g, result.paths[k], res_path, props.main_chr, out=out)

    result.path_strings = [
        [format_bfb(p) for p in result.paths[k]] for k in range(K)
    ]
    result.seconds = time.perf_counter() - begin
    if ledger_dir is not None:
        _append_sc_ledger(result, lh_paths, ledger_dir)
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
