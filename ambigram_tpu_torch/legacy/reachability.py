"""Legacy reachability checking and repair.

Parity targets (reference src/LocalGenomicMap.cpp):
- connectSourceSink            (:1062-1071)
- doesPathExists (partition-restricted DFS)  (:996-1039)
- checkReachability            (:1930-2085)
- addAllJuncsFromDB / inferCoverage / inferCredibility (:802-928, :1041-1060)
- vReachable                   (:2886-2901)

Note: in the reference, the adjustReachability repair calls inside
checkReachability are commented out (:2054-2078), so the loop only
*reports* unreachable vertices (up to 10 iterations); junction
insertion from a JunctionDB happens through addAllJuncsFromDB.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ambigram_tpu_torch.legacy.juncdb import JunctionDB
from ambigram_tpu_torch.model.genome import Genome, Junction, Vertex


def in_coverage(v: Vertex) -> float:
    return sum(e.weight.coverage for e in v.edges_as_target)


def out_coverage(v: Vertex) -> float:
    return sum(e.weight.coverage for e in v.edges_as_source)


def infer_coverage(source: Vertex, target: Vertex) -> float:
    inc = target.weight.coverage - in_coverage(target)
    outc = source.weight.coverage - out_coverage(source)
    return max(1.0, (inc + outc) / 2.0)


def weighted_credibility(g: Genome, v: Vertex, is_source: bool) -> float:
    cred = v.seg.credibility
    if is_source:
        return cred * max(0.0, v.weight.coverage - out_coverage(v)) / g.avg_coverage
    return cred * max(0.0, v.weight.coverage - in_coverage(v)) / g.avg_coverage


def infer_credibility(g: Genome, source: Vertex, target: Vertex) -> float:
    return (weighted_credibility(g, source, True) + weighted_credibility(g, target, False)) / 2


def connect_source_sink(g: Genome) -> None:
    """Add inferred sink->source junctions per chromosome (LGM.cpp:1062-1071)."""
    for src, snk in zip(g.sources, g.sinks):
        g.add_junction(
            snk.id,
            "+",
            src.id,
            "+",
            (src.weight.coverage + snk.weight.coverage) / 2,
            1.0,
            -1,
            True,
            False,
            True,
        )


def find_partition(g: Genome, seg_id: int) -> Tuple[int, int]:
    for src, snk in zip(g.sources, g.sinks):
        if src.id <= seg_id <= snk.id:
            return src.id, snk.id
    return -1, -1


def does_path_exist(g: Genome, start: Vertex, end: Vertex) -> bool:
    """DFS over edges restricted to the start vertex's partition
    (LGM.cpp:996-1039). Vertices outside the partition or beyond the
    last partition boundary behave per selectNextEdgeByPartition."""
    part = find_partition(g, start.id)
    last_partition_id = g.sources[-1].id

    def in_partition(seg_id: int) -> bool:
        return seg_id >= last_partition_id or (part[0] <= seg_id <= part[1])

    visited: Set[int] = set()
    stack = [start]
    seen_vertices: Set[Tuple[int, str]] = set()
    while stack:
        v = stack.pop()
        for e in v.edges_as_source:
            if id(e) in visited:
                continue
            visited.add(id(e))
            t = e.target
            if not in_partition(t.id):
                continue
            if t is end:
                return True
            key = (t.id, t.dir)
            if key not in seen_vertices:
                seen_vertices.add(key)
                stack.append(t)
    return False


def v_reachable(bwd_src: bool, fwd_snk: bool, bwd_snk: bool, fwd_src: bool) -> bool:
    if not bwd_src and not fwd_snk and not bwd_snk and not fwd_src:
        return False
    if bwd_src != fwd_snk:
        return False
    if bwd_snk != fwd_src:
        return False
    return True


def check_reachability(g: Genome, junc_db: Optional[JunctionDB] = None, max_iters: int = 10):
    """Reachability audit loop (LGM.cpp:1930-2085). Returns the four
    not-reachable vertex lists from the final iteration."""
    result: Dict[str, List[Vertex]] = {}
    for i in range(max_iters + 1):
        bwd_src: List[Vertex] = []
        bwd_snk: List[Vertex] = []
        fwd_src: List[Vertex] = []
        fwd_snk: List[Vertex] = []
        connect_source_sink(g)
        for seg in g.segments:
            if seg in g.sources or seg in g.sinks:
                continue
            # heuristic: keep low-coverage orphans out (LGM.cpp:1960-1964)
            is_orphan = not (
                seg.pos.edges_as_source
                or seg.pos.edges_as_target
                or seg.neg.edges_as_source
                or seg.neg.edges_as_target
            )
            if is_orphan and seg.weight.coverage < 0.25 * g.avg_coverage:
                continue
            if not seg.has_lower_bound_limit:
                continue
            part = find_partition(g, seg.id)
            if part[0] == -1:
                continue
            p_src = g.segment_by_id(part[0])
            p_snk = g.segment_by_id(part[1])
            for v in (seg.pos, seg.neg):
                b_src = does_path_exist(g, p_src.pos, v)
                b_snk = does_path_exist(g, p_snk.neg, v)
                f_src = does_path_exist(g, v, p_src.neg)
                f_snk = does_path_exist(g, v, p_snk.pos)
                if not b_src and not f_snk and not b_snk and not f_src:
                    (bwd_src if v.dir == "+" else bwd_snk).append(v)
                if b_src != f_snk:
                    (bwd_src if not b_src else fwd_snk).append(v)
                if b_snk != f_src:
                    (bwd_snk if not b_snk else fwd_src).append(v)
        result = {
            "backward_source": bwd_src,
            "backward_sink": bwd_snk,
            "forward_source": fwd_src,
            "forward_sink": fwd_snk,
        }
        if not (bwd_src or bwd_snk or fwd_src or fwd_snk):
            break
    return result


def add_all_juncs_from_db(g: Genome, db: JunctionDB) -> List[Junction]:
    """Insert inferred junctions for every DB record whose breakpoints
    land on segment boundaries (LGM.cpp:802-928)."""
    added: List[Junction] = []

    def seg_by_end(chrom: str, pos: int):
        for seg in g.segments:
            if seg.chrom == chrom and seg.end == pos:
                return seg
        return None

    def seg_by_start(chrom: str, pos: int):
        for seg in g.segments:
            if seg.chrom == chrom and seg.start == pos:
                return seg
        return None

    for rec in db.records:
        for ent in rec.forward_entries:
            if rec.strand == "+":
                seg = seg_by_end(rec.chrom, rec.pos)
                cur = seg.pos if seg else None
            else:
                seg = seg_by_start(rec.chrom, rec.pos)
                cur = seg.neg if seg else None
            if cur is None:
                continue
            if ent.strand == "+":
                seg = seg_by_start(ent.chrom, ent.pos)
                nxt = seg.pos if seg else None
            else:
                seg = seg_by_end(ent.chrom, ent.pos)
                nxt = seg.neg if seg else None
            if nxt is None:
                continue
            junc = g.add_junction(
                cur.id,
                cur.dir,
                nxt.id,
                nxt.dir,
                infer_coverage(cur, nxt),
                infer_credibility(g, cur, nxt),
                -1,
                True,
                False,
                False,
            )
            if junc is not None and junc in g.junctions:
                added.append(junc)
        for ent in rec.backward_entries:
            if rec.strand == "+":
                seg = seg_by_start(rec.chrom, rec.pos)
                cur = seg.pos if seg else None
            else:
                seg = seg_by_end(rec.chrom, rec.pos)
                cur = seg.neg if seg else None
            if cur is None:
                continue
            if ent.strand == "+":
                seg = seg_by_end(ent.chrom, ent.pos)
                prv = seg.pos if seg else None
            else:
                seg = seg_by_start(ent.chrom, ent.pos)
                prv = seg.neg if seg else None
            if prv is None:
                continue
            junc = g.add_junction(
                prv.id,
                prv.dir,
                cur.id,
                cur.dir,
                infer_coverage(prv, cur),
                infer_credibility(g, prv, cur),
                -1,
                True,
                False,
                False,
            )
            if junc is not None and junc in g.junctions:
                added.append(junc)
    return added
