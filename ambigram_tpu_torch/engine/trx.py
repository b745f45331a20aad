"""Translocation / insertion graph rewrites around the BFB core.

Parity targets:
- insertBeforeBFB    (src/LocalGenomicMap.cpp:4195-4293)
- concatBeforeBFB    (src/LocalGenomicMap.cpp:4295-4395)
- virusBFB           (src/LocalGenomicMap.cpp:3839-3939)
- translocationBFB   (src/LocalGenomicMap.cpp:4052-4193)

insert/concat rewrite the genome *before* BFB reconstruction (PROP
I1:/C1:), splicing foreign-chromosome or virus segments into the host
chromosome and renumbering; virusBFB maps the solved path back onto the
original segments and applies leftover SVs. translocationBFB merges
per-chromosome BFB paths after the fact (PROP I2:/C2:).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ambigram_tpu_torch.engine.path import format_bfb
from ambigram_tpu_torch.model.genome import Genome, Junction, Segment, Vertex, VertexPath


def _find(path: List[Vertex], item: Vertex, start: int = 0, end: Optional[int] = None) -> int:
    if end is None:
        end = len(path)
    for k in range(start, end):
        if path[k] is item:
            return k
    return end


def _rfind(path: List[Vertex], item: Vertex, below: Optional[int] = None) -> int:
    """Last index < below holding item, else -1."""
    if below is None:
        below = len(path)
    for k in range(below - 1, -1, -1):
        if path[k] is item:
            return k
    return -1


def insert_before_bfb(
    g: Genome,
    ins_chr: List[str],
    original_segs: Dict[Segment, Segment],
    unused_sv: List[Junction],
) -> Genome:
    seg_conversion: Dict[int, int] = {}
    segs = list(g.segments)
    juncs = list(g.junctions)
    m_segs: List[Segment] = []
    m_juncs: List[Junction] = []

    # chain the insertion ids along junctions between consecutive
    # ins_chr entries
    insertion_ids: List[int] = []
    visited: List[Junction] = []
    for i in range(1, len(ins_chr)):
        for junc in juncs:
            if junc in visited:
                continue
            chr1, chr2 = junc.source.chrom, junc.target.chrom
            if (ins_chr[i - 1] == chr1 and ins_chr[i] == chr2) or (
                ins_chr[i - 1] == chr2 and ins_chr[i] == chr1
            ):
                id1, id2 = junc.source.id, junc.target.id
                if ins_chr[i - 1] == chr2 and ins_chr[i] == chr1:
                    id1, id2 = id2, id1
                if insertion_ids and insertion_ids[-1] != id1:
                    back = insertion_ids[-1]
                    if back < id1:
                        insertion_ids.extend(range(back, id1))
                    else:
                        insertion_ids.extend(range(back, id1, -1))
                insertion_ids.extend([id1, id2])
                visited.append(junc)
                break
    # drop consecutive duplicates (std::unique semantics)
    dedup: List[int] = []
    for x in insertion_ids:
        if not dedup or dedup[-1] != x:
            dedup.append(x)
    insertion_ids = dedup
    if insertion_ids[0] > insertion_ids[-1]:
        insertion_ids.reverse()
    s_id, e_id = insertion_ids[0], insertion_ids[-1]
    insertion_ids = insertion_ids[1:-1]

    deleted_chr_ids = [segs[i - 1].chr_id for i in insertion_ids]

    i = 1
    while i <= len(segs):
        if i < s_id or i > e_id:
            if segs[i - 1].chr_id in deleted_chr_ids:
                i += 1
                continue
            seg_conversion.setdefault(i, len(m_segs) + 1)
            m_segs.append(Segment.clone(len(m_segs) + 1, segs[i - 1].chr_id, segs[i - 1]))
        else:
            seg_conversion.setdefault(s_id, len(m_segs) + 1)
            m_segs.append(Segment.clone(len(m_segs) + 1, segs[s_id - 1].chr_id, segs[s_id - 1]))
            for j in range(s_id + 1, e_id):
                seg_conversion.setdefault(j, 0)
            for ins in insertion_ids:
                seg_conversion.setdefault(ins, len(m_segs) + 1)
                m_segs.append(
                    Segment.clone(len(m_segs) + 1, segs[s_id - 1].chr_id, segs[ins - 1])
                )
            seg_conversion.setdefault(e_id, len(m_segs) + 1)
            m_segs.append(Segment.clone(len(m_segs) + 1, segs[e_id - 1].chr_id, segs[e_id - 1]))
            i = e_id
        i += 1

    m_sources = [m_segs[0]]
    m_sinks: List[Segment] = []
    for k in range(1, len(m_segs)):
        if m_segs[k].chr_id != m_segs[k - 1].chr_id:
            m_sinks.append(m_segs[k - 1])
            m_sources.append(m_segs[k])
    m_sinks.append(m_segs[-1])

    for junc in juncs:
        if junc.edge_a.source is junc.edge_a.target:
            continue
        start_seg_id, target_seg_id = junc.source.id, junc.target.id
        id1 = seg_conversion.get(start_seg_id, 0) - 1
        id2 = seg_conversion.get(target_seg_id, 0) - 1
        if id1 == -1 or id2 == -1:
            unused_sv.append(junc)
            continue
        dir1, dir2 = junc.source_dir, junc.target_dir
        if start_seg_id in insertion_ids or target_seg_id in insertion_ids:
            if id1 > id2:
                id1, id2 = id2, id1
            dir1 = dir2 = "+"
        m_juncs.append(
            Junction(
                m_segs[id1],
                m_segs[id2],
                dir1,
                dir2,
                junc.weight.coverage,
                junc.credibility,
                junc.weight.copy_num,
                junc.inferred,
                junc.has_lower_bound_limit,
                False,
            )
        )

    for orig_id, new_id in seg_conversion.items():
        if new_id > 0:
            original_segs[m_segs[new_id - 1]] = segs[orig_id - 1]
    new_g = Genome.from_parts(m_segs, m_juncs, m_sources, m_sinks)
    new_g.write_lh("./new.lh")
    return new_g


def concat_before_bfb(
    g: Genome,
    con_chr: List[str],
    original_segs: Dict[Segment, Segment],
    unused_sv: List[Junction],
) -> Genome:
    seg_conversion: Dict[int, int] = {}
    segs = list(g.segments)
    sources = list(g.sources)
    sinks = list(g.sinks)
    juncs = list(g.junctions)
    m_segs: List[Segment] = []
    m_juncs: List[Junction] = []

    s_id = e_id = 0
    s_dir = e_dir = "+"
    for junc in juncs:
        if (junc.source.chrom == con_chr[0] and junc.target.chrom == con_chr[1]) or (
            junc.target.chrom == con_chr[0] and junc.source.chrom == con_chr[1]
        ):
            s_id, e_id = junc.source.id, junc.target.id
            s_dir, e_dir = junc.source_dir, junc.target_dir
            break

    chr_id1 = segs[s_id - 1].chr_id
    if s_dir == "+":
        for i in range(sources[chr_id1].id, s_id + 1):
            seg_conversion.setdefault(i, len(m_segs) + 1)
            m_segs.append(Segment.clone(len(m_segs) + 1, segs[s_id - 1].chr_id, segs[i - 1]))
        for i in range(s_id + 1, sinks[chr_id1].id + 1):
            seg_conversion.setdefault(i, 0)
    else:
        for i in range(sinks[chr_id1].id, s_id - 1, -1):
            seg_conversion.setdefault(i, len(m_segs) + 1)
            m_segs.append(Segment.clone(len(m_segs) + 1, segs[s_id - 1].chr_id, segs[i - 1]))
        for i in range(s_id - 1, sources[chr_id1].id - 1, -1):
            seg_conversion.setdefault(i, 0)
    chr_id2 = segs[e_id - 1].chr_id
    if e_dir == "+":
        for i in range(e_id, sinks[chr_id2].id + 1):
            seg_conversion.setdefault(i, len(m_segs) + 1)
            m_segs.append(Segment.clone(len(m_segs) + 1, segs[s_id - 1].chr_id, segs[i - 1]))
        for i in range(sources[chr_id2].id, e_id):
            seg_conversion.setdefault(i, 0)
    else:
        for i in range(e_id, sources[chr_id2].id - 1, -1):
            seg_conversion.setdefault(i, len(m_segs) + 1)
            m_segs.append(Segment.clone(len(m_segs) + 1, segs[s_id - 1].chr_id, segs[i - 1]))
        for i in range(sinks[chr_id2].id, e_id, -1):
            seg_conversion.setdefault(i, 0)
    for i in range(1, len(segs) + 1):
        if segs[i - 1].chr_id != chr_id1 and segs[i - 1].chr_id != chr_id2:
            seg_conversion.setdefault(i, len(m_segs) + 1)
            m_segs.append(Segment.clone(len(m_segs) + 1, segs[i - 1].chr_id, segs[i - 1]))

    m_sources = [m_segs[0]]
    m_sinks: List[Segment] = []
    for k in range(1, len(m_segs)):
        if m_segs[k].chr_id != m_segs[k - 1].chr_id:
            m_sinks.append(m_segs[k - 1])
            m_sources.append(m_segs[k])
    m_sinks.append(m_segs[-1])

    for junc in juncs:
        start_seg_id, target_seg_id = junc.source.id, junc.target.id
        id1 = seg_conversion.get(start_seg_id, 0) - 1
        id2 = seg_conversion.get(target_seg_id, 0) - 1
        dir1, dir2 = junc.source_dir, junc.target_dir
        if id1 == -1 or id2 == -1:
            unused_sv.append(junc)
            continue
        if (start_seg_id == s_id and target_seg_id == e_id) or (
            start_seg_id == e_id and target_seg_id == s_id
        ):
            if id1 > id2:
                id1, id2 = id2, id1
            dir1 = dir2 = "+"
        m_juncs.append(
            Junction(
                m_segs[id1],
                m_segs[id2],
                dir1,
                dir2,
                junc.weight.coverage,
                junc.credibility,
                junc.weight.copy_num,
                junc.inferred,
                junc.has_lower_bound_limit,
                False,
            )
        )

    for orig_id, new_id in seg_conversion.items():
        if new_id > 0:
            original_segs[m_segs[new_id - 1]] = segs[orig_id - 1]
    new_g = Genome.from_parts(m_segs, m_juncs, m_sources, m_sinks)
    new_g.write_lh("./new.lh")
    return new_g


def virus_bfb(
    g: Genome,
    path: VertexPath,
    original_segs: Dict[Segment, Segment],
    unused_sv: List[Junction],
    out=None,
) -> None:
    """Map a solved path back to original segments and apply the
    second-stage SV (LGM.cpp:3839-3939)."""
    if not path:
        return
    is_fbi = [False]
    for k in range(1, len(path)):
        is_fbi.append(path[k - 1].dir != path[k].dir)

    seg1 = original_segs[path[0].seg]
    seg2 = original_segs[path[1].seg] if len(path) > 1 else seg1
    if seg1.chr_id != seg2.chr_id:
        found = False
        for e in seg1.pos.edges_as_source:
            if e.target.id == seg2.id:
                path[0] = e.source
                found = True
                break
        if not found:
            for e in seg1.neg.edges_as_source:
                if e.target.id == seg2.id:
                    path[0] = e.source
                    break
    else:
        path[0] = seg1.pos if path[0].dir == "+" else seg1.neg

    for k in range(1, len(path)):
        seg = original_segs[path[k].seg]
        if path[k - 1].seg.chr_id != seg.chr_id:
            for e in path[k - 1].edges_as_source:
                if e.target.seg is seg:
                    path[k] = e.target
                    break
        elif is_fbi[k]:
            path[k] = seg.neg if path[k - 1].dir == "+" else seg.pos
        else:
            path[k] = seg.pos if path[k - 1].dir == "+" else seg.neg
    if out is not None:
        out.write("TRX-BFB mode: BFB path in the first stage:\n")
        out.write(format_bfb(path) + "\n")

    for sv in unused_sv:
        is_edge_a = True
        k1 = _rfind(path, sv.edge_a.source)
        if k1 == -1:
            k1 = _rfind(path, sv.edge_b.source)
            is_edge_a = False
        if k1 == -1:
            continue
        n = len(path)
        # reverse-iterator distance of k1 from rbegin
        r_dist = n - 1 - k1
        if is_edge_a:
            k2 = _find(path, sv.edge_b.target)
            if k2 != n and k2 < r_dist:
                del path[:k2]
                path.insert(0, sv.edge_b.source)
            else:
                del path[k1 + 1 :]
                path.append(sv.edge_a.target)
        else:
            k2 = _find(path, sv.edge_a.target)
            if k2 != n and k2 < r_dist:
                del path[:k2]
                path.insert(0, sv.edge_a.source)
            else:
                del path[k1 + 1 :]
                path.append(sv.edge_b.target)
        if out is not None:
            out.write("TRX-BFB mode: BFB path in the second stage:\n")
            out.write(format_bfb(path) + "\n")
        break


def translocation_bfb(
    g: Genome,
    paths: List[VertexPath],
    res: VertexPath,
    main_chr: str,
    out=None,
) -> None:
    """Merge per-chromosome BFB paths along translocation chains
    (LGM.cpp:4052-4193)."""
    if out is not None:
        out.write("BFB with translocation:\n")
    sv: List[Junction] = [
        j for j in g.junctions if j.source.chr_id != j.target.chr_id
    ]
    for p in paths:
        if p and p[0].seg.chrom == main_chr:
            res.extend(p)
    start_pos = 0
    while sv:
        group: List[Vertex] = []
        for i in range(len(sv)):
            if sv[i].source.chrom == main_chr:
                group.append(sv[i].edge_a.source)
                group.append(sv[i].edge_a.target)
                del sv[i]
                break
            elif sv[i].target.chrom == main_chr:
                group.append(sv[i].edge_b.source)
                group.append(sv[i].edge_b.target)
                del sv[i]
                break
        if not group:
            break
        i = 0
        while i < len(sv):
            edge_a, edge_b = sv[i].edge_a, sv[i].edge_b
            if group[-1].seg.chr_id == edge_a.source.seg.chr_id:
                group.extend([edge_a.source, edge_a.target])
            elif group[-1].seg.chr_id == edge_b.source.seg.chr_id:
                group.extend([edge_b.source, edge_b.target])
            else:
                i += 1
                continue
            del sv[i]
            i = 0
            if group[-1].seg.chrom == main_chr:
                break
        if len(group) == 2:  # concatenation
            k1 = _rfind(res, group[0])
            if k1 == -1:
                group.reverse()
                group = [v.complement() for v in group]
                k1 = _rfind(res, group[0])
            if k1 == -1:
                continue
            del res[k1 + 1 :]
            chr_id = group[1].seg.chr_id
            k2 = _find(paths[chr_id], group[1])
            if k2 == len(paths[chr_id]):
                paths[chr_id].reverse()
                paths[chr_id][:] = [v.complement() for v in paths[chr_id]]
                k2 = _find(paths[chr_id], group[1])
            if k2 == len(paths[chr_id]):
                continue
            res.extend(paths[chr_id][k2:])
            start_pos = 0
        else:  # insertion
            if group[0].id > group[-1].id:
                group.reverse()
                group = [v.complement() for v in group]

            def collect(group):
                pos: List[int] = []
                flag = _find(res, group[0], start_pos)
                pos.append(flag)
                if flag != len(res):
                    for i in range(1, len(group) - 1, 2):
                        chr_id = group[i].seg.chr_id
                        p = paths[chr_id]
                        k1 = _find(p, group[i])
                        if k1 == len(p):
                            p.reverse()
                            p[:] = [v.complement() for v in p]
                            k1 = _find(p, group[i])
                        if k1 == len(p):
                            break
                        pos.append(k1)
                        k2 = _rfind(p, group[i + 1])
                        if k2 == -1 or k1 > k2 + 1:
                            p.reverse()
                            p[:] = [v.complement() for v in p]
                            k2 = _rfind(p, group[i + 1])
                        if k2 == -1 or k1 > k2 + 1:
                            break
                        pos.append(k2)
                pos.append(_find(res, group[-1], flag + 1))
                return pos, flag

            pos, flag = collect(group)
            if len(pos) < len(group) or pos[-1] == len(res):
                group.reverse()
                group = [v.complement() for v in group]
                pos, flag = collect(group)
            if len(pos) < len(group) or pos[-1] == len(res):
                continue
            temp: List[Vertex] = []
            for i in range(1, len(pos) - 1, 2):
                chr_id = group[i].seg.chr_id
                temp.extend(paths[chr_id][pos[i] : pos[i + 1] + 1])
            if not temp:
                continue
            del res[pos[0] + 1 : pos[-1]]
            res[pos[0] + 1 : pos[0] + 1] = temp
            start_pos = _find(res, temp[-1])
    if out is not None:
        out.write(format_bfb(res) + "\n")
