"""Indel / non-FBI SV overlay: pre-ILP CN bias and post-search path edits.

Parity targets:
- LocalGenomicMap::getIndelBias (src/LocalGenomicMap.cpp:3699-3744)
- LocalGenomicMap::indelBFB     (src/LocalGenomicMap.cpp:3746-3837)
"""

from __future__ import annotations

from typing import List

from ambigram_tpu_torch.model.genome import Genome, Junction, Vertex, VertexPath


def _find(path: List[Vertex], item: Vertex, start: int = 0, end: int = None) -> int:
    """std::find over [start, end): returns index or `end` (one-past)."""
    if end is None:
        end = len(path)
    for k in range(start, end):
        if path[k] is item:
            return k
    return end


def get_indel_bias(genome: Genome, start_seg_id: int, end_seg_id: int) -> None:
    """Adjust segment CNs +-1 for del/dup/ins chains before the ILP."""
    segs = genome.segments
    sv: List[Junction] = []
    for junc in genome.junctions:
        if junc.source.chr_id != junc.target.chr_id:
            continue
        source_id, target_id = junc.source.id, junc.target.id
        source_dir, target_dir = junc.source_dir, junc.target_dir
        if (
            source_id < start_seg_id
            or source_id > end_seg_id
            or target_id < start_seg_id
            or target_id > end_seg_id
        ):
            continue
        if source_dir != target_dir:
            continue  # FBI or inversion
        if source_dir == target_dir and (
            (source_dir == "+" and target_id - source_id == 1)
            or (source_dir == "-" and source_id - target_id == 1)
        ):
            continue  # normal junction
        sv.append(junc)
    while sv:
        group: List[int] = []
        i = 0
        while i < len(sv):
            source_id, target_id = sv[i].source.id, sv[i].target.id
            if sv[i].source_dir == "-":
                source_id = -source_id
            if sv[i].target_dir == "-":
                target_id = -target_id
            if not group:
                group.extend([source_id, target_id])
            else:
                if target_id == group[0]:
                    group.insert(0, source_id)
                elif source_id == -group[0]:
                    group.insert(0, -target_id)
                elif group[-1] == source_id:
                    group.append(target_id)
                elif group[-1] == -target_id:
                    group.append(-source_id)
                else:
                    i += 1
                    continue
            del sv[i]
            # reference restarts scanning from the (now shifted) same index
        if len(group) == 2:
            if group[0] < group[1]:  # deletion
                for j in range(group[0] + 1, group[1]):
                    segs[abs(j) - 1].weight.copy_num += 1
            else:  # duplication
                for j in range(group[1], group[0] + 1):
                    segs[abs(j) - 1].weight.copy_num -= 1
        else:  # insertion
            for j in range(1, len(group) - 1):
                segs[abs(group[j]) - 1].weight.copy_num -= 1


def indel_bfb(genome: Genome, path: VertexPath, start_seg_id: int, end_seg_id: int, out=None) -> None:
    """Post-search path editing for deletions/duplications/inversions/insertions."""
    sv: List[Junction] = []
    for junc in genome.junctions:
        if junc.source.chr_id != junc.target.chr_id:
            continue
        source_id, target_id = junc.source.id, junc.target.id
        source_dir, target_dir = junc.source_dir, junc.target_dir
        if (
            source_id < start_seg_id
            or source_id > end_seg_id
            or target_id < start_seg_id
            or target_id > end_seg_id
        ):
            continue
        if source_dir != target_dir and abs(source_id - target_id) <= 2:
            continue  # FBI
        if source_dir == target_dir and (
            (source_dir == "+" and target_id - source_id == 1)
            or (source_dir == "-" and source_id - target_id == 1)
        ):
            continue  # normal junction
        sv.append(junc)
    if not sv:
        return
    while sv:
        group: List[Vertex] = []
        i = 0
        while i < len(sv):
            edge_a, edge_b = sv[i].edge_a, sv[i].edge_b
            if not group:
                group.extend([edge_a.source, edge_a.target])
            else:
                if edge_a.target is group[0]:
                    group.insert(0, edge_a.source)
                elif edge_b.target is group[0]:
                    group.insert(0, edge_b.source)
                elif group[-1] is edge_a.source:
                    group.append(edge_a.target)
                elif group[-1] is edge_b.source:
                    group.append(edge_b.target)
                else:
                    i += 1
                    continue
            del sv[i]
        if len(group) == 2:
            if group[0].dir == group[1].dir:
                if (group[0].dir == "+" and group[0].id < group[1].id) or (
                    group[0].dir == "-" and group[0].id > group[1].id
                ):
                    # deletion: erase a gap of <= 3 between the two anchors
                    pos1 = _find(path, group[0])
                    pos2 = _find(path, group[1], pos1 + 1)
                    if pos1 == len(path) or pos2 == len(path):
                        group.reverse()
                        group = [v.complement() for v in group]
                        pos1 = _find(path, group[0])
                        pos2 = _find(path, group[1], pos1 + 1)
                    if pos1 == len(path) or pos2 == len(path) or pos2 - pos1 > 3:
                        continue
                    del path[pos1 + 1 : pos2]
                else:
                    # duplication: re-insert the prefix [pos2, pos1+1)
                    pos1 = _find(path, group[0])
                    pos2 = _find(path, group[1], 0, pos1)
                    if pos1 == len(path) or pos2 == pos1:
                        group.reverse()
                        group = [v.complement() for v in group]
                        pos1 = _find(path, group[0])
                        pos2 = _find(path, group[1], 0, pos1)
                    if pos1 == len(path) or pos2 == pos1:
                        continue
                    path[pos1 + 1 : pos1 + 1] = path[pos2 : pos1 + 1]
            else:
                # inversion: erase a gap of <= 5
                pos1 = _find(path, group[0])
                pos2 = _find(path, group[1], pos1 + 1)
                if pos1 == len(path) or pos2 == len(path):
                    group.reverse()
                    group = [v.complement() for v in group]
                    pos1 = _find(path, group[0])
                    pos2 = _find(path, group[1], pos1 + 1)
                if pos1 == len(path) or pos2 == len(path) or pos2 - pos1 > 5:
                    continue
                del path[pos1 + 1 : pos2]
        else:
            # insertion: splice the group between its anchors
            pos1 = _find(path, group[0])
            pos2 = _find(path, group[-1], pos1 + 1)
            if pos1 == len(path) or pos2 == len(path):
                group.reverse()
                group = [v.complement() for v in group]
                pos1 = _find(path, group[0])
                pos2 = _find(path, group[-1], pos1 + 1)
            if pos1 == len(path) or pos2 == len(path):
                continue
            del path[pos1 + 1 : pos2]
            path[pos1 + 1 : pos1 + 1] = group[1:-1]
    if out is not None:
        from ambigram_tpu_torch.engine.path import format_bfb

        out.write("BFB path with insertion, deletion, or duplication:\n")
        out.write(format_bfb(path) + "\n")
