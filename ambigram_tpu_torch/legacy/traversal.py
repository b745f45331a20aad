"""Legacy copy-exhaustive traversal, circuit extraction, haploid assembly.

Parity targets (reference src/LocalGenomicMap.cpp):
- traverseGraph / traverse / traverseNextEdgeByPartition  (:2691-2791, :2530-2616)
- findPartition / checkPartition                          (:2637-2868)
- isCircuitSimple / allCircuitsSimple / extractCircuits   (:2905-2990)
- sortCircuits / divideCircuits                           (:2992-3018)
- generateHaploids                                        (:3064-3171)
- get_complement                                          (:278-284)
- read_long_frags / traverseLongPath                      (:52-151, :2794-2851)
- read_hic_matrix / traverseWithHic                       (:152-189, :2620-2635)
- writers                                                 (:3020-3062, :3205-3222)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ambigram_tpu_torch.legacy.juncdb import JunctionDB
from ambigram_tpu_torch.model.genome import Edge, Genome, Vertex, VertexPath


def get_complement(path: VertexPath) -> VertexPath:
    return [v.complement() for v in reversed(path)]


class Traverser:
    def __init__(self, genome: Genome):
        self.g = genome
        self.circuits: List[VertexPath] = []
        self.divided_circuits: Dict[int, List[VertexPath]] = {}
        self.traversed_circuits: Dict[int, List[VertexPath]] = {}
        self.divided_haploids: Dict[int, List[VertexPath]] = {}
        self.long_frags: Dict[int, List[VertexPath]] = {}
        self.hic_matrix: Optional[np.ndarray] = None
        self.decrease_matrix: Optional[np.ndarray] = None
        self.using_long = False
        self.using_hic = False

    # ------------------------------------------------------------ partition

    def find_partition(self, seg_id: int) -> Tuple[int, int]:
        for src, snk in zip(self.g.sources, self.g.sinks):
            if src.id <= seg_id <= snk.id:
                return src.id, snk.id
        return -1, -1

    def check_partition(self, target_id: int, part: List[int]) -> bool:
        """part = [start, end], mutated like the reference's int pointers
        (LGM.cpp:2853-2868)."""
        last_partition_id = self.g.sources[-1].id
        if target_id >= last_partition_id or (part[0] <= target_id <= part[1]):
            return True
        pair = self.find_partition(target_id)
        if part[0] == last_partition_id:
            part[0], part[1] = pair
            return True
        return (part[0], part[1]) == pair

    # ------------------------------------------------------------- traverse

    def _next_edge(self, vertex: Vertex, vp: VertexPath, db: JunctionDB, part: List[int]) -> Optional[Edge]:
        """traverseNextEdgeByPartition (LGM.cpp:2530-2616)."""
        if self.using_hic:
            e = self._traverse_with_hic(vp)
            if e is not None:
                return e
        pos = vertex.seg.end if vertex.dir == "+" else vertex.seg.start
        recs = db.find_records(vertex.seg.chrom, pos, vertex.dir)
        if recs:
            support = 0
            for rec in recs:
                for e in vertex.edges_as_source:
                    if e.weight.copy_num >= 1:
                        if self.check_partition(e.target.id, part):
                            tpos = e.target.seg.start if e.target.dir == "+" else e.target.seg.end
                            entry = rec.find_forward_entry(e.target.seg.chrom, tpos, e.target.dir)
                            if entry is not None:
                                if entry.support > support:
                                    return e
                            elif support == 0:
                                return e
        for e in vertex.edges_as_source:
            if e.weight.copy_num >= 1 and self.check_partition(e.target.id, part):
                return e
        return None

    def traverse(self, start: Vertex, db: Optional[JunctionDB]) -> VertexPath:
        """One copy-decrementing walk from `start` (LGM.cpp:2691-2743)."""
        if db is None:
            db = JunctionDB()
        part = [self.g.sources[-1].id, self.g.sinks[-1].id]
        vp: VertexPath = []
        current = start
        if self.using_long:
            self.check_partition(current.id, part)
            while True:
                current = self._traverse_long_path(current, vp, part)
                edge = self._next_edge(current, vp, None if db is None else db, part)
                if edge is None:
                    break
                edge.weight.copy_num -= 1
                current = edge.target
        else:
            vp.append(current)
            self.check_partition(current.id, part)
            while True:
                edge = self._next_edge(current, vp, db, part)
                current.weight.copy_num -= 1
                if edge is None:
                    break
                edge.weight.copy_num -= 1
                vp.append(edge.target)
                current = edge.target
        self.traversed_circuits.setdefault(part[0], []).append(vp)
        self.circuits.append(vp)
        return vp

    def traverse_graph(self, db: JunctionDB) -> None:
        """Copy-exhaustive traversal from sources first (LGM.cpp:2765-2791)."""
        sources = self.g.sources
        others = [s for s in self.g.segments if s not in sources]

        def has_copy(seg):
            return seg.weight.copy_num >= 1

        def copy_exhaustive():
            return all(not has_copy(s) for s in self.g.segments)

        guard = 0
        while not copy_exhaustive():
            for src in sources:
                if has_copy(src):
                    self.traverse(src.pos, db)
            for seg in others:
                if has_copy(seg):
                    self.traverse(seg.pos, db)
            guard += 1
            if guard > 10 * len(self.g.segments) + 100:
                raise RuntimeError("traversal failed to exhaust copies")

    # ------------------------------------------------------------- circuits

    @staticmethod
    def _is_circuit_simple(circuit: VertexPath) -> Tuple[int, int]:
        """First repeated vertex span, or (-1, -1) (LGM.cpp:2949-2962)."""
        for i in range(len(circuit)):
            for j in range(i + 1, len(circuit)):
                if circuit[j] is circuit[i]:
                    if i == 0 and j == len(circuit) - 1:
                        break  # a proper circuit endpoint
                    return i, j
        return -1, -1

    def extract_circuits(self) -> None:
        """Split non-simple circuits into simple subcircuits (LGM.cpp:2974-2990)."""
        while True:
            not_simple = []
            for idx, c in enumerate(self.circuits):
                i, j = self._is_circuit_simple(c)
                if i >= 0:
                    not_simple.append((idx, i, j))
            if not not_simple:
                return
            for idx, begin, end in not_simple:
                sub = self.circuits[idx][begin : end + 1]
                self.circuits.append(sub)
                del self.circuits[idx][begin + 1 : end + 1]

    def sort_circuits(self) -> None:
        self.circuits.sort(key=lambda c: c[0].id)

    def divide_circuits(self) -> None:
        """Assign circuits to partitions; orphan ones round-robin
        (LGM.cpp:2997-3018)."""
        sources = self.g.sources
        for seg in sources:
            self.divided_circuits[seg.id] = []
        index = 0
        for circuit in self.circuits:
            pair = self.find_partition(circuit[0].id)
            if pair[0] > 0:
                self.divided_circuits[pair[0]].append(circuit)
            else:
                pid = sources[index % len(sources)].id
                self.divided_circuits[pid].append(circuit)
                index += 1

    # ------------------------------------------------------------- haploids

    def generate_haploids(self) -> Dict[int, List[VertexPath]]:
        """Insert circuits into each partition's main path wherever a
        rotation of the circuit anchors (LGM.cpp:3064-3171)."""
        self.sort_circuits()
        for partition, circuits in self.divided_circuits.items():
            self.divided_haploids[partition] = []
            if not circuits:
                continue
            inserted = [False] * len(circuits)
            inserted[0] = True
            main_path = circuits[0]
            stall = 0
            while not all(inserted):
                progressed = False
                i = 1
                is_comp = False
                while i < len(circuits):
                    if inserted[i]:
                        i += 1
                        continue
                    current = (
                        list(circuits[i])
                        if not is_comp
                        else get_complement(circuits[i])
                    )
                    vq = list(current[:-1])
                    if not vq:
                        # single-vertex walk: nothing to splice
                        # (reference would pop an empty deque here)
                        inserted[i] = True
                        progressed = True
                        i += 1
                        is_comp = False
                        continue
                    found_at = -1
                    for _rot in range(len(vq) + 1):
                        start_v = vq[0]
                        k = 0
                        while k < len(main_path):
                            if main_path[k] is start_v:
                                found_at = k
                                break
                            k += 1
                        if found_at >= 0:
                            break
                        vq.append(vq.pop(0))
                    if found_at >= 0:
                        main_path[found_at:found_at] = vq
                        inserted[i] = True
                        progressed = True
                        i += 1
                        is_comp = False
                    else:
                        if is_comp:
                            i += 1
                            is_comp = False
                        else:
                            is_comp = True
                if not progressed:
                    stall += 1
                    if stall > 2:
                        # leave unplaceable circuits as extra haploids
                        for k, c in enumerate(circuits):
                            if not inserted[k]:
                                self.divided_haploids[partition].append(c)
                                inserted[k] = True
                        break
            self.divided_haploids[partition].insert(0, main_path)
        return self.divided_haploids

    # ------------------------------------------------------- long fragments

    def read_long_frags(self, path: str) -> None:
        """Long-read fragment paths, flipped/merged per LGM.cpp:52-151."""
        self.long_frags = {s.id: [] for s in self.g.sources}
        with open(path) as f:
            lines = f.read().splitlines()
        for line in lines:
            toks = line.split()
            if not toks:
                continue
            p: VertexPath = []
            for tok in toks:
                seg = self.g.segment_by_id(int(tok[:-1]))
                p.append(seg.pos if tok[-1] == "+" else seg.neg)
            pair = self.find_partition(p[0].id)
            if pair[0] == -1:
                continue
            if p[0].dir == "-":
                if p[-1].dir == "-" or p[-1].id < p[0].id:
                    self.long_frags[pair[0]].append(get_complement(p))
            else:
                self.long_frags[pair[0]].append(p)
        for key in self.long_frags:
            frags = sorted(
                self.long_frags[key], key=lambda p: [v.id for v in p]
            )
            # iterative overlap-merge to fixpoint
            while True:
                merged = self._merge_round(frags)
                if len(merged) == len(frags):
                    break
                frags = sorted(merged, key=lambda p: [v.id for v in p])
            frags.sort(key=len, reverse=True)
            self.long_frags[key] = frags
        self.using_long = True

    @staticmethod
    def _merge_round(frags: List[VertexPath]) -> List[VertexPath]:
        out: List[VertexPath] = []
        for frag in frags:
            placed = False
            for existing in out:
                # merge when frag's head overlaps existing's tail
                max_ov = min(len(existing), len(frag))
                for ov in range(max_ov, 0, -1):
                    if all(existing[-ov + k] is frag[k] for k in range(ov)):
                        existing.extend(frag[ov:])
                        placed = True
                        break
                if placed:
                    break
            if not placed:
                out.append(list(frag))
        return out

    def _traverse_long_path(self, start: Vertex, vp: VertexPath, part: List[int]) -> Vertex:
        """Follow the longest coverable long fragment (LGM.cpp:2794-2830)."""
        frags = self.long_frags.get(part[0], [])
        best, best_len = None, 0
        for p in frags:
            if p and p[0] is start:
                length = self._long_path_len(p)
                if length > best_len:
                    best, best_len = p, length
        if best_len <= 1:
            vp.append(start)
            start.weight.copy_num -= 1
            return start
        for k in range(best_len):
            v = best[k]
            vp.append(v)
            v.weight.copy_num -= 1
            if k + 1 < best_len:
                for e in v.edges_as_source:
                    if e.target is best[k + 1]:
                        e.weight.copy_num -= 1
                        break
        return best[best_len - 1]

    @staticmethod
    def _long_path_len(path: VertexPath) -> int:
        n = 1
        for k in range(len(path) - 1):
            ok = any(
                e.target is path[k + 1] and e.weight.copy_num >= 1
                for e in path[k].edges_as_source
            )
            if ok:
                n += 1
            else:
                return 1
        return n

    # --------------------------------------------------------------- Hi-C

    def read_hic_matrix(self, path: str) -> None:
        """Whitespace matrix of pairwise segment interactions
        (LGM.cpp:152-189)."""
        mat = np.loadtxt(path)
        n = len(self.g.segments) + 1
        self.hic_matrix = np.zeros((n, n))
        self.hic_matrix[1 : mat.shape[0] + 1, 1 : mat.shape[1] + 1] = mat
        total_cn = sum(s.weight.copy_num for s in self.g.segments)
        self.decrease_matrix = self.hic_matrix / max(total_cn, 1)
        self.using_hic = True

    def _traverse_with_hic(self, vp: VertexPath) -> Optional[Edge]:
        if not vp or self.hic_matrix is None:
            return None
        current = vp[-1]
        best_edge, best_v = None, 0.0
        for e in current.edges_as_source:
            if e.weight.copy_num < 1:
                continue
            v = sum(self.hic_matrix[u.id][e.target.id] for u in vp)
            if v > best_v:
                best_edge, best_v = e, v
        if best_v == 0:
            return None
        # decrement interactions along the chosen extension
        for u in vp + [best_edge.source]:
            d = self.decrease_matrix[u.id][best_edge.target.id]
            self.hic_matrix[u.id][best_edge.target.id] -= d
            self.hic_matrix[best_edge.target.id][u.id] -= d
        return best_edge

    # -------------------------------------------------------------- writers

    def write_circuits(self, path: str) -> None:
        with open(path, "w") as f:
            for partition in sorted(self.divided_circuits):
                f.write("partition: %d\n" % partition)
                for circuit in self.divided_circuits[partition]:
                    f.write(" ".join(v.info() for v in circuit) + " \n")

    def write_traversed_paths(self, path: str) -> None:
        with open(path, "w") as f:
            for partition in sorted(self.traversed_circuits):
                seg = self.g.segment_by_id(partition)
                f.write("%s_%d:" % (seg.chrom, seg.start))
                for circuit in self.traversed_circuits[partition]:
                    f.write(" ".join(v.info() for v in circuit) + " ")
                f.write("\n")

    def write_haploids(self, path: str) -> None:
        with open(path, "w") as f:
            for partition in sorted(self.divided_haploids):
                f.write("partition: %d\n" % partition)
                for hap in self.divided_haploids[partition]:
                    f.write(" ".join(v.info() for v in hap) + " \n")
