"""JUNCS file ingestion: long/linked-read evidence components.

Parity target: LocalGenomicMap::readComponents
(src/LocalGenomicMap.cpp:5096-5156).

Each JUNCS line is a run of "<segId><dir>" tokens. The run is split at
strand flips or partition (chromosome) changes; every maximal same-
strand same-partition stretch of length >= 2 becomes a sorted
"component" (fed into the ILP evidence constraint), and every split
point implies a junction that is inserted into the graph (or has its
CN bumped to >= 2 if already present).
"""

from __future__ import annotations

from typing import Dict, List

from ambigram_tpu_torch.model.genome import Genome, Junction, Segment


def read_components(
    genome: Genome,
    original_segs: Dict[Segment, Segment],
    juncs_path: str,
) -> List[List[int]]:
    if not juncs_path:
        return []
    seg_conversion: Dict[int, int] = {}
    for new_seg, orig_seg in original_segs.items():
        seg_conversion[orig_seg.id] = new_seg.id
    res: List[List[int]] = []
    with open(juncs_path, "r") as f:
        lines = f.read().split("\n")
    for line in lines:
        tokens = line.split()
        if not tokens:
            continue
        segs: List[int] = []
        sign: List[str] = []
        for tok in tokens:
            seg_id = int(tok[:-1])
            seg_id = seg_conversion.get(seg_id, seg_id)
            segs.append(seg_id)
            sign.append(tok[-1])
        last_idx = 0
        for i in range(1, len(segs)):
            if (
                genome.segment_by_id(segs[last_idx]).partition
                != genome.segment_by_id(segs[i]).partition
                or sign[i - 1] != sign[i]
            ):
                if i - last_idx >= 2:
                    res.append(sorted(segs[last_idx:i]))
                source_id, target_id = segs[i - 1], segs[i]
                source_dir, target_dir = sign[i - 1], sign[i]
                jun_coverage = genome.avg_coverage
                probe = Junction(
                    genome.segment_by_id(source_id),
                    genome.segment_by_id(target_id),
                    source_dir,
                    target_dir,
                    jun_coverage,
                    1.0,
                    1.0,
                    False,
                    True,
                    False,
                )
                existing = genome.find_junction(probe)
                if existing is None:
                    genome.add_junction(
                        source_id, source_dir, target_id, target_dir, jun_coverage, 1.0, 1.0, False, True, False
                    )
                else:
                    if existing.weight.copy_num < 2:
                        existing.weight.set_copy_num(2.0)
                last_idx = i
        if len(segs) - last_idx >= 2:
            res.append(sorted(segs[last_idx:]))
    # dedupe, preserving sorted order (reference sorts then unique's)
    res.sort()
    out: List[List[int]] = []
    for comp in res:
        if not out or out[-1] != comp:
            out.append(comp)
    return out
