"""Junction copy-number tabulation (normal adjacencies vs fold-back inversions).

Parity target: LocalGenomicMap::getJuncCN
(src/LocalGenomicMap.cpp:3989-4050).

For each segment id i in [0, end], produces
    junc_cn[i, 0]  summed CN of normal adjacency junctions leaving i
    junc_cn[i, 1]  summed CN of fold-back inversions anchored at i
and an `inversions` map seg_id -> Junction for FBI lookup during path
repair. Quirks preserved:
- copy numbers in (0.5, 1) round up to 1 (LGM.cpp:4001-4002);
- an opposite-strand junction counts as FBI when |src - tgt| <= 2
  ("imperfect" FBI window, LGM.cpp:4012);
- an FBI registers under its source id if free, else its target id;
  afterwards every FBI fills any still-unmapped endpoint ids
  (LGM.cpp:4043-4049).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ambigram_tpu_torch.model.genome import Genome, Junction


def get_junc_cn(
    genome: Genome, start_seg_id: int, end_seg_id: int
) -> Tuple[Dict[int, Junction], np.ndarray]:
    junc_cn = np.zeros((end_seg_id + 1, 2), dtype=np.float64)
    inversions: Dict[int, Junction] = {}
    inv: List[Junction] = []
    for junc in genome.junctions:
        source_id = junc.source.id
        target_id = junc.target.id
        if (
            source_id < start_seg_id
            or source_id > end_seg_id
            or target_id < start_seg_id
            or target_id > end_seg_id
        ):
            continue
        copy_num = junc.weight.copy_num
        if 0.5 < copy_num < 1:
            copy_num = 1.0
        if junc.source_dir == junc.target_dir:
            if source_id + 1 == target_id:
                junc_cn[source_id, 0] += copy_num
            elif source_id - 1 == target_id:
                junc_cn[target_id, 0] += copy_num
        else:
            if abs(source_id - target_id) <= 2:
                inv.append(junc)
                if source_id not in inversions:
                    inversions[source_id] = junc
                    junc_cn[source_id, 1] += copy_num
                elif target_id not in inversions:
                    inversions[target_id] = junc
                    junc_cn[target_id, 1] += copy_num
    for junc in inv:
        inversions.setdefault(junc.source.id, junc)
        inversions.setdefault(junc.target.id, junc)
    return inversions, junc_cn


def fbi_bias(
    inversions: Dict[int, Junction],
    junc_cn: np.ndarray,
    start_seg_id: int,
    end_seg_id: int,
) -> int:
    """Objective bias from imperfect FBIs (localhap.cpp:141-146)."""
    bias = 1
    for i in range(start_seg_id, end_seg_id + 1):
        if junc_cn[i, 1] > 0:
            junc = inversions[i]
            if junc.source is not junc.target:
                bias += int(junc_cn[i, 1]) % 2
    return bias
