"""BFB path replay: order -> breakpoint path -> segment path string.

Parity targets:
- LocalGenomicMap::getBFB        (src/LocalGenomicMap.cpp:3514-3697)
- LocalGenomicMap::imperfectFBI  (src/LocalGenomicMap.cpp:3431-3512)
- LocalGenomicMap::printBFB      (src/LocalGenomicMap.cpp:3411-3429)

The replay walks each topological order of the BFB DAG, seeding the
breakpoint path with the top pattern/loop, appending patterns at a
matching end, and splicing loops at the latest parity-valid anchor.
The first order that consumes every node wins; if none does, the whole
enumeration retries in the opposite orientation (LGM.cpp:3691-3695).

Breakpoint paths hold vertices at *pair* granularity: path[2k], path[2k+1]
delimit a monotone run of segments. Expansion to the final segment path
happens in `expand_breakpoint_path`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ambigram_tpu_torch.model.genome import Genome, Junction, Vertex, VertexPath


def format_bfb(path: VertexPath) -> str:
    """Path string with '|' at FBIs and '||' at translocations."""
    if not path:
        return ""
    out = []
    for k in range(1, len(path)):
        prev, cur = path[k - 1], path[k]
        out.append(prev.info())
        if prev.seg.chr_id != cur.seg.chr_id:
            out.append("||")
        elif prev.dir != cur.dir:
            out.append("|")
    out.append(path[-1].info())
    return "".join(out)


def _find_idx(path: List[Vertex], item: Vertex, start: int, end: Optional[int] = None) -> int:
    if end is None:
        end = len(path)
    for k in range(start, end):
        if path[k] is item:
            return k
    return end


def _rfind_idx(path: List[Vertex], item: Vertex, below: int) -> int:
    """Last index k < below with path[k] is item, else -1."""
    for k in range(below - 1, -1, -1):
        if path[k] is item:
            return k
    return -1


def imperfect_fbi(g: Genome, bkp_path: List[Vertex], inversions: Dict[int, Junction]) -> None:
    """Rewrite breakpoint pairs so imperfect FBIs print correctly."""
    pos = 0
    while pos < len(bkp_path):
        n = len(bkp_path)
        # find the complement of bkp_path[pos] at index >= pos+3
        comp = bkp_path[pos].complement()
        if pos + 3 <= n:
            r = _find_idx(bkp_path, comp, pos + 3)
        else:
            # reference would run find() past the buffer (UB); treat as
            # not found
            r = n
        l = r - 1
        if r == n or (pos + 1 < n and bkp_path[l] is not bkp_path[pos + 1].complement()):
            seg_id = bkp_path[pos + 1].id
            if seg_id in inversions:
                junc = inversions[seg_id]
                if bkp_path[pos + 1].dir == "+":
                    if junc.source.id < junc.target.id:
                        bkp_path[pos + 1] = junc.source.pos
                    else:
                        bkp_path[pos + 1] = junc.target.pos
                else:
                    if junc.source.id < junc.target.id:
                        bkp_path[pos + 1] = junc.target.neg
                    else:
                        bkp_path[pos + 1] = junc.source.neg
            if pos > 0:
                seg_id = bkp_path[pos].id
                if seg_id in inversions and bkp_path[pos - 1].id == seg_id:
                    junc = inversions[seg_id]
                    if junc.source.id == seg_id:
                        bkp_path[pos] = (
                            junc.target.pos if bkp_path[pos].dir == "+" else junc.target.neg
                        )
                    else:
                        bkp_path[pos] = (
                            junc.source.pos if bkp_path[pos].dir == "+" else junc.source.neg
                        )
            # run-direction sanity adjustment (LGM.cpp:3469-3470)
            if bkp_path[pos].dir == "+" and bkp_path[pos].id > bkp_path[pos + 1].id:
                bkp_path[pos + 1] = bkp_path[pos]
            if bkp_path[pos].dir == "-" and bkp_path[pos].id < bkp_path[pos + 1].id:
                bkp_path[pos + 1] = bkp_path[pos]
            pos += 2
        else:
            # palindromic center scan (LGM.cpp:3473-3508)
            p1 = pos + (l - pos) // 2
            p2 = p1 + 1
            first_iter_p2 = p1 + 1
            while p1 >= pos - 1 and p1 > 0:
                seg_id = bkp_path[p1].id
                if seg_id in inversions:
                    junc = inversions[seg_id]
                    if bkp_path[p1].dir == "+":
                        if junc.source.id < junc.target.id:
                            bkp_path[p1] = junc.source.pos
                            bkp_path[p1 + 1] = junc.target.neg
                        else:
                            bkp_path[p1] = junc.target.pos
                            bkp_path[p1 + 1] = junc.source.neg
                    else:
                        if junc.source.id < junc.target.id:
                            bkp_path[p1] = junc.target.neg
                            bkp_path[p1 + 1] = junc.source.pos
                        else:
                            bkp_path[p1] = junc.source.neg
                            bkp_path[p1 + 1] = junc.target.pos
                    if p2 != p1 + 1:
                        if p1 > pos - 1 and p2 < len(bkp_path):
                            bkp_path[p2] = bkp_path[p1].complement()
                        if p2 - 1 < len(bkp_path):
                            bkp_path[p2 - 1] = bkp_path[p1 + 1].complement()
                p1 -= 2
                p2 += 2
            del first_iter_p2
            pos = r + 1


def expand_breakpoint_path(g: Genome, bkp_path: List[Vertex]) -> VertexPath:
    """Expand (start, end) breakpoint pairs into per-segment vertex runs
    (LGM.cpp:3658-3690)."""
    path: VertexPath = []
    for j in range(1, len(bkp_path), 2):
        a, b = bkp_path[j - 1], bkp_path[j]
        if a.dir == "+":
            for k in range(a.id, b.id + 1):
                path.append(g.segment_by_id(k).pos)
        else:
            for k in range(a.id, b.id - 1, -1):
                path.append(g.segment_by_id(k).neg)
    return path


def replay_bfb(
    g: Genome,
    adj: List[List[int]],
    node2pat: List[List[int]],
    node2loop: List[List[int]],
    inversions: Dict[int, Junction],
    is_reversed: bool = False,
    print_all: bool = False,
    out=None,
) -> VertexPath:
    """Order enumeration + replay, preferring the native engine.

    The C++ engine (native/bfb_replay.cpp) enumerates topological
    orders lazily and replays incrementally — same first-success result
    as materializing all orders (differential-tested), without the
    factorial order list. Falls back to the Python path for
    print_all mode or when no toolchain is available."""
    # The shared-parent edge rule (LGM.cpp:3353-3361) is not
    # span-monotone, so some solved CN vectors yield a CYCLIC graph —
    # zero topological orders exist, and enumerating to discover that
    # is a factorial dead-end scan (the reference would hang; observed
    # 30+ CPU-minutes on a noisy S=32 incumbent). Kahn's check answers
    # "no path" in O(nodes + edges) with identical semantics.
    n_nodes = len(adj)
    indeg = [0] * n_nodes
    for nbrs in adj:
        for j in nbrs:
            indeg[j] += 1
    frontier = [i for i in range(n_nodes) if indeg[i] == 0]
    seen = 0
    while frontier:
        u = frontier.pop()
        seen += 1
        for j in adj[u]:
            indeg[j] -= 1
            if indeg[j] == 0:
                frontier.append(j)
    if seen != n_nodes:
        return []
    if not print_all:
        try:
            from ambigram_tpu_torch.native import native_bfb_replay

            inv_pairs = {
                seg: (j.source.id, j.target.id) for seg, j in inversions.items()
            }
            steps = native_bfb_replay(
                adj, node2pat, node2loop, inv_pairs, is_reversed=is_reversed
            )
        except Exception:
            steps = None
        if steps is not None:
            path = [
                g.segment_by_id(sid).pos if d > 0 else g.segment_by_id(sid).neg
                for sid, d in steps
            ]
            if path and out is not None:
                out.write(format_bfb(path) + "\n")
            return path
    # Python path (print_all mode / no toolchain): stream orders from
    # the lazy enumerator — O(width) memory on wide DAGs instead of the
    # factorial order list. AMBIGRAM_MAX_ORDERS (0 = unbounded, the
    # reference's exact behavior) caps enumeration per pass on
    # pathological inputs — a wide DAG whose orders all fail to replay
    # is otherwise a factorial-time hang (observed: 30+ CPU-minutes on
    # a noisy S=48 solution). First-success and reverse-retry semantics
    # are unchanged; a bounded pass that finds nothing yields the
    # empty path, same as the reference's no-order-worked outcome.
    import itertools
    import os

    from ambigram_tpu_torch.engine.dag import iter_topological_orders

    cap = int(os.environ.get("AMBIGRAM_MAX_ORDERS", "200000"))
    drained = [0]  # counts per-pass enumerations to detect a bounded miss

    def make_orders():
        it = (o for o in iter_topological_orders(adj) if o)
        if not cap:
            return it

        def counted():
            n = 0
            for o in itertools.islice(it, cap):
                n += 1
                yield o
            drained[0] = max(drained[0], n)

        return counted()

    path = get_bfb_lazy(
        g,
        make_orders,
        node2pat,
        node2loop,
        inversions,
        is_reversed=is_reversed,
        print_all=print_all,
        out=out,
    )
    if not path and cap and drained[0] >= cap:
        from ambigram_tpu_torch.native import _warn_budget

        _warn_budget(
            "replay_bfb: order budget exhausted (AMBIGRAM_MAX_ORDERS=%d) "
            "before any order replayed — 'no path' is bounded, not proven"
            % cap
        )
    return path


def direct_splice_replay(
    g: Genome,
    pairs,
    element_cn,
    inversions: Dict[int, Junction],
    is_reversed: bool = False,
    out=None,
    n_variants: int = 24,
) -> VertexPath:
    """Span-descending DIRECT replay — the fallback for solutions whose
    reference-rule graph is cyclic (zero topological orders).

    The reference's DAG (construct_dag) exists only to ORDER the splice
    attempts; its shared-parent rule is not span-monotone and some
    solved CN vectors give it cycles, where the reference scans a
    factorial dead end and prints nothing (LGM.cpp:3380-3409, :261).
    The splice semantics themselves (get_bfb) only need SOME ordering —
    so build the node list directly from the positive variables
    (bypassing the quirky parallel-sort payload arrays), order by span
    descending (parents before children — the monotone order the DAG
    rule approximates), and replay that single order; a few
    deterministic and seeded tie-break variants cover ambiguous equal-
    span groups. A path found this way has identical validity to a
    DAG-ordered one (same splice/parity rules, same imperfect-FBI
    rewrite), at the SAME epsilon — measured: it replays noisy cases
    whose entire optimal face is cyclic under the reference rule."""
    import random

    T = len(pairs)
    nodes = []
    for t in range(T):
        i, j = int(pairs[t][0]), int(pairs[t][1])
        if element_cn[t] > 0:
            nodes.append(("p", i, j, int(element_cn[t])))
        if element_cn[T + t] > 0:
            nodes.append(("l", i, j, int(element_cn[T + t])))
    if not nodes:
        return []
    rng = random.Random(0)
    variants = [
        sorted(nodes, key=lambda nd: (-(nd[2] - nd[1]), nd[0], nd[1])),
        sorted(nodes, key=lambda nd: (-(nd[2] - nd[1]), nd[0] != "l", nd[1])),
    ]
    for _ in range(max(0, n_variants - 2)):
        variants.append(
            sorted(nodes, key=lambda nd: (-(nd[2] - nd[1]), rng.random()))
        )
    for v in variants:
        n2p: List[List[int]] = []
        n2l: List[List[int]] = []
        for kind, i, j, cn in v:
            if kind == "p":
                n2p.append([i, j, cn])
                n2l.append([])
            else:
                n2l.append([i, j, cn])
                n2p.append([])
        path = get_bfb(
            g,
            [list(range(len(v)))],
            n2p,
            n2l,
            inversions,
            is_reversed=is_reversed,
            out=out,
        )
        if path:
            return path
    return []


def get_bfb(
    g: Genome,
    orders: List[List[int]],
    node2pat: List[List[int]],
    node2loop: List[List[int]],
    inversions: Dict[int, Junction],
    is_reversed: bool = False,
    print_all: bool = False,
    out=None,
) -> VertexPath:
    """Replay topological orders into a breakpoint path; returns the
    first complete expanded path (possibly empty if none works).

    `orders` may be any re-iterable list; `get_bfb_lazy` feeds the same
    engine from a generator factory for bounded-memory --all runs."""
    return get_bfb_lazy(
        g,
        lambda: iter(orders),
        node2pat,
        node2loop,
        inversions,
        is_reversed=is_reversed,
        print_all=print_all,
        out=out,
    )


def get_bfb_lazy(
    g: Genome,
    make_orders,
    node2pat: List[List[int]],
    node2loop: List[List[int]],
    inversions: Dict[int, Junction],
    is_reversed: bool = False,
    print_all: bool = False,
    out=None,
) -> VertexPath:
    """Streaming form of get_bfb: `make_orders()` returns a fresh order
    iterator per pass. Reference flip quirk preserved exactly: the
    reverse-orientation retry fires iff the LAST enumerated order
    failed to replay (LGM.cpp:3691-3695) — even in --all mode where
    earlier orders may have printed successfully."""
    path: VertexPath = []
    path, last_invalid, stopped = _replay_pass(
        g,
        make_orders(),
        node2pat,
        node2loop,
        inversions,
        forward_dir=not is_reversed,
        print_all=print_all,
        out=out,
        path=path,
    )
    if not stopped and last_invalid:
        path, _, _ = _replay_pass(
            g,
            make_orders(),
            node2pat,
            node2loop,
            inversions,
            forward_dir=is_reversed,
            print_all=print_all,
            out=out,
            path=path,
        )
    return path


def _replay_pass(
    g: Genome,
    orders,
    node2pat: List[List[int]],
    node2loop: List[List[int]],
    inversions: Dict[int, Junction],
    forward_dir: bool,
    print_all: bool,
    out,
    path: VertexPath,
):
    """One pass over `orders` in one orientation. Returns
    (path, last_order_invalid, stopped_at_first_success)."""
    last_invalid = False
    for bfb in orders:
        bkp_path: List[Vertex] = []
        if node2pat[bfb[0]]:
            start, end = node2pat[bfb[0]][0], node2pat[bfb[0]][1]
        else:
            start, end = node2loop[bfb[0]][0], node2loop[bfb[0]][1]
        if forward_dir:
            if node2pat[bfb[0]]:
                bkp_path.append(g.segment_by_id(start).pos)
                bkp_path.append(g.segment_by_id(end).pos)
            else:
                for _ in range(node2loop[bfb[0]][2]):
                    bkp_path.append(g.segment_by_id(start).pos)
                    bkp_path.append(g.segment_by_id(end).pos)
                    bkp_path.append(g.segment_by_id(end).neg)
                    bkp_path.append(g.segment_by_id(start).neg)
        else:
            if node2pat[bfb[0]]:
                bkp_path.append(g.segment_by_id(end).neg)
                bkp_path.append(g.segment_by_id(start).neg)
            else:
                for _ in range(node2loop[bfb[0]][2]):
                    bkp_path.append(g.segment_by_id(end).neg)
                    bkp_path.append(g.segment_by_id(start).neg)
                    bkp_path.append(g.segment_by_id(start).pos)
                    bkp_path.append(g.segment_by_id(end).pos)

        i = 1
        while i < len(bfb):
            node = bfb[i]
            if node2pat[node]:
                start, end = node2pat[node][0], node2pat[node][1]
                last = bkp_path[-1]
                if last.id == start and last.dir == "-":
                    bkp_path.append(g.segment_by_id(start).pos)
                    bkp_path.append(g.segment_by_id(end).pos)
                elif last.id == end and last.dir == "+":
                    bkp_path.append(g.segment_by_id(end).neg)
                    bkp_path.append(g.segment_by_id(start).neg)
                else:
                    break
            elif node2loop[node]:
                start, end = node2loop[node][0], node2loop[node][1]
                v1 = g.segment_by_id(start).neg
                v2 = g.segment_by_id(end).pos
                N = len(bkp_path)
                # find the latest parity-valid anchor (LGM.cpp:3591-3603)
                k = _rfind_idx(bkp_path, v1, N)
                while k != -1 and (
                    k % 2 == 0
                    or (k < N - 2 and bkp_path[k - 1].id < bkp_path[k + 2].id)
                ):
                    k = _rfind_idx(bkp_path, v1, k)
                use_v1 = k != -1
                if not use_v1:
                    k = _rfind_idx(bkp_path, v2, N)
                    while k != -1 and (
                        k % 2 == 0
                        or (k < N - 2 and bkp_path[k - 1].id > bkp_path[k + 2].id)
                    ):
                        k = _rfind_idx(bkp_path, v2, k)
                if k == -1:
                    break
                cn = node2loop[node][2]
                loop: List[Vertex] = []
                if use_v1:
                    for _ in range(cn):
                        loop.append(g.segment_by_id(start).pos)
                        loop.append(g.segment_by_id(end).pos)
                        loop.append(g.segment_by_id(end).neg)
                        loop.append(g.segment_by_id(start).neg)
                    bkp_path[k] = g.segment_by_id(start).neg
                    if k + 1 < len(bkp_path):
                        bkp_path[k + 1] = g.segment_by_id(start).pos
                else:
                    for _ in range(cn):
                        loop.append(g.segment_by_id(end).neg)
                        loop.append(g.segment_by_id(start).neg)
                        loop.append(g.segment_by_id(start).pos)
                        loop.append(g.segment_by_id(end).pos)
                    bkp_path[k] = g.segment_by_id(end).pos
                    if k + 1 < len(bkp_path):
                        bkp_path[k + 1] = g.segment_by_id(end).neg
                bkp_path[k + 1 : k + 1] = loop
            i += 1

        imperfect_fbi(g, bkp_path, inversions)
        if i == len(bfb):
            last_invalid = False
            if not path:
                path = expand_breakpoint_path(g, bkp_path)
            if print_all:
                temp = expand_breakpoint_path(g, bkp_path)
                if out is not None:
                    out.write(format_bfb(temp) + "\n")
            else:
                if out is not None:
                    out.write(format_bfb(path) + "\n")
                return path, False, True
        else:
            last_invalid = True
    return path, last_invalid, False
