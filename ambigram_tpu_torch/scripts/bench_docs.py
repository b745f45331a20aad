"""Regenerate the port's benchmark block in README.md from the output of
the port's bench, so the published numbers cannot drift from a run.

Port of ambigram_tpu/scripts/bench_docs.py. Usage:

    python -m ambigram_tpu_torch.bench > bench_out.txt 2>&1   # on the card
    python -m ambigram_tpu_torch.scripts.bench_docs bench_out.txt [--readme README.md]

The input is scanned for the bench's JSON metric lines (one per metric),
as the JAX script scans them. Where the JAX script rewrites the
`BENCH:BEGIN` blocks of README.md and docs/ARCHITECTURE.md (the JAX
package's numbers) and archives a snapshot under docs/, this one
replaces only the block between its own markers, `PORT-BENCH:BEGIN` and
`PORT-BENCH:END`, in README.md's section on the port, and writes nothing
else. Every number in the block carries the card it was measured on:
the bench's result line names the card and its power limit, and each
metric line takes the card of the result line before it. The block
depends on the input alone, so a rerun on the same input leaves the
file byte-identical.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Dict, List, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BEGIN = "<!-- PORT-BENCH:BEGIN (generated by ambigram_tpu_torch.scripts.bench_docs — do not edit by hand) -->"
END = "<!-- PORT-BENCH:END -->"
PRIMARY = "bfb_candidates_scored_per_sec_per_chip"


def extract_metrics(text: str) -> Dict[str, dict]:
    """All metric JSON objects found in the text, keyed by their "metric"
    field (the JAX script's rule: raw bench output, or a BENCH_r*.json artifact
    whose "tail" holds the output lines). Each metric line gets a
    "card" key, the "card" of the last result line before it, unless it
    has one."""
    metrics: Dict[str, dict] = {}
    try:
        doc = json.loads(text)
        if isinstance(doc, dict):
            if "metric" in doc:
                metrics[doc["metric"]] = doc
            if isinstance(doc.get("parsed"), dict) and "metric" in doc["parsed"]:
                metrics[doc["parsed"]["metric"]] = doc["parsed"]
            tail = doc.get("tail")
            text = tail if isinstance(tail, str) else ""
    except ValueError:
        pass
    card = metrics.get(PRIMARY, {}).get("card")
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict) and "metric" in obj:
            if obj["metric"] == PRIMARY:
                card = obj.get("card", card)
            elif card is not None:
                obj.setdefault("card", card)
            metrics[obj["metric"]] = obj
    return metrics


def _on(m: dict) -> str:
    return "on %s" % m["card"]


def render_readme_block(m: Dict[str, dict]) -> str:
    """The port's block: each metric present, headed by the card (name,
    power limit) it was measured on. A metric without a card is left out:
    a number must not be published without its card."""
    out: List[str] = [BEGIN, ""]
    m = {k: v for k, v in m.items() if v.get("card")}
    prim = m.get(PRIMARY)
    if prim:
        blk = prim.get("int8", {})
        out += [
            "K2 chain (`python -m ambigram_tpu_torch.bench`, %s), kernel path `%s`:" % (_on(prim), prim.get("kernel_path")),
            "",
            "| candidates/s | vs single-core C++ | int8 TOPS | of peak |",
            "|---|---|---|---|",
            "| %s | %s | %s | %s%% of %s |"
            % (prim.get("value"), prim.get("vs_baseline"), blk.get("achieved_tops"), blk.get("utilization_pct"),
               blk.get("peak_int8_tops")),
            "",
        ]
    suite = m.get("suite_seconds_large_cases")
    if suite:
        out += [
            "Suite (%s, %s):" % (suite.get("cases"), _on(suite)),
            "",
            "| mode | seconds | eps_sum | solved |",
            "|---|---|---|---|",
        ]
        for mode in ("device", "auto", "exact"):
            leg = suite.get(mode)
            if leg:
                out.append("| %s | %s | %s | %s/%s |" % (mode, leg["seconds"], leg["eps_sum"], leg["solved"],
                                                      suite.get("n_cases", "?")))
        out.append("")
    batch = m.get("batch_throughput_cases_per_min")
    if batch:
        bd, se = batch.get("batch_device", {}), batch.get("serial_exact", {})
        out += [
            "Batch (%s, %s; warm-up %s s apart):" % (batch.get("cases"), _on(batch), batch.get("warmup_seconds")),
            "",
            "| pipeline | seconds | cases/min | solved | eps_sum |",
            "|---|---|---|---|---|",
            "| `run_bfb_many` (device) | %s | %s | %s | %s |"
            % (bd.get("seconds"), bd.get("cases_per_min"), bd.get("solved"), bd.get("eps_sum")),
            "| serial exact loop | %s | %s | %s | %s |"
            % (se.get("seconds"), se.get("cases_per_min"), se.get("solved"), se.get("eps_sum")),
            "",
        ]
    proxy = m.get("scaling_proxy_overhead")
    if proxy:
        out += [
            "Scaling proxy (the stacked case-sharded pass over logical meshes of one card, %s):" % _on(proxy),
            "",
            "| mesh | seconds | first run | cases/min | overhead vs mesh1 | eps_sum | solved |",
            "|---|---|---|---|---|---|---|",
        ]
        for name in sorted((k for k in proxy if re.fullmatch(r"mesh\d+", k)), key=lambda k: int(k[4:])):
            leg = proxy[name]
            out.append(
                "| %s | %s | %s | %s | %s%% | %s | %s/%s |"
                % (leg.get("mesh"), leg.get("seconds"), leg.get("compile_plus_first_run_seconds"),
                   leg.get("cases_per_min"), leg.get("sharding_overhead_pct_vs_mesh1"), leg.get("eps_sum"),
                   leg.get("solved"), leg.get("n_programs"))
            )
        out.append("")
    big = m.get("large_s_device_vs_exact")
    if big:
        out += [
            "Large-S legs (`AMBIGRAM_BENCH_SUITE=big`, %s):" % _on(big),
            "",
            "| case | vars | device (s / eps) | exact 60 s (s / eps) |",
            "|---|---|---|---|",
        ]
        for name in sorted(k for k in big if re.fullmatch(r"S\d+", k)):
            leg = big[name]
            out.append("| %s | %s | %s / %s | %s / %s |" % (name, leg.get("vars"), leg["device"]["seconds"],
                                                         leg["device"]["eps"], leg["exact_60s"]["seconds"],
                                                         leg["exact_60s"]["eps"]))
        out.append("")
    sc = m.get("sc_batch_throughput")
    if sc:
        b, se = sc.get("batch", {}), sc.get("serial", {})
        out += [
            "Single-cell batch (`AMBIGRAM_BENCH_SUITE=sc`, %s, %s):" % (sc.get("cases"), _on(sc)),
            "",
            "| pipeline | seconds | samples/min | solved |",
            "|---|---|---|---|",
            "| `run_sc_bfb_many` | %s | %s | %s |" % (b.get("seconds"), b.get("samples_per_min"), b.get("solved")),
            "| serial loop | %s | %s | %s |" % (se.get("seconds"), se.get("samples_per_min"), se.get("solved")),
            "",
        ]
    out.append(END)
    return "\n".join(out)


def replace_block(path: str, new_block: str) -> bool:
    with open(path) as f:
        text = f.read()
    pattern = re.compile(re.escape(BEGIN) + r".*?" + re.escape(END), re.S)
    if not pattern.search(text):
        return False
    new_text = pattern.sub(lambda _m: new_block, text)
    if new_text != text:
        with open(path, "w") as f:
            f.write(new_text)
    return True


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Regenerate the port's benchmark block in README.md.")
    ap.add_argument("bench_output", help="the port bench's output (stdout and stderr)")
    ap.add_argument("--readme", default=os.path.join(_REPO, "README.md"))
    args = ap.parse_args(argv)
    with open(args.bench_output) as f:
        metrics = extract_metrics(f.read())
    if not metrics:
        print("no metric lines found in %s" % args.bench_output, file=sys.stderr)
        return 1
    if not any(v.get("card") for v in metrics.values()):
        print("no metric line names its card (the bench's result line carries it)", file=sys.stderr)
        return 1
    ok = replace_block(args.readme, render_readme_block(metrics))
    print("%s: port bench block %s" % (args.readme, "updated" if ok else "MARKERS MISSING"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
