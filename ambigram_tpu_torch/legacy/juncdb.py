"""Breakpoint evidence database (reference JunctionDB/Record).

Parity targets:
- JunctionDB::readDB / insertRecord / findRecord
  (src/JunctionDB.cpp:77-240)
- Record entries with forward/backward support
  (src/Record.cpp:9-97)

TSV format (`.junc`): header line then
    chrom_5p  pos_5p  strand_5p  chrom_3p  pos_3p  strand_3p  count

Each junction registers FOUR records: the 5p breakpoint (forward entry
to the 3p side) and its complement (backward entry to the complemented
3p side), plus the 3p breakpoint (backward entry) and its complement
(forward entry). UUIDs are "chrom:+pos" for '+' strand, "chrom:-pos"
for '-'.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class Entry:
    chrom: str
    pos: int
    strand: str
    support: int
    is_complement: bool


def _uuid(chrom: str, pos: int, strand: str) -> str:
    return "%s:%d" % (chrom, pos if strand == "+" else -pos)


class Record:
    def __init__(self, chrom: str, pos: int, strand: str):
        self.chrom = chrom
        self.pos = pos
        self.strand = strand
        self._forward: Dict[str, Entry] = {}
        self._backward: Dict[str, Entry] = {}

    @property
    def forward_entries(self) -> List[Entry]:
        return [self._forward[k] for k in sorted(self._forward)]

    @property
    def backward_entries(self) -> List[Entry]:
        return [self._backward[k] for k in sorted(self._backward)]

    def insert_forward(self, chrom: str, pos: int, strand: str, support: int, is_complement: bool) -> None:
        key = _uuid(chrom, pos, strand)
        if key in self._forward:
            self._forward[key].support += support
        else:
            self._forward[key] = Entry(chrom, pos, strand, support, is_complement)

    def insert_backward(self, chrom: str, pos: int, strand: str, support: int, is_complement: bool) -> None:
        key = _uuid(chrom, pos, strand)
        if key in self._backward:
            self._backward[key].support += support
        else:
            self._backward[key] = Entry(chrom, pos, strand, support, is_complement)

    def find_forward_entry(self, chrom: str, pos: int, strand: str) -> Optional[Entry]:
        return self._forward.get(_uuid(chrom, pos, strand))

    def find_backward_entry(self, chrom: str, pos: int, strand: str) -> Optional[Entry]:
        return self._backward.get(_uuid(chrom, pos, strand))


class JunctionDB:
    def __init__(self, source=None):
        self._records: Dict[str, Record] = {}
        if isinstance(source, str):
            self.read_db(source)
        elif source is not None:
            # a list of model Junctions (JunctionDB.cpp:34-66)
            for junc in source:
                if junc.weight.copy_num > 0:
                    s, t = junc.source, junc.target
                    sd, td = junc.source_dir, junc.target_dir
                    pos5 = s.end if sd == "+" else s.start
                    pos3 = t.start if td == "+" else t.end
                    # NB reference casts coverage to char for support
                    support = int(junc.weight.coverage) % 256
                    self.insert_record(s.chrom, pos5, sd, t.chrom, pos3, td, support)

    @property
    def records(self) -> List[Record]:
        return [self._records[k] for k in sorted(self._records)]

    def read_db(self, path: str) -> None:
        with open(path, "r") as f:
            lines = f.read().splitlines()
        for line in lines[1:]:
            if not line:
                continue
            tok = line.split("\t")
            chrom5, pos5, strand5 = tok[0], int(tok[1]), tok[2][0]
            chrom3, pos3, strand3 = tok[3], int(tok[4]), tok[5][0]
            support = int(tok[6])
            if support > 0:
                self.insert_record(chrom5, pos5, strand5, chrom3, pos3, strand3, support)

    def _record(self, chrom: str, pos: int, strand: str) -> Record:
        key = _uuid(chrom, pos, strand)
        if key not in self._records:
            self._records[key] = Record(chrom, pos, strand)
        return self._records[key]

    def insert_record(
        self,
        chrom5: str,
        pos5: int,
        strand5: str,
        chrom3: str,
        pos3: int,
        strand3: str,
        support: int,
    ) -> None:
        flip = lambda s: "-" if s == "+" else "+"
        # 5p record + its complement
        self._record(chrom5, pos5, strand5).insert_forward(chrom3, pos3, strand3, support, False)
        self._record(chrom5, pos5, flip(strand5)).insert_backward(
            chrom3, pos3, flip(strand3), support, True
        )
        # 3p record + its complement
        self._record(chrom3, pos3, strand3).insert_backward(chrom5, pos5, strand5, support, False)
        self._record(chrom3, pos3, flip(strand3)).insert_forward(
            chrom5, pos5, flip(strand5), support, True
        )

    def find_record(self, chrom: str, pos: int, strand: str) -> Optional[Record]:
        return self._records.get(_uuid(chrom, pos, strand))

    def find_records(self, chrom: str, pos: int, strand: str) -> List[Record]:
        rec = self.find_record(chrom, pos, strand)
        return [rec] if rec is not None else []
