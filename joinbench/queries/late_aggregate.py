"""Query type `late_aggregate`: `ClusteredJoin.late_aggregate`, a join with
late materialization (the reference's `outOfGPU_Join_payload_var`,
src/hash_join_clustered_probe.cu:542-708).

Each relation's payload is its row id, 0 .. n - 1 in table order, and each
side carries extra int32 columns, `r_cols` and `s_cols` of them (keys of the
configuration that only this file reads). The columns are drawn over the
whole int32 range from a generator of their own, seeded with the run's
seed XOR 2^62, so that no run's input pairs share its stream. Each match
adds the row sums of both sides: SUM over matches of (R's row sum + S's row
sum) mod 2^32.

The plain reference, `late_sum`, takes only these inputs: each side's row
sums exact in int64, a block of rows at a time, wrapped to int32; then
`reference.aggregate` twice, once with S's payloads 1 and once with R's, so
that SUM(Rsum + Ssum) = SUM(Rsum * 1) + SUM(1 * Ssum), mod 2^32. With the
payloads row ids in table order, row i's sum is the sum at row id i, as
the program reads it. The control narrows every column to its low 16 bits
before the sums."""

from typing import Callable, Dict, List

import torch

from joinbench import datagen, reference

SALT = 1 << 62
# rows summed at a time, which bounds the int64 transient
_ROWS = 1 << 25


def row_sums(cols: torch.Tensor, payload_bits: int = 32) -> torch.Tensor:
    """Each row's sum of `cols` [n, c] mod 2^32 as int32 (0 with no
    columns), every column narrowed to `payload_bits` first."""
    out = torch.empty(cols.shape[0], dtype=torch.int32, device=cols.device)
    for start in range(0, cols.shape[0], _ROWS):
        block = reference.narrow(cols[start:start + _ROWS], payload_bits)
        v = block.to(torch.int64).sum(1)
        out[start:start + _ROWS] = ((v + (1 << 31)) % (1 << 32)
                                    - (1 << 31)).to(torch.int32)
    return out


def late_sum(r_keys, r_cols, s_keys, s_cols, payload_bits: int = 32) -> int:
    """SUM over key matches of (R's row sum + S's row sum) mod 2^32, as a
    signed int32 value; row i of each side's columns belongs to its key i."""
    rs, ss = row_sums(r_cols, payload_bits), row_sums(s_cols, payload_bits)
    return reference.to_i32(
        reference.aggregate(r_keys, rs, s_keys, torch.ones_like(ss))
        + reference.aggregate(r_keys, torch.ones_like(rs), s_keys, ss))


class LateAggregate:
    """SUM(Rsum + Ssum) mod 2^32 over matches: every query's answer is
    compared."""

    # the limit of each number compared: 0, an exact comparison
    limits = {"wrong_answers": 0}

    def __init__(self, cell, seed: int):
        self.widths = int(cell.config["r_cols"]), int(cell.config["s_cols"])
        self.seed = seed
        self.cols: List[tuple] = []
        self.answers: List[tuple] = []
        self.failed = 0

    def inputs(self, pairs, device) -> List[tuple]:
        """For each pair: R and S as `Relation(keys)`, whose payloads are
        row ids, and their columns [n_r, r_cols] and [n_s, s_cols]."""
        from icde2019_gpu_join_tpu_torch.relation import Relation
        g = datagen.generator(self.seed ^ SALT, device)
        out = []
        for rk, _, sk, _ in pairs:
            rc, sc = (datagen.payloads(k.shape[0] * w, g, device).view(k.shape[0], w)
                      for k, w in zip((rk, sk), self.widths))
            self.cols.append((rc, sc))
            out.append((Relation(rk), Relation(sk), rc, sc))
        return out

    def program(self, engine) -> Callable:
        return lambda r, s, rc, sc: engine.late_aggregate(r, s, rc, sc).aggregate

    def control(self, payload_bits: int) -> Callable:
        return lambda r, s, rc, sc: late_sum(r.keys, rc, s.keys, sc, payload_bits)

    def record(self, i: int, pair: int, answer) -> None:
        self.answers.append((pair, answer))

    def judge(self, pairs) -> Dict[str, int]:
        expect = [late_sum(rk, rc, sk, sc)
                  for (rk, _, sk, _), (rc, sc) in zip(pairs, self.cols)]
        self.failed = sum(a != expect[p] for p, a in self.answers)
        self.compared = f"{len(self.answers)} late sums"
        return {"wrong_answers": self.failed}
