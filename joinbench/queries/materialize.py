"""Query type `materialize`: `ClusteredJoin.materialize`, the matched
(Pr, Ps) pairs into a ring of `capacity_per_s_row` (a key of the mix) slots
for each row of S.

Its inputs are the input pairs as they are made, each side one
`Relation` of its keys and payloads; it draws nothing more from the seed."""

from typing import Callable, Dict, List

import torch

from joinbench import reference


class Materialize:
    """Matched (Pr, Ps) pairs into a ring of capacity slots. Every query's
    output is compared whole, as a multiset of its slots' pairs, the empty
    slots as (0, 0): its count, its number of slots and its two sums
    (`reference.checksum`), taken on the device as the answer is recorded,
    outside the window's clock."""

    # the limit of each number compared: 0, an exact comparison
    limits = {"wrong_answers": 0}

    def __init__(self, cell, seed: int):
        self.capacity = int(cell.mix["capacity_per_s_row"] * cell.config["n_s"])
        self.answers: List[tuple] = []
        self.failed = 0

    def inputs(self, pairs, device) -> List[tuple]:
        from icde2019_gpu_join_tpu_torch.relation import Relation
        return [(Relation(rk, rp), Relation(sk, sp)) for rk, rp, sk, sp in pairs]

    def program(self, engine) -> Callable:
        def call(r, s):
            res = engine.materialize(r, s, capacity=self.capacity)
            return res.count, res.pairs
        return call

    def control(self, payload_bits: int) -> Callable:
        def call(r, s):
            n, packed = reference.pairs(r.keys, r.payload, s.keys, s.payload,
                                        payload_bits)
            out = torch.zeros(self.capacity, dtype=torch.int64,
                              device=packed.device)
            out[:n] = packed[:self.capacity]
            return n, ((out >> 32).to(torch.int32), out.to(torch.int32))
        return call

    def record(self, i: int, pair: int, answer) -> None:
        count, (out_r, out_s) = answer
        self.answers.append((pair, int(count), int(out_r.shape[0]),
                             reference.checksum(out_r, out_s)))

    def judge(self, pairs) -> Dict[str, int]:
        expect = []
        for rk, rp, sk, sp in pairs:
            n, packed = reference.pairs(rk, rp, sk, sp)
            if n > self.capacity:
                raise ValueError("the pairs check needs the join's output to "
                                 "fit the ring: a lap overwrites matches")
            want = torch.zeros(self.capacity, dtype=torch.int64,
                               device=packed.device)
            want[:n] = packed
            del packed
            expect.append((n, self.capacity, reference.fold(want)))
            del want
        counts = sum(a[1:3] != expect[a[0]][:2] for a in self.answers)
        sums = sum(a[3] != expect[a[0]][2] for a in self.answers)
        self.failed = sum(a[1:] != expect[a[0]] for a in self.answers)
        self.compared = (f"{len(self.answers)} outputs ({counts} with a wrong "
                         f"count or size, {sums} with wrong pair sums)")
        return {"wrong_answers": self.failed}
