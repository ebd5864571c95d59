"""Query type `aggregate`: `ClusteredJoin.aggregate`, SUM(Pr * Ps) mod 2^32.

Its inputs are the input pairs as they are made, each side one
`Relation` of its keys and payloads; it draws nothing more from the seed."""

from typing import Callable, Dict, List

from joinbench import reference


class Aggregate:
    """SUM(Pr * Ps) mod 2^32: every query's answer is compared."""

    # the limit of each number compared: 0, an exact comparison
    limits = {"wrong_answers": 0}

    def __init__(self, cell, seed: int):
        self.answers: List[tuple] = []
        self.failed = 0

    def inputs(self, pairs, device) -> List[tuple]:
        from icde2019_gpu_join_tpu_torch.relation import Relation
        return [(Relation(rk, rp), Relation(sk, sp)) for rk, rp, sk, sp in pairs]

    def program(self, engine) -> Callable:
        return lambda r, s: engine.aggregate(r, s).aggregate

    def control(self, payload_bits: int) -> Callable:
        return lambda r, s: reference.aggregate(r.keys, r.payload, s.keys,
                                                s.payload, payload_bits)

    def record(self, i: int, pair: int, answer) -> None:
        self.answers.append((pair, answer))

    def judge(self, pairs) -> Dict[str, int]:
        expect = [reference.aggregate(*p) for p in pairs]
        self.failed = sum(a != expect[p] for p, a in self.answers)
        self.compared = f"{len(self.answers)} sums"
        return {"wrong_answers": self.failed}
