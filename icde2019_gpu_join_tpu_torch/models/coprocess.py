"""Host + device co-processing join: the build side exceeds device memory.

Port of `icde2019_gpu_join_tpu/models/coprocess.py`, the analog of
outOfGPU_Join2_payload (reference src/hash_join_clustered_probe.cu:
1000-1680): the host pre-partitions both relations into 2^OUTER_BITS coarse
partitions (reference LOG_PARTS_OUTER = 4, src/partition-primitives.cuh:
38-42) with the native OpenMP partitioner, a knapsack scheduler groups the
build partitions into device-resident batches (groupOptimal2,
src/partition-primitives.cu:381-469), and each (R_p, S_p) pair is joined on
the device by the banded join. Partial aggregates sum mod 2^32, so the
batching order does not matter.

The pipeline (the reference's event-chained streams, :1400-1622), with the
copies on a copy stream (`utils/placement.Uploader`) and one event per
upload that the compute stream waits on:

  * R batch staging: all of batch b's R partitions are uploaded as a group;
    batch b + 1's uploads are issued when batch b's first pair starts, so R
    transfer rides behind compute, and older batches are dropped (at most
    two batches of R are alive on the device; the PARTS_RESIDENT slot
    analog).
  * The S host partition runs after batch 0's R uploads are issued: the
    host partitioning of the probe side overlaps the build side's transfers
    (reference :1503-1508).
  * S pair double buffering: pair k + 1's upload is issued before pair k's
    join (the event_id % 2 S-slot analog, :1559-1609).

On a card the host partitions land in pinned buffers
(`datagen.host_partition(..., out=...)` into the `.numpy()` views of pinned
tensors), so every slice upload is asynchronous; a copy from pageable memory
would be synchronous with the host.

Padding: none. The JAX module pads each partition slice to a power of two of
at least 2^10 rows (`_quantize_host`) so that every pair hits one of a few
jit shapes; torch compiles nothing per shape, so the port uploads each slice
as it lies and `sort_by_key` pads it to a multiple of 128 rows on the
device. The sentinels add nothing either way, so the aggregate is JAX's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from icde2019_gpu_join_tpu_torch import datagen
from icde2019_gpu_join_tpu_torch.config import EngineConfig
from icde2019_gpu_join_tpu_torch.models.joins import JoinResult
from icde2019_gpu_join_tpu_torch.ops.band_join import (banded_join_aggregate,
                                                       resolve_sort_impl)
from icde2019_gpu_join_tpu_torch.ops.bits import wrap_i32
from icde2019_gpu_join_tpu_torch.relation import Relation
from icde2019_gpu_join_tpu_torch.utils.placement import (Uploader, host_numpy,
                                                         pinned_empty)
from icde2019_gpu_join_tpu_torch.utils.timing import PhaseTimer

OUTER_BITS = 4          # LOG_PARTS_OUTER analog
PARTS_RESIDENT = 5      # device-resident build slots (partition-primitives.cuh:42)


def host_partition_pinned(keys: np.ndarray, pays: np.ndarray, first_bit: int,
                          device="cuda"):
    """`datagen.host_partition` at OUTER_BITS into host tensors, pinned when
    `device` is a card. Returns (keys', pays', counts, offsets): two int32
    tensors and two int64 numpy arrays."""
    ok, op = pinned_empty(keys.size, device), pinned_empty(keys.size, device)
    _, _, counts, offsets = datagen.host_partition(
        keys, pays, OUTER_BITS, first_bit, out=(ok.numpy(), op.numpy()))
    return ok, op, counts, offsets


def build_batches(cnt_r: np.ndarray, n_r: int) -> np.ndarray:
    """The knapsack batch of each build partition, over gains = the fraction
    of resident capacity each consumes (about 1 a uniform partition), as in
    groupOptimal2."""
    avg = max(1, n_r >> OUTER_BITS)
    return datagen.knapsack_batches(cnt_r.astype(np.float64) / avg,
                                    PARTS_RESIDENT)


def pair_schedule(batch_of: np.ndarray, off_r: np.ndarray, off_s: np.ndarray):
    """The batch-ordered pairs (batch, partition, s_lo, s_hi) whose R and S
    sides both hold rows."""
    schedule = []
    for b in range(int(batch_of.max()) + 1 if batch_of.size else 0):
        for p in np.nonzero(batch_of == b)[0]:
            s_lo, s_hi = int(off_s[p]), int(off_s[p + 1])
            if off_r[p + 1] > off_r[p] and s_hi > s_lo:
                schedule.append((b, int(p), s_lo, s_hi))
    return schedule


def coprocess_join_aggregate(r: Relation, s: Relation,
                             config: Optional[EngineConfig] = None,
                             device="cuda") -> JoinResult:
    """SUM(Pr*Ps) of relations in host memory (the oversized case; a
    relation on the card is read back first), joined pair by pair on
    `device`."""
    config = config or EngineConfig()
    device = torch.device(device)
    timer = PhaseTimer()
    fb = config.radix.first_bit
    sort_impl = resolve_sort_impl(config.sort_impl)
    rk, rp = host_numpy(r.keys), host_numpy(r.payload)
    sk, sp = host_numpy(s.keys), host_numpy(s.payload)

    with timer.phase("host_partition_R", bytes_moved=16 * rk.size,
                     rows=rk.size):
        rk_p, rp_p, cnt_r, off_r = host_partition_pinned(rk, rp, fb, device)

    batch_of = build_batches(cnt_r, rk.size)
    num_batches = int(batch_of.max()) + 1 if batch_of.size else 0
    up = Uploader(device)

    def stage_r(b: int):
        """Issue batch b's R uploads: ({partition: (keys, pays)}, event)."""
        parts = [int(p) for p in np.nonzero(batch_of == b)[0]
                 if off_r[p + 1] > off_r[p]]
        flat, event = up.put(*(t[off_r[p]:off_r[p + 1]] for p in parts
                               for t in (rk_p, rp_p)))
        return {p: flat[2 * i: 2 * i + 2] for i, p in enumerate(parts)}, event

    # batch 0's R uploads go in flight before the S host partition runs
    r_staged = {0: stage_r(0)} if num_batches else {}

    with timer.phase("host_partition_S", bytes_moved=16 * sk.size,
                     rows=sk.size):
        sk_p, sp_p, _, off_s = host_partition_pinned(sk, sp, fb, device)

    schedule = pair_schedule(batch_of, off_r, off_s)
    total = torch.zeros((), dtype=torch.int64, device=device)
    with timer.phase("pairs", rows=rk.size + sk.size,
                     bytes_moved=8 * (rk.size + sk.size)) as out:
        staged_upto = 0
        s_next = (up.put(sk_p[schedule[0][2]:schedule[0][3]],
                         sp_p[schedule[0][2]:schedule[0][3]])
                  if schedule else None)
        for i, (b, p, _, _) in enumerate(schedule):
            # entering batch b: put batch b + 1's R uploads in flight and
            # drop older batches; the while also steps over batches with no
            # pair to schedule (an empty S side, or R partitions of gain 0)
            while staged_upto < min(b + 1, num_batches - 1):
                staged_upto += 1
                r_staged[staged_upto] = stage_r(staged_upto)
                r_staged.pop(staged_upto - 2, None)
            (s_keys, s_pays), s_copied = s_next
            if i + 1 < len(schedule):   # pair k + 1's upload before join k
                _, _, nlo, nhi = schedule[i + 1]
                s_next = up.put(sk_p[nlo:nhi], sp_p[nlo:nhi])
            parts, r_copied = r_staged[b]
            up.wait(r_copied)
            up.wait(s_copied)
            total += banded_join_aggregate(
                *parts[p], s_keys, s_pays,
                window_blocks=config.band_window_blocks, sort_impl=sort_impl)
            del s_keys, s_pays
        out["result"] = total
    return JoinResult(aggregate=int(wrap_i32(total)), timer=timer)
