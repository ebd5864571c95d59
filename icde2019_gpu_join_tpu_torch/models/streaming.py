"""Streaming-probe join: build side resident, probe side streamed from host.

Port of `icde2019_gpu_join_tpu/models/streaming.py`, the analog of
outOfGPU_Join3_payload (reference src/hash_join_clustered_probe.cu:
1684-1984). R is sorted once and stays on the device; S lives in host memory
and is cut into segments (S_segment_size = min(CHUNK_SIZE, n/4), :1697) that
flow through a double-buffered stage -> upload -> sort -> banded-probe
pipeline.

The reference builds the overlap with CUDA streams and events, and so does
the port (`utils/placement.Uploader`): two staging slots in pinned host
memory, filled by the threaded staging copy (`datagen.staging_copy`, the
analog of the NUMA staging gather, src/partition-primitives.cu:235-253);
each slot's upload runs on a copy stream and records an event; the compute
stream waits on that event before it sorts the segment; and the host waits
on a slot's last event before it stages the slot again (the reference's
cudaEventSynchronize on the S-slot event, :1559-1575). Segment k's sort
is queued, then segment k + 1 is staged and its upload issued, then segment
k is probed: the card sorts while the host stages, and the copy engine works
while the probe runs. Unlike the JAX pipeline, the probe itself reads the
host once per segment (its round histogram, `ops/band_join.
_probe_schedule`), so the host follows the device segment by segment.

Segment results accumulate on the device (sums mod 2^32 are associative and
commutative, so segmentation does not change the aggregate); one host read
at the end.
"""

from __future__ import annotations

from typing import Optional

import torch

from icde2019_gpu_join_tpu_torch import datagen
from icde2019_gpu_join_tpu_torch.config import EngineConfig
from icde2019_gpu_join_tpu_torch.models.joins import JoinResult
from icde2019_gpu_join_tpu_torch.ops.band_join import (banded_probe,
                                                       resolve_sort_impl,
                                                       sort_by_key)
from icde2019_gpu_join_tpu_torch.ops.bits import wrap_i32
from icde2019_gpu_join_tpu_torch.relation import Relation
from icde2019_gpu_join_tpu_torch.utils.placement import (Uploader, host_numpy,
                                                         pinned_empty)
from icde2019_gpu_join_tpu_torch.utils.timing import PhaseTimer


def segment_rows_for(n_s: int, config: EngineConfig) -> int:
    """Rows per streamed segment: `config.segment_rows`, else
    max(1, min(2^27, ceil(n_s / 4)))."""
    return config.segment_rows or max(1, min(1 << 27, -(-n_s // 4)))


def streaming_join_aggregate(r: Relation, s: Relation,
                             config: Optional[EngineConfig] = None,
                             device="cuda") -> JoinResult:
    """SUM(Pr*Ps) with S streamed in segments to `device`. `s` may lie in
    host memory (the oversized case) or on the card, which is read back
    first; R is moved to `device` and sorted once there."""
    config = config or EngineConfig()
    device = torch.device(device)
    timer = PhaseTimer()
    n_s = s.num_rows
    seg = segment_rows_for(n_s, config)
    w = config.band_window_blocks
    impl = resolve_sort_impl(config.sort_impl)

    with timer.phase("build_sort", bytes_moved=16 * r.num_rows,
                     rows=r.num_rows) as out:
        r_sv, r_p = sort_by_key(r.keys.to(device), r.payload.to(device), impl)
        out["result"] = r_sv

    s_keys_host = host_numpy(s.keys)
    s_pay_host = host_numpy(s.payload)
    up = Uploader(device)
    # two slots: one upload stays in flight while the next segment is
    # staged; a short tail is padded in place (key -1, payload 0 add nothing)
    stage = [(pinned_empty(seg, device), pinned_empty(seg, device))
             for _ in range(2)]
    last_copy = [None, None]

    def put(lo: int, hi: int, slot: int):
        if last_copy[slot] is not None:
            last_copy[slot].synchronize()   # the slot's copy has left it
        sk, sp = stage[slot]
        datagen.staging_copy(sk.numpy()[: hi - lo], s_keys_host[lo:hi])
        datagen.staging_copy(sp.numpy()[: hi - lo], s_pay_host[lo:hi])
        if hi - lo < seg:
            sk[hi - lo:] = -1
            sp[hi - lo:] = 0
        buf, last_copy[slot] = up.put(sk, sp)
        return buf, last_copy[slot]

    total = torch.zeros((), dtype=torch.int64, device=device)
    starts = list(range(0, n_s, seg))
    with timer.phase("stream", bytes_moved=16 * n_s, rows=n_s) as out:
        next_buf = put(0, min(seg, n_s), 0)
        for i, lo in enumerate(starts):
            (sk, sp), copied = next_buf
            up.wait(copied)
            # segment k's sort is queued first, so the card sorts while the
            # host stages k + 1; the probe reads the host, so it comes after
            s_sv, s_p = sort_by_key(sk, sp, impl)
            del sk, sp
            if i + 1 < len(starts):   # stage and upload k + 1 before probe k
                nlo = starts[i + 1]
                next_buf = put(nlo, min(nlo + seg, n_s), (i + 1) % 2)
            total.add_(banded_probe(r_sv, r_p, s_sv, s_p, w, "mul"))
            del s_sv, s_p
        out["result"] = total
    return JoinResult(aggregate=int(wrap_i32(total)), timer=timer)
