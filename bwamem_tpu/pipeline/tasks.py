"""Extension-task batches: the vector-machine analogue of the reference's
task/result wire formats (SURVEY.md §2.3/§2.4).

The FPGA receives one 256 KB byte-stream batch per PE array (4096 cache
lines: header words, 8-word task descriptors, then 4-bit packed base
payloads — decoded from sw_pe_array_task_parse.v / proc_element.v) and
returns dense 5-word result records.  A byte-stream is the right format
for a 32-bit streaming parser; it is the wrong format for a vector
machine.  The equivalent here is a fixed-shape struct-of-arrays
batch that lands in device memory as-is and is consumed by the kernel with
no parsing stage at all — `task_parse` (1963 lines of RTL) disappears
into the packing done here on the host.

Differences from the FPGA format, by design:
  * one task = ONE extension side.  The FPGA runs left then right
    sequentially inside a PE (proc_element.v:1597, the i=0/1 loop)
    because the right side's h0 is the left side's score; we split the
    sides into two batched phases instead (left batch -> h0 chain ->
    right batch), which keeps every lane busy.
  * queries for left extensions are pre-reversed by the caller (bwa does
    the same reversal on the host before ksw_extend).
  * capacity limits are configurable; defaults match the hardware
    (qlen<=255/side, tlen<=2047/side — SURVEY.md §2.3).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from bwamem_tpu import config


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class ExtendTaskBatch:
    """Struct-of-arrays batch of single-sided extension tasks.

    Shapes: query (B, QMAX) int8, target (B, TMAX) int8, all scalars (B,)
    int32.  B, QMAX, TMAX are padded (B to the kernel block multiple,
    QMAX/TMAX to lane multiples); padding tasks have qlen == 0.
    """

    query: np.ndarray
    target: np.ndarray
    qlen: np.ndarray
    tlen: np.ndarray
    h0: np.ndarray
    w: np.ndarray
    max_ins: np.ndarray
    max_del: np.ndarray
    task_id: np.ndarray   # opaque, echoed in results (descriptor d7 analogue)

    @property
    def size(self) -> int:
        return int(self.query.shape[0])

    @property
    def n_real(self) -> int:
        return int(np.sum(self.qlen > 0))

    def cells(self) -> int:
        """Upper-bound DP cell count (for GCUPS accounting): sum over tasks
        of tlen * min(qlen, 2*w+1) — the reference counts actually-computed
        band cells; this is the same bound used for its derived GCUPS."""
        bw = np.minimum(self.qlen, 2 * self.w + 1)
        return int(np.sum(self.tlen.astype(np.int64) * bw))


def pack_tasks(
    queries: list[np.ndarray],
    targets: list[np.ndarray],
    h0: np.ndarray,
    w: np.ndarray,
    max_ins: np.ndarray,
    max_del: np.ndarray,
    task_id: np.ndarray | None = None,
    qmax: int | None = None,
    tmax: int | None = None,
    batch_multiple: int = 8,
    lane_multiple: int = 128,
) -> ExtendTaskBatch:
    """Pack variable-length tasks into a fixed-shape SoA batch.

    qmax/tmax default to the batch maxima rounded up to `lane_multiple`
    (a vector width). The batch dimension is rounded up to
    `batch_multiple` with inert padding tasks.
    """
    n = len(queries)
    assert n == len(targets)
    qlens = np.array([len(q) for q in queries], np.int32)
    tlens = np.array([len(t) for t in targets], np.int32)
    if qmax is None:
        qmax = round_up(max(int(qlens.max(initial=1)), 1), lane_multiple)
    if tmax is None:
        tmax = round_up(max(int(tlens.max(initial=1)), 1), lane_multiple)
    assert qlens.max(initial=0) <= qmax and tlens.max(initial=0) <= tmax
    B = round_up(max(n, 1), batch_multiple)

    query = np.full((B, qmax), config.BASE_N, np.int8)
    target = np.full((B, tmax), config.BASE_N, np.int8)
    for i, (q, t) in enumerate(zip(queries, targets)):
        query[i, : len(q)] = q
        target[i, : len(t)] = t

    def pad(v, fill=0):
        out = np.full(B, fill, np.int32)
        out[:n] = v
        return out

    return ExtendTaskBatch(
        query=query,
        target=target,
        qlen=pad(qlens),
        tlen=pad(tlens),
        h0=pad(np.asarray(h0, np.int32)),
        w=pad(np.asarray(w, np.int32), fill=1),
        max_ins=pad(np.asarray(max_ins, np.int32), fill=1),
        max_del=pad(np.asarray(max_del, np.int32), fill=1),
        task_id=pad(
            np.asarray(task_id, np.int32) if task_id is not None
            else np.arange(n, dtype=np.int32)),
    )
