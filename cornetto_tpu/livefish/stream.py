"""Streaming read pipeline: host-side producer threads feeding fixed-shape
device batches — the moral successor of the reference's batch work pool
(reference: src/thread.c:48-156 work-stealing batch loop; here the "work"
is parse+pack on CPU overlapped with decide() on device, double-buffered
through a bounded queue)."""

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from cornetto_tpu.io.fasta import read_fastx
from cornetto_tpu.kernels.minimizer import encode_seq


@dataclass
class ReadBatch:
    ids: List[str]
    codes: np.ndarray   # (B, L) uint8, padded with 4 (N)
    count: int          # valid rows
    lengths: np.ndarray = None   # (B,) int32 true read lengths


def batches_from_fastq(path: str, batch: int, read_len: int
                       ) -> Iterator[ReadBatch]:
    """Pack the first `read_len` bases of each read (the adaptive-sampling
    chunk) into fixed (batch, read_len) blocks."""
    ids: List[str] = []
    codes = np.full((batch, read_len), 4, dtype=np.uint8)
    lens = np.zeros(batch, dtype=np.int32)
    n = 0
    for rec in read_fastx(path):
        c = encode_seq(rec.seq[:read_len])
        codes[n, :len(c)] = c
        lens[n] = len(c)
        ids.append(rec.name)
        n += 1
        if n == batch:
            yield ReadBatch(ids, codes, n, lens)
            ids = []
            codes = np.full((batch, read_len), 4, dtype=np.uint8)
            lens = np.zeros(batch, dtype=np.int32)
            n = 0
    if n:
        yield ReadBatch(ids, codes, n, lens)


class Prefetcher:
    """Producer thread + bounded queue so host packing overlaps device
    compute."""

    _DONE = object()

    def __init__(self, it: Iterator[ReadBatch], depth: int = 4):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._fill, args=(it,),
                                        daemon=True)
        self._err: Optional[BaseException] = None
        self._thread.start()

    def _fill(self, it):
        try:
            for b in it:
                self._q.put(b)
        except BaseException as e:  # propagate to consumer
            self._err = e
        finally:
            self._q.put(self._DONE)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                if self._err is not None:
                    raise self._err
                return
            yield item


def stream_decisions(engine, fastq_path: str, batch: int = 4096,
                     read_len: int = 450, out=None) -> Tuple[int, int]:
    """Run the decision engine over a FASTQ, writing
    `read_id\tdecision\tcontig\tpos\tnhits` rows.  Returns
    (n_reads, n_accepted).

    Fast path: single-line FASTQ + a packed-capable engine go through the
    native one-pass parse+encode+pack kernel (native/fastq_pack.c, ~3 Mr/s
    vs ~90k r/s for the Python chain) — the host stops being the
    end-to-end bottleneck.  Anything else (FASTA, multi-line records, no
    C toolchain) falls back to the tolerant Python path below."""
    import sys
    out = out or sys.stdout
    if hasattr(engine, "decide_packed"):
        from cornetto_tpu.native.fastq_pack import (NativeParseError,
                                                    iter_packed_batches)
        gen = iter_packed_batches(fastq_path, batch, read_len)
        try:
            # probe the first batch BEFORE any output: a non-FASTQ file is
            # detected here and falls back cleanly; a parse error later
            # (mid-file corruption) is a hard error, as it should be
            first = next(gen, None)
        except NativeParseError:
            first = gen = None
        if gen is not None:
            if first is None:
                return 0, 0
            return _stream_decisions_native(engine, first, gen,
                                            read_len, out)
    return _stream_decisions_py(engine, fastq_path, batch, read_len, out)


def _stream_decisions_native(engine, first, gen,
                             read_len: int, out) -> Tuple[int, int]:
    """Three-stage pipeline behind the dispatch thread: the Prefetcher
    thread parses+packs, the dispatch (this) thread only uploads+enqueues,
    a DRAIN thread blocks on the device readbacks, and a writer thread
    formats TSV natively (tsv_format.c, GIL released) — so uploads go
    back-to-back and readbacks never stall an upload."""
    import itertools
    # single-readback variant when the engine offers it (see
    # decision_core_packed_fused)
    decide = getattr(engine, "decide_packed_fused", engine.decide_packed)
    writer = _RowWriter(out, getattr(engine, "contig_names", None))
    dq: "queue.Queue" = queue.Queue(maxsize=4)
    _DONE = object()
    drain_err: List[BaseException] = []

    def _drain_loop():
        while True:
            item = dq.get()
            if item is _DONE:
                return
            if drain_err:
                continue        # swallow queue to unblock the producer
            try:
                writer.put(*_readback(item))
            except BaseException as e:
                drain_err.append(e)

    drain = threading.Thread(target=_drain_loop, daemon=True)
    drain.start()
    try:
        for pb in Prefetcher(itertools.chain([first], gen)):
            if pb.nmask is None:
                lens = pb.lengths
                if lens is not None and bool(
                        np.all(lens[:pb.count] == read_len)):
                    # all chunks full-length (the steady-state norm): skip
                    # the 4 B/read lengths upload; pad rows beyond count
                    # produce garbage decisions that are never emitted
                    lens = None
                res = decide(pb.packed, None, read_len, lengths=lens)
            else:
                # interior Ns: take the bitmap path.  The native kernel's
                # bitmap marks only real N bases; pad positions past each
                # read's length (packed as code 0) must also be masked, so
                # fold the length bound into the bitmap here.
                nm = pb.nmask.copy()
                pos = np.arange(nm.shape[1] * 8, dtype=np.int32)
                pad = (pos[None, :] >= pb.lengths[:, None])
                nm |= np.packbits(pad, axis=1,
                                  bitorder="little")[:, :nm.shape[1]]
                res = decide(pb.packed, nm, read_len)
            dq.put((pb, res))
            if drain_err:
                break
    finally:
        dq.put(_DONE)
        drain.join()
        writer.close()
    if drain_err:
        raise drain_err[0]
    return writer.total, writer.accepted


def _readback(entry):
    pb, res = entry
    if isinstance(res, tuple):
        # only the first 4 outputs feed the TSV; skip reading back the
        # hq/est2 coverage extras (each extra array is one more copy)
        return pb, tuple(np.asarray(x) for x in res[:4])
    from cornetto_tpu.livefish.decide import unpack_fused
    return pb, unpack_fused(np.asarray(res))   # fused (2, B) int32


class _RowWriter:
    """FIFO formatting+writing thread: keeps TSV formatting off the device
    dispatch thread.  Batches carrying a compact id blob format natively
    (tsv_format.c releases the GIL, ~10M rows/s); others take the Python
    row loop (byte-identical output, tested)."""

    _DONE = object()

    def __init__(self, out, names):
        import queue
        import threading
        from cornetto_tpu.native import tsv_format as _tf
        self._out = out
        self._names = names
        self._tf = _tf if _tf.available() else None
        self._ntable = _tf.NameTable(names) if self._tf else None
        self._q: "queue.Queue" = queue.Queue(maxsize=8)
        self.total = self.accepted = 0
        self._err = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def put(self, pb, arrs) -> None:
        if self._err is not None:
            raise self._err
        self._q.put((pb, arrs))

    def _run(self):
        try:
            while True:
                item = self._q.get()
                if item is self._DONE:
                    return
                pb, arrs = item
                d, best, est, nhits = arrs[:4]
                if self._tf is not None and \
                        getattr(pb, "id_blob", None) is not None:
                    data, acc = self._tf.format_batch(
                        pb.id_blob, pb.id_off, pb.id_len,
                        d, best, est, nhits, self._ntable, pb.count)
                    self._out.write(data.decode("ascii"))
                    self.accepted += acc
                    self.total += pb.count
                    continue
                names = self._names
                rows = []
                for i in range(pb.count):
                    ctg = (names[best[i]] if names is not None
                           else str(int(best[i])))
                    rows.append("%s\t%s\t%s\t%d\t%d\n"
                                % (pb.ids[i],
                                   "proceed" if d[i] else "unblock",
                                   ctg if nhits[i] > 0 else ".",
                                   int(est[i]), int(nhits[i])))
                    self.accepted += int(d[i])
                self._out.write("".join(rows))
                self.total += pb.count
        except BaseException as e:
            self._err = e

    def close(self):
        self._q.put(self._DONE)
        self._t.join()
        if self._err is not None:
            raise self._err


def _stream_decisions_py(engine, fastq_path: str, batch: int,
                         read_len: int, out) -> Tuple[int, int]:
    from cornetto_tpu.kernels.minimizer import pack_reads
    total = accepted = 0
    use_packed = hasattr(engine, "decide_packed")
    pending = None  # (ReadBatch, device result) for pipelining
    for rb in Prefetcher(batches_from_fastq(fastq_path, batch, read_len)):
        if use_packed:
            packed, nmask = pack_reads(rb.codes)
            # the N bitmap only needs to cross host->device when a read
            # has an interior N (rare: basecallers emit pure ACGT); pad-
            # to-batch tails are covered by per-read lengths (4 B/read)
            if rb.lengths is not None and not _has_interior_n(rb):
                res = engine.decide_packed(packed, None, read_len,
                                           lengths=rb.lengths)
            else:
                res = engine.decide_packed(packed, nmask, read_len)
        else:
            res = engine.decide(rb.codes)
        if pending is not None:
            total, accepted = _drain(pending[0], pending[1], out,
                                     total, accepted, engine)
        pending = (rb, res)
    if pending is not None:
        total, accepted = _drain(pending[0], pending[1], out,
                                 total, accepted, engine)
    return total, accepted


def _has_interior_n(rb: ReadBatch) -> bool:
    pos = np.arange(rb.codes.shape[1], dtype=np.int32)
    within = pos[None, :] < rb.lengths[:, None]
    return bool(np.any((rb.codes >= 4) & within))


def _drain(rb: ReadBatch, res, out, total, accepted, engine):
    d, best, est, nhits = (np.asarray(x) for x in res[:4])
    names = getattr(engine, "contig_names", None)
    for i in range(rb.count):
        ctg = (names[best[i]] if names is not None else str(int(best[i])))
        out.write("%s\t%s\t%s\t%d\t%d\n"
                  % (rb.ids[i],
                     "proceed" if d[i] else "unblock",
                     ctg if nhits[i] > 0 else ".",
                     int(est[i]), int(nhits[i])))
        total += 1
        accepted += int(d[i])
    return total, accepted
