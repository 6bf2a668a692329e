"""Disk spill: file-backed partials and external sort.

The port's copy of presto_tpu/exec/spill.py (reference roles:
spiller/FileSingleStreamSpiller.java writing serialized pages to spill
files, MemoryRevokingScheduler revoking operator memory into them). A
spill file is one SerializedPage frame (protocol/serde.py, LZ4 by
default), byte for byte the frame the JAX package writes for the same
page, so every type round-trips (strings, DECIMAL(38) limb lanes, nested
columns).

Two consumers:
  - exec/lifespan.BatchedRunner: aggregation partials revoke to disk
    under `spill_enabled` + `spill_path` (host RAM without a path);
  - external_sort(): sorted run files and a streaming k-way merge;
and exec/spill_join.py partitions both sides of a join through it.

The disk-fault hook of the JAX module (`_disk_faults` :50, which reads
testing/faults' injector) waits for the port's copy of testing/faults;
its metrics counters wait for an observability layer.
"""

from __future__ import annotations

import heapq
import os
import shutil
import tempfile
import uuid
from typing import Iterator, List, Optional, Sequence, Tuple

from presto_tpu_torch.data.column import Page


class SpillError(RuntimeError):
    """Classified spill-write failure (ENOSPC / torn write / EIO on a
    spill file): a query that dies here fails cleanly instead of
    surfacing a bare OSError from deep inside an operator."""

    def __init__(self, message: str):
        super().__init__(f"Spill failed: {message}")


class SpillHandle:
    __slots__ = ("path", "num_rows", "types", "names", "bytes")

    def __init__(self, path: str, num_rows: int, types, names,
                 nbytes: int):
        self.path = path
        self.num_rows = num_rows
        self.types = types
        self.names = names
        self.bytes = nbytes


class FileSpiller:
    """Write pages to spill files; read them back page by page. One
    directory per spiller instance, deleted on close when the spiller
    made it. Pages read back land on `device` (None means the card)."""

    def __init__(self, directory: Optional[str] = None,
                 codec: str = "lz4", device=None):
        self._own_dir = directory is None
        self.directory = directory or tempfile.mkdtemp(
            prefix="presto_tpu_torch_spill_")
        os.makedirs(self.directory, exist_ok=True)
        self.codec = codec
        self.device = device
        self.handles: List[SpillHandle] = []
        self.total_spilled_bytes = 0

    def spill(self, page: Page) -> SpillHandle:
        from presto_tpu_torch.protocol.serde import (
            encode_serialized_page, page_to_wire_blocks,
        )
        frame = encode_serialized_page(
            page_to_wire_blocks(page), checksummed=True,
            compression=self.codec)
        path = os.path.join(self.directory,
                            f"run_{len(self.handles)}_{uuid.uuid4().hex[:8]}")
        try:
            with open(path, "wb") as f:
                f.write(frame)
        except OSError as e:
            # a partial run file is unreadable garbage: it must not
            # outlive the failure (close() only knows recorded handles)
            try:
                os.unlink(path)
            except OSError:
                pass
            raise SpillError(f"spill write failed: {e}") from e
        h = SpillHandle(path, int(page.num_rows),
                        [c.type for c in page.columns],
                        tuple(page.names), len(frame))
        self.handles.append(h)
        self.total_spilled_bytes += len(frame)
        return h

    def read(self, handle: SpillHandle, device=None) -> Page:
        """The spilled page, on `device` (default: the spiller's)."""
        from presto_tpu_torch.protocol.serde import (
            decode_serialized_page, wire_blocks_to_page,
        )
        with open(handle.path, "rb") as f:
            data = f.read()
        blocks, n, _ = decode_serialized_page(data)
        page = wire_blocks_to_page(
            blocks, list(handle.types), n,
            device=self.device if device is None else device)
        page.names = handle.names
        return page

    def read_rows(self, handle: SpillHandle) -> Iterator[tuple]:
        yield from self.read(handle, device="cpu").to_pylist()

    def close(self):
        """Idempotent teardown. An OWNED directory is removed whole
        (strays from a mid-spill crash included); a caller-supplied
        directory only loses the files this spiller recorded."""
        for h in self.handles:
            try:
                os.unlink(h.path)
            except OSError:
                pass
        self.handles = []
        if self._own_dir:
            shutil.rmtree(self.directory, ignore_errors=True)

    def __enter__(self) -> "FileSpiller":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def merge_sorted_rows(iters: Sequence[Iterator[tuple]], keys
                      ) -> Iterator[tuple]:
    """Streaming k-way merge of row iterators already sorted by `keys`
    (ops/keys.SortKey sequence): SQL null ordering, per-key direction,
    NaN after every other value."""

    class _Key:
        __slots__ = ("row",)

        def __init__(self, row):
            self.row = row

        def __lt__(self, other):
            for k in keys:
                a = self.row[k.field]
                b = other.row[k.field]
                if a is None or b is None:
                    if (a is None) != (b is None):
                        return (a is None) == k.nulls_sort_first
                    continue
                a_nan = isinstance(a, float) and a != a
                b_nan = isinstance(b, float) and b != b
                if a_nan or b_nan:
                    if a_nan != b_nan:
                        return b_nan
                    continue
                if a == b:
                    continue
                return (a < b) == k.ascending
            return False

    return heapq.merge(*iters, key=_Key)


def external_sort(ex, plan, driving: str, num_batches: int,
                  spill_dir: Optional[str] = None
                  ) -> Tuple[List[tuple], int]:
    """Disk-backed external sort: run the sort plan once per driving-scan
    lifespan (each run sorts its slice on the device), spill every sorted
    run, then stream-merge the runs. Peak memory is one lifespan plus the
    merge window, not the whole table.

    `ex` is a SplitExecutor; `plan` must be the SORT subtree. Returns
    (rows, spilled_bytes)."""
    spiller = FileSpiller(spill_dir, device=ex.device)
    try:
        for b in range(num_batches):
            ex.set_splits({driving: [(b, num_batches)]})
            spiller.spill(ex.execute(plan))
        merged = merge_sorted_rows(
            [spiller.read_rows(h) for h in spiller.handles], plan.keys)
        return list(merged), spiller.total_spilled_bytes
    finally:
        spiller.close()
