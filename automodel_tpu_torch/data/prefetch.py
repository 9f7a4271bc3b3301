"""The input pipeline: background collate workers and N-deep device
prefetch with deterministic resume, port of ``automodel_tpu/data/prefetch.py``.

The sync train loop pays, serially per step, the collate (python and numpy
stacking), the host-to-device copy and then the step. Here a small thread
pool collates upcoming batches at once (numpy and disk reads release the
GIL), one producer thread stacks and places them in order, and a bounded
queue holds up to ``data.prefetch.depth`` device-ready optimizer batches
ahead; the train loop's input cost per step becomes a queue pop.

Resume: ``state_dict()`` is the consumption cursor, not the fetch cursor.
Each queue item carries the loader cursor as of after it, adopted only when
the consumer pops it, so a checkpoint at step N resumes at the first batch
the optimizer has not taken; batches fetched ahead are dropped at shutdown
and replayed exactly once. The rollback's fast-forward calls ``seek()``,
which flushes the queue, joins the producer and restarts at the new cursor.

Placement on the card (``DevicePlacer``, the ``place`` callback the recipe
gives): the producer thread binds the device first (a fresh host thread has
no current device), copies each array from a pinned host buffer on a side
stream, records an event after the copies and waits for it before it
queues the batch, so every pinned source outlives its copy. The consumer
(``DevicePlacer.adopt``) makes its own stream wait on that event and
``record_stream``s each tensor on it, so the allocator never hands a
batch's memory back to the side stream while the step still reads it.

YAML::

    data:
      prefetch:
        enabled: true        # section presence opts in; this key opts out
        depth: 2             # device-ready optimizer batches held ahead
        collate_workers: 2   # parallel collate threads feeding the producer
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from automodel_tpu_torch.data.collators import stack_microbatches


@dataclasses.dataclass
class PrefetchConfig:
    """The ``data.prefetch:`` YAML section (strict keys)."""

    enabled: bool = True
    depth: int = 2
    collate_workers: int = 2

    def __post_init__(self) -> None:
        if self.enabled and self.depth < 1:
            raise ValueError(f"data.prefetch.depth must be >= 1, got {self.depth}")
        if self.enabled and self.collate_workers < 1:
            raise ValueError(
                f"data.prefetch.collate_workers must be >= 1, got {self.collate_workers}"
            )

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "PrefetchConfig":
        d = dict(d or {})
        d.pop("_target_", None)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise TypeError(f"unknown data.prefetch keys: {sorted(unknown)}")
        return cls(**d)

    @classmethod
    def from_data_section(cls, section: Any) -> "PrefetchConfig":
        """From the whole ``data:`` section (None → disabled); only
        ``prefetch:`` is read, and its keys are strict."""
        if section is None:
            return cls(enabled=False)
        pf = dict(section).get("prefetch")
        if pf is None:
            return cls(enabled=False)
        return cls.from_dict(dict(pf))


@dataclasses.dataclass
class PreparedBatch:
    """One device-ready optimizer batch: the host-side stacked arrays (token
    accounting reads these), the placed device tree, the token count, and
    the loader cursor as of after this batch."""

    host: dict
    device: Any
    n_tokens: int
    state_after: dict


class _EpochEnd:
    __slots__ = ("state_after",)

    def __init__(self, state_after: dict):
        self.state_after = state_after


class _Failure:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


def default_prepare(group: list) -> tuple[dict, int]:
    """Stack a grad-acc group; token count over all ``*input_ids`` leaves
    (the same numerator the train loop's tps uses)."""
    stacked = stack_microbatches(group)
    n_tokens = int(
        sum(
            np.prod(v.shape)
            for k, v in stacked.items()
            if k.endswith("input_ids") and isinstance(v, np.ndarray)
        )
    )
    return stacked, n_tokens


class PrefetchingLoader:
    """Bounded background pipeline over a ``DataLoader``.

    Duck-types the loader's stateful-resume surface (``state_dict`` /
    ``load_state_dict`` / ``seek`` / ``epoch`` / ``batch_in_epoch`` /
    ``__len__``) against the CONSUMPTION cursor, and iterates like the
    loader (one epoch per ``__iter__`` call) — but yields
    :class:`PreparedBatch` groups of ``group_size`` microbatches
    (``yields_groups = True``; StepScheduler detects this and skips its own
    grouping), with stacking and device placement already done in the
    producer thread. Partial epoch-tail groups are discarded exactly as the
    scheduler's sync grouping discards them, so the rollback's cursor
    arithmetic (``train_ft._rollback``) is the same on both paths.

    The wrapped loader must expose ``batch_for(epoch, i)`` (thread-safe,
    functional batch construction — ``DataLoader`` does) and a read-only
    dataset: collate workers call it concurrently.
    """

    yields_groups = True

    def __init__(
        self,
        loader: Any,
        config: PrefetchConfig,
        prepare: Callable[[list], tuple[dict, int]] | None = None,
        place: Callable[[dict], Any] | None = None,
        group_size: int = 1,
    ):
        self.loader = loader
        self.config = config
        self.prepare = prepare or default_prepare
        self.place = place or (lambda host: host)
        self.group_size = max(int(group_size), 1)
        state = loader.state_dict()
        self._consumed = {
            "epoch": int(state.get("epoch", 0)),
            "batch_in_epoch": int(state.get("batch_in_epoch", 0)),
            "seed": state.get("seed"),
        }
        self._q: queue.Queue = queue.Queue(maxsize=config.depth)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        self._closed = False

    # -- loader surface (consumption cursor) --------------------------------
    def __len__(self) -> int:
        return len(self.loader)

    @property
    def epoch(self) -> int:
        return self._consumed["epoch"]

    @property
    def batch_in_epoch(self) -> int:
        return self._consumed["batch_in_epoch"]

    @property
    def queue_depth(self) -> int:
        """Device-ready batches waiting ahead of the consumer (the log
        record's ``prefetch_depth``)."""
        return self._q.qsize()

    def state_dict(self) -> dict:
        return {k: v for k, v in self._consumed.items() if v is not None}

    def load_state_dict(self, state: dict) -> None:
        self.seek(
            int(state["epoch"]), int(state["batch_in_epoch"]), seed=state.get("seed")
        )

    def seek(self, epoch: int, batch_in_epoch: int, seed: Any = None) -> None:
        """Flush everything fetched ahead and restart fetching at an exact
        cursor (resume restore; rollback fast-forward). Blocks until the
        producer has joined, so no stale batch can race into the queue."""
        self._halt_producer()
        if seed is not None:
            self.loader.seed = seed
        # the inner loader's own cursor is irrelevant while prefetching (the
        # producer does its own math) but is kept in lockstep so an unwrap
        # or a direct inspection reads the same position
        if hasattr(self.loader, "seek"):
            self.loader.seek(epoch, batch_in_epoch)
        self._consumed = {
            "epoch": int(epoch),
            "batch_in_epoch": int(batch_in_epoch),
            "seed": getattr(self.loader, "seed", None),
        }
        self._closed = False

    # -- iteration -----------------------------------------------------------
    def __iter__(self) -> Iterator[PreparedBatch]:
        """One epoch of prepared groups (mirrors ``DataLoader.__iter__``'s
        one-epoch contract; the producer runs ahead across epochs)."""
        while True:
            item = self._next_item()
            if isinstance(item, _EpochEnd):
                self._consumed = dict(item.state_after)
                return
            # consumption happens HERE: a checkpoint taken after this pop
            # must resume at the next batch, never replay this one
            self._consumed = dict(item.state_after)
            yield item

    def _next_item(self):
        if self._closed:
            raise RuntimeError("PrefetchingLoader is closed")
        self._ensure_started()
        while True:
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._thread is None or not self._thread.is_alive():
                    raise RuntimeError(
                        "prefetch producer died without a recorded failure"
                    )
                continue
            if isinstance(item, _Failure):
                self._halt_producer()
                raise item.exc
            return item

    # -- producer ------------------------------------------------------------
    def _ensure_started(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._pool = ThreadPoolExecutor(
            max_workers=self.config.collate_workers,
            thread_name_prefix="collate",
        )
        self._thread = threading.Thread(
            target=self._produce,
            args=(dict(self._consumed),),
            name="prefetch-producer",
            daemon=True,
        )
        self._thread.start()

    def _produce(self, cursor: dict) -> None:
        """Fetch cursor walk: submit collate jobs ``lookahead`` batches
        ahead to the worker pool, reassemble in order, stack + place each
        full group, enqueue with the cursor-after. Partial tails are never
        fetched (the scheduler would discard them); the epoch-end sentinel
        carries the next epoch's cursor."""
        gs = self.group_size
        lookahead = self.config.depth * gs + self.config.collate_workers
        epoch, b = int(cursor["epoch"]), int(cursor["batch_in_epoch"])
        try:
            while not self._stop.is_set():
                nb = len(self.loader)
                full_end = b + ((nb - b) // gs) * gs if nb >= b + gs else b
                inflight: list = []
                next_submit = b
                group: list = []
                while not self._stop.is_set() and (inflight or next_submit < full_end):
                    while next_submit < full_end and len(inflight) < lookahead:
                        inflight.append(
                            self._pool.submit(self.loader.batch_for, epoch, next_submit)
                        )
                        next_submit += 1
                    if not inflight:
                        break
                    batch = inflight.pop(0).result()
                    group.append(batch)
                    if len(group) < gs:
                        continue
                    host, n_tokens = self.prepare(group)
                    b += gs
                    group = []
                    item = PreparedBatch(
                        host=host,
                        device=self.place(host),
                        n_tokens=n_tokens,
                        state_after={
                            "epoch": epoch,
                            "batch_in_epoch": b,
                            "seed": getattr(self.loader, "seed", None),
                        },
                    )
                    if not self._q_put(item):
                        return
                if self._stop.is_set():
                    return
                epoch, b = epoch + 1, 0
                if not self._q_put(
                    _EpochEnd(
                        {
                            "epoch": epoch,
                            "batch_in_epoch": 0,
                            "seed": getattr(self.loader, "seed", None),
                        }
                    )
                ):
                    return
        except BaseException as exc:  # surfaced at the consumer's next pop
            self._q_put(_Failure(exc))

    def _q_put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    # -- lifecycle -----------------------------------------------------------
    def _halt_producer(self) -> None:
        self._stop.set()
        if self._thread is not None:
            # drain so a producer blocked on a full queue can observe stop
            while self._thread.is_alive():
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    self._thread.join(timeout=0.05)
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
        self._thread = None
        while True:  # anything raced in between drain and join
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def suspend(self) -> None:
        """Join the producer and drop the run-ahead without closing: the
        next pop restarts fetching at the consumption cursor. The recipe
        calls this after each validation pass, so the validation pipeline
        does not hold the next pass's batches on the device until then."""
        self._halt_producer()

    def close(self) -> None:
        """Join the producer and drop everything fetched ahead. Called at
        loop exit, normal or not. Idempotent; the consumption cursor
        survives, so ``state_dict()`` stays valid."""
        self._halt_producer()
        self._closed = True


class PlacedBatch(dict):
    """A batch's device tensors by key, with the event recorded after their
    copies (``None`` off the card)."""

    ready: Optional[torch.cuda.Event] = None


class DevicePlacer:
    """The pipeline's ``place`` callback for one device (``__call__``, run
    in the producer thread) and its consumer side (``adopt``, run where the
    step runs). Off the card the arrays become tensors that share their
    memory, as the sync path's copy to the CPU does."""

    def __init__(self, device: Any, select: Any = None):
        self.device = torch.device(device)
        # under a mesh: the host batch → this rank's part (data/loader.local_batch)
        self.select = select
        if self.device.type == "cuda" and self.device.index is None:
            # the producer thread binds this index; ``cuda`` alone names the
            # current device of the thread that builds the placer
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._local = threading.local()

    def __call__(self, host: dict) -> PlacedBatch:
        if self.select is not None:
            host = self.select(host)
        arrays = {k: v for k, v in host.items() if isinstance(v, np.ndarray)}
        if self.device.type != "cuda":
            return PlacedBatch({k: torch.from_numpy(v).to(self.device) for k, v in arrays.items()})
        stream = getattr(self._local, "stream", None)
        if stream is None:
            # a fresh host thread: bind the device before any CUDA work
            torch.cuda.set_device(self.device)
            stream = self._local.stream = torch.cuda.Stream(self.device)
        out = PlacedBatch()
        with torch.cuda.stream(stream):
            for k, v in arrays.items():
                out[k] = torch.from_numpy(v).pin_memory().to(self.device, non_blocking=True)
            out.ready = torch.cuda.Event()
            out.ready.record(stream)
        # the pinned sources go when this returns: wait for their copies
        out.ready.synchronize()
        return out

    def adopt(self, batch: PlacedBatch) -> PlacedBatch:
        """Order the consumer's stream after the batch's copies, and keep
        each tensor's memory from the allocator until that stream's work
        on it is done."""
        if batch.ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(batch.ready)
            for t in batch.values():
                t.record_stream(stream)
        return batch
