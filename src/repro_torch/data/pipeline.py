"""Deterministic, restart-exact input pipeline with background prefetch
(PyTorch counterpart of ``repro.data.pipeline``).

* batches are a pure function of (seed, step) — after a crash or restart
  the trainer resumes at step k and receives the same batches (the
  checkpoint only needs to store the step number, not pipeline state);
* a daemon thread keeps ``prefetch`` batches ahead of the consumer, so
  batch synthesis overlaps the step;
* ``shard_for_host`` slices the global batch to one host's rows.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import torch


class PrefetchPipeline:
    def __init__(
        self,
        make_batch: Callable[[int], dict],   # step -> batch dict
        *,
        start_step: int = 0,
        prefetch: int = 2,
    ):
        self.make_batch = make_batch
        self.step = start_step
        self.prefetch = prefetch
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _producer(self) -> None:
        step = self.step
        while not self._stop.is_set():
            try:
                item = (step, self.make_batch(step))
            except Exception as e:  # handed to the consumer, raised there
                self._put(e)
                return
            self._put(item)
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


def shard_for_host(
    batch: dict,
    *,
    host_index: int = 0,
    num_hosts: int = 1,
    batch_axis: int = 0,
) -> dict:
    """Slice the global batch (a dict of tensors) to this host's rows; an
    entry that is not a tensor (a graph batch's ``n_graphs``) stays as it
    is."""
    if num_hosts == 1:
        return batch

    def slice_leaf(x):
        if not isinstance(x, torch.Tensor):
            return x
        per = x.shape[batch_axis] // num_hosts
        return x.narrow(batch_axis, host_index * per, per)

    return {k: slice_leaf(v) for k, v in batch.items()}
