"""Device prefetch (port of ``tpufw.train.prefetch``): the next batch's
host-to-device copy overlaps the current step.

A named daemon thread pulls host batches (dicts of numpy arrays), copies
each array into a pinned host tensor and from there to the device with
``non_blocking=True`` on a side ``torch.cuda.Stream``, and records an
event. The consumer's stream waits on that event before it hands the
batch out, and ``record_stream`` tells the caching allocator that the
consumer's stream uses the memory, so a buffer is not reused before the
step that reads it is done. On the CPU the same thread hands out torch
tensors, with no streams.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

_END = object()


def prefetch_to_device(
    batches: Iterator[dict],
    device,
    buffer_size: Optional[int] = None,
) -> Iterator[dict]:
    """Yield ``batches`` as dicts of tensors on ``device``, up to
    ``buffer_size`` (default ``TPUFW_PREFETCH_DEPTH``, 2) transfers ahead
    of the consumer. An error of the source is raised at the batch where
    it happened; a consumer that stops early (closes the generator) stops
    the thread, which closes the source."""
    if buffer_size is None:
        from tpufw_torch.workloads.env import env_int

        buffer_size = max(1, env_int("prefetch_depth", 2))
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    side = torch.cuda.Stream(device=dev) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=buffer_size)
    abandoned = threading.Event()

    def put(item) -> bool:
        # A bounded put that gives up once the consumer is gone (the
        # normal end: Trainer.run breaks at total_steps on an endless
        # stream); a plain put would block the thread forever.
        while not abandoned.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def transfer(batch: dict):
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}
        if not cuda:
            return host, None
        with torch.cuda.stream(side):
            out = {k: v.pin_memory().to(dev, non_blocking=True)
                   for k, v in host.items()}
            event = torch.cuda.Event()
            event.record(side)
        return out, event

    def worker():
        try:
            try:
                for batch in batches:
                    if not put(transfer(batch)):
                        return
            finally:
                close = getattr(batches, "close", None)
                if close:
                    close()  # runs the source's finally (native handles)
        except BaseException as e:  # re-raised on the consumer side
            put((_END, e))
            return
        put((_END, None))

    t = threading.Thread(target=worker, daemon=True, name="tpufw-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item[0] is _END:
                if item[1] is not None:
                    raise item[1]
                return
            out, event = item
            if event is not None:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(event)
                for v in out.values():
                    v.record_stream(stream)
            yield out
    finally:
        abandoned.set()
        # The worker notices within one bounded put; joined, it no longer
        # copies when the interpreter exits.
        t.join(timeout=30)
