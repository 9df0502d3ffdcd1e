"""Background batch prefetcher with device staging (the port of
bmhrl_tpu/data/dataset.Prefetcher).

A worker thread pulls batches from the source iterator and stages the
numeric arrays on the device: on CUDA it copies each array into pinned host
memory and then to the card with ``non_blocking=True`` on a side stream, and
records an event; the consumer makes its current stream wait on that event
before it hands the batch out. With depth >= 2 the copy of batch t+1
overlaps the decode of batch t.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from bmhrl_tpu_torch import resolve_device


class Prefetcher:
    DEVICE_KEYS = ("rgb", "flow", "audio")

    def __init__(self, it: Iterator, depth: int = 2, device="cuda"):
        self.device = resolve_device(device)
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._error: Optional[BaseException] = None
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None

        def work():
            try:
                for item in it:
                    event = None
                    if isinstance(item, dict):
                        item = dict(item)
                        for k in self.DEVICE_KEYS:
                            if k not in item:
                                continue
                            host = torch.from_numpy(np.ascontiguousarray(
                                item[k]))
                            if cuda:
                                with torch.cuda.stream(side):
                                    item[k] = host.pin_memory().to(
                                        self.device, non_blocking=True)
                            else:
                                item[k] = host.to(self.device)
                        if cuda:
                            event = torch.cuda.Event()
                            event.record(side)
                    self.q.put((item, event))
            except BaseException as e:  # surface loader errors, don't
                self._error = e         # truncate the stream silently
            finally:
                self.q.put(self._done)

        self.t = threading.Thread(target=work, daemon=True)
        self.t.start()

    def __iter__(self):
        while True:
            got = self.q.get()
            if got is self._done:
                if self._error is not None:
                    raise RuntimeError(
                        "Prefetcher source iterator failed") from self._error
                return
            item, event = got
            if event is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(event)
                for k in self.DEVICE_KEYS:
                    if k in item:
                        # allocated on the side stream, used on this one
                        item[k].record_stream(stream)
            yield item
