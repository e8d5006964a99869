"""Tensor bytes from the card to the host in order, for a file or a hash.

``stream_bytes`` hands each tensor's raw bytes to a sink (``f.write``,
``hashlib``'s ``update``) in the given order. Device tensors pass through
two pinned host buffers of ``STAGE_BYTES``: the card copies into one while
the sink takes the other, and no pageable host memory is allocated, where
``.cpu()`` of each tensor would fault in fresh pages for it. Host tensors go
to the sink as they are.
"""

from typing import Any, Callable, Iterable

import torch

# bytes of each of the two pinned buffers
STAGE_BYTES = 64 << 20


def stream_bytes(tensors: Iterable[torch.Tensor], sink: Callable[[memoryview], Any]) -> None:
    """Each tensor's bytes (C order), one tensor after another, to ``sink``
    in chunks; the chunks do not follow the tensors' bounds."""
    stage = _Staging(sink)
    for t in tensors:
        if not t.numel():
            continue
        data = t.detach().contiguous().reshape(-1).view(torch.uint8)
        if data.is_cuda:
            stage.put(data)
        else:
            stage.flush()
            sink(data.numpy().data)
    stage.flush()


class _Staging:
    def __init__(self, sink):
        self.sink, self.bufs, self.cur, self.fill, self.device = sink, [], 0, 0, None
        self.pending: list = [None, None]  # (event, bytes) of a buffer the sink has not taken

    def put(self, data: torch.Tensor) -> None:
        self.device = data.device
        if not self.bufs:
            self.bufs = [torch.empty(STAGE_BYTES, dtype=torch.uint8, pin_memory=True) for _ in range(2)]
        done = 0
        while done < data.numel():
            n = min(STAGE_BYTES - self.fill, data.numel() - done)
            self.bufs[self.cur][self.fill : self.fill + n].copy_(data[done : done + n], non_blocking=True)
            self.fill, done = self.fill + n, done + n
            if self.fill == STAGE_BYTES:
                self._swap()

    def _swap(self) -> None:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self.pending[self.cur] = (event, self.fill)
        self.cur, self.fill = self.cur ^ 1, 0
        self._take(self.cur)  # the older buffer, before the card refills it

    def _take(self, i: int) -> None:
        if self.pending[i] is not None:
            event, n = self.pending[i]
            event.synchronize()
            self.sink(self.bufs[i][:n].numpy().data)
            self.pending[i] = None

    def flush(self) -> None:
        """Everything put so far, to the sink."""
        if self.fill:
            self._swap()
        self._take(self.cur)
        self._take(self.cur ^ 1)
